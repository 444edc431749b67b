"""DecodeEngine: the one subsystem turning straggler masks into decode
weights, shared by the Monte-Carlo simulator, ClusterSim and the coded
all-reduce.

It decodes a whole ``[B, n]`` ensemble of masks per call instead of a
Python loop over trials:

  * ``decode_batch(masks)`` -> ``[B, n]`` weights + ``[B]`` errors for
    the one-step (Algorithm 1), ridge/optimal (Algorithm 2) and
    algorithmic (Lemma 12) decoders, plus the ignore-stragglers
    baseline.
  * ``decode_apply_batch(masks, messages)`` fuses the one-step decode
    into the gradient accumulate itself: ``diag(scales) masks @
    messages`` in one pass, never materializing the ``[B, n]`` weight
    ensemble (``kernels.ops.fused_decode_apply``).
  * backends: ``torch`` (the default) runs the one-step decode through
    the batched kernels of ``kernels.ops`` on ``device`` -- the CUDA
    kernels on the card (the counterpart of the reference's "pallas"),
    their plain versions when the caller asks for ``device="cpu"``
    (the counterpart of "pallas_interpret"/"xla").  It switches to the
    row-ELL packing of G (``GradientCode.ell()``) when the code is
    sparse enough that gathering beats the dense product.  ``numpy``
    is the fp64 host path (BLAS batched), used only when asked for; it
    also serves the optimal and algorithmic decoders, whose kernels are
    not ported yet.
  * ``decode(mask)`` -> ``[n]`` weights through a mask->weights LRU
    cache, so regimes that repeat masks (adversarial stragglers, stable
    deadline cohorts) decode once per distinct mask.

The kernels return fp32 ``V = diag(rho) M G^T``; the engine turns it into
errors in fp64 on the host, as the reference does, so the zero-error
count of the Monte-Carlo cells (errors < 1e-9) is not moved by an fp32
reduction.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .. import platform
from ..kernels import ops
from . import decoding
from .codes import GradientCode

__all__ = ["BatchDecode", "DecodeEngine"]

_BACKENDS = ("numpy", "torch")
DECODERS = ("onestep", "optimal", "algorithmic", "ignore")


@dataclasses.dataclass(frozen=True)
class BatchDecode:
    """Result of one batched decode: per-mask weights and errors."""

    weights: np.ndarray      # [B, n] decode weights (zero at stragglers)
    errors: np.ndarray       # [B] decoding error (err_1 / err / ||u_t||^2)

    @property
    def batch(self) -> int:
        return int(self.weights.shape[0])


class DecodeEngine:
    """Owns a GradientCode and decodes mask ensembles against it.

    Construction is cheap; the ELL packing and per-code constants are
    derived lazily.  One engine per live code — the training loop
    rebuilds it on elastic re-coding, the simulator builds one per
    (scheme, delta) cell.
    """

    def __init__(self, code: GradientCode, *, backend: str = "torch",
                 device=None, rho: Optional[float] = None,
                 s: Optional[int] = None, ridge: float = 0.0, iters: int = 8,
                 sparse: str = "auto", optimal_impl: str = "auto",
                 cache_size: int = 512, tiles=None):
        if backend not in _BACKENDS:
            raise ValueError(f"backend {backend!r} not in {_BACKENDS}")
        if tiles is not None:
            raise ValueError("tiles= must be None: the port has no tile "
                             "table yet")
        if sparse not in ("auto", "always", "never"):
            raise ValueError(f"sparse {sparse!r}")
        if optimal_impl not in ("auto", "pinv", "gram"):
            raise ValueError(f"optimal_impl {optimal_impl!r} not in "
                             f"('auto', 'pinv', 'gram')")
        self.code = code
        self.backend = backend
        # the torch backend runs on the card unless the caller names a
        # device; the numpy backend computes on the host and keeps a
        # device only when given one (for callers that move results)
        self.device = (platform.device(device)
                       if backend == "torch" or device is not None else None)
        self._dev_G = None              # lazy fp32 G on self.device
        self._dev_ell = None            # lazy (idx, val) ELL on self.device
        self.rho = rho                  # None -> per-mask k/(r s)
        self.ridge = ridge
        self.iters = iters
        self.sparse = sparse
        # least-squares strategy: 'gram' = masked-Gram normal equations
        # (one O(k n^2) Gram, O(n^2)/mask — the fast path for large
        # ensembles, ridge-regularized); 'pinv' = exact min-norm batched
        # pinv (matches decoding.optimal_weights to solver rounding —
        # the explicit opt-in for numpy/ridge=0 exact-oracle tests);
        # 'auto' = gram (E10's speedup[optimal] gate pins this default)
        self.optimal_impl = optimal_impl
        self._gram = None               # lazy G^T G / G^T 1 for 'gram'
        # s in rho = k/(r s): the caller's nominal tasks/worker when
        # given (the paper's calibration — simulate passes it), else
        # inferred from G's density exactly like decoding.onestep_weights
        self._s = s if s is not None else decoding._infer_s(code.G)
        self._cache: OrderedDict = OrderedDict()
        self._cache_size = cache_size
        self.cache_hits = 0
        self.cache_misses = 0
        # number of decode_batch invocations — ClusterSim's tests assert
        # one batched decode per (scheme, policy) run against this
        self.batch_calls = 0
        # number of fused decode-apply scale computations (decode_batch
        # is NOT incremented on the fused path: no weight ensemble)
        self.fused_calls = 0

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    @property
    def k(self) -> int:
        return self.code.k

    @property
    def n(self) -> int:
        return self.code.n

    def rhos_for(self, masks: np.ndarray) -> np.ndarray:
        """Per-mask one-step scaling: the fixed rho, or k/(r_b s)."""
        masks = decoding._as_masks(masks, self.n)
        if self.rho is not None:
            return np.full(masks.shape[0], float(self.rho))
        return decoding._default_rhos(self.k, masks.sum(axis=1), self._s)

    def _use_ell(self) -> bool:
        if self.sparse == "never":
            return False
        idx, _ = self.code.ell()
        rmax = idx.shape[1]
        # gather wins when the packed row is meaningfully narrower than
        # the dense worker dimension
        return self.sparse == "always" or 4 * rmax <= self.n

    # ------------------------------------------------------------------
    # batched decode
    # ------------------------------------------------------------------

    def decode_batch(self, masks: np.ndarray, method: str = "onestep", *,
                     iters: Optional[int] = None) -> BatchDecode:
        """Decode a [B, n] mask ensemble -> weights [B, n], errors [B]."""
        masks = decoding._as_masks(masks, self.n)
        self.batch_calls += 1
        if method == "onestep":
            return self._onestep_batch(masks)
        if method == "optimal":
            return self._optimal_batch(masks)
        if method == "algorithmic":
            return self._algorithmic_batch(
                masks, self.iters if iters is None else iters)
        if method == "ignore":
            return self._ignore_batch(masks)
        raise ValueError(f"unknown decode method {method!r}; "
                         f"have {DECODERS}")

    def errors_batch(self, masks: np.ndarray, method: str = "onestep", *,
                     iters: Optional[int] = None) -> np.ndarray:
        """[B] decoding errors only (what the Monte-Carlo cells consume)."""
        return self.decode_batch(masks, method, iters=iters).errors

    def _onestep_batch(self, masks: np.ndarray) -> BatchDecode:
        G = self.code.G
        rhos = self.rhos_for(masks)
        W = rhos[:, None] * masks
        if self.backend == "numpy":
            errs = decoding.err1_batch(G, masks, rhos)
            return BatchDecode(weights=W, errors=errs)
        V = self._kernel_onestep(masks, rhos)
        errs = ((V - 1.0) ** 2).sum(axis=1)
        return BatchDecode(weights=W, errors=errs)

    def _kernel_onestep(self, masks: np.ndarray,
                        rhos: np.ndarray) -> np.ndarray:
        m = torch.from_numpy(np.ascontiguousarray(masks)).to(self.device)
        r = torch.from_numpy(rhos.astype(np.float32)).to(self.device)
        if self._use_ell():
            idx, val = self._device_ell()
            V = ops.batched_onestep_decode_ell(idx, val, m, r)
        else:
            V = ops.batched_onestep_decode(self._device_G(), m, r)
        return V.cpu().numpy().astype(np.float64)

    def _device_G(self) -> torch.Tensor:
        if self._dev_G is None:
            self._dev_G = torch.from_numpy(
                self.code.G.astype(np.float32)).to(self.device)
        return self._dev_G

    def _device_ell(self):
        if self._dev_ell is None:
            idx, val = self.code.ell()
            if idx.size and (idx.min() < 0 or idx.max() >= self.n):
                raise ValueError(f"ELL column index outside [0, {self.n})")
            self._dev_ell = (torch.from_numpy(idx).to(self.device),
                             torch.from_numpy(val).to(self.device))
        return self._dev_ell

    def _require_numpy(self, method: str) -> None:
        if self.backend != "numpy":
            raise NotImplementedError(
                f"the {method} decoder's kernels come in a later slice of "
                f"the port; decode it with backend='numpy'")

    def _optimal_batch(self, masks: np.ndarray) -> BatchDecode:
        self._require_numpy("optimal")
        G = self.code.G
        mode = self.optimal_impl
        if mode == "auto":
            mode = "gram"
        if mode == "pinv":
            # exact min-norm batched pinv (the scalar-oracle-equivalent
            # reference path; numpy only)
            W = decoding.optimal_weights_batch(G, masks, ridge=self.ridge)
        else:
            W = self._gram_weights(masks)
        errs = decoding.err_batch(G, W)
        return BatchDecode(weights=W, errors=errs)

    def _gram_weights(self, masks: np.ndarray) -> np.ndarray:
        """Masked-Gram normal-equations least squares (docs/families.md).

        The batched fp64 solve shares a ridge floor (normal equations
        square the condition number; on rank-deficient supports the
        weights approach the min-norm solution as ridge -> 0 while the
        decode *errors* match the pinv path far tighter than the weights
        do).
        """
        ridge = max(self.ridge, 1e-6)
        if self._gram is None:
            G = self.code.G
            self._gram = (G.T @ G, G.sum(axis=0))
        gram, rhs0 = self._gram
        return decoding.normal_eq_weights_batch(self.code.G, masks,
                                                ridge=ridge,
                                                gram=gram, rhs0=rhs0)

    def _algorithmic_batch(self, masks: np.ndarray,
                           iters: int) -> BatchDecode:
        self._require_numpy("algorithmic")
        W, errs = decoding.algorithmic_weights_batch(
            self.code.G, masks, iters, return_errors=True)
        return BatchDecode(weights=W, errors=errs)

    def _ignore_batch(self, masks: np.ndarray) -> BatchDecode:
        G = self.code.G
        colnnz = (G != 0).sum(axis=0).astype(np.float64)
        cover = np.maximum(masks @ colnnz, 1.0)
        W = masks * (self.k / cover)[:, None]
        errs = decoding.err_batch(G, W)
        return BatchDecode(weights=W, errors=errs)

    # ------------------------------------------------------------------
    # fused decode-apply (one-step decode folded into the accumulate)
    # ------------------------------------------------------------------

    def onestep_scales(self, masks: np.ndarray, *,
                       renorm: bool = False) -> np.ndarray:
        """[B] per-mask scalar s_b with one-step weights w_b = s_b m_b.

        renorm=False gives the raw rho_b = k/(r_b s); renorm=True folds
        ``decoding.exact_decode_renorm`` in analytically: the renormed
        one-step weight is ``w * k / sum(G w)`` and for w = rho*m the
        rho cancels, leaving ``k / (m @ colsum(G))`` — with the same
        tot <= 1e-6 skip rule (all-straggler rows keep the raw rho).
        """
        masks = decoding._as_masks(masks, self.n)
        self.fused_calls += 1
        rhos = self.rhos_for(masks)
        if not renorm:
            return rhos
        denom = masks.astype(np.float64) @ self.code.G.sum(axis=0)
        tot = rhos * denom
        return np.where(tot > 1e-6, self.k / np.where(denom == 0, 1.0, denom),
                        rhos)

    def decode_apply_batch(self, masks: np.ndarray, messages, *,
                           renorm: bool = False,
                           impl: Optional[str] = None):
        """One-step decode fused into the apply: [B, P] decoded grads.

        Equivalent to ``decode_batch(masks, 'onestep').weights @
        messages`` (with optional exact renorm) but in a single pass
        over the [L, P] worker messages -- no weight ensemble, no error
        reduction.  ``impl`` overrides the backend.  numpy computes in
        fp64 BLAS and returns an array.  torch runs
        ``kernels.ops.fused_decode_apply`` in fp32 on the messages'
        device when they are a tensor (and returns a tensor there), on
        the engine's device otherwise (and returns an fp64 array, as the
        reference does).
        """
        masks = decoding._as_masks(masks, self.n)
        scales = self.onestep_scales(masks, renorm=renorm)
        backend = self.backend if impl is None else impl
        if backend not in _BACKENDS:
            raise ValueError(f"impl {backend!r} not in {_BACKENDS}")
        is_tensor = isinstance(messages, torch.Tensor)
        if backend == "numpy":
            if is_tensor:
                messages = messages.cpu().numpy()
            W = scales[:, None] * masks
            return W @ np.asarray(messages, dtype=np.float64)
        dev = messages.device if is_tensor else (
            self.device if self.device is not None else platform.device())
        msg = torch.as_tensor(messages, device=dev).to(torch.float32)
        out = ops.fused_decode_apply(
            msg.contiguous(),
            torch.from_numpy(np.ascontiguousarray(masks)).to(dev),
            torch.from_numpy(scales.astype(np.float32)).to(dev))
        return out if is_tensor else out.cpu().numpy().astype(np.float64)

    # ------------------------------------------------------------------
    # single-mask decode with LRU cache (training hot path)
    # ------------------------------------------------------------------

    def decode(self, mask: np.ndarray, method: str = "onestep", *,
               iters: Optional[int] = None) -> np.ndarray:
        """[n] decode weights for one mask, memoized on the mask bytes.

        Adversarial and deadline straggler regimes repeat masks across
        steps; each distinct (mask, method) decodes exactly once.
        """
        mask = np.asarray(mask, dtype=bool)
        it = self.iters if iters is None else iters
        key = (method, it, mask.tobytes())
        hit = self._cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            self._cache.move_to_end(key)
            return hit
        self.cache_misses += 1
        w = self.decode_batch(mask[None], method, iters=it).weights[0]
        w.setflags(write=False)   # cached array is shared — freeze it
        self._cache[key] = w
        if len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return w

    def cache_info(self) -> dict:
        return {"hits": self.cache_hits, "misses": self.cache_misses,
                "size": len(self._cache), "maxsize": self._cache_size}

    def clear_cache(self) -> None:
        self._cache.clear()
        self.cache_hits = self.cache_misses = 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"DecodeEngine(code={self.code.name!r}, k={self.k}, "
                f"n={self.n}, backend={self.backend!r}, "
                f"device={self.device})")
