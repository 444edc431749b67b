"""Decoders: reconstruct (approximately) 1_k from the non-straggler matrix A.

Three decoders from the paper:

* one-step (Algorithm 1): v = rho * A @ 1_r.  O(nnz(A)), streaming.
* optimal  (Algorithm 2): v = A @ argmin_x ||A x - 1_k||^2.  Least squares.
* algorithmic (Lemma 12): u_t = (I - A A^T / nu) u_{t-1}, u_0 = 1_k.
  ||u_t||^2 decreases monotonically to err(A); each iterate costs two
  matvecs, interpolating between one-step and optimal decoding.

All of these produce *decode weights* w in R^n (zero at stragglers) such
that the master's reconstruction is  v = G @ w  and the decoded gradient
is  sum_j w_j * (coded partial of worker j).  The training path consumes
the weights; the error analyses consume v.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "err",
    "err1",
    "onestep_weights",
    "onestep_decode",
    "optimal_weights",
    "optimal_decode",
    "algorithmic_weights",
    "algorithmic_error_curve",
    "decode_weights",
    "exact_decode_renorm",
    "apply_weights",
    # batched (mask-ensemble) variants — consumed by core.engine
    "err1_batch",
    "err_batch",
    "onestep_weights_batch",
    "optimal_weights_batch",
    "normal_eq_weights_batch",
    "solve_masked_gram",
    "algorithmic_weights_batch",
    "algorithmic_error_curve_batch",
    "spectral_norm_sq_batch",
]


def _as2d(A: np.ndarray) -> np.ndarray:
    A = np.asarray(A, dtype=np.float64)
    if A.ndim != 2:
        raise ValueError(f"expected 2-D matrix, got shape {A.shape}")
    return A


def err(A: np.ndarray) -> float:
    """Optimal decoding error err(A) = min_x ||A x - 1_k||_2^2 (Def. 1)."""
    A = _as2d(A)
    k = A.shape[0]
    ones = np.ones(k)
    if A.shape[1] == 0:
        return float(k)
    x, _, _, _ = np.linalg.lstsq(A, ones, rcond=None)
    res = A @ x - ones
    return float(res @ res)


def err1(A: np.ndarray, rho: float) -> float:
    """One-step decoding error err_1(A) = ||rho * A 1_r - 1_k||_2^2 (Def. 2)."""
    A = _as2d(A)
    k = A.shape[0]
    v = rho * A.sum(axis=1) - np.ones(k)
    return float(v @ v)


def default_rho(k: int, r: int, s: int) -> float:
    """The paper's canonical rho = k / (r s)."""
    if r == 0:
        return 0.0
    return k / (r * s)


def onestep_weights(G: np.ndarray, mask: np.ndarray, rho: Optional[float] = None,
                    s: Optional[int] = None) -> np.ndarray:
    """Decode weights for Algorithm 1: w_j = rho if j is a non-straggler.

    rho defaults to k/(r s) with s inferred from G's mean column degree
    if not given.
    """
    G = _as2d(G)
    mask = np.asarray(mask, dtype=bool)
    k, n = G.shape
    r = int(mask.sum())
    if rho is None:
        if s is None:
            s = max(1, int(round((G != 0).sum() / max(n, 1))))
        rho = default_rho(k, r, s)
    return rho * mask.astype(np.float64)


def onestep_decode(G: np.ndarray, mask: np.ndarray, rho: Optional[float] = None,
                   s: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(v, w): reconstruction v = G @ w and the weights, Algorithm 1."""
    w = onestep_weights(G, mask, rho=rho, s=s)
    return _as2d(G) @ w, w


def optimal_weights(G: np.ndarray, mask: np.ndarray, ridge: float = 0.0) -> np.ndarray:
    """Decode weights for Algorithm 2 embedded in R^n (zeros at stragglers).

    Solves min_x ||A x - 1_k||^2 (+ ridge ||x||^2) over the non-straggler
    columns A.  With ridge=0 this is the pseudo-inverse solution
    x = A^+ 1_k; a tiny ridge stabilizes ill-conditioned A (the paper
    notes one-step decoding is preferred exactly when A is
    ill-conditioned).
    """
    G = _as2d(G)
    mask = np.asarray(mask, dtype=bool)
    k, n = G.shape
    A = G[:, mask]
    w = np.zeros(n)
    if A.shape[1] == 0:
        return w
    ones = np.ones(k)
    if ridge > 0.0:
        r = A.shape[1]
        x = np.linalg.solve(A.T @ A + ridge * np.eye(r), A.T @ ones)
    else:
        x, _, _, _ = np.linalg.lstsq(A, ones, rcond=None)
    w[mask] = x
    return w


def optimal_decode(G: np.ndarray, mask: np.ndarray, ridge: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(v, w) for Algorithm 2."""
    w = optimal_weights(G, mask, ridge=ridge)
    return _as2d(G) @ w, w


def _spectral_norm_sq(A: np.ndarray) -> float:
    if min(A.shape) == 0:
        return 1.0
    return float(np.linalg.norm(A, 2) ** 2)


def algorithmic_weights(G: np.ndarray, mask: np.ndarray, iters: int,
                        nu: Optional[float] = None) -> np.ndarray:
    """Decode weights after `iters` steps of the Lemma-12 iteration.

    u_t = (I - A A^T/nu) u_{t-1};  the reconstruction after t steps is
    v_t = 1_k - u_t = A x_t  with  x_t = (1/nu) sum_{j<t} A^T u_j,  so the
    weights are x_t scattered into R^n.  iters=1 with nu = r s^2 / k
    recovers (a scaled) one-step decode; iters -> inf recovers optimal.
    """
    G = _as2d(G)
    mask = np.asarray(mask, dtype=bool)
    k, n = G.shape
    A = G[:, mask]
    w = np.zeros(n)
    if A.shape[1] == 0 or iters <= 0:
        return w
    if nu is None:
        nu = _spectral_norm_sq(A)
    u = np.ones(k)
    x = np.zeros(A.shape[1])
    for _ in range(iters):
        x = x + (A.T @ u) / nu
        u = u - (A @ (A.T @ u)) / nu
    w[mask] = x
    return w


def algorithmic_error_curve(A: np.ndarray, iters: int, nu: Optional[float] = None
                            ) -> np.ndarray:
    """[||u_0||^2, ..., ||u_iters||^2] — the Fig.-5 curve (monotone to err(A))."""
    A = _as2d(A)
    k = A.shape[0]
    if nu is None:
        nu = _spectral_norm_sq(A)
    u = np.ones(k)
    out = [float(u @ u)]
    for _ in range(iters):
        if A.shape[1]:
            u = u - (A @ (A.T @ u)) / nu
        out.append(float(u @ u))
    return np.asarray(out)


# --------------------------------------------------------------------------
# Batched (mask-ensemble) decoders.
#
# All of these take a [B, n] boolean batch of non-straggler masks and
# return [B, n] weights (and [B] errors where noted), replacing the
# Python trial loops in the Monte-Carlo engine.  Zero terms contribute
# exactly 0.0 to float sums, so the masked full-width linear algebra
# below reproduces the per-mask submatrix results exactly (onestep) or
# to solver/BLAS rounding (optimal, algorithmic).
# --------------------------------------------------------------------------


def _as_masks(masks: np.ndarray, n: int) -> np.ndarray:
    masks = np.asarray(masks, dtype=bool)
    if masks.ndim == 1:
        masks = masks[None]
    if masks.ndim != 2 or masks.shape[1] != n:
        raise ValueError(f"masks shape {masks.shape} != (B, {n})")
    return masks


def _infer_s(G: np.ndarray) -> int:
    return max(1, int(round((G != 0).sum() / max(G.shape[1], 1))))


def _default_rhos(k: int, rs: np.ndarray, s: int) -> np.ndarray:
    """Vectorized default_rho: k/(r s), 0 where r == 0."""
    out = np.zeros(len(rs))
    nz = rs > 0
    out[nz] = k / (rs[nz] * s)
    return out


def _batch_chunks(B: int, k: int, n: int, budget_elems: int = 1 << 26):
    """Yield slices covering range(B), bounding k*n*chunk work arrays."""
    step = max(1, budget_elems // max(k * n, 1))
    for lo in range(0, B, step):
        yield slice(lo, min(lo + step, B))


def err1_batch(G: np.ndarray, masks: np.ndarray,
               rhos: np.ndarray) -> np.ndarray:
    """err_1 per mask: ||rho_b * G m_b - 1_k||^2.  Returns [B]."""
    G = _as2d(G)
    masks = _as_masks(masks, G.shape[1])
    V = np.asarray(rhos)[:, None] * (masks @ G.T)
    return ((V - 1.0) ** 2).sum(axis=1)


def err_batch(G: np.ndarray, W: np.ndarray) -> np.ndarray:
    """Residual ||G w_b - 1_k||^2 for given decode weights.  Returns [B]."""
    G = _as2d(G)
    V = W @ G.T
    return ((V - 1.0) ** 2).sum(axis=1)


def onestep_weights_batch(G: np.ndarray, masks: np.ndarray,
                          rho: Optional[float] = None,
                          s: Optional[int] = None) -> np.ndarray:
    """Batched Algorithm 1 weights: w_b = rho_b * m_b.  Returns [B, n]."""
    G = _as2d(G)
    k, n = G.shape
    masks = _as_masks(masks, n)
    if rho is None:
        if s is None:
            s = _infer_s(G)
        rhos = _default_rhos(k, masks.sum(axis=1), s)
    else:
        rhos = np.full(masks.shape[0], float(rho))
    return rhos[:, None] * masks


def optimal_weights_batch(G: np.ndarray, masks: np.ndarray,
                          ridge: float = 0.0) -> np.ndarray:
    """Batched Algorithm 2 weights embedded in R^n.  Returns [B, n].

    ridge == 0 takes the min-norm LS solution via batched pinv of the
    column-masked G (zeroed columns contribute zero weights, matching
    the per-mask submatrix lstsq).  ridge > 0 goes through the masked
    normal equations (normal_eq_weights_batch), whose off-support rows
    reduce to w_j = 0.  Work is chunked over B to bound memory.
    """
    G = _as2d(G)
    k, n = G.shape
    masks = _as_masks(masks, n)
    if ridge > 0.0:
        return normal_eq_weights_batch(G, masks, ridge=ridge)
    B = masks.shape[0]
    ones = np.ones(k)
    W = np.zeros((B, n))
    for sl in _batch_chunks(B, k, n):
        m = masks[sl].astype(np.float64)
        A = G[None, :, :] * m[:, None, :]                    # [b, k, n]
        W[sl] = (np.linalg.pinv(A) @ ones) * m
    return W


def solve_masked_gram(masked_gram: np.ndarray, masks: np.ndarray,
                      rhs0: np.ndarray, ridge: float) -> np.ndarray:
    """Solve the [B] regularized normal-equation systems and return
    weights [B, n].

    ``masked_gram[b] = diag(m_b) G^T G diag(m_b)`` (the Gram ensemble —
    from numpy or a batched Gram kernel), ``rhs0 = G^T 1``.
    Straggler rows are all-zero in the masked Gram; the unit added to
    their diagonal pins x_j = 0, and ``ridge`` stabilizes the on-support
    block (rank-deficient supports — duplicated FRC/SBM columns — tend
    to the min-norm solution as ridge -> 0).
    """
    masks = np.asarray(masks, dtype=bool)
    B, n = masks.shape
    M = np.array(masked_gram, dtype=np.float64)   # copy: diagonal is edited
    idx = np.arange(n)
    M[:, idx, idx] += np.where(masks, ridge, 1.0)
    rhs = masks * rhs0[None, :]
    x = np.linalg.solve(M, rhs[..., None])[..., 0]
    return x * masks


def normal_eq_weights_batch(G: np.ndarray, masks: np.ndarray,
                            ridge: float = 1e-8,
                            gram: Optional[np.ndarray] = None,
                            rhs0: Optional[np.ndarray] = None) -> np.ndarray:
    """Batched least-squares weights via the masked-Gram identity.

    Since A_b = G diag(m_b), the per-mask Gram matrix is
    ``A_b^T A_b = diag(m_b) (G^T G) diag(m_b)`` — the FULL Gram G^T G
    masked on rows and columns.  So G^T G is formed once (O(k n^2)) and
    each mask costs an O(n^2) masking plus one LAPACK batched solve,
    never a per-mask pinv/SVD: the decoder path that makes batched
    optimal decoding of [B, n] ensembles (sbm / expander frontiers)
    cheap.  Returns [B, n]; exact zeros at stragglers.

    Long-lived callers (DecodeEngine) pass their cached ``gram`` /
    ``rhs0`` so repeated decodes skip even the one-time contraction.
    """
    G = _as2d(G)
    k, n = G.shape
    masks = _as_masks(masks, n)
    if ridge <= 0.0:
        raise ValueError("normal_eq_weights_batch needs ridge > 0; use "
                         "optimal_weights_batch for the exact min-norm path")
    B = masks.shape[0]
    if gram is None:
        gram = G.T @ G                                       # [n, n] once
    if rhs0 is None:
        rhs0 = G.sum(axis=0)                                 # G^T 1_k
    W = np.zeros((B, n))
    for sl in _batch_chunks(B, n, n):
        m = masks[sl].astype(np.float64)
        Mg = gram[None, :, :] * m[:, :, None] * m[:, None, :]
        W[sl] = solve_masked_gram(Mg, masks[sl], rhs0, ridge)
    return W


def spectral_norm_sq_batch(G: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """||A_b||_2^2 per mask (A_b = column-masked G).  Returns [B].

    Degenerate masks (empty A) map to 1.0, matching _spectral_norm_sq.
    """
    G = _as2d(G)
    k, n = G.shape
    masks = _as_masks(masks, n)
    out = np.ones(masks.shape[0])
    for sl in _batch_chunks(masks.shape[0], k, n):
        A = G[None, :, :] * masks[sl].astype(np.float64)[:, None, :]
        sv = np.linalg.svd(A, compute_uv=False)[:, 0]
        nz = sv > 0
        out[sl] = np.where(nz, sv ** 2, 1.0)
    return out


def algorithmic_weights_batch(G: np.ndarray, masks: np.ndarray, iters: int,
                              nu: Optional[np.ndarray] = None,
                              return_errors: bool = False):
    """Batched Lemma-12 weights after `iters` iterations.  Returns
    [B, n] (and [B] final ||u_t||^2 errors when return_errors=True).

    nu may be a scalar, a [B] array, or None (per-mask spectral norm,
    matching the scalar path).
    """
    G = _as2d(G)
    k, n = G.shape
    masks = _as_masks(masks, n)
    B = masks.shape[0]
    W = np.zeros((B, n))
    if iters <= 0:
        if return_errors:
            return W, np.full(B, float(k))
        return W
    if nu is None:
        nus = spectral_norm_sq_batch(G, masks)
    else:
        nus = np.broadcast_to(np.asarray(nu, dtype=np.float64), (B,)).copy()
    nus[nus <= 0] = 1.0
    m = masks.astype(np.float64)
    U = np.ones((B, k))
    X = np.zeros((B, n))
    inv = (1.0 / nus)[:, None]
    for _ in range(iters):
        T = (U @ G) * m                # [B, n] = A^T u, masked
        X += T * inv
        U = U - (T @ G.T) * inv        # u - A A^T u / nu
    W = X * m                          # exact zeros at stragglers
    if return_errors:
        return W, (U ** 2).sum(axis=1)
    return W


def algorithmic_error_curve_batch(G: np.ndarray, masks: np.ndarray,
                                  iters: int,
                                  nu: Optional[np.ndarray] = None
                                  ) -> np.ndarray:
    """[B, iters+1] of ||u_t||^2 per mask (batched Fig.-5 curves)."""
    G = _as2d(G)
    k, n = G.shape
    masks = _as_masks(masks, n)
    B = masks.shape[0]
    if nu is None:
        nus = spectral_norm_sq_batch(G, masks)
    else:
        nus = np.broadcast_to(np.asarray(nu, dtype=np.float64), (B,)).copy()
    nus[nus <= 0] = 1.0
    m = masks.astype(np.float64)
    U = np.ones((B, k))
    inv = (1.0 / nus)[:, None]
    out = np.empty((B, iters + 1))
    out[:, 0] = (U ** 2).sum(axis=1)
    for t in range(iters):
        T = (U @ G) * m
        U = U - (T @ G.T) * inv
        out[:, t + 1] = (U ** 2).sum(axis=1)
    return out


def decode_weights(G: np.ndarray, mask: np.ndarray, method: str = "onestep",
                   **kw) -> np.ndarray:
    """Unified entry point used by the training runtime."""
    if method == "onestep":
        return onestep_weights(G, mask, **kw)
    if method == "optimal":
        return optimal_weights(G, mask, **kw)
    if method == "algorithmic":
        return algorithmic_weights(G, mask, **kw)
    if method == "ignore":  # ignore-stragglers baseline: average what arrived
        mask = np.asarray(mask, dtype=bool)
        G = _as2d(G)
        k = G.shape[0]
        # scale so that E[v] ~ 1_k when row coverage is uniform
        cover = (G[:, mask] != 0).sum()
        return mask * (k / max(cover, 1))
    raise ValueError(f"unknown decode method {method!r}")


def exact_decode_renorm(G: np.ndarray, W: np.ndarray) -> np.ndarray:
    """Rescale decode weights so sum(G @ w) == k (unbiased-ish decode).

    THE renorm rule shared by the fused trainer (scalar w) and the coded
    all-reduce trace path ([S, n] ensembles) — one implementation so the
    two weight streams cannot drift.  Rows whose decode sum is tiny
    (all-straggler masks) are returned unchanged.
    """
    G = _as2d(G)
    k = G.shape[0]
    W = np.asarray(W, dtype=np.float64)
    if W.ndim == 1:
        tot = float((G @ W).sum())
        return W * (k / tot) if tot > 1e-6 else W
    tot = (G @ W.T).sum(axis=0)
    scale = np.where(tot > 1e-6, k / np.where(tot > 1e-6, tot, 1.0), 1.0)
    return W * scale[:, None]


def apply_weights(partials: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Master-side reference decode: partials (n, d) -> sum_j w_j partials_j.

    This is the explicit 'gather to master then combine' path the tests
    compare against the all-reduce-fused training implementation.
    """
    partials = np.asarray(partials)
    return np.tensordot(w, partials, axes=(0, 0))
