"""Monte-Carlo simulation engine for decoding errors (paper Sec. 6).

Reproduces the quantities in Figs. 2-5: average err_1(A)/k and err(A)/k
over random straggler draws, and the algorithmic-decoder curve ||u_t||^2/k.

Batched architecture: each (scheme, delta, decoder) cell samples ALL of
its trial masks up front (`sample_straggler_masks`) and hands them to a
DecodeEngine as one [trials, n] ensemble — one batched decode per cell
instead of a Python loop over trials.  Schemes the registry declares
randomized (bgc / rbgc / sregular / sbm / expander) additionally average
over `code_draws` independent code draws, splitting the trials across
them (one batched decode per draw); deterministic schemes use a single
draw.  Scheme names resolve through core.registry.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from . import decoding
from . import registry
from .engine import DecodeEngine

__all__ = [
    "sample_straggler_mask",
    "sample_straggler_masks",
    "MCResult",
    "monte_carlo_error",
    "sweep_delta",
    "algorithmic_curve_mc",
    "RESAMPLED_SCHEMES",
]


def _resampled() -> tuple:
    """Schemes whose construction is random: the paper averages over
    code AND straggler randomness for these.  Declared per-family in
    the registry (CodeFamily.randomized), not hardcoded here."""
    return registry.randomized_schemes()


# legacy alias (module-load snapshot); prefer registry.randomized_schemes()
RESAMPLED_SCHEMES = _resampled()


def sample_straggler_mask(n: int, num_stragglers: int, rng: np.random.Generator
                          ) -> np.ndarray:
    """Uniform without-replacement straggler draw -> boolean keep-mask."""
    mask = np.ones(n, dtype=bool)
    if num_stragglers > 0:
        mask[rng.choice(n, size=num_stragglers, replace=False)] = False
    return mask


def sample_straggler_masks(n: int, num_stragglers: int, trials: int,
                           rng: np.random.Generator) -> np.ndarray:
    """[trials, n] boolean keep-masks, each an independent uniform
    without-replacement draw of `num_stragglers` stragglers.

    Vectorized: rank one uniform matrix per trial instead of `trials`
    calls to rng.choice.
    """
    masks = np.ones((trials, n), dtype=bool)
    if num_stragglers <= 0:
        return masks
    u = rng.random((trials, n))
    idx = np.argpartition(u, num_stragglers - 1, axis=1)[:, :num_stragglers]
    masks[np.arange(trials)[:, None], idx] = False
    return masks


@dataclasses.dataclass
class MCResult:
    scheme: str
    decoder: str
    k: int
    n: int
    s: int
    delta: float
    trials: int
    mean: float  # mean err/k
    std: float
    q05: float
    q95: float
    p_zero: float  # fraction of trials with (near-)zero error


def _trial_groups(trials: int, groups: int) -> List[int]:
    """Split `trials` into `groups` near-equal positive chunk sizes."""
    groups = max(1, min(groups, trials))
    base, rem = divmod(trials, groups)
    return [base + (1 if g < rem else 0) for g in range(groups)]


def monte_carlo_error(
    scheme: str,
    k: int,
    n: int,
    s: int,
    delta: float,
    trials: int,
    decoder: str = "onestep",
    seed: int = 0,
    resample_code: bool = True,
    iters: int = 8,
    code_draws: int = 16,
    backend: str = "torch",
    device=None,
) -> MCResult:
    """Average decoding error over `trials` random straggler draws.

    resample_code=True averages over the code randomness as well
    (matching the paper): `code_draws` independent codes are drawn and
    the trials are split across them, so the decode stays batched.
    FRC/cyclic/uncoded are deterministic and always use a single code.
    Codes and masks come from ``np.random.default_rng(seed)`` exactly as
    in the reference package; the decode runs on ``backend``/``device`` (the
    card by default).
    """
    fam = registry.get(scheme)
    fam.require_decoder(decoder)
    rng = np.random.default_rng(seed)
    num_straggle = int(round(delta * n))
    draws = code_draws if (resample_code and fam.randomized) else 1
    errs = np.empty(trials)
    lo = 0
    for chunk in _trial_groups(trials, draws):
        code = fam.make(k=k, n=n, s=s, rng=rng)
        masks = sample_straggler_masks(n, num_straggle, chunk, rng)
        # nominal s, NOT inferred from G's density: the paper's
        # rho = k/(r s) calibration uses the construction parameter.
        # pinv keeps the MC error curves on the exact least-squares
        # oracle (the golden pins predate the gram default).
        eng = DecodeEngine(code, backend=backend, device=device,
                           iters=iters, s=s, optimal_impl="pinv")
        errs[lo: lo + chunk] = eng.errors_batch(masks, decoder)
        lo += chunk
    errs = errs / k
    return MCResult(
        scheme=scheme, decoder=decoder, k=k, n=n, s=s, delta=delta,
        trials=trials, mean=float(errs.mean()), std=float(errs.std()),
        q05=float(np.quantile(errs, 0.05)), q95=float(np.quantile(errs, 0.95)),
        p_zero=float((errs < 1e-9).mean()),
    )


def sweep_delta(
    schemes: Sequence[str],
    deltas: Sequence[float],
    k: int,
    s: int,
    trials: int,
    decoder: str = "onestep",
    seed: int = 0,
    backend: str = "torch",
    device=None,
) -> List[MCResult]:
    out: List[MCResult] = []
    for scheme in schemes:
        for d in deltas:
            out.append(monte_carlo_error(scheme, k=k, n=k, s=s, delta=d,
                                         trials=trials, decoder=decoder,
                                         seed=seed, backend=backend,
                                         device=device))
    return out


def algorithmic_curve_mc(
    scheme: str,
    k: int,
    s: int,
    delta: float,
    trials: int,
    iters: int,
    seed: int = 0,
    code_draws: int = 16,
) -> np.ndarray:
    """Mean ||u_t||^2/k curve, t = 0..iters (Fig. 5), batched per draw."""
    fam = registry.get(scheme)
    rng = np.random.default_rng(seed)
    num_straggle = int(round(delta * k))
    draws = code_draws if fam.randomized else 1
    acc = np.zeros(iters + 1)
    for chunk in _trial_groups(trials, draws):
        code = fam.make(k=k, n=k, s=s, rng=rng)
        masks = sample_straggler_masks(k, num_straggle, chunk, rng)
        curves = decoding.algorithmic_error_curve_batch(code.G, masks, iters)
        acc += curves.sum(axis=0)
    return acc / (trials * k)
