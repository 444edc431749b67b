"""Scheme registry: the one declarative table of gradient-code families.

Before this module, every layer that switched on a scheme name (the
Monte-Carlo engine, ClusterSim, the frontier sweep, the trainer, the
coded all-reduce, the CLI, the benchmarks) carried its own hardcoded
``{frc, bgc, cyclic}``-style tuple, so adding a code family meant a
seven-file change.  Now a family is ONE record:

    register(CodeFamily(
        name="sbm",
        constructor=codes.sbm,
        decoders=("onestep", "optimal", "algorithmic", "ignore"),
        randomized=True,            # Monte-Carlo resamples code draws
        adversary="greedy",         # worst-case straggler profile
        param_grid={"s": (2, 5, 10), "blocks": (2, 4, 8)},
    ))

and every consumer resolves through :func:`get` / :func:`names` /
:func:`make`:

  * ``core.simulate`` asks ``randomized`` instead of RESAMPLED_SCHEMES;
  * ``sim.cluster`` / ``sim.frontier`` build codes by name and check
    the requested decoder against ``decoders``;
  * ``training.train_loop`` validates (scheme, decoder) pairs up front;
  * ``launch.train`` derives its CLI choices from ``names()``;
  * the benchmarks sweep ``families()`` filtered by capability.

See docs/families.md for the contract and the one-file recipe for adding
a family.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from . import codes as codes_lib
from . import theory
from .codes import GradientCode

__all__ = [
    "DECODERS",
    "CodeFamily",
    "register",
    "get",
    "find",
    "families",
    "names",
    "make",
    "randomized_schemes",
]

# decoder surface of core.engine.DecodeEngine / core.decoding
DECODERS = ("onestep", "optimal", "algorithmic", "ignore")

def _lb_err_frac(k: int, n: int, s: int, delta: float) -> float:
    """Fundamental lower bound on err/k at straggler fraction delta,
    evaluated with the fixed-survivor-count (hypergeometric) form —
    the weaker of the two forms, so the floor never over-rejects."""
    r = max(0, min(n, int(round((1.0 - delta) * n))))
    return theory.fundamental_err_lower_bound(k, s, r, n) / k


# adversary profiles (paper Sec. 4): "block" = the linear-time FRC
# block-killing adversary applies structurally; "greedy" = only the
# generic poly-time greedy/random-search adversaries; "none" = no
# redundancy to attack (uncoded)
ADVERSARY_PROFILES = ("block", "greedy", "none")


@dataclasses.dataclass(frozen=True)
class CodeFamily:
    """Declarative record for one gradient-code family.

    ``constructor(k, n, s, rng=..., **params)`` must return a
    :class:`~repro_torch.core.codes.GradientCode` whose ``name`` equals this
    record's name (``with_workers`` elasticity rebuilds through it).
    ``validate`` returns a human-readable reason when (k, n, s) is not
    constructible, else None — the registry's pre-flight check that
    turns constructor tracebacks into actionable errors.
    """

    name: str
    constructor: Callable[..., GradientCode]
    description: str = ""
    decoders: Tuple[str, ...] = DECODERS
    randomized: bool = False          # MC averages over code draws too
    adversary: str = "greedy"         # block | greedy | none
    deterministic_rng_free: bool = False  # constructor ignores rng
    param_grid: Mapping[str, Tuple] = dataclasses.field(
        default_factory=dict)     # declarative sweep defaults (metadata)
    validate: Optional[Callable[[int, int, int], Optional[str]]] = None

    def __post_init__(self):
        unknown = set(self.decoders) - set(DECODERS)
        if unknown:
            raise ValueError(f"family {self.name!r} declares unknown "
                             f"decoders {sorted(unknown)}; have {DECODERS}")
        if self.adversary not in ADVERSARY_PROFILES:
            raise ValueError(f"family {self.name!r} adversary profile "
                             f"{self.adversary!r} not in {ADVERSARY_PROFILES}")

    # ------------------------------------------------------------------
    # capability queries
    # ------------------------------------------------------------------

    def supports_decoder(self, decoder: str) -> bool:
        return decoder in self.decoders

    def require_decoder(self, decoder: str) -> None:
        """Raise the one canonical incompatibility error (shared by the
        MC engine, ClusterSim and the trainer — one message format)."""
        if decoder not in self.decoders:
            raise ValueError(f"family {self.name!r} does not declare "
                             f"decoder {decoder!r}; supported: "
                             f"{self.decoders}")

    def check(self, k: int, n: int, s: int) -> Optional[str]:
        """None when (k, n, s) is constructible, else the reason."""
        if k <= 0 or n <= 0:
            return f"k={k}, n={n} must be positive"
        if not (1 <= s <= k):
            return f"s={s} must be in [1, k={k}]"
        if self.validate is not None:
            return self.validate(k, n, s)
        return None

    def legal_s(self, k: int, n: int, lo: int = 1,
                hi: Optional[int] = None, *,
                delta: Optional[float] = None,
                error_budget: Optional[float] = None) -> Tuple[int, ...]:
        """All s in [lo, hi] this family can construct at (k, n).

        The ragged-size test harness picks from this instead of
        special-casing divisibility rules (FRC needs s | k, s-regular
        needs k*s even) per family.

        With ``delta=`` and ``error_budget=`` the ladder is additionally
        filtered by the Wang et al. fundamental limit: rungs whose
        lower bound already exceeds the budget (err/k) at straggler
        fraction delta are budget-infeasible for EVERY code and decoder,
        so no amount of calibration can admit them.
        """
        hi = k if hi is None else min(hi, k)
        rungs = tuple(s for s in range(max(lo, 1), hi + 1)
                      if self.check(k, n, s) is None)
        if error_budget is None:
            return rungs
        if delta is None:
            raise ValueError("error_budget= requires delta= (the straggler "
                             "fraction the budget must hold at)")
        return tuple(s for s in rungs
                     if _lb_err_frac(k, n, s, delta) <= error_budget)

    def s_floor(self, k: int, n: int, *, delta: float,
                error_budget: float) -> int:
        """Smallest constructible s whose fundamental lower bound fits
        the err/k budget at straggler fraction delta.

        Derived from theory.fundamental_err_lower_bound (Wang et al.),
        which holds for every assignment matrix of column sparsity s and
        every decoder — below this floor the budget is information-
        theoretically impossible, not merely uncalibrated.  Raises
        ValueError when no legal s fits.
        """
        feasible = self.legal_s(k, n, delta=delta, error_budget=error_budget)
        if not feasible:
            best = self.legal_s(k, n)
            detail = ""
            if best:
                lb = _lb_err_frac(k, n, best[-1], delta)
                detail = (f" (even s={best[-1]} has fundamental lower "
                          f"bound err/k >= {lb:.4g})")
            raise ValueError(
                f"no s in [1, {k}] lets family {self.name!r} meet "
                f"err/k <= {error_budget:g} at delta={delta:g} for "
                f"(k={k}, n={n}){detail}; raise the error budget, lower "
                f"delta, or add workers")
        return feasible[0]

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    def make(self, k: int, n: int, s: int,
             rng: Optional[np.random.Generator] = None,
             seed: Optional[int] = None, *,
             delta: Optional[float] = None,
             error_budget: Optional[float] = None,
             **params) -> GradientCode:
        """Build a code, optionally enforcing the fundamental-limit floor.

        With ``delta=`` and ``error_budget=`` the requested s is checked
        against the Wang et al. lower bound and rejected (with the
        feasible floor named) when the budget is provably unreachable.
        """
        reason = self.check(k, n, s)
        if reason is not None:
            raise ValueError(
                f"cannot construct {self.name!r} at (k={k}, n={n}, s={s}): "
                f"{reason}; legal s at this size: "
                f"{self.legal_s(k, n, hi=min(k, 64))}")
        if error_budget is not None:
            if delta is None:
                raise ValueError("error_budget= requires delta= (the "
                                 "straggler fraction the budget must hold "
                                 "at)")
            lb = _lb_err_frac(k, n, s, delta)
            if lb > error_budget:
                floor = self.s_floor(k, n, delta=delta,
                                     error_budget=error_budget)
                raise ValueError(
                    f"s={s} is below the fundamental-limit floor for "
                    f"{self.name!r} at (k={k}, n={n}): the Wang et al. "
                    f"lower bound gives err/k >= {lb:.4g} > budget "
                    f"{error_budget:g} at delta={delta:g} for EVERY code "
                    f"of this sparsity and every decoder; smallest "
                    f"feasible s is {floor} (raise s, raise the budget, "
                    f"or lower delta)")
        if rng is None:
            rng = np.random.default_rng(0 if seed is None else seed)
        return self.constructor(k, n, s, rng=rng, **params)


_REGISTRY: Dict[str, CodeFamily] = {}


def register(family: CodeFamily, *, overwrite: bool = False) -> CodeFamily:
    """Add a family to the registry (the one-file extension point)."""
    if family.name in _REGISTRY and not overwrite:
        raise ValueError(f"code family {family.name!r} already registered; "
                         f"pass overwrite=True to replace it")
    _REGISTRY[family.name] = family
    return family


def get(name: str) -> CodeFamily:
    fam = _REGISTRY.get(name)
    if fam is None:
        raise KeyError(
            f"unknown code family {name!r}; registered families: "
            f"{sorted(_REGISTRY)}. Add one with "
            f"repro_torch.core.registry.register(CodeFamily(name={name!r}, "
            f"constructor=...)) — see docs/families.md.")
    return fam


def find(name: str) -> Optional[CodeFamily]:
    """Non-raising lookup (for codes built outside the registry)."""
    return _REGISTRY.get(name)


def families() -> Tuple[CodeFamily, ...]:
    """All registered families, in registration order."""
    return tuple(_REGISTRY.values())


def names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def make(name: str, k: int, n: int, s: int,
         rng: Optional[np.random.Generator] = None,
         seed: Optional[int] = None, *,
         delta: Optional[float] = None,
         error_budget: Optional[float] = None, **params) -> GradientCode:
    """The factory every scheme-switch resolves through.

    ``delta=`` + ``error_budget=`` opt into the fundamental-limit floor
    (reject s the Wang et al. bound proves budget-infeasible)."""
    return get(name).make(k, n, s, rng=rng, seed=seed, delta=delta,
                          error_budget=error_budget, **params)


def randomized_schemes() -> Tuple[str, ...]:
    """Families whose construction is random (MC resamples code draws)."""
    return tuple(f.name for f in _REGISTRY.values() if f.randomized)


# --------------------------------------------------------------------------
# built-in families (paper + follow-up literature)
# --------------------------------------------------------------------------


def _square(k: int, n: int, s: int) -> Optional[str]:
    if n != k:
        return f"requires n == k (got k={k}, n={n})"
    return None


def _frc_check(k: int, n: int, s: int) -> Optional[str]:
    if n != k:
        return f"FRC requires n == k (got k={k}, n={n})"
    if k % s != 0:
        return f"FRC requires s | k (got k={k}, s={s})"
    return None


def _sregular_check(k: int, n: int, s: int) -> Optional[str]:
    if n != k:
        return f"s-regular code requires n == k (got k={k}, n={n})"
    if (k * s) % 2 != 0:
        return f"s-regular graph needs k*s even (k={k}, s={s})"
    if s >= k:
        return f"need s < k (s={s}, k={k})"
    return None


register(CodeFamily(
    name="frc",
    constructor=codes_lib.frc,
    description="Fractional repetition (block-diagonal 1_{sxs}); best "
                "average error, worst adversarial case (Thm 10)",
    adversary="block",
    param_grid={"s": (2, 5, 10)},
    validate=_frc_check,
))

register(CodeFamily(
    name="bgc",
    constructor=codes_lib.bgc,
    description="Bernoulli gradient code G_ij ~ Bern(s/k) (paper Sec. 5)",
    randomized=True,
    param_grid={"s": (2, 5, 10)},
))

register(CodeFamily(
    name="rbgc",
    constructor=codes_lib.rbgc,
    description="Regularized BGC: column degree capped at 2s (Alg. 3)",
    randomized=True,
    param_grid={"s": (2, 5, 10)},
))

register(CodeFamily(
    name="sregular",
    constructor=codes_lib.sregular,
    description="Random s-regular graph adjacency (Raviv et al. expander "
                "baseline)",
    randomized=True,
    param_grid={"s": (4, 6, 10)},
    validate=_sregular_check,
))

register(CodeFamily(
    name="sbm",
    constructor=codes_lib.sbm,
    description="Stochastic-block-model code: intra/inter-cluster "
                "Bernoulli densities (Charles & Papailiopoulos)",
    randomized=True,
    param_grid={"s": (2, 5, 10), "blocks": (2, 4, 8),
                "intra": (0.5, 0.7, 0.9)},
))

register(CodeFamily(
    name="expander",
    constructor=codes_lib.expander,
    description="(s, ns/k)-biregular random bipartite code; least-squares "
                "decoding beats one-step at equal replication "
                "(Glasgow & Wootters)",
    randomized=True,
    param_grid={"s": (2, 5, 10)},
))

register(CodeFamily(
    name="cyclic",
    constructor=codes_lib.cyclic_repetition,
    description="Cyclic repetition support (Tandon et al. pattern, "
                "all-ones coefficients)",
    deterministic_rng_free=True,
    param_grid={"s": (2, 5, 10)},
))

register(CodeFamily(
    name="uncoded",
    constructor=codes_lib.uncoded,
    description="Identity assignment, no redundancy",
    adversary="none",
    deterministic_rng_free=True,
    param_grid={"s": (1,)},
    validate=_square,
))
