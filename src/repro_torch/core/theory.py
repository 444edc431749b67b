"""Closed-form results from the paper, used to validate Monte-Carlo runs.

Every function cites its theorem.  Combinatorial quantities use exact
integer arithmetic (math.comb) and return floats.

Beyond the source paper this module carries the *fundamental limit* of
approximate gradient coding (Wang, Liu & Shroff, arXiv:1901.08166): a
computation-load/error lower bound that every code family — not just
the paper's constructions — can be measured against.  See
docs/theory.md for the full theorem -> function -> source-paper map,
and core.certify for the spectral-gap certificates built on top.
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = [
    "thm5_expected_err1_frc",
    "thm5_expected_err1_frc_exact",
    "thm6_expected_err_frc",
    "thm6_expected_err_frc_as_printed",
    "thm7_tail_frc",
    "thm8_s_threshold",
    "cor9_s_zero_error",
    "thm10_frc_worstcase_err",
    "thm3_expander_err1_bound",
    "thm21_bgc_err1_bound",
    "thm24_rbgc_err1_bound",
    "lemma4_expected_gram_frc",
    "expected_err1_bgc_exact",
    "fundamental_err_lower_bound",
    "fundamental_err_lower_bound_load",
    "gap_to_optimal",
]


def thm5_expected_err1_frc(k: int, s: int, delta: float) -> float:
    """Theorem 5: E[err_1(A_frac)] with rho = k/(rs), r = (1-delta)k.

    E = delta*k / ((1-delta)*s) - (1/(1-delta)) * (s-1)/s
    """
    if not (0 <= delta < 1):
        raise ValueError("delta in [0,1)")
    return delta * k / ((1 - delta) * s) - (s - 1) / (s * (1 - delta))


def thm5_expected_err1_frc_exact(k: int, s: int, r: int) -> float:
    """Corrected (exact) version of Theorem 5.

    The paper's Lemma 4 states P(a_j duplicates a_i) = (s-1)/k, but under
    *without replacement* column sampling the exact probability is
    (s-1)/(k-1) — there are s-1 duplicates among the k-1 remaining
    columns.  Propagating through the Theorem-5 algebra:

        E[err_1] = (k^2/(r^2 s^2)) * ( r s + r (r-1) s (s-1) / (k-1) ) - k.

    Monte Carlo matches this form to sampling error (see
    tests/test_theory_mc.py); the paper's stated formula is its k -> inf
    limit and understates the error by Theta(1) for finite k (documented
    in EXPERIMENTS.md).
    """
    if r == 0:
        return float(k)
    return (k**2 / (r**2 * s**2)) * (r * s + r * (r - 1) * s * (s - 1) / (k - 1)) - k


def thm6_expected_err_frc(k: int, s: int, r: int) -> float:
    """Theorem 6 (corrected): E[err(A_frac)] = k * C(k-s, r) / C(k, r).

    The paper prints C(k-s, r-s)/C(k, r), but P(block i fully straggled)
    = P(all r non-stragglers drawn from the other k-s columns)
    = C(k-s, r)/C(k, r) — which is also what the paper's own Theorem 7
    uses with alpha+1 = 1.  Monte Carlo and the exact inclusion-exclusion
    pmf (frc_err_distribution) confirm the corrected form; see
    EXPERIMENTS.md errata."""
    if k - s < r:
        return 0.0
    return k * math.comb(k - s, r) / math.comb(k, r)


def thm6_expected_err_frc_as_printed(k: int, s: int, r: int) -> float:
    """The formula exactly as printed in the paper (for the errata bench)."""
    if r < s:
        return float(k)
    return k * math.comb(k - s, r - s) / math.comb(k, r)


def thm7_tail_frc(k: int, s: int, r: int, alpha: int) -> float:
    """Theorem 7: upper bound on P(err(A_frac) > alpha*s).

    P <= C(k/s, alpha+1) * C(k-(alpha+1)s, r) / C(k, r).
    """
    if k % s:
        raise ValueError("FRC needs s | k")
    top = k - (alpha + 1) * s
    if top < r:
        return 0.0
    bound = math.comb(k // s, alpha + 1) * math.comb(top, r) / math.comb(k, r)
    return min(1.0, bound)


def thm8_s_threshold(k: int, delta: float, alpha: int) -> float:
    """Theorem 8: s >= (1 + 1/(1+alpha)) log(k)/(1-delta) gives
    P(err > alpha*s) <= 1/k."""
    return (1 + 1 / (1 + alpha)) * math.log(k) / (1 - delta)


def cor9_s_zero_error(k: int, delta: float) -> float:
    """Corollary 9: s >= 2 log(k)/(1-delta) gives P(err > 0) <= 1/k."""
    return 2 * math.log(k) / (1 - delta)


def thm10_frc_worstcase_err(k: int, r: int) -> float:
    """Theorem 10: adversarial optimal-decoding error of FRC is k - r."""
    return float(k - r)


def thm3_expander_err1_bound(k: int, s: int, delta: float, lam: float) -> float:
    """Raviv et al. bound (as stated in Sec. 6):
    err_1(A) <= (lam(G)^2 / s^2) * delta*k / (1-delta), for any delta*k
    stragglers (worst case)."""
    return (lam**2 / s**2) * delta * k / (1 - delta)


def thm21_bgc_err1_bound(k: int, s: int, delta: float, c: float = 1.0) -> float:
    """Theorem 21 shape: err_1(A) <= C^2 k / ((1-delta) s), s >= log k.

    C is the universal constant from concentration (Lemma 18); pass the
    empirically calibrated value via `c` when comparing to Monte Carlo.
    """
    return c**2 * k / ((1 - delta) * s)


def thm24_rbgc_err1_bound(k: int, s: int, delta: float, alpha: float = 1.0,
                          c: float = 1.0) -> float:
    """Theorem 24 shape: err_1(A') <= C^2 alpha^3 k / ((1-delta) s), all s>=1."""
    return c**2 * alpha**3 * k / ((1 - delta) * s)


def lemma4_expected_gram_frc(k: int, s: int) -> tuple[float, float]:
    """Lemma 4: E[a_i . a_j] = s (i==j) and s^2/k - s/k (i != j)."""
    return float(s), s**2 / k - s / k


def expected_err1_bgc_exact(k: int, s: int, r: int) -> float:
    """Exact E[err_1(A)] for the (unregularized) BGC with rho = k/(rs).

    Derivation (not in the paper; used to sanity-check simulations):
    entries iid Bernoulli(p), p = s/k.  With v = rho * A 1_r,
    E[||v - 1||^2] = k * (rho^2 * (r*p*(1-p) + (r*p)^2) - 2*rho*r*p + 1).
    """
    p = s / k
    if r == 0:
        return float(k)
    rho = k / (r * s)
    m2 = r * p * (1 - p) + (r * p) ** 2  # E[(row sum)^2]
    return k * (rho**2 * m2 - 2 * rho * r * p + 1)


@functools.lru_cache(maxsize=65536)
def fundamental_err_lower_bound(k: int, s: int, r: int, n: int | None = None
                                ) -> float:
    """Wang-Liu-Shroff fundamental limit (arXiv:1901.08166, Thm 1 shape).

    For ANY assignment matrix G in {0,1}^{k x n} whose total computation
    load is at most n*s (column degree <= s on average), and ANY decoder,
    the expected squared error under a uniformly random set of r
    survivors satisfies

        E[err] >= min over degree profiles d_1..d_k, sum d_i <= n*s of
                  sum_i C(n - d_i, r) / C(n, r),

    because a task whose d_i assigned workers all straggle is *uncovered*
    and contributes at least 1 to ||G m w - 1||^2 for every weight vector
    w (the task's row of the decoded sum is exactly 0, the target is 1).
    f(d) = C(n-d, r)/C(n, r) is convex in d (its successive ratio
    (n-d-r)/(n-d) is decreasing), so the minimum splits the n*s replica
    budget as evenly as integer degrees allow:

        d_lo = floor(n*s/k),  k_hi = n*s - k*d_lo  tasks get  d_lo + 1.

        LB = (k - k_hi) * f(d_lo) + k_hi * f(d_lo + 1).

    Equality holds for FRC under optimal decoding (Theorem 6:
    thm6_expected_err_frc(k, s, r) == LB when n == k and s | k), which
    makes FRC *optimal* among all codes of the same load — the reference
    point for gap_to_optimal.  Returns the unnormalized error in [0, k];
    divide by k for the err/k convention used by the frontier.
    """
    n = k if n is None else n
    if not (0 <= r <= n):
        raise ValueError(f"need 0 <= r <= n, got r={r}, n={n}")
    if k <= 0 or s < 0:
        raise ValueError("k >= 1 and s >= 0 required")
    if r == 0:
        return float(k)
    denom = math.comb(n, r)

    def f(d: int) -> float:
        d = min(d, n)
        return math.comb(n - d, r) / denom if n - d >= r else 0.0

    budget = n * s
    d_lo = budget // k
    k_hi = budget - k * d_lo
    return (k - k_hi) * f(d_lo) + k_hi * f(d_lo + 1)


def fundamental_err_lower_bound_load(k: int, s: int, delta: float,
                                     n: int | None = None) -> float:
    """Normalized-load (iid-straggler) form of the fundamental limit.

    When each worker straggles independently with probability delta, a
    task of degree d is uncovered with probability delta**d, so

        E[err] >= (k - k_hi) * delta**d_lo + k_hi * delta**(d_lo + 1)

    with the same even integer split of the n*s replica budget
    (delta**d is convex in d).  Note the fixed-r hypergeometric form is
    tighter at the same mean load: C(n-d, r)/C(n, r) <= (1 - r/n)**d,
    so use `fundamental_err_lower_bound` when the survivor *count* is
    fixed and this form when workers straggle independently (the
    ClusterSim deadline policies are closer to the iid model).
    Returns the unnormalized error in [0, k].
    """
    n = k if n is None else n
    if not (0.0 <= delta <= 1.0):
        raise ValueError(f"delta in [0, 1] required, got {delta}")
    if k <= 0 or s < 0:
        raise ValueError("k >= 1 and s >= 0 required")
    budget = n * s
    d_lo = budget // k
    k_hi = budget - k * d_lo
    return (k - k_hi) * delta**d_lo + k_hi * delta ** (d_lo + 1)


def gap_to_optimal(measured_err: float, k: int, s: int, *,
                   r: int | None = None, delta: float | None = None,
                   n: int | None = None) -> float:
    """Ratio of a measured error to the fundamental lower bound.

    Pass `r` for the fixed-survivor-count (hypergeometric) bound or
    `delta` for the iid-straggler bound — exactly one of the two.
    A gap of 1.0 means the family sits on the fundamental limit (FRC
    with optimal decoding); larger means headroom.  Returns inf when
    the bound is 0 (e.g. delta == 0) but error was measured, and 1.0
    when both are (numerically) zero.
    """
    if (r is None) == (delta is None):
        raise ValueError("pass exactly one of r= or delta=")
    if r is not None:
        lb = fundamental_err_lower_bound(k, s, r, n)
    else:
        lb = fundamental_err_lower_bound_load(k, s, delta, n)
    if lb <= 0.0:
        return 1.0 if measured_err <= 1e-12 else math.inf
    return max(0.0, measured_err) / lb


def frc_err_distribution(k: int, s: int, r: int, max_alpha: int | None = None
                         ) -> np.ndarray:
    """Exact pmf of err(A_frac)/s = number of missing blocks (inclusion-
    exclusion over the k/s blocks under without-replacement sampling).

    P(exactly m blocks missing) = C(B, m) * sum_{j} (-1)^j C(B-m, j)
        * C(k-(m+j)s, r) / C(k, r),   B = k/s.
    """
    if k % s:
        raise ValueError("s | k required")
    B = k // s
    max_alpha = B if max_alpha is None else min(max_alpha, B)
    denom = math.comb(k, r)
    pmf = np.zeros(max_alpha + 1)
    for m in range(max_alpha + 1):
        acc = 0.0
        for j in range(B - m + 1):
            top = k - (m + j) * s
            if top < r:
                break
            acc += (-1) ** j * math.comb(B - m, j) * math.comb(top, r) / denom
        pmf[m] = math.comb(B, m) * acc
    return np.clip(pmf, 0.0, 1.0)
