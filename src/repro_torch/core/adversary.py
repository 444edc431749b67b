"""Adversarial straggler selection (paper Sec. 4).

* FRC worst case (Thm 10): kill whole repetition blocks; err = k - r,
  findable in O(k) with knowledge of the layout and O(k^2) from G alone
  (column dedup).
* General adversarial selection (r-ASP) is NP-hard (Thm 11, reduction from
  Densest-k-Subgraph).  We implement the reduction object itself (for the
  tests that check Eq. 4.2/4.3) plus two poly-time *heuristic* adversaries
  (greedy column removal, random search) that model what a realistic
  adversary could do against BGC/rBGC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import decoding

__all__ = [
    "frc_adversarial_mask",
    "greedy_adversarial_mask",
    "random_search_adversarial_mask",
    "DkSReduction",
    "build_dks_reduction",
    "densest_k_subgraph_greedy",
]


def frc_adversarial_mask(G: np.ndarray, num_stragglers: int) -> np.ndarray:
    """Worst-case straggler set for an FRC (Thm 10), from G alone.

    Groups identical columns (the repetition blocks survive any column
    permutation), then kills entire blocks until the straggler budget is
    spent.  Runtime O(k * n) via hashing — better than the paper's O(k^2)
    column-compare bound.  Returns a boolean non-straggler mask.
    """
    G = np.asarray(G)
    k, n = G.shape
    groups: dict[bytes, list[int]] = {}
    for j in range(n):
        groups.setdefault(G[:, j].tobytes(), []).append(j)
    # kill the largest whole blocks first (each fully-killed block of size
    # s adds s to err); prefer blocks that fit in the remaining budget.
    blocks = sorted(groups.values(), key=len, reverse=True)
    mask = np.ones(n, dtype=bool)
    budget = num_stragglers
    for blk in blocks:
        if len(blk) <= budget:
            mask[blk] = False
            budget -= len(blk)
    if budget > 0:  # spend leftovers on partial blocks (adds no error, but
        for j in range(n):  # the adversary must pick exactly num_stragglers)
            if budget == 0:
                break
            if mask[j]:
                mask[j] = False
                budget -= 1
    return mask


def greedy_adversarial_mask(
    G: np.ndarray,
    num_stragglers: int,
    objective: str = "optimal",
    rho: Optional[float] = None,
) -> np.ndarray:
    """Greedy poly-time adversary: repeatedly remove the worker whose
    removal maximizes the decoding error.  O(num_stragglers * n) decodes.

    objective: 'optimal' -> err(A), 'onestep' -> err_1(A).
    """
    G = np.asarray(G, dtype=np.float64)
    k, n = G.shape
    s = max(1, int(round((G != 0).sum() / n)))
    mask = np.ones(n, dtype=bool)

    def score(m: np.ndarray) -> float:
        A = G[:, m]
        if objective == "optimal":
            return decoding.err(A)
        r = int(m.sum())
        return decoding.err1(A, rho if rho is not None else decoding.default_rho(k, r, s))

    for _ in range(num_stragglers):
        best_j, best_v = -1, -np.inf
        for j in np.flatnonzero(mask):
            mask[j] = False
            v = score(mask)
            mask[j] = True
            if v > best_v:
                best_j, best_v = j, v
        mask[best_j] = False
    return mask


def random_search_adversarial_mask(
    G: np.ndarray,
    num_stragglers: int,
    trials: int,
    rng: np.random.Generator,
    objective: str = "optimal",
) -> np.ndarray:
    """Best-of-`trials` random straggler sets (the weakest adversary)."""
    G = np.asarray(G, dtype=np.float64)
    k, n = G.shape
    s = max(1, int(round((G != 0).sum() / n)))
    best_mask, best_v = None, -np.inf
    for _ in range(trials):
        mask = np.ones(n, dtype=bool)
        mask[rng.choice(n, size=num_stragglers, replace=False)] = False
        A = G[:, mask]
        if objective == "optimal":
            v = decoding.err(A)
        else:
            r = n - num_stragglers
            v = decoding.err1(A, decoding.default_rho(k, r, s))
        if v > best_v:
            best_mask, best_v = mask, v
    return best_mask


# --------------------------------------------------------------------------
# Thm 11: the DkS -> r-ASP reduction, as a concrete constructible object.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DkSReduction:
    """The matrix C and bookkeeping of the Theorem-11 reduction.

    Given a d-regular graph (V, E) with |V| = nv and a target subgraph
    size kq, solving r-ASP on C with r = kq + (|E| - nv) is equivalent to
    finding the densest kq-subgraph.  `objective(x)` evaluates
    ||rho C x - 1||^2 for the selection x = [y; z] (Eq. 4.2);
    `predicted_objective(edges_in_S, a)` evaluates the closed form
    2 rho^2 e(S) + d rho^2 a - 2 rho d a + |E| used in the proof (with the
    corrected |E| = nv*d/2 edge count; see build_dks_reduction).
    """

    C: np.ndarray  # (ne, ne)
    adjacency: np.ndarray  # (nv, nv)
    d: int
    kq: int
    rho: float

    @property
    def nv(self) -> int:
        return self.adjacency.shape[0]

    @property
    def ne(self) -> int:
        return self.C.shape[0]

    @property
    def r(self) -> int:
        return self.kq + (self.ne - self.nv)

    def objective(self, x: np.ndarray) -> float:
        m = self.C.shape[0]
        v = self.rho * (self.C @ x) - np.ones(m)
        return float(v @ v)

    def predicted_objective(self, edges_in_s: int, a: int) -> float:
        return (2 * self.rho**2 * edges_in_s
                + self.d * self.rho**2 * a
                - 2 * self.rho * self.d * a
                + self.ne)


def build_dks_reduction(adjacency: np.ndarray, kq: int, rho: float = 0.5
                        ) -> DkSReduction:
    """Construct C = [B | 0] from the unsigned incidence matrix B of a
    d-regular graph (Thm 11 proof).  Requires rho in (0, 2/3)."""
    M = np.asarray(adjacency, dtype=np.float64)
    nv = M.shape[0]
    deg = M.sum(axis=1)
    d = int(deg[0])
    if not np.all(deg == d):
        raise ValueError("Thm 11 reduction requires a d-regular graph")
    if not (0 < rho < 2 / 3):
        raise ValueError("rho must lie in (0, 2/3)")
    edges = [(i, j) for i in range(nv) for j in range(i + 1, nv) if M[i, j]]
    ne = len(edges)
    if ne != nv * d // 2:
        raise ValueError("inconsistent adjacency")
    if ne < nv:
        raise ValueError("reduction needs |E| >= |V| (d >= 2)")
    # Standard unsigned incidence: B^T B = M + d I and 1^T B = d 1^T, which
    # is exactly what the Thm-11 proof uses.  (The paper states |E| = nd; a
    # d-regular graph has nd/2 undirected edges — the factor-2 miscount
    # does not affect the argument, only the padding width.  We build the
    # corrected ne x ne square C.)
    B = np.zeros((ne, nv))
    for e, (i, j) in enumerate(edges):
        B[e, i] = 1.0
        B[e, j] = 1.0
    C = np.concatenate([B, np.zeros((ne, ne - nv))], axis=1)
    return DkSReduction(C=C, adjacency=M, d=d, kq=kq, rho=rho)


def densest_k_subgraph_greedy(adjacency: np.ndarray, kq: int) -> np.ndarray:
    """Greedy peeling heuristic for DkS: repeatedly delete the minimum-
    degree vertex until kq remain.  Poly-time (the NP-hardness of the
    exact problem is the paper's point); returns vertex index array."""
    M = np.asarray(adjacency).copy().astype(np.float64)
    nv = M.shape[0]
    alive = np.ones(nv, dtype=bool)
    for _ in range(nv - kq):
        deg = M[alive][:, alive].sum(axis=1)
        idx = np.flatnonzero(alive)
        alive[idx[np.argmin(deg)]] = False
    return np.flatnonzero(alive)
