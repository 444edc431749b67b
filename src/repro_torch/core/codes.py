"""Gradient-code constructions (assignment matrices G).

The paper's objects: a k x n *function assignment matrix* G whose column j
supports the tasks computed by worker j, with entries giving the linear
combination the worker returns.  All constructions here are O(k * n) or
better, which is the paper's selling point versus Ramanujan/expander
constructions.

Conventions
-----------
* G has shape (k, n): k tasks (gradient partitions), n workers.
* Column sparsity ~ s tasks per worker.
* All constructions are deterministic given a seed.
* Matrices are small (k, n <= a few thousand) and kept as dense float64
  numpy arrays; the training path consumes them as constants.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

__all__ = [
    "GradientCode",
    "frc",
    "bgc",
    "rbgc",
    "sregular",
    "sbm",
    "expander",
    "cyclic_repetition",
    "uncoded",
    "make_code",
    "CODE_REGISTRY",
    "spectral_gap",
]


@dataclasses.dataclass(frozen=True)
class GradientCode:
    """An assignment matrix plus the metadata the runtime needs."""

    name: str
    G: np.ndarray  # (k, n)
    s: int  # nominal tasks/worker (column sparsity target)
    seed: Optional[int] = None
    # family construction params beyond (k, n, s) — e.g. sbm's
    # blocks/intra — as (key, value) pairs so the elastic rebuild
    # (with_workers) reconstructs the SAME variant, not the defaults
    params: Tuple[Tuple[str, object], ...] = ()

    @property
    def k(self) -> int:
        return int(self.G.shape[0])

    @property
    def n(self) -> int:
        return int(self.G.shape[1])

    @property
    def max_col_degree(self) -> int:
        return int((self.G != 0).sum(axis=0).max())

    @property
    def col_degrees(self) -> np.ndarray:
        return (self.G != 0).sum(axis=0)

    @property
    def row_degrees(self) -> np.ndarray:
        return (self.G != 0).sum(axis=1)

    def nonstraggler_submatrix(self, mask: np.ndarray) -> np.ndarray:
        """A = columns of G belonging to the non-stragglers (mask==True)."""
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != (self.n,):
            raise ValueError(f"mask shape {mask.shape} != ({self.n},)")
        return self.G[:, mask]

    @property
    def density(self) -> float:
        """nnz(G) / (k n) — the paper's s/k sparsity for column-regular G."""
        return float((self.G != 0).sum()) / max(self.k * self.n, 1)

    def ell(self) -> Tuple[np.ndarray, np.ndarray]:
        """Row-major ELL packing of G: (col_idx [k, rmax] int32,
        vals [k, rmax] float32), zero-padded to the max row degree.

        Row i's nonzero columns sit left-justified in col_idx[i] with
        their coefficients in vals[i]; padding entries have idx 0 and
        val 0 so gather-and-accumulate kernels can ignore them.  The
        decoders only ever form G @ (masked weights), so the row packing
        is the kernel-facing view of the paper's column sparsity
        (row degree ~ n s / k = s when n = k): a batched one-step decode
        reads B*k*rmax mask entries instead of streaming B*k*n dense
        zeros.  Cached after the first call (G is immutable).
        """
        cached = self.__dict__.get("_ell")
        if cached is None:
            nz = self.G != 0
            deg = nz.sum(axis=1)
            rmax = max(int(deg.max()) if deg.size else 0, 1)
            idx = np.zeros((self.k, rmax), dtype=np.int32)
            val = np.zeros((self.k, rmax), dtype=np.float32)
            for i in range(self.k):
                cols = np.flatnonzero(nz[i])
                idx[i, : len(cols)] = cols
                val[i, : len(cols)] = self.G[i, cols]
            cached = (idx, val)
            object.__setattr__(self, "_ell", cached)  # frozen dataclass
        return cached

    @classmethod
    def from_arrays(cls, G: np.ndarray, name: str, s: int, *,
                    seed: Optional[int] = None,
                    params: Tuple[Tuple[str, object], ...] = ()
                    ) -> "GradientCode":
        """Wrap an existing (k, n) assignment matrix, e.g. one built by
        another implementation, so both decode the same G."""
        G = np.array(G, dtype=np.float64)          # private copy
        if G.ndim != 2:
            raise ValueError(f"G must be (k, n), got shape {G.shape}")
        return cls(name=str(name), G=G, s=int(s), seed=seed,
                   params=tuple(params))

    def with_workers(self, n: int, rng: np.random.Generator) -> "GradientCode":
        """Rebuild the same family for a different worker count (elastic).

        Family params (sbm blocks/intra, ...) carry over so the rebuilt
        code is the same VARIANT, not the family defaults.
        """
        fam = self.name.split("(")[0]
        return make_code(fam, k=n, n=n, s=self.s, rng=rng,
                        **dict(self.params))


def _check(k: int, n: int, s: int) -> None:
    if k <= 0 or n <= 0:
        raise ValueError(f"k={k}, n={n} must be positive")
    if not (1 <= s <= k):
        raise ValueError(f"s={s} must be in [1, k={k}]")


def frc(k: int, n: int, s: int, rng: Optional[np.random.Generator] = None) -> GradientCode:
    """Fractional Repetition Code (paper Sec. 3, from Tandon et al.).

    Block-diagonal 1_{s x s} blocks: k tasks and n=k workers, s | k.  Block
    b's s workers each compute the same s tasks.  A random column
    permutation is applied when an rng is provided (the adversarial
    analysis in Sec. 4.1 is permutation-invariant; tests exercise both).
    """
    _check(k, n, s)
    if n != k:
        raise ValueError(f"FRC requires n == k (got k={k}, n={n})")
    if k % s != 0:
        raise ValueError(f"FRC requires s | k (got k={k}, s={s})")
    G = np.zeros((k, n), dtype=np.float64)
    for b in range(k // s):
        G[b * s : (b + 1) * s, b * s : (b + 1) * s] = 1.0
    if rng is not None:
        G = G[:, rng.permutation(n)]
    return GradientCode(name="frc", G=G, s=s, seed=None)


def bgc(k: int, n: int, s: int, rng: np.random.Generator) -> GradientCode:
    """Bernoulli Gradient Code (paper Sec. 5): G_ij ~ Bernoulli(s/k)."""
    _check(k, n, s)
    G = (rng.random((k, n)) < (s / k)).astype(np.float64)
    return GradientCode(name="bgc", G=G, s=s)


def rbgc(k: int, n: int, s: int, rng: np.random.Generator) -> GradientCode:
    """Regularized BGC (paper Algorithm 3).

    Draw Bernoulli(s/k) entries; any column with degree > 2s is pruned
    (random edges removed) until its degree is exactly s.  Guarantees
    max column degree <= 2s so Thm 24's bound applies for all s >= 1.
    """
    _check(k, n, s)
    G = (rng.random((k, n)) < (s / k)).astype(np.float64)
    for j in range(n):
        d = int(G[:, j].sum())
        if d > 2 * s:
            support = np.flatnonzero(G[:, j])
            drop = rng.choice(support, size=d - s, replace=False)
            G[drop, j] = 0.0
    return GradientCode(name="rbgc", G=G, s=s)


def sregular(k: int, n: int, s: int, rng: np.random.Generator) -> GradientCode:
    """Random s-regular graph adjacency code (Raviv et al. baseline).

    G = adjacency matrix of a random simple s-regular graph on k vertices
    (k == n).  Random regular graphs are expanders with high probability
    (lambda -> 2 sqrt(s-1), near-Ramanujan) so this is the efficient
    stand-in for the expander-code baseline, exactly as in the paper's
    simulations (Sec. 6).
    """
    _check(k, n, s)
    if n != k:
        raise ValueError(f"s-regular code requires n == k (got k={k}, n={n})")
    if (k * s) % 2 != 0:
        raise ValueError(f"s-regular graph needs k*s even (k={k}, s={s})")
    if s >= k:
        raise ValueError(f"need s < k (s={s}, k={k})")
    import networkx as nx

    g = nx.random_regular_graph(d=s, n=k, seed=int(rng.integers(2**31 - 1)))
    G = nx.to_numpy_array(g, dtype=np.float64)
    return GradientCode(name="sregular", G=G, s=s)


def block_ids(count: int, blocks: int) -> np.ndarray:
    """[count] int block id per index, contiguous near-equal blocks.

    The one partition rule shared by the SBM code construction and the
    clustered-straggler trace source, so a clustered trace's failing
    blocks line up with the code's worker blocks.
    """
    blocks = max(1, min(blocks, count))
    ids = np.empty(count, dtype=np.int64)
    for b, chunk in enumerate(np.array_split(np.arange(count), blocks)):
        ids[chunk] = b
    return ids


def sbm(k: int, n: int, s: int, rng: np.random.Generator, *,
        blocks: int = 4, intra: float = 0.7) -> GradientCode:
    """Stochastic-block-model code (Charles & Papailiopoulos 2017).

    Tasks and workers are partitioned into `blocks` contiguous clusters
    and G_ij ~ Bernoulli(p_in) when task i and worker j share a cluster,
    Bernoulli(p_out) otherwise.  `intra` is the fraction of a worker's
    expected s tasks drawn from its own cluster; densities are
    calibrated per worker so E[column degree] == s regardless of ragged
    block sizes.  blocks=1 (or intra such that p_in == p_out) recovers
    the BGC; high `intra` concentrates redundancy inside clusters, the
    regime where clustered (pod-correlated) stragglers separate the
    families.
    """
    _check(k, n, s)
    if not (0.0 <= intra <= 1.0):
        raise ValueError(f"intra={intra} must be in [0, 1]")
    # both sides must share ONE block count or the membership lookup
    # below misaligns (k < blocks <= n would index past tasks_in)
    blocks = max(1, min(blocks, k, n))
    t_id = block_ids(k, blocks)
    w_id = block_ids(n, blocks)
    tasks_in = np.bincount(t_id, minlength=blocks).astype(np.float64)
    k_in = tasks_in[w_id]                           # [n] own-cluster tasks
    k_out = k - k_in
    # per-worker expected-degree budgets: intra*s own-cluster, the rest
    # cross-cluster.  A side that saturates (expected degree would need
    # p > 1, e.g. small own-cluster at high intra) SPILLS its excess to
    # the other side rather than dropping it, so E[column degree] == s
    # holds at every ragged block size (s <= k guarantees capacity) and
    # the paper's rho = k/(r s) calibration stays valid.
    want_in = np.full(n, intra * s)
    want_out = np.full(n, (1.0 - intra) * s)
    eff_in = np.minimum(want_in, k_in)
    eff_out = np.minimum(want_out + (want_in - eff_in), k_out)
    eff_in = np.minimum(eff_in + (want_out + (want_in - eff_in) - eff_out),
                        k_in)
    p_in = np.divide(eff_in, k_in, out=np.zeros(n), where=k_in > 0)
    p_out = np.divide(eff_out, k_out, out=np.zeros(n), where=k_out > 0)
    same = t_id[:, None] == w_id[None, :]           # [k, n]
    P = np.where(same, p_in[None, :], p_out[None, :])
    G = (rng.random((k, n)) < P).astype(np.float64)
    return GradientCode(name="sbm", G=G, s=s,
                        params=(("blocks", blocks), ("intra", intra)))


def expander(k: int, n: int, s: int, rng: np.random.Generator) -> GradientCode:
    """Regular random bipartite code (Glasgow & Wootters 2021).

    Every worker computes exactly s tasks and every task is replicated
    ⌊ns/k⌋ or ⌈ns/k⌉ times — the (s, ns/k)-biregular support whose
    least-squares decoding beats one-step decoding at the same
    replication.  Sampled by degree-balanced random selection: each
    column picks the s least-replicated tasks with random tie-breaking,
    which keeps both sides regular at every ragged (k, n, s) and is a
    random near-regular bipartite graph (an expander w.h.p., like the
    configuration model).
    """
    _check(k, n, s)
    G = np.zeros((k, n), dtype=np.float64)
    row_deg = np.zeros(k, dtype=np.float64)
    for j in rng.permutation(n):
        pick = np.argsort(row_deg + rng.random(k), kind="stable")[:s]
        G[pick, j] = 1.0
        row_deg[pick] += 1.0
    return GradientCode(name="expander", G=G, s=s)


def cyclic_repetition(k: int, n: int, s: int, rng: Optional[np.random.Generator] = None) -> GradientCode:
    """Cyclic support code: worker j computes tasks {j, j+1, ..., j+s-1} mod k.

    The support pattern of Tandon et al.'s cyclic codes with all-ones
    coefficients; a deterministic, load-balanced baseline whose one-step
    decoding behaves like a circulant smoothing operator.
    """
    _check(k, n, s)
    G = np.zeros((k, n), dtype=np.float64)
    cols = np.arange(n)
    for off in range(s):
        G[(cols * k // n + off) % k, cols] = 1.0
    return GradientCode(name="cyclic", G=G, s=s)


def uncoded(k: int, n: Optional[int] = None, s: int = 1,
            rng: Optional[np.random.Generator] = None) -> GradientCode:
    """Identity assignment: worker j computes task j only (no redundancy)."""
    n = k if n is None else n
    if n != k:
        raise ValueError("uncoded requires n == k")
    return GradientCode(name="uncoded", G=np.eye(k, dtype=np.float64), s=1)


# Raw constructor table, kept for direct access; the declarative layer
# (decoder compatibilities, param grids, adversary profiles, validation)
# lives in core.registry, which is the factory every scheme-switch in
# the repo resolves through.
CODE_REGISTRY: Dict[str, Callable[..., GradientCode]] = {
    "frc": frc,
    "bgc": bgc,
    "rbgc": rbgc,
    "sregular": sregular,
    "sbm": sbm,
    "expander": expander,
    "cyclic": cyclic_repetition,
    "uncoded": uncoded,
}


def make_code(
    name: str,
    k: int,
    n: int,
    s: int,
    rng: Optional[np.random.Generator] = None,
    seed: Optional[int] = None,
    **params,
) -> GradientCode:
    """Factory used by configs / CLI: make_code('bgc', k=128, n=128, s=5).

    Delegates to core.registry (the authoritative scheme table) so
    unknown names raise the registry's actionable error and family
    extras (e.g. sbm's blocks/intra) pass through.
    """
    from . import registry  # deferred: registry imports this module

    return registry.make(name, k=k, n=n, s=s, rng=rng, seed=seed, **params)


def spectral_gap(code: GradientCode) -> float:
    """Second-largest singular value of G (= max(|lambda_2|, |lambda_k|)
    for symmetric square G).

    For a symmetric adjacency matrix (sregular) this is the classic
    expander gap used by theory.thm3_expander_err1_bound.  For the
    general bipartite k x n case (expander/sbm at ragged sizes) the
    right generalization is sigma_2 of the biadjacency matrix: the
    eigenvalues of the symmetric square [[0, G], [G^T, 0]] are exactly
    {+-sigma_i} plus |k - n| zeros, so sigma_2(G) IS the second-largest
    |eigenvalue| of the bipartite graph's adjacency matrix, and for
    symmetric nonnegative G it coincides with max(|lambda_2|,
    |lambda_k|) (Perron: lambda_1 dominates).  core.certify turns this
    into an adversarial-erasure error certificate.
    """
    G = code.G
    if G.shape[0] == G.shape[1] and np.allclose(G, G.T):
        lam = np.linalg.eigvalsh(G)
        return float(max(abs(lam[0]), abs(lam[-2])))
    sig = np.linalg.svd(G, compute_uv=False)
    if sig.size < 2:
        raise ValueError("spectral_gap needs min(k, n) >= 2")
    return float(sig[1])
