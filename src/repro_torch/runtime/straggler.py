"""Straggler models: who fails to report by the aggregation deadline.

All models are deterministic given (seed, step) so every host in an SPMD
job derives the same mask without communication — the SPMD-native
replacement for the paper's master observing arrivals.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from ..core import adversary as ADV

__all__ = ["StragglerModel", "NoStragglers", "IIDStragglers",
           "FixedFractionStragglers", "DeadlineStragglers",
           "CorrelatedStragglers", "AdversarialStragglers",
           "BimodalStragglers", "ClusteredStragglers",
           "make_straggler_model"]


class StragglerModel:
    """mask[j] == True  <=>  worker j is a NON-straggler this step."""

    def sample(self, step: int, n: int) -> np.ndarray:
        raise NotImplementedError

    def latencies(self, step: int, n: int) -> np.ndarray:
        """Per-worker compute latencies (seconds) for the wall-clock model.

        Deterministic in (seed, step) like every mask draw, so each host
        derives the same value.  The base model is latency-free (unit
        latencies); models with a real latency distribution override
        this with a default_rng((self.seed, step)) draw.
        """
        del step
        return np.ones(n)


@dataclasses.dataclass
class NoStragglers(StragglerModel):
    def sample(self, step: int, n: int) -> np.ndarray:
        return np.ones(n, dtype=bool)


@dataclasses.dataclass
class IIDStragglers(StragglerModel):
    """Each worker independently straggles with probability delta."""
    delta: float
    seed: int = 0

    def sample(self, step: int, n: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        return rng.random(n) >= self.delta


@dataclasses.dataclass
class FixedFractionStragglers(StragglerModel):
    """Exactly floor(delta*n) stragglers, uniformly chosen (the paper's
    sampling model)."""
    delta: float
    seed: int = 0

    def sample(self, step: int, n: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        mask = np.ones(n, dtype=bool)
        ns = int(self.delta * n)
        if ns:
            mask[rng.choice(n, ns, replace=False)] = False
        return mask


@dataclasses.dataclass
class DeadlineStragglers(StragglerModel):
    """Latency = base + Pareto(alpha) tail; straggler iff latency > deadline.

    Matches the empirical 'slowest nodes dictate runtime' premise; the
    latency draw is reused by repro_torch.sim (LatencyTrace) for the
    wall-clock co-simulation.
    """
    base: float = 1.0
    tail_scale: float = 0.2
    alpha: float = 2.0
    deadline: float = 1.5
    seed: int = 0

    def latencies(self, step: int, n: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        return self.base + self.tail_scale * (rng.pareto(self.alpha, n) + 1.0)

    def sample(self, step: int, n: int) -> np.ndarray:
        return self.latencies(step, n) <= self.deadline


@dataclasses.dataclass
class CorrelatedStragglers(StragglerModel):
    """Pod-level correlated failures: a whole pod's workers straggle
    together with prob p_pod; plus iid node-level noise p_node."""
    pod_size: int
    p_pod: float = 0.05
    p_node: float = 0.05
    seed: int = 0

    def sample(self, step: int, n: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        npods = -(-n // self.pod_size)
        pod_ok = rng.random(npods) >= self.p_pod
        node_ok = rng.random(n) >= self.p_node
        mask = node_ok & np.repeat(pod_ok, self.pod_size)[:n]
        return mask


@dataclasses.dataclass
class BimodalStragglers(StragglerModel):
    """Bimodal slow-node fleet: a fixed subset of nodes is persistently
    slow (bad NIC, thermal throttling, noisy neighbour) while the rest
    are fast; every node adds per-step log-normal jitter.

    The slow set is a deterministic function of the seed alone — the
    same nodes are slow on every step, the empirically common 'that one
    bad host' regime that iid models can't express.  Stragglers are the
    nodes whose jittered latency misses the deadline, so with
    deadline between the two modes the straggler set is essentially the
    slow set.
    """
    slow_fraction: float = 0.1
    fast: float = 1.0
    slow: float = 3.0
    jitter: float = 0.05      # sigma of multiplicative log-normal noise
    deadline: float = 1.5
    seed: int = 0

    def slow_nodes(self, n: int) -> np.ndarray:
        """Boolean [n] slow-set indicator, step-independent."""
        rng = np.random.default_rng((self.seed, 0x51))
        k_slow = int(round(self.slow_fraction * n))
        slow = np.zeros(n, dtype=bool)
        if k_slow:
            slow[rng.choice(n, k_slow, replace=False)] = True
        return slow

    def latencies(self, step: int, n: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        base = np.where(self.slow_nodes(n), self.slow, self.fast)
        return base * np.exp(self.jitter * rng.standard_normal(n))

    def sample(self, step: int, n: int) -> np.ndarray:
        return self.latencies(step, n) <= self.deadline


@dataclasses.dataclass
class ClusteredStragglers(StragglerModel):
    """Cluster-correlated slow episodes: whole blocks of workers go slow
    together and STAY slow for `episode` consecutive steps.

    Workers are partitioned into `blocks` contiguous clusters by the
    same rule as the SBM code construction (core.codes.block_ids), so a
    clustered trace's failing blocks line up with an SBM code's worker
    blocks — the regime in which clustered codes and iid-style codes
    separate (Charles & Papailiopoulos).  Each block independently
    enters a slow episode with probability `p_block` per epoch (epoch =
    `episode` steps), which keeps the draw a pure function of
    (seed, step) — every SPMD host derives the same latencies with no
    communication and no Markov state to thread.
    """

    blocks: int = 4
    p_block: float = 0.15
    episode: int = 8          # steps a slow episode lasts
    fast: float = 1.0
    slow: float = 3.0
    jitter: float = 0.05      # sigma of multiplicative log-normal noise
    deadline: float = 1.5
    seed: int = 0

    def slow_blocks(self, step: int) -> np.ndarray:
        """[blocks] bool slow indicator for the epoch containing step."""
        epoch = step // max(self.episode, 1)
        rng = np.random.default_rng((self.seed, epoch, 0xC1))
        return rng.random(self.blocks) < self.p_block

    def latencies(self, step: int, n: int) -> np.ndarray:
        from ..core.codes import block_ids

        member = block_ids(n, self.blocks)
        base = np.where(self.slow_blocks(step)[member], self.slow, self.fast)
        rng = np.random.default_rng((self.seed, step))
        return base * np.exp(self.jitter * rng.standard_normal(n))

    def sample(self, step: int, n: int) -> np.ndarray:
        return self.latencies(step, n) <= self.deadline


@dataclasses.dataclass
class AdversarialStragglers(StragglerModel):
    """Poly-time adversary (paper Sec. 4): FRC-structural if the code is an
    FRC, else greedy; budget = floor(delta * n) stragglers per step.

    The adversarial mask depends only on (G, n), not on the step, so it
    is computed once per worker count and cached — the greedy search is
    O(n * budget) least-squares decodes, far too expensive to redo every
    training step.
    """
    G: np.ndarray
    delta: float
    mode: str = "auto"  # auto | frc | greedy
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def sample(self, step: int, n: int) -> np.ndarray:
        del step  # step-independent: the adversary always plays its best
        cached = self._cache.get(n)
        if cached is None:
            cached = self._compute_mask(n)
            self._cache[n] = cached
        return cached.copy()

    def _compute_mask(self, n: int) -> np.ndarray:
        budget = int(self.delta * n)
        if budget == 0:
            return np.ones(n, dtype=bool)
        mode = self.mode
        if mode == "auto":
            # detect FRC structure: duplicated columns
            cols = {self.G[:, j].tobytes() for j in range(self.G.shape[1])}
            mode = "frc" if len(cols) < self.G.shape[1] else "greedy"
        if mode == "frc":
            return ADV.frc_adversarial_mask(self.G, budget)
        return ADV.greedy_adversarial_mask(self.G, budget, objective="onestep")


def make_straggler_model(name: str, **kw) -> StragglerModel:
    models = {
        "none": NoStragglers,
        "iid": IIDStragglers,
        "fixed": FixedFractionStragglers,
        "deadline": DeadlineStragglers,
        "correlated": CorrelatedStragglers,
        "adversarial": AdversarialStragglers,
        "bimodal": BimodalStragglers,
        "clustered": ClusteredStragglers,
    }
    if name not in models:
        raise ValueError(f"unknown straggler model {name!r}")
    return models[name](**kw)
