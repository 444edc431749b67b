"""ClusterSim: co-simulate wall-clock and decoding over whole runs.

Dataflow (docs/architecture.md §8):

    LatencyTrace [S, n]
        --(sync policy)-->  masks [S, n]  +  step_times [S]
        --(DecodeEngine)->  per-step decode errors [S]   (ONE batched call)

The decode runs on the engine's backend and device: the card by default
(``backend="torch"``), the plain kernels when the caller asks for
``device="cpu"``, the fp64 host path with ``backend="numpy"``.
:meth:`ClusterSim.run_distributed` keeps the worker messages and the
decoded gradients as tensors on that device.

The policy layer is vectorized: sync / deadline / backup map the whole
trace to masks and times with numpy reductions; the adaptive-deadline
controller is the one inherently sequential policy (its deadline at step
t depends on the straggler fraction it observed at t-1) and runs a cheap
O(S·n) python loop — but decoding stays a single ``decode_batch`` over
all S masks per (scheme, policy) cell, never a per-step decode loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core import decoding
from ..core import registry
from ..core.codes import GradientCode
from ..core.engine import DecodeEngine
from .traces import LatencyTrace

__all__ = [
    "SyncPolicy", "WaitForAll", "DeadlinePolicy", "BackupPolicy",
    "AdaptiveDeadline", "make_policy", "POLICIES",
    "ClusterRunResult", "ClusterSim",
]


# --------------------------------------------------------------------------
# sync policies: trace -> (masks, step_times)
# --------------------------------------------------------------------------


class SyncPolicy:
    """Maps a latency row to (non-straggler mask, step time).

    ``apply`` consumes a whole [S, n] trace at once (vectorized where the
    policy allows); ``step`` is the incremental form the training loop
    uses, threading opaque controller state.
    """

    name = "base"

    def step(self, lat: np.ndarray, state=None
             ) -> Tuple[np.ndarray, float, object]:
        raise NotImplementedError

    def apply(self, lat: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
        """[S, n] latencies -> (masks [S, n] bool, times [S], extras)."""
        S, n = lat.shape
        masks = np.empty((S, n), dtype=bool)
        times = np.empty(S)
        state = None
        for t in range(S):
            masks[t], times[t], state = self.step(lat[t], state)
        return masks, times, {}


@dataclasses.dataclass
class WaitForAll(SyncPolicy):
    """Uncoded baseline: wait for every worker; nobody straggles."""

    name = "sync"

    def step(self, lat, state=None):
        return np.ones(lat.shape[-1], dtype=bool), float(lat.max()), state

    def apply(self, lat):
        S, n = lat.shape
        return np.ones((S, n), dtype=bool), lat.max(axis=1), {}


@dataclasses.dataclass
class DeadlinePolicy(SyncPolicy):
    """Fixed deadline: workers past it are stragglers absorbed as decode
    error; the step ends at min(deadline, slowest worker)."""

    deadline: float = 1.5
    name = "deadline"

    def step(self, lat, state=None):
        return (lat <= self.deadline,
                float(min(self.deadline, lat.max())), state)

    def apply(self, lat):
        return (lat <= self.deadline,
                np.minimum(self.deadline, lat.max(axis=1)), {})


@dataclasses.dataclass
class BackupPolicy(SyncPolicy):
    """Dean-style backup tasks: the step ends when a `quantile` fraction
    of workers has reported; later arrivals are the stragglers."""

    quantile: float = 0.95
    name = "backup"

    # method='higher' picks the actual arrival time of the quantile
    # worker, so at least ceil(quantile * n) workers report every step
    def step(self, lat, state=None):
        cut = float(np.quantile(lat, self.quantile, method="higher"))
        return lat <= cut, cut, state

    def apply(self, lat):
        cuts = np.quantile(lat, self.quantile, axis=1, method="higher")
        return lat <= cuts[:, None], cuts, {}


@dataclasses.dataclass
class AdaptiveDeadline(SyncPolicy):
    """Online deadline controller: tune the deadline toward a target
    straggler fraction.

    Multiplicative-exponential update (always positive, scale-free):

        d_{t+1} = clip(d_t * exp(gain * (frac_t - target)), dmin, dmax)

    where frac_t is the straggler fraction observed under d_t.  Too many
    stragglers -> the deadline relaxes; too few -> it tightens, trading
    wall-clock back for decode accuracy until the cluster sits at the
    target point of the paper's frontier.
    """

    target: float = 0.1        # straggler fraction to steer toward
    gain: float = 0.5
    d0: float = 1.5            # initial deadline
    dmin: float = 1e-3
    dmax: float = 1e3
    name = "adaptive"

    def step(self, lat, state=None):
        d = self.d0 if state is None else float(state)
        mask = lat <= d
        time = float(min(d, lat.max()))
        frac = 1.0 - mask.mean()
        d_next = float(np.clip(d * np.exp(self.gain * (frac - self.target)),
                               self.dmin, self.dmax))
        return mask, time, d_next

    def apply(self, lat):
        S, n = lat.shape
        masks = np.empty((S, n), dtype=bool)
        times = np.empty(S)
        deadlines = np.empty(S)
        state = None
        for t in range(S):
            deadlines[t] = self.d0 if state is None else state
            masks[t], times[t], state = self.step(lat[t], state)
        return masks, times, {"deadlines": deadlines}


POLICIES = ("sync", "deadline", "backup", "adaptive")


def make_policy(name_or_policy: Union[str, SyncPolicy], **kw) -> SyncPolicy:
    if isinstance(name_or_policy, SyncPolicy):
        return name_or_policy
    registry = {"sync": WaitForAll, "deadline": DeadlinePolicy,
                "backup": BackupPolicy, "adaptive": AdaptiveDeadline}
    if name_or_policy not in registry:
        raise ValueError(f"unknown sync policy {name_or_policy!r}; "
                         f"have {POLICIES}")
    return registry[name_or_policy](**kw)


# --------------------------------------------------------------------------
# the co-simulation
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ClusterRunResult:
    """One (code, trace, policy, decoder) cell of the co-simulation."""

    scheme: str
    policy: str
    decoder: str
    step_times: np.ndarray     # [S] modelled seconds per step
    masks: np.ndarray          # [S, n] non-straggler masks
    errors: np.ndarray         # [S] decode error / k per step
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def steps(self) -> int:
        return int(self.step_times.shape[0])

    @property
    def total_time(self) -> float:
        return float(self.step_times.sum())

    @property
    def mean_step_time(self) -> float:
        return float(self.step_times.mean())

    @property
    def mean_error(self) -> float:
        return float(self.errors.mean())

    @property
    def mean_stragglers(self) -> float:
        return float((~self.masks).sum(axis=1).mean())

    @property
    def worst_stragglers(self) -> int:
        return int((~self.masks).sum(axis=1).max())

    def summary(self) -> dict:
        return {
            "scheme": self.scheme, "policy": self.policy,
            "decoder": self.decoder, "steps": self.steps,
            "total_time": self.total_time,
            "mean_step_time": self.mean_step_time,
            "mean_error": self.mean_error,
            "mean_stragglers": self.mean_stragglers,
            "worst_stragglers": self.worst_stragglers,
        }


class ClusterSim:
    """Trace-driven wall-clock × accuracy co-simulation for one code.

    ``code`` may be a GradientCode or a registry scheme name (built at
    k = n = trace.n with the given ``s``); the requested decoder is
    validated against the family's declared compatibilities.

    The whole run decodes in exactly ONE DecodeEngine.decode_batch call:
    the policy first maps the trace to all S masks, then the engine
    decodes the [S, n] ensemble.  `engine.batch_calls` before/after is
    the test hook for that invariant.
    """

    def __init__(self, code: Union[GradientCode, str], trace: LatencyTrace,
                 policy: Union[str, SyncPolicy] = "deadline", *,
                 decoder: str = "onestep", backend: str = "torch",
                 device=None, s: Optional[int] = None, iters: int = 8,
                 engine: Optional[DecodeEngine] = None,
                 code_seed: int = 0, staleness: int = 0,
                 decode_cost: float = 0.0, **policy_kw):
        if isinstance(code, str):
            # scheme name -> registry build sized to the trace (k = n).
            # Validate against the REQUESTED family (a registered alias
            # may construct codes named after its base constructor).
            if s is None:
                raise ValueError(
                    f"ClusterSim({code!r}, ...) needs an explicit s= "
                    f"(tasks per worker) to build the code; a silent "
                    f"default would misreport the frontier")
            fam = registry.get(code)
            code = fam.make(k=trace.n, n=trace.n, s=s, seed=code_seed)
        else:
            fam = registry.find(code.name)
        if fam is not None:
            fam.require_decoder(decoder)
        if trace.n != code.n:
            raise ValueError(f"trace has n={trace.n} workers but code has "
                             f"n={code.n}")
        self.code = code
        self.trace = trace
        self.policy = make_policy(policy, **policy_kw)
        self.decoder = decoder
        self.engine = engine if engine is not None else DecodeEngine(
            code, backend=backend, device=device, s=s, iters=iters)
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        # decode pipelining (docs/architecture.md §10): step t applies
        # the weights decoded from step t-staleness's mask, re-masked by
        # step t's stragglers; the decode overlaps the compute, so its
        # cost leaves the critical path whenever decode_cost <= the
        # policy's step time.  staleness=0 keeps the synchronous
        # semantics with the decode cost ADDED to every step.
        self.staleness = int(staleness)
        self.decode_cost = float(decode_cost)

    def run(self) -> ClusterRunResult:
        masks, times, extras = self.policy.apply(self.trace.latencies)
        if self.staleness == 0:
            errors = self.engine.errors_batch(masks, self.decoder) \
                / self.code.k
            if self.decode_cost:
                times = times + self.decode_cost   # synchronous barrier
            return ClusterRunResult(
                scheme=self.code.name, policy=self.policy.name,
                decoder=self.decoder, step_times=times, masks=masks,
                errors=errors, extras=extras)
        # stale-weighted pipelining, still ONE decode_batch: prepend
        # `staleness` all-alive warm-start rows so row t of the decoded
        # ensemble is what step t applies (weights of mask t-staleness)
        S, n = masks.shape
        st = self.staleness
        aug = np.vstack([np.ones((st, n), dtype=bool), masks])
        W = self.engine.decode_batch(aug, self.decoder).weights
        W_eff = W[:S] * masks                       # today's stragglers: 0
        errors = decoding.err_batch(self.code.G, W_eff) / self.code.k
        # the decode overlaps the next step's compute; it only stretches
        # a step whose compute finishes before the decode does
        times = np.maximum(times, self.decode_cost)
        return ClusterRunResult(
            scheme=self.code.name, policy=self.policy.name,
            decoder=self.decoder, step_times=times, masks=masks,
            errors=errors, extras=extras)

    def run_distributed(self, *, steps: Optional[int] = None,
                        task_grads=None, group=None,
                        fused: bool = False) -> ClusterRunResult:
        """The co-simulation executed through the coded all-reduce
        (docs/architecture.md §9).

        Same trace -> policy -> masks dataflow as :meth:`run`, but the
        decode happens through ``dist.coded_allreduce``: each rank
        combines its workers' coded messages with the step's decode
        weights and the all-reduce over the process group (``group``, or
        the default one; one rank when none is initialised) produces the
        decoded gradient.  Weights for ALL S masks still come from ONE
        ``decode_batch`` call.

        ``task_grads`` [k, P] are the per-task gradients, a tensor (kept
        on its device and dtype) or an array (moved to the engine's
        device).  The default is the k standard basis vectors in fp32 on
        the engine's device, for which the decoded vector is exactly
        ``G @ w_s`` and the measured squared error against the full
        gradient (the all-ones vector) IS the decode error the analytic
        path reports -- so ``errors`` (measured) can be compared against
        ``extras['analytic_errors']`` (engine-derived).  The worker
        messages ``G^T @ task_grads`` are formed on the device with
        ``torch.matmul``; ``extras['decoded']`` is the [S, P] decoded
        tensor there.

        ``fused=True`` routes the aggregation through
        ``CodedAllReduce.aggregate_messages_fused`` (one-step decoder
        only): the decode weights are never materialized.
        """
        from ..dist.coded_allreduce import CodedAllReduce

        lat = self.trace.latencies if steps is None \
            else self.trace.latencies[:steps]
        masks, times, extras = self.policy.apply(lat)
        k = self.code.k
        if isinstance(task_grads, torch.Tensor):
            dev = task_grads.device
        elif self.engine.device is not None:
            dev = self.engine.device
        else:
            raise ValueError("run_distributed needs a device: pass "
                             "task_grads as a tensor or give the engine one")
        if task_grads is None:
            task_grads = torch.eye(k, dtype=torch.float32, device=dev)
        task_grads = torch.as_tensor(task_grads, device=dev)
        G = torch.as_tensor(self.code.G, dtype=task_grads.dtype, device=dev)
        messages = G.T @ task_grads                     # [n, P] worker msgs
        allreduce = CodedAllReduce(self.code, engine=self.engine, group=group)
        if fused:
            if self.decoder != "onestep":
                raise ValueError("fused=True implements the one-step "
                                 f"decoder; got decoder={self.decoder!r}")
            decoded = allreduce.aggregate_messages_fused(
                messages, masks, renorm=False)
            scales = self.engine.onestep_scales(masks)
            analytic = decoding.err_batch(
                self.code.G, scales[:, None] * masks) / k
        else:
            decoded_batch = self.engine.decode_batch(masks, self.decoder)
            decoded = allreduce.aggregate_messages_batch(
                messages, decoded_batch.weights)
            analytic = decoded_batch.errors / k
        full = task_grads.sum(dim=0)                    # the uncoded gradient
        dev_errors = _sq_dist_rows(decoded, full) / k
        extras = dict(extras,
                      analytic_errors=analytic,
                      decoded=decoded,
                      n_devices=allreduce.n_devices)
        return ClusterRunResult(
            scheme=self.code.name, policy=self.policy.name,
            decoder=self.decoder, step_times=times, masks=masks,
            errors=dev_errors, extras=extras)


def _sq_dist_rows(X: torch.Tensor, y: torch.Tensor,
                  budget: int = 1 << 26) -> np.ndarray:
    """[S] fp64 host array of ||X[s] - y||^2, computed on X's device in
    fp64 a few rows at a time (at most ~`budget` elements per chunk)."""
    S, P = X.shape
    step = max(1, budget // max(P, 1))
    y = y.to(torch.float64)
    out = [((X[lo:lo + step].to(torch.float64) - y) ** 2).sum(dim=1)
           for lo in range(0, S, step)]
    return torch.cat(out).cpu().numpy() if out else np.zeros(0)
