"""LatencyTrace: the one latency abstraction behind ClusterSim.

A trace is a ``[steps, n]`` matrix of per-worker compute latencies for a
whole run — the co-simulation's ground truth.  Everything upstream of
the sync policy is a trace source:

  * the straggler models in ``runtime.straggler`` that own a real
    latency distribution (Pareto-tail deadline, bimodal slow-node)
    contribute their ``latencies(step, n)`` rows directly;
  * mask-only models (iid, fixed-fraction, pod-correlated, adversarial)
    are lifted to latencies by mapping straggler -> ``slow`` and
    non-straggler -> ``base`` — the two-point distribution their mask
    semantics already implies;
  * recorded cluster traces replay from JSON (``LatencyTrace.load``).

A trace is sampled once (the straggler models sample masks; a trace
holds latencies), then any sync policy in ``sim.cluster`` maps it
to per-step masks + step times, and the DecodeEngine decodes all the
masks in one batched call.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from ..core.codes import block_ids
from ..runtime.straggler import StragglerModel, make_straggler_model

__all__ = ["LatencyTrace", "TraceCursor", "trace_from_model", "make_trace",
           "TRACE_SOURCES", "ChurnEvent", "ChurnScenario",
           "make_churn_scenario", "ingest_machine_events"]


@dataclasses.dataclass(frozen=True)
class LatencyTrace:
    """Per-worker latencies for a whole run: ``latencies[t, j]`` is the
    compute time of worker j at step t (seconds)."""

    latencies: np.ndarray          # [steps, n] float64
    source: str = "unknown"

    def __post_init__(self):
        lat = np.asarray(self.latencies, dtype=np.float64)
        if lat.ndim != 2:
            raise ValueError(f"trace must be [steps, n], got {lat.shape}")
        if lat.size and lat.min() < 0:
            raise ValueError("latencies must be non-negative")
        object.__setattr__(self, "latencies", lat)

    @property
    def steps(self) -> int:
        return int(self.latencies.shape[0])

    @property
    def n(self) -> int:
        return int(self.latencies.shape[1])

    @classmethod
    def from_arrays(cls, latencies: np.ndarray,
                    source: str = "replay") -> "LatencyTrace":
        """Wrap an existing [steps, n] latency matrix (a copy is kept)."""
        return cls(np.array(latencies, dtype=np.float64), source=source)

    def scaled(self, compute_scale: float) -> "LatencyTrace":
        """Rescale every latency (s coded tasks cost ~s/1 of the uncoded
        step — the paper's compute-overhead axis)."""
        return LatencyTrace(self.latencies * float(compute_scale),
                            source=self.source)

    def window(self, start: int, stop: Optional[int] = None) -> "LatencyTrace":
        return LatencyTrace(self.latencies[start:stop], source=self.source)

    def tile(self, steps: int) -> "LatencyTrace":
        """Repeat the trace to cover `steps` rows (replay longer runs)."""
        reps = -(-steps // self.steps)
        return LatencyTrace(np.tile(self.latencies, (reps, 1))[:steps],
                            source=self.source)

    # ---------------------------- JSON replay ----------------------------

    def to_json(self) -> str:
        return json.dumps({"source": self.source,
                           "latencies": self.latencies.tolist()})

    @classmethod
    def from_json(cls, text: str) -> "LatencyTrace":
        obj = json.loads(text)
        return cls(np.asarray(obj["latencies"], dtype=np.float64),
                   source=obj.get("source", "replay"))

    def save(self, path: Union[str, Path]) -> Path:
        p = Path(path)
        p.write_text(self.to_json())
        return p

    @classmethod
    def load(cls, path: Union[str, Path]) -> "LatencyTrace":
        return cls.from_json(Path(path).read_text())


class TraceCursor:
    """Per-column replay cursor over a :class:`LatencyTrace`.

    The serving simulator treats column j as replica j's latency
    *stream*: each draw for a replica consumes that replica's next row
    (wrapping modulo ``steps``), independently of the other replicas.
    ``take`` is fully vectorized — a chunk of replica ids draws all its
    latencies in one call, with requests routed to the same replica
    consuming consecutive rows in request order.
    """

    def __init__(self, trace: LatencyTrace):
        if trace.steps == 0 or trace.n == 0:
            raise ValueError("cursor needs a non-empty trace")
        self.trace = trace
        self._pos = np.zeros(trace.n, dtype=np.int64)

    def take(self, replicas: np.ndarray) -> np.ndarray:
        """Next latency for each entry of ``replicas`` ([R] int)."""
        r = np.asarray(replicas, dtype=np.int64)
        if r.size == 0:
            return np.empty(0)
        if r.min() < 0 or r.max() >= self.trace.n:
            raise ValueError(f"replica ids out of range [0, {self.trace.n})")
        order = np.argsort(r, kind="stable")
        sr = r[order]
        # cumcount within each replica group (sr is sorted, so groups
        # are contiguous): entry i gets its replica's (pos + cumcount)th row
        starts = np.flatnonzero(np.r_[True, sr[1:] != sr[:-1]])
        sizes = np.diff(np.r_[starts, sr.size])
        cum = np.arange(sr.size) - np.repeat(starts, sizes)
        rows = (self._pos[sr] + cum) % self.trace.steps
        out = np.empty(r.size)
        out[order] = self.trace.latencies[rows, sr]
        uniq = sr[starts]
        self._pos[uniq] = (self._pos[uniq] + sizes) % self.trace.steps
        return out


def _has_latency_distribution(model: StragglerModel) -> bool:
    """True when the model overrides the base unit-latency stub."""
    return type(model).latencies is not StragglerModel.latencies


def trace_from_model(model: StragglerModel, steps: int, n: int, *,
                     base: float = 1.0, slow: float = 3.0) -> LatencyTrace:
    """Sample a [steps, n] trace from any straggler model.

    Models with a real latency distribution (DeadlineStragglers,
    BimodalStragglers) are sampled directly; mask-only models are lifted
    via straggler -> `slow`, non-straggler -> `base`.
    """
    lat = np.empty((steps, n))
    if _has_latency_distribution(model):
        for t in range(steps):
            lat[t] = model.latencies(t, n)
    else:
        for t in range(steps):
            lat[t] = np.where(model.sample(t, n), base, slow)
    return LatencyTrace(lat, source=type(model).__name__)


# sources with first-class latency semantics; anything accepted by
# make_straggler_model also works (lifted through the two-point map).
# 'clustered' is the block-correlated slow-episode source whose failing
# blocks align with the SBM code's worker clusters (core.codes.block_ids)
TRACE_SOURCES = ("pareto", "bimodal", "clustered", "correlated",
                 "adversarial", "iid", "fixed", "none", "replay")


def make_trace(source: str, steps: int = 0, n: int = 0, *,
               path: Optional[Union[str, Path]] = None,
               base: float = 1.0, slow: float = 3.0,
               **kw) -> LatencyTrace:
    """Trace factory: named straggler models plus JSON replay.

    'pareto' aliases the DeadlineStragglers Pareto-tail model; 'replay'
    loads `path` and tiles it to `steps` when steps > 0.
    """
    if source == "replay":
        if path is None:
            raise ValueError("replay trace needs path=")
        trace = LatencyTrace.load(path)
        return trace.tile(steps) if steps else trace
    if steps <= 0 or n <= 0:
        raise ValueError("generated traces need steps > 0 and n > 0")
    name = "deadline" if source == "pareto" else source
    model = make_straggler_model(name, **kw)
    return trace_from_model(model, steps, n, base=base, slow=slow)


# ==========================================================================
# churn: worker arrival / departure as a first-class trace channel
# ==========================================================================

EVENT_KINDS = ("preempt", "preempt_block", "scale_up")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One membership change, applied at the TOP of ``step`` (before the
    step's mask is drawn).

    ``preempt`` / ``preempt_block`` remove the capacity slots listed in
    ``workers`` (block preemption lists a whole code block — aligned to
    :func:`repro_torch.core.codes.block_ids` over the live set at emission
    time); ``scale_up`` adds ``count`` fresh workers drawn from the
    lowest inactive capacity slots.
    """

    step: int
    kind: str
    workers: Tuple[int, ...] = ()    # capacity slot ids removed (preempt*)
    count: int = 0                   # workers added (scale_up)

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"kind {self.kind!r} not in {EVENT_KINDS}")
        if self.step < 0:
            raise ValueError(f"step must be >= 0, got {self.step}")
        if self.kind.startswith("preempt") and not self.workers:
            raise ValueError(f"{self.kind} event needs workers")
        if self.kind == "scale_up" and self.count <= 0:
            raise ValueError("scale_up event needs count > 0")
        object.__setattr__(self, "workers",
                           tuple(int(w) for w in self.workers))

    def as_dict(self) -> dict:
        return {"step": int(self.step), "kind": self.kind,
                "workers": list(self.workers), "count": int(self.count)}

    @classmethod
    def from_dict(cls, d: dict) -> "ChurnEvent":
        return cls(step=int(d["step"]), kind=d["kind"],
                   workers=tuple(d.get("workers", ())),
                   count=int(d.get("count", 0)))


@dataclasses.dataclass(frozen=True)
class ChurnScenario:
    """A latency trace plus the membership channel on top of it.

    The trace is sampled at full CAPACITY ``n_max`` (= ``trace.n``);
    slots ``[0, n0)`` are live at step 0 and :class:`ChurnEvent`\\ s
    mutate the live set over the run.  ``speed`` is the heterogeneous
    per-worker latency multiplier (worker j's latency at step t is
    ``trace.latencies[t, j] * speed[j]``) — spot fleets are not uniform
    hardware.  Membership replay is pure in the scenario, so every
    consumer (trainer, analytic sim, E13) derives the identical live-set
    trajectory.
    """

    trace: LatencyTrace
    events: Tuple[ChurnEvent, ...] = ()
    speed: Optional[np.ndarray] = None     # [n_max] multipliers, default 1
    n0: Optional[int] = None               # live at step 0 (default n_max)

    def __post_init__(self):
        events = tuple(sorted((e if isinstance(e, ChurnEvent)
                               else ChurnEvent.from_dict(e)
                               for e in self.events), key=lambda e: e.step))
        object.__setattr__(self, "events", events)
        n0 = self.trace.n if self.n0 is None else int(self.n0)
        if not (1 <= n0 <= self.trace.n):
            raise ValueError(f"n0={n0} must be in [1, n_max={self.trace.n}]")
        object.__setattr__(self, "n0", n0)
        speed = (np.ones(self.trace.n) if self.speed is None
                 else np.asarray(self.speed, dtype=np.float64))
        if speed.shape != (self.trace.n,):
            raise ValueError(f"speed shape {speed.shape} != ({self.trace.n},)")
        if speed.size and speed.min() <= 0:
            raise ValueError("speed multipliers must be positive")
        object.__setattr__(self, "speed", speed)
        for e in events:
            if not (0 <= e.step < self.steps):
                raise ValueError(f"event at step {e.step} outside "
                                 f"[0, {self.steps})")
            if e.workers and (min(e.workers) < 0
                              or max(e.workers) >= self.n_max):
                raise ValueError(f"event workers {e.workers} outside "
                                 f"[0, {self.n_max})")

    @property
    def steps(self) -> int:
        return self.trace.steps

    @property
    def n_max(self) -> int:
        return self.trace.n

    def events_at(self, step: int) -> Tuple[ChurnEvent, ...]:
        return tuple(e for e in self.events if e.step == step)

    def initial_ids(self) -> np.ndarray:
        return np.arange(self.n0, dtype=np.int64)

    def apply_event(self, live: np.ndarray, event: ChurnEvent) -> np.ndarray:
        """THE membership-transition rule (single source of truth).

        preempt*: drop the listed slots (already-dead slots are ignored
        — replayed external traces can double-report removals).
        scale_up: add the ``count`` lowest inactive capacity slots
        (clamped at capacity).  Returns a sorted live-id array.
        """
        live_set = set(int(x) for x in np.asarray(live).ravel())
        if event.kind in ("preempt", "preempt_block"):
            live_set -= set(event.workers)
        else:
            free = [j for j in range(self.n_max) if j not in live_set]
            live_set |= set(free[: event.count])
        return np.array(sorted(live_set), dtype=np.int64)

    def membership(self) -> np.ndarray:
        """[steps, n_max] bool live matrix from replaying the events."""
        cached = self.__dict__.get("_membership")
        if cached is not None:
            return cached
        out = np.zeros((self.steps, self.n_max), dtype=bool)
        live = self.initial_ids()
        by_step: dict = {}
        for e in self.events:
            by_step.setdefault(e.step, []).append(e)
        for t in range(self.steps):
            for e in by_step.get(t, ()):
                live = self.apply_event(live, e)
            out[t, live] = True
        object.__setattr__(self, "_membership", out)
        return out

    def latencies_at(self, step: int, ids: np.ndarray) -> np.ndarray:
        """Speed-scaled latency row for the given live slots."""
        ids = np.asarray(ids, dtype=np.int64)
        row = self.trace.latencies[step % self.steps, ids]
        return row * self.speed[ids]

    # ---------------------------- JSON replay ----------------------------

    def to_json(self) -> str:
        return json.dumps({
            "source": self.trace.source,
            "latencies": self.trace.latencies.tolist(),
            "events": [e.as_dict() for e in self.events],
            "speed": self.speed.tolist(),
            "n0": int(self.n0),
        })

    @classmethod
    def from_json(cls, text: str) -> "ChurnScenario":
        obj = json.loads(text)
        return cls(
            trace=LatencyTrace(np.asarray(obj["latencies"], dtype=np.float64),
                               source=obj.get("source", "replay")),
            events=tuple(ChurnEvent.from_dict(d)
                         for d in obj.get("events", ())),
            speed=(np.asarray(obj["speed"], dtype=np.float64)
                   if obj.get("speed") is not None else None),
            n0=obj.get("n0"),
        )

    def save(self, path: Union[str, Path]) -> Path:
        p = Path(path)
        p.write_text(self.to_json())
        return p

    @classmethod
    def load(cls, path: Union[str, Path]) -> "ChurnScenario":
        return cls.from_json(Path(path).read_text())


def make_churn_scenario(source: str = "bimodal", steps: int = 400,
                        n0: int = 64, *, n_max: Optional[int] = None,
                        preempt_rate: float = 0.02, preempt_max: int = 2,
                        block_rate: float = 0.0, blocks: int = 4,
                        scaleup_rate: float = 0.01, scaleup_max: int = 4,
                        min_workers: int = 4, speed_sigma: float = 0.0,
                        warmup: int = 10, seed: int = 0,
                        **trace_kw) -> ChurnScenario:
    """Scenario generator: spot-market churn over any trace source.

    Per step (after ``warmup``), at most one event fires: a whole-block
    preemption with probability ``block_rate`` (the block drawn from
    :func:`~repro_torch.core.codes.block_ids` over the CURRENT live set, so a
    failing block is exactly one of the blocks an SBM code built over
    those workers would use), else a spot preemption of 1..preempt_max
    random live workers with probability ``preempt_rate``, else a
    scale-up of 1..scaleup_max fresh workers with probability
    ``scaleup_rate``.  Events never push the fleet below ``min_workers``
    or above capacity.  ``speed_sigma > 0`` draws lognormal per-worker
    speed multipliers.  Everything is pure in ``seed``.
    """
    if n_max is None:
        n_max = max(n0 + max(2 * scaleup_max, n0 // 4), n0)
    if not (1 <= min_workers <= n0 <= n_max):
        raise ValueError(f"need 1 <= min_workers <= n0 <= n_max, got "
                         f"({min_workers}, {n0}, {n_max})")
    trace = make_trace(source, steps=steps, n=n_max, seed=seed, **trace_kw)
    ev_rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC4]))
    sp_rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5D]))
    speed = (np.exp(sp_rng.normal(0.0, speed_sigma, n_max))
             if speed_sigma > 0 else None)
    scenario = ChurnScenario(trace=trace, speed=speed, n0=n0)  # event-free
    live = scenario.initial_ids()
    events = []
    for t in range(warmup, steps):
        u = ev_rng.random()
        event = None
        if u < block_rate and blocks > 1:
            # whole-block loss: the correlated-failure world of the
            # clustered trace, hitting membership instead of latency
            ids = block_ids(live.size, min(blocks, live.size))
            b = int(ev_rng.integers(ids.max() + 1))
            victims = live[ids == b]
            if live.size - victims.size >= min_workers and victims.size:
                event = ChurnEvent(step=t, kind="preempt_block",
                                   workers=tuple(victims))
        elif u < block_rate + preempt_rate:
            m = int(ev_rng.integers(1, preempt_max + 1))
            m = min(m, live.size - min_workers)
            if m > 0:
                victims = ev_rng.choice(live, size=m, replace=False)
                event = ChurnEvent(step=t, kind="preempt",
                                   workers=tuple(int(v) for v in victims))
        elif u < block_rate + preempt_rate + scaleup_rate:
            m = int(ev_rng.integers(1, scaleup_max + 1))
            m = min(m, n_max - live.size)
            if m > 0:
                event = ChurnEvent(step=t, kind="scale_up", count=m)
        if event is not None:
            events.append(event)
            live = scenario.apply_event(live, event)
    return ChurnScenario(trace=trace, events=tuple(events), speed=speed,
                         n0=n0)


def ingest_machine_events(path: Union[str, Path], *,
                          bin_seconds: float = 300.0,
                          latency_source: str = "bimodal",
                          min_workers: int = 2, seed: int = 0,
                          max_steps: Optional[int] = None,
                          **trace_kw) -> ChurnScenario:
    """Ingest a public machine-events cluster trace as a ChurnScenario.

    Accepts the Google ``clusterdata-2011`` ``machine_events`` CSV
    schema: ``timestamp_us, machine_id, event_type[, platform, cpus,
    mem]`` with event_type 0 = ADD, 1 = REMOVE, 2 = UPDATE (ignored),
    no header row ('#'-prefixed comment lines are skipped).  Machines
    present at the trace start (events at timestamp 0) form the initial
    fleet; later ADD/REMOVE events are binned into ``bin_seconds`` steps
    and replayed as scale-up / preemption events, so the ARRIVAL AND
    DEPARTURE PROCESS is the external cluster's own.  The public
    membership traces carry no per-step worker latencies, so the latency
    channel is synthesized from ``latency_source`` at full capacity;
    which live slot a removal hits is drawn from ``seed`` (machine
    identity across re-adds is not preserved — counts and timing are).
    """
    adds: dict = {}
    removes: dict = {}
    machines = set()
    t0 = None
    initial = set()
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(",")
        ts, mid, etype = float(parts[0]), parts[1], int(parts[2])
        if etype == 2:
            continue
        machines.add(mid)
        if etype == 0 and ts <= 0:
            initial.add(mid)
            continue
        t0 = ts if t0 is None else min(t0, ts)
        (adds if etype == 0 else removes).setdefault(ts, []).append(mid)
    if not initial:
        raise ValueError(f"{path}: no initial fleet (ADD events at t=0)")
    n0 = len(initial)
    n_max = len(machines)
    usec = 1e6 * bin_seconds
    bins = sorted({int((ts - t0) // usec) + 1
                   for ts in list(adds) + list(removes)}) if t0 is not None \
        else []
    steps = (bins[-1] + 1) if bins else 1
    if max_steps is not None:
        steps = min(steps, int(max_steps))
    trace = make_trace(latency_source, steps=steps, n=n_max, seed=seed,
                       **trace_kw)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x1E]))
    scenario = ChurnScenario(trace=trace, n0=n0)
    live = scenario.initial_ids()
    events = []
    per_step: dict = {}
    for ts, mids in sorted(adds.items()):
        step = int((ts - t0) // usec) + 1
        per_step.setdefault(step, []).append(("add", len(mids)))
    for ts, mids in sorted(removes.items()):
        step = int((ts - t0) // usec) + 1
        per_step.setdefault(step, []).append(("remove", len(mids)))
    for step in sorted(per_step):
        if step >= steps:
            break
        for op, count in per_step[step]:
            if op == "remove":
                count = min(count, live.size - min_workers)
                if count <= 0:
                    continue
                victims = rng.choice(live, size=count, replace=False)
                event = ChurnEvent(step=step, kind="preempt",
                                   workers=tuple(int(v) for v in victims))
            else:
                count = min(count, n_max - live.size)
                if count <= 0:
                    continue
                event = ChurnEvent(step=step, kind="scale_up", count=count)
            events.append(event)
            live = scenario.apply_event(live, event)
    return ChurnScenario(trace=trace, events=tuple(events), n0=n0)
