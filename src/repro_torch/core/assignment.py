"""Task <-> example assignment: how a gradient code meets a physical batch.

The global (physical) batch of B rows is laid out as

    [n workers] x [slots tasks/worker] x [T rows/task-slot]

with B = n * slots * T.  Each slot of worker j holds one of the worker's
assigned tasks (column support of G), so the same *unique* task data is
replicated across all workers assigned that task.  k unique tasks cover
B_unique = k * T distinct examples; redundancy = B / B_unique.

For decode weights w (from repro_torch.core.decoding), the per-slot loss weight

    weight[j, t] = w_j * G[task(j,t), j] / (k * T)

makes  sum_{j,t,rows} weight * loss_row  ==  (decoded approximation of)
the mean loss over the k*T unique examples.  This identity — decode as
loss reweighting — is what lets the whole scheme run inside a vanilla
data-parallel all-reduce (docs/architecture.md §2.1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .codes import GradientCode

__all__ = ["CodedAssignment", "build_assignment"]


@dataclasses.dataclass(frozen=True)
class CodedAssignment:
    """Static (per-run) assignment tables, all numpy, all host-side."""

    code_name: str
    k: int                  # number of tasks
    n: int                  # number of workers (DP groups)
    slots: int              # task slots per worker (max column degree)
    task_ids: np.ndarray    # (n, slots) int32, -1 = empty slot
    coeffs: np.ndarray      # (n, slots) float32, G[task, worker] (0 if empty)
    G: np.ndarray           # (k, n) the code matrix

    @property
    def replication(self) -> float:
        return float((self.task_ids >= 0).sum()) / self.k

    def slot_weights(self, w: np.ndarray, rows_per_slot: int) -> np.ndarray:
        """Per-slot loss weights for decode weights w (n,).

        Normalized so an exact decode (G @ w == 1_k) yields exactly the
        mean loss over the k * rows_per_slot unique examples.
        """
        w = np.asarray(w, dtype=np.float64)
        if w.shape != (self.n,):
            raise ValueError(f"w shape {w.shape} != ({self.n},)")
        denom = float(self.k * rows_per_slot)
        # stays float64: the G coefficients are exact (0/1 codes) and the
        # consumers cast at the device boundary — the fp64 differential
        # tests need the host-side weights unrounded
        sw = (w[:, None] * self.coeffs.astype(np.float64)) / denom
        return np.where(self.task_ids >= 0, sw, 0.0)

    def row_weights(self, w: np.ndarray, rows_per_slot: int) -> np.ndarray:
        """Flat per-row weights of shape (n * slots * rows_per_slot,)."""
        sw = self.slot_weights(w, rows_per_slot)
        return np.repeat(sw.reshape(-1), rows_per_slot)

    def unique_row_of_slot(self, rows_per_slot: int) -> np.ndarray:
        """(n*slots*rows_per_slot,) index into the unique-example space
        [0, k*rows_per_slot) — identifies replicated rows; -1 for padding."""
        base = self.task_ids.reshape(-1).astype(np.int64)
        out = np.empty((self.n * self.slots, rows_per_slot), dtype=np.int64)
        for idx, t in enumerate(base):
            if t < 0:
                out[idx] = -1
            else:
                out[idx] = np.arange(rows_per_slot) + t * rows_per_slot
        return out.reshape(-1)


def build_assignment(code: GradientCode, slots: Optional[int] = None
                     ) -> CodedAssignment:
    """Pack a code's column supports into fixed-width slot tables."""
    G = code.G
    k, n = G.shape
    degrees = (G != 0).sum(axis=0)
    min_slots = int(degrees.max()) if n else 0
    if slots is None:
        slots = max(min_slots, 1)
    if slots < min_slots:
        raise ValueError(f"slots={slots} < max column degree {min_slots}")
    task_ids = np.full((n, slots), -1, dtype=np.int32)
    coeffs = np.zeros((n, slots), dtype=np.float32)
    for j in range(n):
        support = np.flatnonzero(G[:, j])
        task_ids[j, : len(support)] = support
        coeffs[j, : len(support)] = G[support, j]
    return CodedAssignment(
        code_name=code.name, k=k, n=n, slots=slots,
        task_ids=task_ids, coeffs=coeffs, G=G,
    )
