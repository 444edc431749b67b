"""CodedAllReduce: coded gradient aggregation on torch.distributed
(docs/architecture.md §9).

    workers  --(partition_workers)-->  ranks        (contiguous column blocks)
    trace    --(sync policy)------->   masks [S, n]
    masks    --(DecodeEngine)------>   weights [S, n]   (ONE decode_batch)
    rank d   --(local accumulate)-->   Σ_{j∈d} w_j msg_j
    ranks    --(all_reduce SUM)---->   decoded gradient  (on every rank)

Each of the n logical workers (columns of G) is pinned to a lane of one
rank; a rank owns ``lanes = ceil(n / D)`` workers (the last ranks hold
padding lanes when n is not a multiple of D, and contribute exact zeros).
A straggler mask zeroes a worker's decode weight and with it the lane's
contribution; decoding is the summed all-reduce over the ranks.  The
process group is the default one of ``torch.distributed`` (or ``group=``):
NCCL on the card, gloo for the CPU tests.  Without an initialised process
group the aggregation runs on one rank with lanes = n, as the reference
does on one device.

Two aggregation surfaces, both on tensors that stay on their device:

  * :meth:`CodedAllReduce.aggregate_messages_batch` -- the explicit
    message path: a rank combines its local worker messages with the
    [S, n] decode weights in ``kernels.ops.coded_accumulate_batched``,
    then all-reduces.
  * :meth:`CodedAllReduce.aggregate_messages_fused` -- the one-step
    decode fused into the accumulate (``kernels.ops.fused_decode_apply``):
    the weights are rank-1 in the mask, so the [S, n] weight ensemble is
    never built.

fp32 messages go through the kernels; fp64 messages take a plain matmul,
the dtype-preserving path of the fp64 differential tests (the reference's
``jax_enable_x64`` path).  The training surface (``value_and_grad``) comes
with the port of the trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import platform
from ..core.codes import GradientCode
from ..core.decoding import exact_decode_renorm
from ..core.engine import DecodeEngine
from ..kernels import ops

__all__ = [
    "DevicePartition",
    "partition_workers",
    "CodedAllReduce",
]


# --------------------------------------------------------------------------
# worker -> rank partition
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DevicePartition:
    """Static assignment of the n code columns to D device lanes.

    ``worker_ids[d, l]`` is the worker owned by lane l of device d, or
    -1 for a padding lane.  Workers are packed contiguously, so a
    device's workers are one slice ``[d * lanes, min(n, (d + 1) * lanes))``
    of the worker dimension.
    """

    n: int                      # logical workers (columns of G)
    n_devices: int              # world size D
    lanes: int                  # worker slots per device, ceil(n / D)
    worker_ids: np.ndarray      # [D, lanes] int32, -1 = padding lane

    @property
    def padded_n(self) -> int:
        return self.n_devices * self.lanes

    @property
    def lane_mask(self) -> np.ndarray:
        """[D, lanes] bool — True where the lane holds a real worker."""
        return self.worker_ids >= 0

    def local_slice(self, d: int) -> slice:
        """The workers of device d, as a slice of the worker dimension
        (empty on a padding-only device)."""
        lo = min(d * self.lanes, self.n)
        return slice(lo, min(lo + self.lanes, self.n))

    def scatter(self, per_worker: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """[n, ...] per-worker array -> [D, lanes, ...]; pads get `fill`."""
        per_worker = np.asarray(per_worker)
        if per_worker.shape[0] != self.n:
            raise ValueError(f"leading dim {per_worker.shape[0]} != n={self.n}")
        out = np.full((self.padded_n,) + per_worker.shape[1:], fill,
                      dtype=per_worker.dtype)
        ids = self.worker_ids.reshape(-1)
        out[ids >= 0] = per_worker[ids[ids >= 0]]
        return out.reshape((self.n_devices, self.lanes) + per_worker.shape[1:])

    def gather(self, per_device: np.ndarray) -> np.ndarray:
        """[D, lanes, ...] -> [n, ...], dropping padding lanes (inverse
        of :meth:`scatter` for any fill value)."""
        per_device = np.asarray(per_device)
        flat = per_device.reshape((self.padded_n,) + per_device.shape[2:])
        ids = self.worker_ids.reshape(-1)
        out = np.empty((self.n,) + per_device.shape[2:], dtype=per_device.dtype)
        out[ids[ids >= 0]] = flat[ids >= 0]
        return out


def partition_workers(n: int, n_devices: int) -> DevicePartition:
    """Contiguous block partition of n workers over D devices.

    Handles every ragged case: n not a multiple of D (padding lanes),
    D = 1 (everything local), and D > n (trailing devices hold only
    padding and contribute exact zeros to the all-reduce).
    """
    if n <= 0 or n_devices <= 0:
        raise ValueError(f"need n > 0 and n_devices > 0, got ({n}, {n_devices})")
    lanes = max(-(-n // n_devices), 1)
    ids = np.full((n_devices, lanes), -1, dtype=np.int32)
    flat = ids.reshape(-1)
    flat[:n] = np.arange(n, dtype=np.int32)
    return DevicePartition(n=n, n_devices=n_devices, lanes=lanes,
                           worker_ids=ids)


# --------------------------------------------------------------------------
# the coded all-reduce
# --------------------------------------------------------------------------


class CodedAllReduce:
    """Coded data-parallel aggregation for one GradientCode over the ranks
    of a process group.

    Owns the worker->rank partition.  The DecodeEngine is shared with
    (not owned by) the caller so the ClusterSim batch-call invariants
    hold on the engine they observe.
    """

    def __init__(self, code: GradientCode, *,
                 engine: Optional[DecodeEngine] = None,
                 group: Optional[dist.ProcessGroup] = None):
        self.code = code
        self.engine = engine if engine is not None else DecodeEngine(code)
        self.group = group
        if dist.is_available() and dist.is_initialized():
            world, self.rank = dist.get_world_size(group), dist.get_rank(group)
        else:
            world, self.rank = 1, 0
        self.partition = partition_workers(code.n, world)

    @property
    def n_devices(self) -> int:
        return self.partition.n_devices

    # ------------------------------------------------------------------
    # per-step decode weights
    # ------------------------------------------------------------------

    def weights_for_masks(self, masks: np.ndarray, method: str = "onestep",
                          *, renorm: bool = True) -> np.ndarray:
        """[S, n] masks -> [S, n] decode weights in ONE decode_batch call.

        ``renorm`` applies the trainer's exact-decode rescaling
        w <- w * k / sum(G @ w) per step, skipped for all-straggler rows
        where the denominator vanishes.
        """
        masks = np.asarray(masks, dtype=bool)
        if masks.ndim == 1:
            masks = masks[None]
        W = self.engine.decode_batch(masks, method).weights
        return exact_decode_renorm(self.code.G, W) if renorm else W

    def device_weights(self, w: np.ndarray) -> np.ndarray:
        """[n] decode weights -> [D, lanes] (zeros at padding lanes)."""
        return self.partition.scatter(np.asarray(w, dtype=np.float64))

    # ------------------------------------------------------------------
    # message path: explicit per-worker coded gradients
    # ------------------------------------------------------------------

    def _messages(self, messages) -> torch.Tensor:
        if not isinstance(messages, torch.Tensor):
            dev = self.engine.device if self.engine.device is not None \
                else platform.device()
            messages = torch.as_tensor(np.asarray(messages), device=dev)
        if messages.ndim != 2 or messages.shape[0] != self.code.n:
            raise ValueError(f"messages {tuple(messages.shape)} do not match "
                             f"n={self.code.n}")
        return messages.contiguous()

    def _reduce(self, out: torch.Tensor) -> torch.Tensor:
        if self.n_devices > 1:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def aggregate_messages_batch(self, messages, weights) -> torch.Tensor:
        """Decode S steps of per-worker messages over the ranks: [S, P].

        ``messages[j]`` is worker j's coded partial Σ_i G[i,j] g_i (a
        [n, P] tensor, or an array moved to the engine's device);
        ``weights`` is the [S, n] decode-weight ensemble.  Each rank
        combines its local workers' rows with the batched
        weighted-accumulate kernel and the all-reduce completes the
        decode.  The result is a tensor on the messages' device, on every
        rank.
        """
        messages = self._messages(messages)
        weights = np.atleast_2d(np.asarray(weights))
        if weights.shape[1] != self.code.n:
            raise ValueError(f"weights {weights.shape} do not match "
                             f"n={self.code.n}")
        loc = self.partition.local_slice(self.rank)
        S, P = weights.shape[0], messages.shape[1]
        if loc.stop == loc.start:                    # padding-only rank
            out = messages.new_zeros((S, P))
        else:
            m = messages[loc]                        # [L, P] view
            w = torch.as_tensor(np.ascontiguousarray(weights[:, loc]),
                                dtype=messages.dtype, device=m.device)
            if messages.dtype == torch.float64:      # fp64 differential path
                out = w @ m
            else:
                out = ops.coded_accumulate_batched(m, w)
        return self._reduce(out)

    def aggregate_messages_fused(self, messages, masks: np.ndarray, *,
                                 renorm: bool = True) -> torch.Tensor:
        """One-step decode fused into the rank-local accumulate: [S, P].

        Semantically ``aggregate_messages_batch(messages,
        weights_for_masks(masks, 'onestep', renorm=renorm))`` but the
        [S, n] weight ensemble is never materialized: the one-step
        weights are rank-1 in the mask (w = scale * m, see
        ``DecodeEngine.onestep_scales``), so each rank contracts its raw
        0/1 mask lanes against the local messages in a single
        ``kernels.ops.fused_decode_apply`` pass and applies the per-step
        scale at emission.  The all-reduce completes the decode.
        """
        messages = self._messages(messages)
        masks = np.atleast_2d(np.asarray(masks, dtype=bool))
        if masks.shape[1] != self.code.n:
            raise ValueError(f"masks {masks.shape} do not match "
                             f"n={self.code.n}")
        scales = self.engine.onestep_scales(masks, renorm=renorm)
        loc = self.partition.local_slice(self.rank)
        S, P = masks.shape[0], messages.shape[1]
        if loc.stop == loc.start:                    # padding-only rank
            out = messages.new_zeros((S, P))
        else:
            m = messages[loc]
            dev = m.device
            mk = torch.from_numpy(np.ascontiguousarray(masks[:, loc])).to(dev)
            if messages.dtype == torch.float64:      # fp64 differential path
                sc = torch.from_numpy(scales).to(dev)
                out = (sc[:, None] * mk.to(torch.float64)) @ m
            else:
                sc = torch.from_numpy(scales.astype(np.float32)).to(dev)
                out = ops.fused_decode_apply(m, mk, sc)
        return self._reduce(out)

    def aggregate_messages(self, messages, w: np.ndarray) -> torch.Tensor:
        """Single-mask decode of per-worker messages -> [P]."""
        return self.aggregate_messages_batch(messages, np.asarray(w)[None])[0]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"CodedAllReduce(code={self.code.name!r}, n={self.code.n}, "
                f"ranks={self.n_devices}, lanes={self.partition.lanes}, "
                f"rank={self.rank})")
