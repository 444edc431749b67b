"""One public wrapper per kernel, dispatching on the tensors' device.

    CPU tensors   -> the plain PyTorch version in ``kernels.ref`` (the
                     tests; the counterpart of the reference's "xla" /
                     "pallas_interpret" impls)
    CUDA tensors  -> the hand-written CUDA kernel (the counterpart of
                     "pallas"), or an error for inputs it does not take

There is no fallback: a CUDA tensor never reaches the plain version, and
the kernels take fp32 only (``dist.coded_allreduce`` keeps its fp64
differential path on a plain matmul outside these wrappers, as the
reference does).  All inputs of one call must lie on one device.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import batched_decode as _bd
from . import coded_accumulate as _acc
from . import fused_decode_apply as _fused
from . import ref as _ref

__all__ = [
    "batched_onestep_decode", "batched_onestep_decode_ell",
    "coded_accumulate_batched", "fused_decode_apply",
    "KERNELS", "launch_counts", "reset_launch_counts",
]

# name -> the CUDA launcher whose .launches counts its kernel
KERNELS = {
    "batched_onestep_decode": _bd.DENSE,
    "batched_onestep_decode_ell": _bd.ELL,
    "coded_accumulate_batched": _acc.KERNEL,
    "fused_decode_apply": _fused.KERNEL,
}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _device(*xs: torch.Tensor) -> torch.device:
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev


def batched_onestep_decode(G, masks, rhos):
    """V [B, k] = diag(rhos) (masks @ G^T): Algorithm 1 over a mask batch."""
    if _device(G, masks, rhos).type == "cpu":
        return _ref.batched_onestep_decode_ref(G, masks, rhos)
    return _bd.batched_onestep_decode(G, masks, rhos)


def batched_onestep_decode_ell(ell_idx, ell_val, masks, rhos):
    """Sparse batched Algorithm 1 over the row-ELL packing of G."""
    if _device(ell_idx, ell_val, masks, rhos).type == "cpu":
        return _ref.batched_onestep_decode_ell_ref(ell_idx, ell_val, masks,
                                                   rhos)
    return _bd.batched_onestep_decode_ell(ell_idx, ell_val, masks, rhos)


def coded_accumulate_batched(grads, weights):
    """out [B, P] = weights [B, L] @ grads [L, P] -- the coded all-reduce's
    device-local weighted accumulate over a weight-row batch."""
    if _device(grads, weights).type == "cpu":
        return _ref.coded_accumulate_batched_ref(grads, weights)
    return _acc.coded_accumulate_batched(grads, weights)


def fused_decode_apply(messages, masks, scales):
    """out [B, P] = diag(scales) (masks [B, L] @ messages [L, P]) -- the
    one-step decode fused into the accumulate: no weight ensemble."""
    if _device(messages, masks, scales).type == "cpu":
        return _ref.fused_decode_apply_ref(messages, masks, scales)
    return _fused.fused_decode_apply(messages, masks, scales)
