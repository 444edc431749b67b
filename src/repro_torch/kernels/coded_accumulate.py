"""Batched coded weighted accumulate on the card.

    out [B, P] = weights [B, L] @ msgs [L, P]

the coded all-reduce's device-local decode: every weight row (one per
step of a trace) combines the same stack of worker messages.  CUDA kernel
in ``csrc/coded_accumulate.cu`` (body in ``csrc/accumulate.cuh``, whose
note says which Pallas kernel it replaces and what bounds it).  The
wrapper takes fp32 CUDA tensors only; ``kernels.ops`` routes CPU tensors
to ``kernels.ref`` and keeps fp64 on a plain matmul.
"""

from __future__ import annotations

import torch

from .cuda import CudaKernel, check

__all__ = ["coded_accumulate_batched", "KERNEL"]

KERNEL = CudaKernel("coded_accumulate", "coded_accumulate_batched", "pppiii")


def coded_accumulate_batched(grads: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """weights @ grads.  grads [L, P] fp32, weights [B, L] fp32 ->
    [B, P] fp32."""
    dev = grads.device
    L, P = grads.shape
    B = weights.shape[0]
    check(grads, "grads", torch.float32, (L, P), dev)
    check(weights, "weights", torch.float32, (B, L), dev)
    out = torch.empty((B, P), dtype=torch.float32, device=dev)
    if out.numel():
        KERNEL(dev, grads.data_ptr(), weights.data_ptr(), out.data_ptr(),
               B, L, P)
    return out
