"""Fused one-step decode-apply on the card.

    out [B, P] = diag(scales) (masks [B, L] @ msgs [L, P])

For the one-step decoder the weights are rank-1 in the 0/1 mask
(w_b = s_b m_b), so the decode rides the accumulate and the [B, L] weight
matrix is never built.  CUDA kernel in ``csrc/fused_decode_apply.cu``
(body in ``csrc/accumulate.cuh``, whose note says which Pallas kernel it
replaces and what bounds it).  The wrapper takes CUDA tensors only;
``kernels.ops`` routes CPU tensors to ``kernels.ref``.
"""

from __future__ import annotations

import torch

from .cuda import CudaKernel, check

__all__ = ["fused_decode_apply", "KERNEL"]

KERNEL = CudaKernel("fused_decode_apply", "fused_decode_apply", "ppppiii")


def fused_decode_apply(messages: torch.Tensor, masks: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """scales[b] * (masks[b] @ messages).  messages [L, P] fp32, masks
    [B, L] bool, scales [B] fp32 -> [B, P] fp32."""
    dev = messages.device
    L, P = messages.shape
    B = masks.shape[0]
    check(messages, "messages", torch.float32, (L, P), dev)
    check(masks, "masks", torch.bool, (B, L), dev)
    check(scales, "scales", torch.float32, (B,), dev)
    out = torch.empty((B, P), dtype=torch.float32, device=dev)
    if out.numel():
        KERNEL(dev, messages.data_ptr(), masks.data_ptr(), scales.data_ptr(),
               out.data_ptr(), B, L, P)
    return out
