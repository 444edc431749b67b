"""Plain PyTorch versions of the port's four CUDA kernels.

Each function is the semantic ground truth of one kernel: the wrappers in
``kernels.ops`` run it for tensors that lie on the CPU (the tests), and
``chip_smoke.py`` holds each CUDA kernel against it on the card.  Written
in the most obvious form, in fp32 like the kernels; the two aggregation
functions follow their inputs up to fp64, the dtype-preserving path of
the fp64 differential tests.
"""

from __future__ import annotations

import torch

__all__ = [
    "batched_onestep_decode_ref", "batched_onestep_decode_ell_ref",
    "coded_accumulate_batched_ref", "fused_decode_apply_ref",
]


def batched_onestep_decode_ref(G: torch.Tensor, masks: torch.Tensor,
                               rhos: torch.Tensor) -> torch.Tensor:
    """V[b] = rho_b * G @ m_b.  G [k,n], masks [B,n], rhos [B] -> [B,k]."""
    V = masks.to(torch.float32) @ G.to(torch.float32).T
    return rhos.to(torch.float32)[:, None] * V


def batched_onestep_decode_ell_ref(ell_idx: torch.Tensor,
                                   ell_val: torch.Tensor,
                                   masks: torch.Tensor,
                                   rhos: torch.Tensor) -> torch.Tensor:
    """The same V through the row-ELL packing of G: gather each mask at
    row i's support ``ell_idx[i]`` and weight by ``ell_val[i]``.  Padding
    entries (idx 0, val 0) add exactly 0.  -> [B, k]."""
    B = masks.shape[0]
    gathered = masks.to(torch.float32)[:, ell_idx.reshape(-1).long()]
    v = (gathered.reshape(B, *ell_idx.shape)
         * ell_val.to(torch.float32)[None]).sum(dim=2)
    return rhos.to(torch.float32)[:, None] * v


def _acc_dtype(*xs: torch.Tensor) -> torch.dtype:
    dt = torch.float32
    for x in xs:
        dt = torch.promote_types(dt, x.dtype)
    return dt


def coded_accumulate_batched_ref(grads: torch.Tensor,
                                 weights: torch.Tensor) -> torch.Tensor:
    """weights @ grads per weight row.  grads [L, P], weights [B, L]."""
    dt = _acc_dtype(grads, weights)
    return weights.to(dt) @ grads.to(dt)


def fused_decode_apply_ref(messages: torch.Tensor, masks: torch.Tensor,
                           scales: torch.Tensor) -> torch.Tensor:
    """out[b] = scales[b] * (masks[b] @ messages).  messages [L, P],
    masks [B, L], scales [B] -> [B, P]."""
    dt = _acc_dtype(messages, scales)
    w = scales.to(dt)[:, None] * masks.to(dt)
    return w @ messages.to(dt)
