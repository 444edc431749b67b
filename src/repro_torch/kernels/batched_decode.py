"""Batched one-step decode on the card: one launch, B straggler masks.

    batched_onestep_decode      V = diag(rho) M G^T                [B, k]
    batched_onestep_decode_ell  the same V through the row-ELL packing
                                of G (``GradientCode.ell()``): reads
                                B*k*rmax mask entries instead of the B*k*n
                                dense product

CUDA kernels in ``csrc/batched_decode.cu`` (their note says which Pallas
kernels they replace and what bounds them).  These wrappers take CUDA
tensors only and check them; ``kernels.ops`` routes CPU tensors to the
plain versions in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from .cuda import CudaKernel, check

__all__ = ["batched_onestep_decode", "batched_onestep_decode_ell",
           "DENSE", "ELL"]

DENSE = CudaKernel("batched_decode", "onestep_dense", "ppppiii")
ELL = CudaKernel("batched_decode", "onestep_ell", "pppppiiii")


def batched_onestep_decode(G: torch.Tensor, masks: torch.Tensor,
                           rhos: torch.Tensor) -> torch.Tensor:
    """V[b] = rho_b * G @ m_b.  G [k, n] fp32, masks [B, n] bool,
    rhos [B] fp32 -> [B, k] fp32."""
    dev = G.device
    k, n = G.shape
    B = masks.shape[0]
    check(G, "G", torch.float32, (k, n), dev)
    check(masks, "masks", torch.bool, (B, n), dev)
    check(rhos, "rhos", torch.float32, (B,), dev)
    out = torch.empty((B, k), dtype=torch.float32, device=dev)
    if out.numel():
        DENSE(dev, G.data_ptr(), masks.data_ptr(), rhos.data_ptr(),
              out.data_ptr(), B, k, n)
    return out


def batched_onestep_decode_ell(ell_idx: torch.Tensor, ell_val: torch.Tensor,
                               masks: torch.Tensor,
                               rhos: torch.Tensor) -> torch.Tensor:
    """Sparse batched Algorithm 1.  ell_idx [k, rmax] int32 (column
    indices, 0-padded), ell_val [k, rmax] fp32 (0-padded), masks [B, n]
    bool, rhos [B] fp32 -> [B, k] fp32."""
    dev = ell_idx.device
    k, rmax = ell_idx.shape
    B, n = masks.shape
    check(ell_idx, "ell_idx", torch.int32, (k, rmax), dev)
    check(ell_val, "ell_val", torch.float32, (k, rmax), dev)
    check(masks, "masks", torch.bool, (B, n), dev)
    check(rhos, "rhos", torch.float32, (B,), dev)
    out = torch.empty((B, k), dtype=torch.float32, device=dev)
    if out.numel():
        ELL(dev, ell_idx.data_ptr(), ell_val.data_ptr(), masks.data_ptr(),
            rhos.data_ptr(), out.data_ptr(), B, k, rmax, n)
    return out
