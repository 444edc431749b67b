// Fused one-step decode-apply: the decode weights w_b = s_b * m_b are
// rank-1 in the 0/1 mask, so the decode rides the accumulate and no [B, L]
// weight matrix is built:
//
//     out[b, p] = s_b * sum_l m[b, l] * msgs[l, p]               -> [B, P] fp32
//
// Replaces repro/kernels/fused_decode_apply.py :: fused_decode_apply
// (_fused_kernel).  The mask bytes are widened to 0/1 floats as they are
// staged in shared memory and the scale is applied once at the store.
// What bounds it on the H100 (memory, exactly as the weighted accumulate)
// and how the kernel streams the messages is set out in accumulate.cuh,
// which holds the body shared with coded_accumulate.cu.

#include "accumulate.cuh"

extern "C" int fused_decode_apply(const void* msgs, const void* masks,
                                  const void* scales, void* out, int64_t B,
                                  int64_t L, int64_t P, void* stream) {
    return accumulate::launch<true>(msgs, masks, scales, out, B, L, P, stream);
}
