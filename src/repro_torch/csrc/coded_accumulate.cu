// Batched coded weighted accumulate, the coded all-reduce's device-local
// decode:
//
//     out[b, p] = sum_l W[b, l] * msgs[l, p]                     -> [B, P] fp32
//
// Replaces repro/kernels/coded_accumulate.py :: coded_accumulate_batched
// (_acc_batch_kernel).  What bounds it on the H100 (memory: the messages
// are read once and the output written once) and how the kernel streams
// the messages is set out in accumulate.cuh, which holds the body shared
// with fused_decode_apply.cu.

#include "accumulate.cuh"

extern "C" int coded_accumulate_batched(const void* msgs, const void* weights,
                                        void* out, int64_t B, int64_t L,
                                        int64_t P, void* stream) {
    return accumulate::launch<false>(msgs, weights, nullptr, out, B, L, P,
                                     stream);
}
