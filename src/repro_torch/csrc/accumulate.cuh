// Shared body of the two gradient-aggregation kernels:
//
//     out[b, p] = scale_b * sum_l w[b, l] * msgs[l, p]           -> [B, P] fp32
//
// with w an fp32 weight matrix and scale 1 (coded_accumulate.cu), or w a
// 0/1 byte mask and scale the per-mask one-step scale (fused_decode_apply.cu).
//
// What bounds it on the H100: memory.  It does 2*B*L flops per column and
// must read L*P message floats and write B*P output floats; at the
// coded all-reduce's shapes (L = 8 workers, B = 16 steps, P = 61,051,392
// parameters of one minicpm-2b layer) that is 5.86 GB against 15.6 GFLOP,
// i.e. ~1.75 ms at 3.35 TB/s and 0.23 ms at 67 fp32 TFLOP/s.
//
// Design: stream the messages from HBM once.  Each 256-thread block owns a
// tile of 1024 consecutive columns (4 per thread, loaded as one float4 when
// P and the pointers allow it) and walks its batch rows 8 at a time with
// 32 register accumulators per thread; the block's weight rows are staged
// in shared memory 64 workers at a time and read as broadcasts.  Message
// tiles re-read for the next 8 rows come back from L1/L2, not HBM.  When
// the column tiles are too few to fill the card (small P, e.g. basis
// gradients), the batch rows are split across blocks as well; blocks that
// share a column tile are adjacent in launch order so their re-reads hit
// L2.  All offsets are 64-bit: L*P and B*P pass 2^31 at the main-path
// shapes.  The ragged column edge falls back to scalar loads and stores;
// no operand is padded.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace accumulate {

constexpr int THREADS = 256;
constexpr int VEC = 4;                       // columns per thread
constexpr int64_t TP = THREADS * VEC;        // columns per block
constexpr int BB = 8;                        // batch rows per register pass
constexpr int LC = 64;                       // workers per staged weight chunk
constexpr int64_t TARGET_BLOCKS = 4 * 132;   // enough blocks to fill 132 SMs

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
    return a < b ? a : b;
}

template <bool MASKED>
__device__ __forceinline__ float weight_at(const void* w, int64_t off) {
    if constexpr (MASKED) {
        return static_cast<const uint8_t*>(w)[off] ? 1.f : 0.f;
    } else {
        return static_cast<const float*>(w)[off];
    }
}

template <bool MASKED>
__global__ void __launch_bounds__(THREADS)
accumulate_kernel(const float* __restrict__ msgs, const void* __restrict__ w,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int64_t B, int64_t L, int64_t P, int64_t rows_per_block,
                  int64_t n_groups, bool vec) {
    __shared__ float ws[BB][LC];
    const int64_t group = blockIdx.x % n_groups;
    const int64_t tile = blockIdx.x / n_groups;
    const int64_t p = tile * TP + static_cast<int64_t>(threadIdx.x) * VEC;
    const int64_t left = P - p;                  // columns this thread may touch
    const bool full = vec && left >= VEC;
    const int64_t b_begin = group * rows_per_block;
    const int64_t b_end = min64(B, b_begin + rows_per_block);

    for (int64_t b0 = b_begin; b0 < b_end; b0 += BB) {
        float acc[BB][VEC];
#pragma unroll
        for (int r = 0; r < BB; ++r)
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[r][q] = 0.f;

        for (int64_t l0 = 0; l0 < L; l0 += LC) {
            __syncthreads();
            for (int e = threadIdx.x; e < BB * LC; e += THREADS) {
                const int r = e / LC, c = e % LC;
                const int64_t b = b0 + r, l = l0 + c;
                ws[r][c] = (b < b_end && l < L) ? weight_at<MASKED>(w, b * L + l)
                                                : 0.f;
            }
            __syncthreads();
            if (left <= 0) continue;
            const int64_t lc = min64(LC, L - l0);
#pragma unroll 8
            for (int64_t c = 0; c < lc; ++c) {
                const float* src = msgs + (l0 + c) * P + p;
                float v[VEC];
                if (full) {
                    const float4 x = __ldg(reinterpret_cast<const float4*>(src));
                    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
                } else {
#pragma unroll
                    for (int q = 0; q < VEC; ++q) v[q] = q < left ? __ldg(src + q) : 0.f;
                }
#pragma unroll
                for (int r = 0; r < BB; ++r) {
                    const float wr = ws[r][c];
#pragma unroll
                    for (int q = 0; q < VEC; ++q) acc[r][q] += wr * v[q];
                }
            }
        }
        if (left <= 0) continue;
#pragma unroll
        for (int r = 0; r < BB; ++r) {
            const int64_t b = b0 + r;
            if (b >= b_end) break;
            const float s = MASKED ? scales[b] : 1.f;
            float* dst = out + b * P + p;
            if (full) {
                *reinterpret_cast<float4*>(dst) =
                    make_float4(acc[r][0] * s, acc[r][1] * s, acc[r][2] * s,
                                acc[r][3] * s);
            } else {
#pragma unroll
                for (int q = 0; q < VEC; ++q)
                    if (q < left) dst[q] = acc[r][q] * s;
            }
        }
    }
}

// Host-side launch: picks the column tiling and the batch split, launches
// on `stream`, and returns cudaGetLastError().
template <bool MASKED>
int launch(const void* msgs, const void* w, const void* scales, void* out,
           int64_t B, int64_t L, int64_t P, void* stream) {
    if (B <= 0 || P <= 0) return 0;
    const int64_t tiles = (P + TP - 1) / TP;
    const int64_t chunks = (B + BB - 1) / BB;
    int64_t groups = (TARGET_BLOCKS + tiles - 1) / tiles;
    groups = groups < 1 ? 1 : (groups > chunks ? chunks : groups);
    const int64_t rows = ((chunks + groups - 1) / groups) * BB;
    groups = (B + rows - 1) / rows;
    // float4 path: every row start (l*P, b*P) and both base pointers must be
    // 16-byte aligned
    const bool vec = P % VEC == 0 &&
                     reinterpret_cast<uintptr_t>(msgs) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    accumulate_kernel<MASKED><<<static_cast<unsigned>(tiles * groups), THREADS,
                                0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(msgs), w, static_cast<const float*>(scales),
        static_cast<float*>(out), B, L, P, rows, groups, vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace accumulate
