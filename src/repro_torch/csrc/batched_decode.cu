// Batched one-step decode (Algorithm 1) over a [B, n] straggler-mask batch:
//
//     V[b, i] = rho_b * sum_j G[i, j] * m[b, j]                  -> [B, k] fp32
//
// Two kernels with a plain C interface (loaded with ctypes by
// repro_torch/kernels/batched_decode.py):
//
//   onestep_dense  replaces repro/kernels/batched_decode.py ::
//                  batched_onestep_decode (_onestep_batch_kernel).
//   onestep_ell    replaces repro/kernels/batched_decode.py ::
//                  batched_onestep_decode_ell (_onestep_ell_kernel).
//
// What bounds them on the H100: at the main-path shapes (B = 1000-2000
// masks, k = n = 256) the dense form does 2*B*k*n = 0.13-0.26 GFLOP on
// ~1.5-3 MB of operands, so its floor is the fp32 CUDA-core rate (67
// TFLOP/s: ~2-4 us) and the ELL form moves and computes even less; both
// are dominated by the launch (~several us), not by bytes or FLOPs.
//
// Design: no tensor cores (fp32 in, fp32 accumulate, exact for 0/1 codes).
//   * dense: a classic shared-memory tiled product.  A 32 x 32 output tile
//     (32 masks x 32 rows of G) per 256-thread block; the contracted worker
//     dimension j streams through in 32-wide chunks staged in shared
//     memory (masks widened from bytes to fp32 there).  Each thread keeps
//     4 accumulators and sums j in order, so 0/1 products add exactly.
//     The ragged edge is masked in the loads (zeros) and the stores, not
//     padded: any n, k, B >= 1.
//   * ELL: one thread per (b, i) pair walks row i's rmax packed entries
//     and reads m[b, idx] straight from global memory (a mask row is n
//     bytes and stays L1/L2-resident), so n is unbounded -- the Pallas
//     kernel's [bb, n] VMEM mask block has no counterpart.  Padding
//     entries (idx 0, val 0) add exactly 0; out-of-range indices are
//     skipped rather than read.
//
// Both launch on the caller's stream and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 32;   // masks per tile
constexpr int TI = 32;   // rows of G per tile
constexpr int TJ = 32;   // workers per staged chunk
constexpr int TY = 8;    // thread rows; each thread owns TB / TY outputs

__global__ void __launch_bounds__(TI * TY)
onestep_dense_kernel(const float* __restrict__ G,
                     const uint8_t* __restrict__ masks,
                     const float* __restrict__ rhos,
                     float* __restrict__ out,
                     int64_t B, int64_t k, int64_t n) {
    __shared__ float ms[TB][TJ + 1];
    __shared__ float gs[TI][TJ + 1];
    const int tx = threadIdx.x;              // row of G within the tile
    const int ty = threadIdx.y;
    const int64_t b0 = static_cast<int64_t>(blockIdx.x) * TB;
    const int64_t i0 = static_cast<int64_t>(blockIdx.y) * TI;
    float acc[TB / TY] = {0.f, 0.f, 0.f, 0.f};

    for (int64_t j0 = 0; j0 < n; j0 += TJ) {
        const int64_t j = j0 + tx;
        for (int r = ty; r < TB; r += TY) {
            const int64_t b = b0 + r;
            ms[r][tx] = (b < B && j < n && masks[b * n + j]) ? 1.f : 0.f;
            const int64_t i = i0 + r;
            gs[r][tx] = (i < k && j < n) ? G[i * n + j] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int jj = 0; jj < TJ; ++jj) {
            const float g = gs[tx][jj];
#pragma unroll
            for (int q = 0; q < TB / TY; ++q) acc[q] += ms[ty + TY * q][jj] * g;
        }
        __syncthreads();
    }
    const int64_t i = i0 + tx;
    if (i >= k) return;
#pragma unroll
    for (int q = 0; q < TB / TY; ++q) {
        const int64_t b = b0 + ty + TY * q;
        if (b < B) out[b * k + i] = acc[q] * rhos[b];
    }
}

__global__ void onestep_ell_kernel(const int32_t* __restrict__ idx,
                                   const float* __restrict__ val,
                                   const uint8_t* __restrict__ masks,
                                   const float* __restrict__ rhos,
                                   float* __restrict__ out,
                                   int64_t B, int64_t k, int64_t rmax,
                                   int64_t n) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= B * k) return;
    const int64_t b = t / k;
    const int64_t i = t - b * k;
    const uint8_t* m = masks + b * n;
    const int32_t* ix = idx + i * rmax;
    const float* v = val + i * rmax;
    float acc = 0.f;
    for (int64_t r = 0; r < rmax; ++r) {
        const int64_t j = ix[r];
        if (j >= 0 && j < n && m[j]) acc += v[r];
    }
    out[t] = acc * rhos[b];
}

}  // namespace

extern "C" int onestep_dense(const void* G, const void* masks, const void* rhos,
                             void* out, int64_t B, int64_t k, int64_t n,
                             void* stream) {
    if (B <= 0 || k <= 0) return 0;
    const dim3 block(TI, TY);
    const dim3 grid(static_cast<unsigned>((B + TB - 1) / TB),
                    static_cast<unsigned>((k + TI - 1) / TI));
    onestep_dense_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(G), static_cast<const uint8_t*>(masks),
        static_cast<const float*>(rhos), static_cast<float*>(out), B, k, n);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int onestep_ell(const void* idx, const void* val, const void* masks,
                           const void* rhos, void* out, int64_t B, int64_t k,
                           int64_t rmax, int64_t n, void* stream) {
    if (B <= 0 || k <= 0) return 0;
    constexpr int threads = 256;
    const int64_t blocks = (B * k + threads - 1) / threads;
    onestep_ell_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(idx), static_cast<const float*>(val),
        static_cast<const uint8_t*>(masks), static_cast<const float*>(rhos),
        static_cast<float*>(out), B, k, rmax, n);
    return static_cast<int>(cudaGetLastError());
}
