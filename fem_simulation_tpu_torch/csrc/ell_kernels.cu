// Hand-written CUDA kernel of the block-ELL SpMV (sm_90a).
//
// Plain C interface, loaded with ctypes by ops/_cuda.py (one library with
// lattice_kernels.cu, whose lat_error_string names the error codes).
// The entry point launches on the stream it is given, allocates nothing
// (the torch wrapper passes the output), does not synchronise, and returns
// the CUDA error code of its launch (0 = success).
//
// ell_spmv replaces spmv_lanes -> _spmv_lanes_kernel (pallas_call at
// fem_simulation_tpu/ops/pallas_kernels.py:68, kernel at :34), which is the
// block-ELL SpMV of ops/ell.py:29-51 in a lanes layout. It computes, for the
// rows n in [r0, r1),
//
//   y[n - r0, j] = sum_k sum_i values[n, k, j, i] * (x[nbr[n, k], i] * mask[n, k])
//
// with values (N, K, 3, 3), nbr (N, K) int32, mask (N, K) float32, x (N, 3).
// The mask multiplies the gathered x as ops/ell.py:36 does, and masked slots
// are not skipped, so a non-finite value at a padded slot propagates.
//
// Bound on this card: memory. A row of a hex-mesh matrix has K <= 27 slots:
// 27 * 36 B of values + 27 * 8 B of nbr and mask, ~1.2 KB, against 27 * 21
// flops, so the 74k-vertex beam's fine level moves ~88 MB, ~26 us at
// 3.35 TB/s; x (12 B a vertex) is gathered from L2.
//
// Design: the TPU kernel streamed one stencil slot at a time across all
// rows (full-width vector ops, because Mosaic had no wide gather). A GPU
// gathers natively, so here one warp takes one row and lane k takes slot k
// (K <= 32): the warp's loads of values, nbr and mask cover the row's
// contiguous bytes, each lane gathers its neighbour's 3 floats and forms the
// slot's 3 partial outputs, and a fixed butterfly of shuffles sums the slots.
// The summation order is fixed, so the result is run-to-run identical. No
// atomics, no shared memory.
//
// No --use_fast_math: the build keeps IEEE arithmetic.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const float* __restrict__ values, const int* __restrict__ nbr,
                const float* __restrict__ mask, const float* __restrict__ x,
                float* __restrict__ y, int r0, int r1, int K) {
    const int lane = threadIdx.x & 31;
    const int row = r0 + blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
    if (row >= r1) return;  // the row is uniform across the warp
    float y0 = 0.f, y1 = 0.f, y2 = 0.f;
    if (lane < K) {
        const long long e = static_cast<long long>(row) * K + lane;
        const float m = mask[e];
        const long long c = 3LL * nbr[e];
        const float x0 = x[c] * m, x1 = x[c + 1] * m, x2 = x[c + 2] * m;
        const float* v = values + 9 * e;
        y0 = v[0] * x0 + v[1] * x1 + v[2] * x2;
        y1 = v[3] * x0 + v[4] * x1 + v[5] * x2;
        y2 = v[6] * x0 + v[7] * x1 + v[8] * x2;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        y0 += __shfl_down_sync(0xffffffffu, y0, off);
        y1 += __shfl_down_sync(0xffffffffu, y1, off);
        y2 += __shfl_down_sync(0xffffffffu, y2, off);
    }
    if (lane == 0) {
        float* out = y + 3LL * (row - r0);
        out[0] = y0;
        out[1] = y1;
        out[2] = y2;
    }
}

}  // namespace

extern "C" {

// y: (r1 - r0, 3). Requires 0 <= r0 < r1, 1 <= K <= 32 and every nbr entry
// of rows [r0, r1) a row of x.
int ell_spmv(const float* values, const int* nbr, const float* mask,
             const float* x, float* y, int r0, int r1, int K, void* stream) {
    if (r1 <= r0 || K < 1 || K > 32)
        return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (r1 - r0 + kRowsPerBlock - 1) / kRowsPerBlock;
    ell_spmv_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        values, nbr, mask, x, y, r0, r1, K);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
