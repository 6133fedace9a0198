// Hand-written CUDA kernels of the block-ELL SpMV and of the smoothers built
// around it (sm_90a).
//
// Plain C interface, loaded with ctypes by ops/_cuda.py (one library with
// lattice_kernels.cu, whose lat_error_string names the error codes).
// Every entry point launches on the stream it is given, allocates nothing
// (the torch wrapper passes outputs and buffers), does not synchronise, and
// returns the CUDA error code of its launches (0 = success).
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
// ell_gs and ell_jacobi have no TPU kernel of their own: the JAX package
// composes its smoothers (solvers/smoothers.py) from the SpMV above, one row
// SpMV, one 3x3 adjugate solve and one slice update per color and sweep. On
// this card that composition is launch bound (hundreds of small launches
// per Gauss-Seidel iteration, and masked copies of the whole value tensor
// for the lower and upper triangles), so the same row pass as ell_spmv is
// fused with the solve and the update:
//
//   x_i <- D_i^{-1} (b_i - sum_{k != diag_slot_i} A_ik (x[nbr_ik] mask_ik))
//
// with D_i = values[i, diag_slot_i] and the adjugate solve of ops/ell.py
// (det / (det^2 + 1e-12)). Masked slots are not skipped (a non-finite value
// at a padded slot propagates), and the lower / upper selection of the
// two-stage form costs nothing: the canonical order is color sorted and a
// color is an independent set, so updating x in place, colors last to
// first (backward sweep) then first to last (forward sweep), reads x_prev
// at every neighbour not yet visited and the new value at every neighbour
// already visited, which is (D+U)^{-1}(b - L x_prev) followed by
// (D+L)^{-1}(b - U x_bwd). solvers/smoothers.py checks the independent-set
// property once per operator on the host.
//
// Bound: memory, as the SpMV: every row's values, nbr and mask are read once
// per sweep, 2 * N * K * 44 B per iteration (53 us on the 74k beam's fine
// level at 3.35 TB/s). Between two colors the whole device must be in
// order: one cooperative launch runs all iterations with grid.sync()
// between the color passes (a grid barrier costs less than the launch
// boundary that one plain launch per color would put there: that form
// measured slower on small levels and equal on the largest).
// ell_jacobi reads the previous iterate from a second buffer and swaps the
// two per iteration (one plain launch each). One warp takes a row, lane k
// slot k, a fixed shuffle butterfly sums the slots: run-to-run identical.
//
// No --use_fast_math: the build keeps IEEE arithmetic.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxColors = 16;

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

// One relaxed row (a whole warp calls it with a warp-uniform row): the
// off-diagonal row product against xin, then lane 0 solves the diagonal
// block and writes xout[row]. xin may alias xout (Gauss-Seidel in place:
// rows of one color never read each other). The pass is bound by latency,
// not bytes (a color of the 74k level is ~9k rows for ~8k resident warps),
// so every load that does not depend on another is started up front: a lane
// loads its slot whether or not it is the diagonal's, the diagonal block
// then comes from its lane by shuffle instead of a second trip to memory.
__device__ __forceinline__ void relax_row(
    const float* __restrict__ values, const int* __restrict__ nbr,
    const float* __restrict__ mask, const int* __restrict__ diag_slot,
    const float* __restrict__ b, const float* xin, float* xout, int row,
    int K, int lane) {
    const unsigned full = 0xffffffffu;
    const int ds = diag_slot[row];
    const float bj = lane < 3 ? b[3LL * row + lane] : 0.f;
    float v[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    if (lane < K) {
        const long long e = static_cast<long long>(row) * K + lane;
        const float m = mask[e];
        const long long c = 3LL * nbr[e];
#pragma unroll
        for (int t = 0; t < 9; ++t) v[t] = values[9 * e + t];
        // x changes under the kernel (other blocks write it between two
        // colors): read it from L2, never from this SM's L1
        const float x0 = __ldcg(xin + c) * m, x1 = __ldcg(xin + c + 1) * m,
                    x2 = __ldcg(xin + c + 2) * m;
        if (lane != ds) {
            s0 = v[0] * x0 + v[1] * x1 + v[2] * x2;
            s1 = v[3] * x0 + v[4] * x1 + v[5] * x2;
            s2 = v[6] * x0 + v[7] * x1 + v[8] * x2;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        s0 += __shfl_down_sync(full, s0, off);
        s1 += __shfl_down_sync(full, s1, off);
        s2 += __shfl_down_sync(full, s2, off);
    }
    float d[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) d[t] = __shfl_sync(full, v[t], ds);
    const float b1 = __shfl_sync(full, bj, 1), b2 = __shfl_sync(full, bj, 2);
    if (lane == 0) {
        const float a00 = d[0], a01 = d[1], a02 = d[2], a10 = d[3],
                    a11 = d[4], a12 = d[5], a20 = d[6], a21 = d[7],
                    a22 = d[8];
        const float r0 = bj - s0, r1 = b1 - s1, r2 = b2 - s2;
        // ops/ell.py solve3x3: the adjugate, det / (det^2 + eps)
        const float c00 = a11 * a22 - a12 * a21;
        const float c01 = a12 * a20 - a10 * a22;
        const float c02 = a10 * a21 - a11 * a20;
        const float det = a00 * c00 + a01 * c01 + a02 * c02;
        const float c10 = a02 * a21 - a01 * a22;
        const float c11 = a00 * a22 - a02 * a20;
        const float c12 = a01 * a20 - a00 * a21;
        const float c20 = a01 * a12 - a02 * a11;
        const float c21 = a02 * a10 - a00 * a12;
        const float c22 = a00 * a11 - a01 * a10;
        const float inv_det = det / (det * det + 1e-12f);
        float* out = xout + 3LL * row;
        out[0] = (c00 * r0 + c10 * r1 + c20 * r2) * inv_det;
        out[1] = (c01 * r0 + c11 * r1 + c21 * r2) * inv_det;
        out[2] = (c02 * r0 + c12 * r1 + c22 * r2) * inv_det;
    }
}

struct RelaxArgs {
    const float* values;
    const int* nbr;
    const float* mask;
    const int* diag_slot;
    const float* b;
    int K;
};

// Rows [r0, r1) relaxed against xin into xout, one warp per row.
__global__ void __launch_bounds__(kThreads)
ell_relax_rows_kernel(const RelaxArgs A, const float* xin, float* xout,
                      int r0, int r1) {
    const int lane = threadIdx.x & 31;
    const int row = r0 + blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
    if (row >= r1) return;
    relax_row(A.values, A.nbr, A.mask, A.diag_slot, A.b, xin, xout, row, A.K,
              lane);
}

struct GsArgs {
    RelaxArgs A;
    float* x;
    int offs[kMaxColors + 1];
    int n_colors;
    int iterations;
};

// The whole colored symmetric Gauss-Seidel in one cooperative launch:
// per iteration the colors last to first, then first to last, a grid
// barrier after every non-empty color (the test is uniform over the grid).
__global__ void __launch_bounds__(kThreads)
ell_gs_coop_kernel(const __grid_constant__ GsArgs P) {
    cg::grid_group grid = cg::this_grid();
    const int lane = threadIdx.x & 31;
    const int warp = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
    const int n_warps = gridDim.x * kRowsPerBlock;
    const int nc = P.n_colors;
    for (int it = 0; it < P.iterations; ++it) {
        for (int pass = 0; pass < 2 * nc; ++pass) {
            const int c = pass < nc ? nc - 1 - pass : pass - nc;
            const int r0 = P.offs[c], r1 = P.offs[c + 1];
            if (r1 <= r0) continue;
            for (int row = r0 + warp; row < r1; row += n_warps)
                relax_row(P.A.values, P.A.nbr, P.A.mask, P.A.diag_slot, P.A.b,
                          P.x, P.x, row, P.A.K, lane);
            grid.sync();
        }
    }
}

int blocks_for_rows(int rows) {
    return (rows + kRowsPerBlock - 1) / kRowsPerBlock;
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

// Colored symmetric Gauss-Seidel, `iterations` times, in place on x (N, 3):
// in x0, out the result. offs: n_colors + 1 row offsets of the color
// classes (a host array, copied). One cooperative launch.
// Requires 1 <= K <= 32, 1 <= n_colors <= 16, iterations >= 0, and every
// color an independent set of the matrix graph.
int ell_gs(const float* values, const int* nbr, const float* mask,
           const int* diag_slot, const int* offs, int n_colors,
           const float* b, float* x, int N, int K, int iterations,
           void* stream) {
    if (N < 1 || K < 1 || K > 32 || n_colors < 1 || n_colors > kMaxColors
        || iterations < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (iterations == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    GsArgs P;
    P.A = RelaxArgs{values, nbr, mask, diag_slot, b, K};
    P.x = x;
    int widest = 0;
    for (int c = 0; c <= n_colors; ++c) P.offs[c] = offs[c];
    for (int c = 0; c < n_colors; ++c)
        widest = max(widest, offs[c + 1] - offs[c]);
    P.n_colors = n_colors;
    P.iterations = iterations;
    if (widest == 0) return 0;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ell_gs_coop_kernel, kThreads, 0);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorLaunchOutOfResources;
    if (e != cudaSuccess) return static_cast<int>(e);
    const int want = blocks_for_rows(widest), cap = sms * per_sm;
    void* args[] = {&P};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(ell_gs_coop_kernel),
        dim3(want < cap ? want : cap), dim3(kThreads), args, 0, st);
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : last);
}

// Block Jacobi, `iterations` times: xa (N, 3) holds x0; iteration t reads
// one buffer and writes the other, so the result is in xa for an even
// count and in xb for an odd one.
int ell_jacobi(const float* values, const int* nbr, const float* mask,
               const int* diag_slot, const float* b, float* xa, float* xb,
               int N, int K, int iterations, void* stream) {
    if (N < 1 || K < 1 || K > 32 || iterations < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const RelaxArgs A{values, nbr, mask, diag_slot, b, K};
    for (int it = 0; it < iterations; ++it) {
        ell_relax_rows_kernel<<<blocks_for_rows(N), kThreads, 0, st>>>(
            A, it % 2 ? xb : xa, it % 2 ? xa : xb, 0, N);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
