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
// Design: the TPU kernel streamed one stencil slot at a time across all
// rows (full-width vector ops, because Mosaic had no wide gather). A GPU
// gathers natively, so here a group of L lanes takes one row, L the
// smallest power of two >= K (the C entry picks it from K: 8 for the
// cloth's K = 7, 32 for a hex mesh's K = 27), and lane k takes slot k: the
// group's loads of values, nbr and mask cover the row's contiguous bytes,
// each lane gathers its neighbour's 3 floats and forms the slot's 3 partial
// outputs, and a fixed butterfly of width L sums the slots. The summation
// order is fixed, so the result is run-to-run identical; for K <= L < 32
// it is also the whole-warp butterfly's (whose first steps add the idle
// lanes' exact zeros), up to the sign of a zero. No atomics, no shared
// memory.
//
// What bounds it on this card. At K = 27 (the hex meshes): memory. A row
// is 27 * 36 B of values + 27 * 8 B of nbr and mask, ~1.2 KB, against
// 27 * 18 flops, so the 74k-vertex beam's fine level moves ~88 MB, ~26 us
// at 3.35 TB/s; x (12 B a vertex) is gathered from L2. At K = 7 (the
// cloth, 4k-17k rows, 0.4-1.7 us of bytes): latency. A row is two
// dependent memory trips (nbr and mask, then the gather of x); a whole
// warp a row left 25 of its 32 lanes idle and put 8 rows in a 256-thread
// block, so the 128x128 cloth's 2,081 blocks ran in two waves of the 1,056
// that 132 SMs hold. Eight lanes a row put 32 rows in a block: 521 blocks,
// one wave. (A thread a row, its slots summed in the same order, measured
// slower: 3.6-3.9 us against 1.6-2.4 at the cloth's shapes.)
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
// The backward kernels (no TPU kernel of their own: the JAX package gets
// these gradients from jax.grad of the SpMV and of the smoother's
// composition, models/train_interp.py:51-79) make the SpMV and the Jacobi
// smoother differentiable under torch.autograd (ops/ell_kernels.py,
// EllSpmvFn / EllJacobiFn):
//
//   ell_spmv_t      gx[j] = alpha * sum over (i, k) with nbr[i, k] = j of
//                   mask[i, k] * values[i, k]^T g[i]   (optionally leaving
//                   out the slot k = skip[i] of every row)
//   ell_outer       gv[i, k] (+)= alpha * g[i] (x) (x[nbr[i, k]] mask[i, k]),
//                   j-major as the forward reads values (optionally leaving
//                   slot skip[i] of every row untouched): the values'
//                   gradient of the SpMV. The SpMV's lane groups, lane k
//                   reading slot k's nbr and mask once and gathering its x
//                   once (the first form took a thread a float: nine reads
//                   of them a slot and two integer divisions a float).
//   ell_jacobi_bwd  the adjoint of one Jacobi iteration
//                   x_{t+1} = D^{-1} (b - O x_t) in one launch: lam =
//                   D^{-T} gbar by the forward's own adjugate formula,
//                   gb (+)= lam, the exact derivative of that formula with
//                   respect to the diagonal block (+)= into
//                   gv[i, diag_slot[i]], and -lam (x) x_t into the
//                   off-diagonal slots: the products ell_outer would form,
//                   from the x_t[nbr] mask its lanes already hold for the
//                   residual (from a zero start x_t is not read: the
//                   residual is b and the products are -lam (x) 0, which
//                   an accumulating call does not add).
//
// Both write a row's values gradient through outer_row: the row's group
// writes the row's 9 K contiguous floats, float t by lane t mod L, its
// slot's x_t[nbr] mask by shuffle, so a warp's stores are contiguous.
// Bound: memory, the N K 36 B of the gradient written.
//
// The rest of a Jacobi iteration's adjoint is ell_spmv_t (gbar_t =
// -O^T lam, the diagonal slot left out), launched only where an earlier
// iterate or x_0 takes a gradient. The transposed product is a gather, not
// a scatter: a transpose table built once on the host lists, for every
// column j, the flat entries e = i * K + k with nbr[i, k] = j in increasing
// e, padded with -1. The ELL tables pad a row with slots that point at the
// row itself, so for a structurally symmetric matrix every column has
// exactly K entries and the table is (N, K). One warp takes a column, lane
// t the entries t, t + 32, ..., a fixed butterfly sums them: no float
// atomics, and the result repeats bit for bit. Bound: memory, as the
// forward (the values are read once more, through the table).
//
// No --use_fast_math: the build keeps IEEE arithmetic.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxColors = 16;

// A group of L lanes a row (L a power of two >= K), lane k slot k; a warp
// holds 32 / L rows. The warp leaves only when all of its rows lie past r1
// (the shuffles need every lane of the warp), and a row's group reduces
// with a butterfly of width L.
template <int L>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const float* __restrict__ values, const int* __restrict__ nbr,
                const float* __restrict__ mask, const float* __restrict__ x,
                float* __restrict__ y, int r0, int r1, int K) {
    constexpr int kRows = kThreads / L;
    const int lane = threadIdx.x & (L - 1);
    if (r0 + static_cast<int>(blockIdx.x) * kRows
            + static_cast<int>(threadIdx.x & ~31u) / L >= r1)
        return;  // every row of the warp lies past r1
    const int row = r0 + blockIdx.x * kRows + threadIdx.x / L;
    float y0 = 0.f, y1 = 0.f, y2 = 0.f;
    if (row < r1 && lane < K) {
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
    for (int off = L / 2; off > 0; off >>= 1) {
        y0 += __shfl_down_sync(0xffffffffu, y0, off, L);
        y1 += __shfl_down_sync(0xffffffffu, y1, off, L);
        y2 += __shfl_down_sync(0xffffffffu, y2, off, L);
    }
    if (row < r1 && lane == 0) {
        float* out = y + 3LL * (row - r0);
        out[0] = y0;
        out[1] = y1;
        out[2] = y2;
    }
}

// Row i's slots of gv (+)= alpha * g_i (x) xm_k, lane k of the row's group
// of L lanes holding xm_k = x[nbr[i, k]] mask[i, k]; slot `skip` (-1: none)
// is left as it is, and so is every slot of a row that is not live (whose
// lanes still take part in the shuffles). The group writes the row's 9 K
// contiguous floats, float t by lane t mod L with its slot's xm by
// shuffle, so a warp's stores are contiguous. (Each lane writing its own
// slot's 36 bytes, 9 stores a lane 36 bytes apart, measured 1.8-3.5 times
// slower.) Each product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: never contracted into an FMA), as the plain version's
// alpha * (g * xm) and out + p are, whether alpha is a constant here or an
// argument.
template <int L>
__device__ __forceinline__ void outer_row(
    float* gv_row, float g0, float g1, float g2, float xm0, float xm1,
    float xm2, int K, int skip, float alpha, int accumulate, bool live,
    int lane) {
    const int total = 9 * K;
    for (int t0 = 0; t0 < total; t0 += L) {  // uniform across the warp
        const int t = t0 + lane;
        const int slot = t / 9;
        const int src = slot < K ? slot : K - 1;
        const float a0 = __shfl_sync(0xffffffffu, xm0, src, L);
        const float a1 = __shfl_sync(0xffffffffu, xm1, src, L);
        const float a2 = __shfl_sync(0xffffffffu, xm2, src, L);
        if (live && t < total && slot != skip) {
            const int r = t - 9 * slot, j = r / 3, l = r - 3 * j;
            const float xm = l == 0 ? a0 : (l == 1 ? a1 : a2);
            const float gj = j == 0 ? g0 : (j == 1 ? g1 : g2);
            const float p = __fmul_rn(alpha, __fmul_rn(gj, xm));
            gv_row[t] = accumulate ? __fadd_rn(gv_row[t], p) : p;
        }
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

// gx[col] = alpha * sum of mask[e] values[e]^T g[e / K] over the entries e
// of the column's transpose-table row (-1: padding), one warp a column.
__global__ void __launch_bounds__(kThreads)
ell_spmv_t_kernel(const float* __restrict__ values,
                  const float* __restrict__ mask, const int* __restrict__ tt,
                  const int* __restrict__ skip, const float* __restrict__ g,
                  float* __restrict__ gx, float alpha, int N, int K, int Kt) {
    const int lane = threadIdx.x & 31;
    const int col = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
    if (col >= N) return;  // the column is uniform across the warp
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int t = lane; t < Kt; t += 32) {
        const int e = tt[static_cast<long long>(col) * Kt + t];
        if (e < 0) continue;
        const int i = e / K;
        if (skip != nullptr && e - i * K == skip[i]) continue;
        const float m = mask[e];
        const float* v = values + 9LL * e;
        const float g0 = g[3LL * i], g1 = g[3LL * i + 1], g2 = g[3LL * i + 2];
        s0 += (v[0] * g0 + v[3] * g1 + v[6] * g2) * m;
        s1 += (v[1] * g0 + v[4] * g1 + v[7] * g2) * m;
        s2 += (v[2] * g0 + v[5] * g1 + v[8] * g2) * m;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        s0 += __shfl_down_sync(0xffffffffu, s0, off);
        s1 += __shfl_down_sync(0xffffffffu, s1, off);
        s2 += __shfl_down_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
        float* out = gx + 3LL * col;
        out[0] = alpha * s0;
        out[1] = alpha * s1;
        out[2] = alpha * s2;
    }
}

// gv[e, j, l] (+)= alpha * (g[i, j] * (x[nbr[e], l] * mask[e])), e = i K + k:
// a group of L lanes a row (L a power of two >= K), lane k reads slot k's
// nbr and mask once and gathers its x once; outer_row stores. Slot skip[i]
// of row i is left as it is.
template <int L>
__global__ void __launch_bounds__(kThreads)
ell_outer_kernel(const float* __restrict__ g, const int* __restrict__ nbr,
                 const float* __restrict__ mask, const float* __restrict__ x,
                 const int* __restrict__ skip, float alpha, int accumulate,
                 float* __restrict__ gv, int N, int K) {
    constexpr int kRows = kThreads / L;
    const int lane = threadIdx.x & (L - 1);
    if (static_cast<int>(blockIdx.x) * kRows
            + static_cast<int>(threadIdx.x & ~31u) / L >= N)
        return;  // every row of the warp lies past N
    const int i = blockIdx.x * kRows + threadIdx.x / L;
    const bool live = i < N;
    float xm0 = 0.f, xm1 = 0.f, xm2 = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f;
    int sk = -1;
    if (live) {
        if (lane < K) {
            const long long e = static_cast<long long>(i) * K + lane;
            const float m = mask[e];
            const long long c = 3LL * nbr[e];
            xm0 = x[c] * m;
            xm1 = x[c + 1] * m;
            xm2 = x[c + 2] * m;
        }
        g0 = g[3LL * i];
        g1 = g[3LL * i + 1];
        g2 = g[3LL * i + 2];
        if (skip != nullptr) sk = skip[i];
    }
    outer_row<L>(gv + 9LL * i * K, g0, g1, g2, xm0, xm1, xm2, K,
                             sk, alpha, accumulate, live, lane);
}

// The adjoint of one Jacobi iteration at a row (one warp a row, lane k
// slot k, as relax_row): lam = s C gbar with C the cofactor matrix of the
// diagonal block D and s = det / (det^2 + eps), the transpose of the
// forward's x = s C^T r. Every lane computes lam (the same operations on the
// same shuffled inputs, so the same bits); lane 0 stores it. With gv given,
// the forward's residual r = b - sum_{k != ds} A_k (xt[nbr_k] m_k) is
// recomputed (r = b from a zero start, xt null: no x_t is read) and the
// exact derivative of x = s(det) C(D)^T r with respect to D goes to the
// diagonal slot: row p of it is
//   s (r_{p-1} (D_{p+1} x gbar) + r_{p+1} (gbar x D_{p+2}))
//     + s'(det) (r . C gbar) C_p,        s' = (eps - det^2) / (det^2 + eps)^2
// (indices mod 3; row n of C is D_{n+1} x D_{n+2}). With offdiag (gv given,
// and xt or a storing call: the C entry sets it), the other
// slots (+)= -(lam (x) xm_k), xm_k = xt[nbr_k] m_k already in lane k's
// registers (zero from a zero start): what ell_outer(lam, ..., xt,
// skip = diag_slot, alpha = -1) writes, by outer_row, in the same launch.
__global__ void __launch_bounds__(kThreads)
ell_jacobi_bwd_kernel(const RelaxArgs A, const float* __restrict__ xt,
                      const float* __restrict__ gbar, float* __restrict__ lam,
                      float* __restrict__ gb, float* __restrict__ gv,
                      int accumulate, int offdiag, int N) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
    if (row >= N) return;
    const int K = A.K;
    const int ds = A.diag_slot[row];
    const float bj = lane < 3 ? A.b[3LL * row + lane] : 0.f;
    const float gj = lane < 3 ? gbar[3LL * row + lane] : 0.f;
    float v[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f;  // xt[nbr] mask of the lane's slot
    if (lane < K) {
        const long long e = static_cast<long long>(row) * K + lane;
        if (gv != nullptr && xt != nullptr) {  // the whole row: the residual
#pragma unroll
            for (int t = 0; t < 9; ++t) v[t] = A.values[9 * e + t];
            const float m = A.mask[e];
            const long long c = 3LL * A.nbr[e];
            x0 = xt[c] * m;
            x1 = xt[c + 1] * m;
            x2 = xt[c + 2] * m;
            if (lane != ds) {
                s0 = v[0] * x0 + v[1] * x1 + v[2] * x2;
                s1 = v[3] * x0 + v[4] * x1 + v[5] * x2;
                s2 = v[6] * x0 + v[7] * x1 + v[8] * x2;
            }
        } else if (lane == ds) {
#pragma unroll
            for (int t = 0; t < 9; ++t) v[t] = A.values[9 * e + t];
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
    const float g0 = __shfl_sync(full, gj, 0), g1 = __shfl_sync(full, gj, 1),
                g2 = __shfl_sync(full, gj, 2);
    const float a00 = d[0], a01 = d[1], a02 = d[2], a10 = d[3], a11 = d[4],
                a12 = d[5], a20 = d[6], a21 = d[7], a22 = d[8];
    // ops/ell.py solve3x3: the cofactors, det / (det^2 + eps)
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
    const float den = det * det + 1e-12f;
    const float inv_det = det / den;
    const float u0 = c00 * g0 + c01 * g1 + c02 * g2;
    const float u1 = c10 * g0 + c11 * g1 + c12 * g2;
    const float u2 = c20 * g0 + c21 * g1 + c22 * g2;
    const float l0 = u0 * inv_det, l1 = u1 * inv_det, l2 = u2 * inv_det;
    if (offdiag)  // uniform across the warp
        outer_row<32>(gv + 9 * (static_cast<long long>(row) * K), l0, l1,
                      l2, x0, x1, x2, K, ds, -1.0f, accumulate, true, lane);
    if (lane != 0) return;
    float* lo = lam + 3LL * row;
    lo[0] = l0;
    lo[1] = l1;
    lo[2] = l2;
    if (gb != nullptr) {
        float* o = gb + 3LL * row;
        o[0] = accumulate ? o[0] + l0 : l0;
        o[1] = accumulate ? o[1] + l1 : l1;
        o[2] = accumulate ? o[2] + l2 : l2;
    }
    if (gv == nullptr) return;
    const float r[3] = {bj - s0, b1 - s1, b2 - s2};
    const float h = (1e-12f - det * det) / den / den
                    * (r[0] * u0 + r[1] * u1 + r[2] * u2);
    const float D[3][3] = {{a00, a01, a02}, {a10, a11, a12}, {a20, a21, a22}};
    const float C[3][3] = {{c00, c01, c02}, {c10, c11, c12}, {c20, c21, c22}};
    const float G[3] = {g0, g1, g2};
    float* o = gv + 9 * (static_cast<long long>(row) * K + ds);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
        const float* P = D[(p + 1) % 3];   // D_{p+1}
        const float* Q = D[(p + 2) % 3];   // D_{p+2}
        const float rm = r[(p + 2) % 3], rp = r[(p + 1) % 3];
        // r_{p-1} (D_{p+1} x g) + r_{p+1} (g x D_{p+2})
        const float q0 = rm * (P[1] * G[2] - P[2] * G[1])
                         + rp * (G[1] * Q[2] - G[2] * Q[1]);
        const float q1 = rm * (P[2] * G[0] - P[0] * G[2])
                         + rp * (G[2] * Q[0] - G[0] * Q[2]);
        const float q2 = rm * (P[0] * G[1] - P[1] * G[0])
                         + rp * (G[0] * Q[1] - G[1] * Q[0]);
        const float w0 = inv_det * q0 + h * C[p][0];
        const float w1 = inv_det * q1 + h * C[p][1];
        const float w2 = inv_det * q2 + h * C[p][2];
        o[3 * p] = accumulate ? o[3 * p] + w0 : w0;
        o[3 * p + 1] = accumulate ? o[3 * p + 1] + w1 : w1;
        o[3 * p + 2] = accumulate ? o[3 * p + 2] + w2 : w2;
    }
}

int blocks_for_rows(int rows) {
    return (rows + kRowsPerBlock - 1) / kRowsPerBlock;
}

// The lanes a row of ell_spmv and ell_outer: the smallest power of two
// >= K (1 <= K <= 32).
int row_lanes(int K) {
    int lanes = 1;
    while (lanes < K) lanes <<= 1;
    return lanes;
}

// Blocks of kThreads for `rows` rows of `lanes` lanes each.
int blocks_for_groups(int rows, int lanes) {
    return static_cast<int>(
        (static_cast<long long>(rows) * lanes + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// y: (r1 - r0, 3), a group of row_lanes(K) lanes a row. Requires
// 0 <= r0 < r1, 1 <= K <= 32 and every nbr entry of rows [r0, r1) a row
// of x.
int ell_spmv(const float* values, const int* nbr, const float* mask,
             const float* x, float* y, int r0, int r1, int K, void* stream) {
    if (r1 <= r0 || K < 1 || K > 32)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int lanes = row_lanes(K), blocks = blocks_for_groups(r1 - r0, lanes);
#define ELL_SPMV(L)                                                         \
    case L:                                                                  \
        ell_spmv_kernel<L><<<blocks, kThreads, 0, st>>>(                     \
            values, nbr, mask, x, y, r0, r1, K);                             \
        break
    switch (lanes) {
        ELL_SPMV(1);
        ELL_SPMV(2);
        ELL_SPMV(4);
        ELL_SPMV(8);
        ELL_SPMV(16);
        ELL_SPMV(32);
    }
#undef ELL_SPMV
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

// gx (N, 3) = alpha * (values^T-gather of g), through the transpose table
// tt (N, Kt) int32 of flat entries (-1 padded); skip (N,) int32 or null: the
// slot of each row to leave out (the diagonal, for the Jacobi adjoint).
// Requires N >= 1, 1 <= K, Kt >= 1 and every table entry < N * K.
int ell_spmv_t(const float* values, const float* mask, const int* tt,
               const int* skip, const float* g, float* gx, float alpha, int N,
               int K, int Kt, void* stream) {
    if (N < 1 || K < 1 || Kt < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    ell_spmv_t_kernel<<<blocks_for_rows(N), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        values, mask, tt, skip, g, gx, alpha, N, K, Kt);
    return static_cast<int>(cudaGetLastError());
}

// gv (N, K, 3, 3): slot k of row i (+)= alpha * g[i] (x) (x[nbr[i, k]]
// mask[i, k]) (accumulate != 0: added to gv); skip (N,) int32 or null: the
// slot of each row left untouched. A group of row_lanes(K) lanes a row;
// requires 1 <= K <= 32.
int ell_outer(const float* g, const int* nbr, const float* mask,
              const float* x, const int* skip, float alpha, int accumulate,
              float* gv, int N, int K, void* stream) {
    if (N < 1 || K < 1 || K > 32)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int lanes = row_lanes(K), blocks = blocks_for_groups(N, lanes);
#define ELL_OUTER(L)                                                        \
    case L:                                                                  \
        ell_outer_kernel<L><<<blocks, kThreads, 0, st>>>(                    \
            g, nbr, mask, x, skip, alpha, accumulate, gv, N, K);             \
        break
    switch (lanes) {
        ELL_OUTER(1);
        ELL_OUTER(2);
        ELL_OUTER(4);
        ELL_OUTER(8);
        ELL_OUTER(16);
        ELL_OUTER(32);
    }
#undef ELL_OUTER
    return static_cast<int>(cudaGetLastError());
}

// The adjoint of one Jacobi iteration that read xt (N, 3), or the zero
// start (xt null): lam (N, 3) = D^{-T} gbar; gb (N, 3) or null (+)= lam; gv
// (N, K, 3, 3) or null: the diagonal slots (+)= the diagonal blocks'
// gradient and the other slots (+)= -lam (x) (xt[nbr] mask) (accumulate
// != 0: add to gb and gv, else store). From the zero start an accumulating
// call leaves the other slots untouched: it would add -lam (x) 0.
int ell_jacobi_bwd(const float* values, const int* nbr, const float* mask,
                   const int* diag_slot, const float* b, const float* xt,
                   const float* gbar, float* lam, float* gb, float* gv,
                   int accumulate, int N, int K, void* stream) {
    if (N < 1 || K < 1 || K > 32)
        return static_cast<int>(cudaErrorInvalidValue);
    const int offdiag = gv != nullptr && (xt != nullptr || !accumulate);
    const RelaxArgs A{values, nbr, mask, diag_slot, b, K};
    ell_jacobi_bwd_kernel<<<blocks_for_rows(N), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        A, xt, gbar, lam, gb, gv, accumulate, offdiag, N);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
