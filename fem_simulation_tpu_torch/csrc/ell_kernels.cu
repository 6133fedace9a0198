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
// Between two colors every row of the level must be in order, so a call is
// one launch that orders its passes inside (a plain launch a color measured
// slower): ell_gs's forms and what bounds them are set out at the kernels
// below. ell_jacobi reads the previous iterate from a second buffer and
// swaps the two per iteration (one plain launch each; bound: memory, every
// row's values once an iteration, and nbr and mask from x): a group of 8,
// 16 or 32 lanes a row, the first iteration from zero in a form that
// gathers nothing (ell_jacobi_kernel below). A fixed butterfly sums the
// slots: run-to-run identical.
//
// The backward kernels (no TPU kernel of their own: the JAX package gets
// these gradients from jax.grad of the SpMV and of the smoother's
// composition, models/train_interp.py:51-79) make the SpMV and the Jacobi
// smoother differentiable under torch.autograd (ops/ell_kernels.py,
// EllSpmvFn / EllJacobiFn):
//
//   ell_spmv_t      gx[j] = alpha * sum over (i, k) with nbr[i, k] = j of
//                   mask[i, k] * values[i, k]^T g[i]   (optionally leaving
//                   out the slot k = skip[i] of every row; below)
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
// ell_outer writes a row's values gradient through outer_row: the row's
// group writes the row's 9 K contiguous floats, float t by lane t mod L,
// its slot's x_t[nbr] mask by shuffle, so a warp's stores are contiguous.
// ell_jacobi_bwd writes a block's rows' gradient, one contiguous span, with
// 16-byte stores from a copy in shared memory. Bound: memory, the N K 36 B
// of the gradient written.
//
// ell_spmv_t replaces no Pallas kernel of its own: the JAX package gets
// A^T g from jax.vjp / jax.grad through the SpMV of ops/ell.py:29 (x's
// gradient of spmv; in the smoother of solvers/smoothers.py:48 the rest of
// a Jacobi iteration's adjoint, gbar_t = -O^T lam, the diagonal slot left
// out, where an earlier iterate or x_0 takes a gradient). The transposed
// product is a gather, not a scatter: a transpose table built once on the
// host lists, for every column j, the flat entries e = i * K + k with
// nbr[i, k] = j in increasing e, padded with -1. The ELL tables pad a row
// with slots that point at the row itself, so for a structurally symmetric
// matrix every column has exactly K entries and the table is (N, K): Kt 7
// on the cloth, 27 on the hex meshes. A fixed butterfly sums a column's
// entries: no float atomics, and the result repeats bit for bit, the first
// form's bits (its term's contraction pinned, its sum order kept).
//
// What bounds it on this card. The bytes are the values and mask read once
// through the table (40 B an entry): 6.8 / 7.6 us at the 19k / 21k fine
// Hessians, whose 18-20 MB of values stay in L2 from call to call, ~27 us
// at the 74k one (72 MB, more than the 50 MB L2). But a column's entries
// lie in K different rows, ~1 KB apart, and the first form (a warp a
// column, each lane reading its entry's 9 floats one at a time after the
// table, an integer division and skip) asked for every entry's two 32 B
// sectors nine times, one sector a lane per load: 50% of the bound at the
// fine Hessians, 46% at 74k; and at K 7 it left 25 of a warp's 32 lanes
// idle (two waves at the 128x128 cloth). The forms (the C entry launches
// the one spmv_t_plan picks, at its lanes, from a sweep of both at every
// shape, scripts/spmv_t_forms.py):
//   lanes    a group of P or P / 2 lanes a column (P the smallest power of
//            two >= Kt: 8 at K 7, 32 at K 27), each lane one or two whole
//            entries; e / K a multiply (K a template constant at 7 and
//            27) and, once e is known, every load of the entry issued at
//            once, skip a select on the term: two memory trips an entry.
//            The cloth: 8 lanes (4 where the grid would hold two blocks
//            an SM).
//   staged   the same groups, the column's entries' values first copied
//            into shared memory, float f of the column's 9 P by lane f mod
//            L, so a load instruction covers consecutive floats of a few
//            entries (a sector or two each) instead of one sector an
//            entry; lane t then reads its entries there (a stride of 9
//            floats, odd, and the columns' spans offset by L banks: no bank
//            conflicts). The hex meshes: 16 lanes (two entries a lane:
//            twice the columns in flight), 32 where the grid would not
//            fill the SMs.
//   strided  the first form, kept as it was written, for Kt > 32 (which no
//            table of the repo has): a warp a column, lane t the entries t,
//            t + 32, ...
//
// No --use_fast_math: the build keeps IEEE arithmetic.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"

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

// A slot's 3 partial products values[e] (x[nbr[e]] mask[e]), the gathered
// x already multiplied by the mask. Every smoother form and ell_jacobi
// form them with this one expression, so they round alike.
__device__ __forceinline__ void slot_product(const float* v, float x0,
                                             float x1, float x2, float& s0,
                                             float& s1, float& s2) {
    s0 = v[0] * x0 + v[1] * x1 + v[2] * x2;
    s1 = v[3] * x0 + v[4] * x1 + v[5] * x2;
    s2 = v[6] * x0 + v[7] * x1 + v[8] * x2;
}

// The adjugate of the diagonal block d (row-major) as ops/ell.py solve3x3
// forms it: c[3 i + j] the cofactor c_ij, inv_det = det / (det^2 + eps).
__device__ __forceinline__ void adjugate(const float* d, float* c,
                                         float& inv_det) {
    const float a00 = d[0], a01 = d[1], a02 = d[2], a10 = d[3], a11 = d[4],
                a12 = d[5], a20 = d[6], a21 = d[7], a22 = d[8];
    c[0] = a11 * a22 - a12 * a21;
    c[1] = a12 * a20 - a10 * a22;
    c[2] = a10 * a21 - a11 * a20;
    const float det = a00 * c[0] + a01 * c[1] + a02 * c[2];
    c[3] = a02 * a21 - a01 * a22;
    c[4] = a00 * a22 - a02 * a20;
    c[5] = a01 * a20 - a00 * a21;
    c[6] = a01 * a12 - a02 * a11;
    c[7] = a02 * a10 - a00 * a12;
    c[8] = a00 * a11 - a01 * a10;
    inv_det = det / (det * det + 1e-12f);
}

// o = D^{-1} (b - s) from D's adjugate (ops/ell.py solve3x3).
__device__ __forceinline__ void apply_adjugate(const float* c, float inv_det,
                                               float b0, float b1, float b2,
                                               float s0, float s1, float s2,
                                               float& o0, float& o1,
                                               float& o2) {
    const float r0 = b0 - s0, r1 = b1 - s1, r2 = b2 - s2;
    o0 = (c[0] * r0 + c[3] * r1 + c[6] * r2) * inv_det;
    o1 = (c[1] * r0 + c[4] * r1 + c[7] * r2) * inv_det;
    o2 = (c[2] * r0 + c[5] * r1 + c[8] * r2) * inv_det;
}

// One relaxed row (a whole warp calls it with a warp-uniform row; ell_gs's
// first form): the off-diagonal row product against xin, then lane 0 solves
// the diagonal block and writes xout[row]. xin may alias xout (in place:
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
        if (lane != ds) slot_product(v, x0, x1, x2, s0, s1, s2);
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
        float c[9], inv_det;
        adjugate(d, c, inv_det);
        float* out = xout + 3LL * row;
        apply_adjugate(c, inv_det, bj, b1, b2, s0, s1, s2, out[0], out[1],
                       out[2]);
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

// -- ell_jacobi: one block-Jacobi iteration a launch -------------------------
//
// A group of G lanes takes a row (G = 8, 16 or 32; 256 / G rows a block),
// lane l holding slots l, l + G, ... (32 / G of them), so all of a row's
// loads are in flight at once. jacobi_lanes picks G per launch: the most
// lanes whose grid still fits one wave (32 up to 8,448 rows on 132 SMs,
// 16 up to 16,896, else 8), since a lane's slots are a serial chain that
// only more rows in flight hide (on an H100 the first iteration from zero
// took 1.99 / 1.42 us at 325 rows with 8 / 32 lanes, 3.79 / 3.53 at 10,449
// with 8 / 16, whose 32 lanes take two waves: 3.72; scripts/jacobi_lanes.py
// times each count). The group adds its slots in relax_row's butterfly
// order (lane_sum, then an xor butterfly of width G), so every lane ends with
// relax_row's lane-0 sums whatever G, and every lane solves the row with
// the adjugate (no lane-0 tail: 256 / G rows solve at once); lanes 0-2
// store. Two forms:
//   from x      x gathered through nbr and mask (later iterations, and any
//               call from a given x0);
//   zero start  the first iteration from x0 = 0: nbr and mask are not read
//               and nothing is gathered, but every slot's product with the
//               zero x is still formed (slot_product; the build keeps IEEE
//               arithmetic, so v * 0 is not folded), so a non-finite value
//               at any slot, live or padded, propagates as the JAX
//               smoother's spmv(values * offdiag, ..., 0) does, and the
//               finite bits are the from-x form's on a zero x.
// Bound: memory. A row is 36 K bytes of values (which the propagation of
// non-finite values requires), diag_slot and b in and x out (~1,000 B at K
// 27); from x also nbr and mask (8 K) and the gather of x.

// A lane's S = 32 / G slot partials p[j] (slot l + G j) added in the order
// relax_row's butterfly adds them within the lane (its steps 16 and 8).
template <int S>
__device__ __forceinline__ float lane_sum(const float* p) {
    if (S == 4) return (p[0] + p[2]) + (p[1] + p[3]);
    if (S == 2) return p[0] + p[1];
    return p[0];
}

template <int G, bool Zero>
__global__ void __launch_bounds__(kThreads)
ell_jacobi_kernel(const RelaxArgs A, const float* __restrict__ xin,
                  float* __restrict__ xout, int N) {
    constexpr int kRows = kThreads / G, S = 32 / G;
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & (G - 1);
    const int first = blockIdx.x * kRows;
    if (first + static_cast<int>(threadIdx.x & ~31u) / G >= N)
        return;  // every row of the warp lies past N
    const int row = first + static_cast<int>(threadIdx.x) / G;
    const bool live = row < N;
    const int rs = live ? row : N - 1;  // a row that exists, for the loads
    const int K = A.K;
    const int ds = A.diag_slot[rs];
    const float b0 = A.b[3LL * rs], b1 = A.b[3LL * rs + 1],
                b2 = A.b[3LL * rs + 2];
    float v[S][9], p0[S], p1[S], p2[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
        const int k = lane + G * j;
        // a slot past K reads slot 0 and adds 0, as relax_row's idle lanes
        const long long e = static_cast<long long>(rs) * K + (k < K ? k : 0);
#pragma unroll
        for (int t = 0; t < 9; ++t) v[j][t] = A.values[9 * e + t];
        float x0 = 0.f, x1 = 0.f, x2 = 0.f;
        if (!Zero) {
            const float m = A.mask[e];
            const long long c = 3LL * A.nbr[e];
            x0 = xin[c] * m;
            x1 = xin[c + 1] * m;
            x2 = xin[c + 2] * m;
        }
        float q0, q1, q2;
        slot_product(v[j], x0, x1, x2, q0, q1, q2);
        const bool use = k < K && k != ds;
        p0[j] = use ? q0 : 0.f;
        p1[j] = use ? q1 : 0.f;
        p2[j] = use ? q2 : 0.f;
    }
    float s0 = lane_sum<S>(p0), s1 = lane_sum<S>(p1), s2 = lane_sum<S>(p2);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
        s0 += __shfl_xor_sync(full, s0, off, G);
        s1 += __shfl_xor_sync(full, s1, off, G);
        s2 += __shfl_xor_sync(full, s2, off, G);
    }
    // the diagonal block from the lane that holds slot ds
    const int jd = ds / G;
    float d[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
        float w = v[0][t];
#pragma unroll
        for (int j = 1; j < S; ++j) w = jd == j ? v[j][t] : w;
        d[t] = __shfl_sync(full, w, ds & (G - 1), G);
    }
    float c[9], inv_det, o0, o1, o2;
    adjugate(d, c, inv_det);
    apply_adjugate(c, inv_det, b0, b1, b2, s0, s1, s2, o0, o1, o2);
    if (live && lane < 3)
        xout[3LL * row + lane] = lane == 0 ? o0 : (lane == 1 ? o1 : o2);
}

// -- ell_gs: the forms of a colored symmetric Gauss-Seidel call -------------
//
// Every form runs the same passes: per iteration the non-empty colors last
// to first, then first to last, but a color is not relaxed twice in a row
// (the backward sweep ends on the first color and the forward sweep starts
// on it; the forward sweep ends on the last color and the next backward
// sweep starts on it). A color is an independent set and a row's own slot
// is skipped (its padded slots are masked), so the repeated pass would read
// the inputs the pass before it read and write the same values: m
// non-empty colors and t iterations make t (2m - 2) + 1 passes (43 for 8
// colors and 3 iterations, against 48), pass p relaxing the color of index
// |m - 1 - p mod (2m - 2)| among them.
//
// The forms (ell_gs_plan picks one with its blocks before the launch, by a
// cost model fitted to an H100):
//   kGsCoop     the first form: one cooperative launch, a warp a row
//               (relax_row), every row's values, nbr and mask read from
//               memory in every pass, a grid barrier between passes. The
//               plan keeps it where it models cheaper, and where no staged
//               form fits (a color of more than ~12k rows over 132 SMs).
//   kGsCluster  one thread-block cluster of `blocks` <= 16 blocks. Block r
//               owns the same slice of every color, [off_c + size_c r /
//               blocks, off_c + size_c (r + 1) / blocks), and stages its
//               rows (values, nbr, mask, diag_slot, b) into shared memory
//               once a call, with a full copy of x: the group that relaxes
//               a row stores its new x into every block's copy (st.async
//               into distributed shared memory), so a gather is a load from
//               the block's own shared memory. Between passes each block
//               waits on its own mbarrier for the other blocks' rows of the
//               pass's color, not on a cluster barrier.
//   kGsResident a cooperative launch of `blocks` blocks (at most one an SM
//               where the rows need most of its shared memory), each
//               staging its slices once a call as above; x stays in device
//               memory (gathered from L2), a grid barrier between passes.
//   kGsStream   the same launch, but a block stages only the slice of the
//               pass it works on, double-buffered: the next pass's slice
//               (values, nbr, mask, diag_slot and b do not depend on x) is
//               in flight before this pass's work and barrier, so after
//               the barrier only the x gather waits. For levels whose rows
//               do not fit on chip (the 74k beam's fine level, 88 MB).
// The staged forms relax a row with 8 lanes, lane l holding slots l, l + 8,
// l + 16 and l + 24: it adds them as (s_l + s_{l+16}) + (s_{l+8} + s_{l+24})
// and an xor butterfly of width 8 adds the lanes, which adds the pairs of
// relax_row's 32-lane butterfly term by term, so every lane of the group
// ends with lane 0's sums and every form gives the bits of every other (and
// of the first form's 48 passes, up to the sign of a zero). The diagonal
// block's adjugate is formed once a call (it does not depend on x).
//
// Bound: a call must read every row's values, nbr and mask once (1,188
// bytes a row at K 27), diag_slot and b, and read and write x: 2.4 MB on the
// 2k beam's fine level, 88 MB on the 74k beam's, 0.7 / 27 us at 3.35 TB/s.
// The passes are a chain of dependent steps (gather, sum, solve, store,
// barrier), so latency sets the time. On an H100 (scripts/barrier_costs.cu,
// scripts/gs_pass_trace.py): a grid barrier costs ~1.1 us and a cluster
// barrier 0.6-0.74 us (its release at cluster scope; a relaxed one 0.06),
// so the first form spent ~2 us a pass; the cluster form's pass is
// ~0.7-0.9 us (a row's relaxation from shared memory ~0.3-0.4, its
// st.async stores ~0.13, the block barrier and the mbarrier wait
// ~0.1-0.3), the resident form's ~1.6-2.1 (the L2 gather, the grid
// barrier).
constexpr int kGsCoop = 0;
constexpr int kGsCluster = 1;
constexpr int kGsResident = 2;
constexpr int kGsStream = 3;
constexpr int kGsForms = 4;
constexpr int kGsThreads = 512;
constexpr int kGsLanes = 8;
constexpr int kGsGroups = kGsThreads / kGsLanes;
// the most dynamic shared memory a staged form takes: a block's 227 KB
// (232,448 bytes) less room for the kernels' static shared memory
constexpr int kGsSmemCap = 230400;
constexpr int kMaxCluster = 16;

struct GsArgs {
    RelaxArgs A;
    float* x;
    int offs[kMaxColors + 1];
    int seq[kMaxColors];   // the non-empty colors, in order
    int m;                 // how many there are
    int passes;
    int N;
    int rows;              // rows of the shared layout (gs_layout_rows)
};

// The color of pass p (see above).
__device__ __forceinline__ int pass_color(const GsArgs& P, int p) {
    if (P.m == 1) return P.seq[0];
    const int t = (P.m - 1) - p % (2 * P.m - 2);
    return P.seq[t < 0 ? -t : t];
}

// The first row of block r's slice of color c among `blocks` blocks.
__host__ __device__ __forceinline__ int slice_start(const int* offs, int c,
                                                    int r, int blocks) {
    return offs[c] + static_cast<int>(
        static_cast<long long>(offs[c + 1] - offs[c]) * r / blocks);
}

// The whole colored symmetric Gauss-Seidel in one cooperative launch, a
// warp a row, a grid barrier between passes.
__global__ void __launch_bounds__(kThreads)
ell_gs_coop_kernel(const __grid_constant__ GsArgs P) {
    cg::grid_group grid = cg::this_grid();
    const int lane = threadIdx.x & 31;
    const int warp = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
    const int n_warps = gridDim.x * kRowsPerBlock;
    for (int p = 0; p < P.passes; ++p) {
        const int c = pass_color(P, p);
        const int r1 = P.offs[c + 1];
        for (int row = P.offs[c] + warp; row < r1; row += n_warps)
            relax_row(P.A.values, P.A.nbr, P.A.mask, P.A.diag_slot, P.A.b,
                      P.x, P.x, row, P.A.K, lane);
        if (p + 1 < P.passes) grid.sync();
    }
}

// A block's rows in shared memory, local row l: values [l][K][9], mask
// [l][K], b [l][3], nbr [l][K], diag_slot [l] and the diagonal block's
// adjugate and inv_det [l][10] (formed once, as they do not depend on x);
// R rows of room, gs_row_floats(K) floats a row.
struct Tables {
    float* vals;
    float* mask;
    float* bs;
    int* nbr;
    int* ds;
    float* inv;
};

__host__ __device__ __forceinline__ int gs_row_floats(int K) {
    return 11 * K + 14;
}

__device__ __forceinline__ Tables tables_at(float* base, int R, int K) {
    Tables T;
    T.vals = base;
    T.mask = T.vals + 9 * K * R;
    T.bs = T.mask + K * R;
    T.nbr = reinterpret_cast<int*>(T.bs + 3 * R);
    T.ds = T.nbr + K * R;
    T.inv = reinterpret_cast<float*>(T.ds + R);
    return T;
}

// The adjugates of local rows [0, cnt) of T, a thread a row, once their
// values and diag_slot have landed (the caller waits and syncs before and
// after).
__device__ __forceinline__ void stage_adjugates(const Tables& T, int cnt,
                                                int K) {
    for (int l = threadIdx.x; l < cnt; l += blockDim.x)
        adjugate(T.vals + 9 * (l * K + T.ds[l]), T.inv + 10 * l,
                 T.inv[10 * l + 9]);
}

template <class T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
        cp_async4(dst + i, src + i);
}

// Global rows [g0, g0 + cnt) into local rows [l0, l0 + cnt) of T
// (asynchronous: the caller commits and waits).
__device__ __forceinline__ void stage_rows(const Tables& T,
                                           const RelaxArgs& A, int g0,
                                           int l0, int cnt) {
    const int K = A.K;
    stage(T.vals + 9 * K * l0, A.values + 9LL * K * g0, 9 * K * cnt);
    stage(T.mask + K * l0, A.mask + static_cast<long long>(K) * g0, K * cnt);
    stage(T.nbr + K * l0, A.nbr + static_cast<long long>(K) * g0, K * cnt);
    stage(T.ds + l0, A.diag_slot + g0, cnt);
    stage(T.bs + 3 * l0, A.b + 3LL * g0, 3 * cnt);
}

// Local row l relaxed by the 8 lanes of a group (lane8 = its lane; every
// lane of a warp that has a row calls it, `live` false for a group past
// its rows, and ls = l where live, else a row of T that exists). Every load is made
// whether or not its slot counts (a slot past K reads slot 0, the diagonal
// slot its own values), so all of them can be in flight at once, and a
// slot that does not count adds 0 as in relax_row. The last three steps of
// relax_row's butterfly are an xor butterfly of width 8, which adds the
// same pairs, so every lane of the group ends with lane 0's sums and
// returns the new x in o. gather(j, x0, x1, x2) loads x of row j as the
// staged nbr names it.
template <class Gather>
__device__ __forceinline__ void relax_staged(const Tables& T, int l, int ls,
                                             bool live, int K, int lane8,
                                             Gather gather, float& o0,
                                             float& o1, float& o2) {
    const unsigned full = 0xffffffffu;
    const int ds = T.ds[ls];
    float inv[10];
#pragma unroll
    for (int t = 0; t < 10; ++t) inv[t] = T.inv[10 * ls + t];
    const float b0 = T.bs[3 * ls], b1 = T.bs[3 * ls + 1],
                b2 = T.bs[3 * ls + 2];
    float p0[4], p1[4], p2[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int k = lane8 + kGsLanes * j;
        const int e = ls * K + (k < K ? k : 0);
        const float m = T.mask[e];
        float x0, x1, x2, q0, q1, q2;
        gather(T.nbr[e], x0, x1, x2);
        slot_product(T.vals + 9 * e, x0 * m, x1 * m, x2 * m, q0, q1, q2);
        const bool use = live && k < K && k != ds;
        p0[j] = use ? q0 : 0.f;
        p1[j] = use ? q1 : 0.f;
        p2[j] = use ? q2 : 0.f;
    }
    // relax_row's butterfly: its steps 16 and 8 here, within the lane
    float s0 = (p0[0] + p0[2]) + (p0[1] + p0[3]);
    float s1 = (p1[0] + p1[2]) + (p1[1] + p1[3]);
    float s2 = (p2[0] + p2[2]) + (p2[1] + p2[3]);
#pragma unroll
    for (int off = kGsLanes / 2; off > 0; off >>= 1) {
        s0 += __shfl_xor_sync(full, s0, off, kGsLanes);
        s1 += __shfl_xor_sync(full, s1, off, kGsLanes);
        s2 += __shfl_xor_sync(full, s2, off, kGsLanes);
    }
    apply_adjugate(inv, inv[9], b0, b1, b2, s0, s1, s2, o0, o1, o2);
}

// A block's slices of the colors and the passes' colors, in shared memory.
struct GsBlock {
    int lb[kMaxColors + 1];     // first local row of each color; lb[n] rows
    int g0[kMaxColors];         // first global row of its slice of each
    int other[kMaxColors];      // rows of each color other blocks own
    int sched[2 * kMaxColors];  // the color of each pass of a period
    int period;                 // passes a period (see pass_color)
};

// B for block r of `blocks` blocks.
__device__ __forceinline__ void block_setup(const GsArgs& P, int n_colors,
                                            int r, int blocks, GsBlock& B) {
    if (threadIdx.x == 0) {
        int l = 0;
        for (int c = 0; c < n_colors; ++c) {
            B.lb[c] = l;
            B.g0[c] = slice_start(P.offs, c, r, blocks);
            const int own = slice_start(P.offs, c, r + 1, blocks) - B.g0[c];
            B.other[c] = P.offs[c + 1] - P.offs[c] - own;
            l += own;
        }
        B.lb[n_colors] = l;
        B.period = P.m == 1 ? 1 : 2 * P.m - 2;
        for (int i = 0; i < B.period; ++i) B.sched[i] = pass_color(P, i);
    }
    __syncthreads();
}

// kGsCluster: the whole call in one cluster of gridDim.x blocks; shared
// memory [x: 4 N floats, row j's 3 at 4 j][Tables of P.rows rows]. No
// cluster barrier between passes (a release at cluster scope costs ~0.7 us
// on an H100): a row's group stores its new x into every other block's
// copy with st.async (16 bytes), each store completing 16 bytes of a
// transaction count on that block's mbarrier, and a block starts pass p + 1
// once its mbarrier has counted every row of pass p's color that other
// blocks own and its own warps are past a block barrier. A block's reads of
// pass p are done before its stores of pass p leave (they are computed
// from them), and no block starts pass p + 1 before every block's pass p
// stores arrived, so no store of pass p + 1 meets a read of pass p. Two
// mbarriers, pass p on p & 1: a block is at most one pass ahead of another.
__global__ void __launch_bounds__(kGsThreads, 1)
ell_gs_cluster_kernel(const __grid_constant__ GsArgs P, int n_colors) {
    extern __shared__ __align__(16) float smem[];
    __shared__ GsBlock B;
    __shared__ __align__(8) unsigned long long bars[2];
    cg::cluster_group cluster = cg::this_cluster();
    const int r = static_cast<int>(cluster.block_rank());
    const int nb = static_cast<int>(cluster.num_blocks());
    const int K = P.A.K;
    block_setup(P, n_colors, r, nb, B);
    float* xs = smem;
    const Tables T = tables_at(smem + 4 * P.N, P.rows, K);
    for (int c = 0; c < n_colors; ++c)
        stage_rows(T, P.A, B.g0[c], B.lb[c], B.lb[c + 1] - B.lb[c]);
    for (int i = threadIdx.x; i < 3 * P.N; i += blockDim.x)
        cp_async4(xs + 4 * (i / 3) + i % 3, P.x + i);
    cp_async_commit();
    if (threadIdx.x == 0) {
        mbar_init(smem_addr(&bars[0]), 1);
        mbar_init(smem_addr(&bars[1]), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cp_async_wait_all();
    __syncthreads();
    stage_adjugates(T, B.lb[n_colors], K);
    __syncthreads();
    cluster.sync();  // every block's x staged and mbarriers set up
    const int lane8 = threadIdx.x & (kGsLanes - 1);
    const int group = threadIdx.x / kGsLanes;
    // the copies of x and the mbarriers of the blocks this lane stores to
    // (ranks lane8 and lane8 + 8), mapped once
    unsigned xq[2], bq[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = lane8 + kGsLanes * h < nb ? lane8 + kGsLanes * h : r;
        xq[h] = map_rank(smem_addr(xs), q);
        bq[h][0] = map_rank(smem_addr(&bars[0]), q);
        bq[h][1] = map_rank(smem_addr(&bars[1]), q);
    }
    int pos = 0;
    for (int p = 0; p < P.passes; ++p) {
        const int c = B.sched[pos];
        pos = pos + 1 == B.period ? 0 : pos + 1;
        const unsigned bar = smem_addr(&bars[p & 1]);
        if (threadIdx.x == blockDim.x - 1)  // a thread that relaxes least
            mbar_expect(bar, 16u * B.other[c]);
        const int l1 = B.lb[c + 1];
        for (int l0 = B.lb[c]; l0 < l1; l0 += kGsGroups) {
            if (l0 + (group & ~3) >= l1) break;  // no row for this warp
            const int l = l0 + group;
            const bool live = l < l1;
            float o0, o1, o2;
            relax_staged(T, l, live ? l : l0, live, K, lane8,
                         [&](int j, float& a, float& b, float& d) {
                             const float4 v =
                                 *reinterpret_cast<const float4*>(xs + 4 * j);
                             a = v.x;
                             b = v.y;
                             d = v.z;
                         },
                         o0, o1, o2);
            if (live) {
                const int g = B.g0[c] + l - B.lb[c];
                if (lane8 == 0)
                    *reinterpret_cast<float4*>(xs + 4 * g) =
                        make_float4(o0, o1, o2, 0.f);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int q = lane8 + kGsLanes * h;
                    if (q < nb && q != r)
                        st_async4(xq[h] + 16u * g, o0, o1, o2,
                                  (p & 1) ? bq[h][1] : bq[h][0]);
                }
            }
        }
        __syncthreads();  // this block's rows of color c seen by its warps
        mbar_wait(bar, (p >> 1) & 1);  // and the other blocks' rows
    }
    for (int c = 0; c < n_colors; ++c) {  // the block's own rows out
        const int g = B.g0[c], cnt = B.lb[c + 1] - B.lb[c];
        for (int i = threadIdx.x; i < 3 * cnt; i += blockDim.x)
            P.x[3LL * g + i] = xs[4 * (g + i / 3) + i % 3];
    }
    cluster.sync();  // no block leaves while another may still store to it
}

// kGsResident (Stream false) and kGsStream (Stream true): a cooperative
// launch, x in device memory. Resident: shared memory holds the Tables of
// the block's P.rows rows; Stream: two Tables of P.rows rows (the widest
// slice), pass p in buffer p & 1.
template <bool Stream>
__global__ void __launch_bounds__(kGsThreads, 1)
ell_gs_grid_kernel(const __grid_constant__ GsArgs P, int n_colors) {
    extern __shared__ __align__(16) float smem[];
    __shared__ GsBlock B;
    cg::grid_group grid = cg::this_grid();
    const int K = P.A.K;
    block_setup(P, n_colors, blockIdx.x, gridDim.x, B);
    const int buffer = gs_row_floats(K) * P.rows;  // floats of one Tables
    const int first = B.sched[0];
    if (Stream) {
        stage_rows(tables_at(smem, P.rows, K), P.A, B.g0[first], 0,
                   B.lb[first + 1] - B.lb[first]);
    } else {
        for (int c = 0; c < n_colors; ++c)
            stage_rows(tables_at(smem, P.rows, K), P.A, B.g0[c], B.lb[c],
                       B.lb[c + 1] - B.lb[c]);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    stage_adjugates(tables_at(smem, P.rows, K),
                    Stream ? B.lb[first + 1] - B.lb[first] : B.lb[n_colors],
                    K);
    __syncthreads();
    const int lane8 = threadIdx.x & (kGsLanes - 1);
    const int group = threadIdx.x / kGsLanes;
    float* x = P.x;
    int pos = 0;
    for (int p = 0; p < P.passes; ++p) {
        const int c = B.sched[pos];
        pos = pos + 1 == B.period ? 0 : pos + 1;
        const bool next = Stream && p + 1 < P.passes;
        const int cn = B.sched[pos];
        float* other = smem + ((p & 1) ? 0 : buffer);
        if (next) {  // the next pass's slice, in flight during this pass
            stage_rows(tables_at(other, P.rows, K), P.A, B.g0[cn], 0,
                       B.lb[cn + 1] - B.lb[cn]);
            cp_async_commit();
        }
        const Tables T =
            tables_at(smem + ((Stream && (p & 1)) ? buffer : 0), P.rows, K);
        const int base = Stream ? 0 : B.lb[c], cnt = B.lb[c + 1] - B.lb[c];
        for (int i0 = 0; i0 < cnt; i0 += kGsGroups) {
            if (i0 + (group & ~3) >= cnt) break;  // no row for this warp
            const int i = i0 + group;
            const bool live = i < cnt;
            float o0, o1, o2;
            // x changes under the kernel: gathered from L2, not L1
            relax_staged(T, base + i, base + (live ? i : i0), live, K, lane8,
                         [&](int j, float& a, float& b, float& d) {
                             const float* xr = x + 3LL * j;
                             a = __ldcg(xr);
                             b = __ldcg(xr + 1);
                             d = __ldcg(xr + 2);
                         },
                         o0, o1, o2);
            if (live && lane8 == 0) {
                float* out = x + 3LL * (B.g0[c] + i);
                out[0] = o0;
                out[1] = o1;
                out[2] = o2;
            }
        }
        if (next) {  // the next slice landed: its adjugates, before the barrier
            cp_async_wait_all();
            __syncthreads();
            stage_adjugates(tables_at(other, P.rows, K),
                            B.lb[cn + 1] - B.lb[cn], K);
        }
        if (p + 1 < P.passes) grid.sync();
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

// The adjoint of one Jacobi iteration x_{t+1} = D^{-1} (b - O x_t) at a row:
// lam = s C gbar with C the cofactor matrix of the diagonal block D and
// s = det / (det^2 + eps), the transpose of the forward's x = s C^T r. With
// gv given, the forward's residual r = b - sum_{k != ds} A_k (xt[nbr_k] m_k)
// is recomputed (r = b from the zero start: no x_t is read) and the exact
// derivative of x = s(det) C(D)^T r with respect to D goes to the diagonal
// slot: row p of it is
//   s (r_{p-1} (D_{p+1} x gbar) + r_{p+1} (gbar x D_{p+2}))
//     + s'(det) (r . C gbar) C_p,        s' = (eps - det^2) / (det^2 + eps)^2
// (indices mod 3; row n of C is D_{n+1} x D_{n+2}); the other slots take
// -(lam (x) xm_k), xm_k = xt[nbr_k] m_k (zero from the zero start): what
// ell_outer(lam, ..., xt, skip = diag_slot, alpha = -1) writes.
//
// Forms (kBwd*): no values' gradient (lam and gb only: the diagonal block,
// diag_slot and gbar read); from x_t (the row's values, nbr and mask read
// and x_t gathered, for the residual and the products); the zero start
// (only the diagonal block of the values read, nothing gathered).
//
// Design: the forward's row groups, G = jacobi_lanes(N, sms) lanes a row
// (8 without the values' gradient) and 256 / G rows a block. Every lane
// computes lam in the first form's roundings (fms, dot3 below; the
// residual from x_t is the forward's row pass, lane_sum and the xor
// butterfly), lanes 0-2 store one component each, and lane p < 3 forms row
// p of the diagonal derivative, each entry rounded as the first form
// rounded it. The
// values' gradient is the bytes that bound the kernel (N K 36 B against
// ~150 + 18 K FLOPs a row), and a block's rows own one contiguous span of
// it, so the group writes its row's 9 K floats into a copy of the block's
// span in shared memory (its own slots' products from the xm in its
// registers, the derivative at the diagonal slot), and after one block
// barrier the block stores the span with 16-byte stores (a head and a tail
// of single floats where the span does not start or end on 16 bytes);
// accumulating, it reads, adds and writes the same span. Each float is
// rounded as outer_row rounds it: -(lam_j xm_l) by __fmul_rn, a sum by
// __fadd_rn. From the zero start an accumulating call adds only the 9
// floats of the diagonal slot (the others would take -lam (x) 0), single
// stores by lanes 0-2.
constexpr int kBwdNoGv = 0;
constexpr int kBwdFromXt = 1;
constexpr int kBwdZero = 2;

// The adjoint's arithmetic with every rounding pinned to the one the first
// form's build made (recovered from its outputs and its SASS on an H100):
// written as plain expressions, the compiler contracts a b - c d and
// a b + c d into an FMA on either product, by how many uses each product
// has after common subexpressions are merged, so another layout of the same
// expressions (a row of the derivative a lane) rounds differently.
// x1 y1 - x2 y2 with the first product fused.
__device__ __forceinline__ float fms(float x1, float y1, float x2,
                                     float y2) {
    return __fmaf_rn(x1, y1, -__fmul_rn(x2, y2));
}

// a0 b0 + a1 b1 + a2 b2 as the compiler orders it: a1 b1 rounded, then
// a0 b0 and a2 b2 fused in turn.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
    return __fmaf_rn(a2, b2, __fmaf_rn(a0, b0, __fmul_rn(a1, b1)));
}

// The floats of shared memory a block of G lanes a row takes in the span
// forms: the span of its 256 / G rows and 3 floats of room to give it the
// alignment of gv's.
int bwd_span_floats(int K, int G) {
    return kThreads / G * 9 * K + 3;
}

template <int G, int Form>
__global__ void __launch_bounds__(kThreads)
ell_jacobi_bwd_kernel(const RelaxArgs A, const float* __restrict__ xt,
                      const float* __restrict__ gbar, float* __restrict__ lam,
                      float* __restrict__ gb, float* __restrict__ gv,
                      int accumulate, int N) {
    constexpr int kRows = kThreads / G, S = 32 / G;
    extern __shared__ __align__(16) float span[];
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & (G - 1);
    const int first = blockIdx.x * kRows;
    const int row = first + static_cast<int>(threadIdx.x) / G;
    const bool live = row < N;
    const int rs = live ? row : N - 1;  // a row that exists, for the loads
    const int K = A.K;
    const int ds = A.diag_slot[rs];
    const float g0 = gbar[3LL * rs], g1 = gbar[3LL * rs + 1],
                g2 = gbar[3LL * rs + 2];
    float d[9];
    const float* dv = A.values + 9 * (static_cast<long long>(rs) * K + ds);
#pragma unroll
    for (int t = 0; t < 9; ++t) d[t] = dv[t];
    float bj[3] = {0.f, 0.f, 0.f};
    if (Form != kBwdNoGv) {
        bj[0] = A.b[3LL * rs];
        bj[1] = A.b[3LL * rs + 1];
        bj[2] = A.b[3LL * rs + 2];
    }
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    float xm[S][3];  // xt[nbr] mask of the lane's slots (zero start: 0)
#pragma unroll
    for (int j = 0; j < S; ++j) xm[j][0] = xm[j][1] = xm[j][2] = 0.f;
    if (Form == kBwdFromXt) {  // the whole row: the residual
        float p0[S], p1[S], p2[S];
#pragma unroll
        for (int j = 0; j < S; ++j) {
            const int k = lane + G * j;
            const long long e =
                static_cast<long long>(rs) * K + (k < K ? k : 0);
            float v[9];
#pragma unroll
            for (int t = 0; t < 9; ++t) v[t] = A.values[9 * e + t];
            const float m = A.mask[e];
            const long long c = 3LL * A.nbr[e];
            xm[j][0] = xt[c] * m;
            xm[j][1] = xt[c + 1] * m;
            xm[j][2] = xt[c + 2] * m;
            float q0, q1, q2;
            slot_product(v, xm[j][0], xm[j][1], xm[j][2], q0, q1, q2);
            const bool use = k < K && k != ds;
            p0[j] = use ? q0 : 0.f;
            p1[j] = use ? q1 : 0.f;
            p2[j] = use ? q2 : 0.f;
        }
        s0 = lane_sum<S>(p0);
        s1 = lane_sum<S>(p1);
        s2 = lane_sum<S>(p2);
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {
            s0 += __shfl_xor_sync(full, s0, off, G);
            s1 += __shfl_xor_sync(full, s1, off, G);
            s2 += __shfl_xor_sync(full, s2, off, G);
        }
    }
    const float a00 = d[0], a01 = d[1], a02 = d[2], a10 = d[3], a11 = d[4],
                a12 = d[5], a20 = d[6], a21 = d[7], a22 = d[8];
    // ops/ell.py solve3x3: the cofactors, det / (det^2 + eps)
    const float c00 = fms(a11, a22, a12, a21);
    const float c01 = fms(a12, a20, a10, a22);
    const float c02 = fms(a10, a21, a11, a20);
    const float det = dot3(a00, c00, a01, c01, a02, c02);
    const float c10 = fms(a02, a21, a01, a22);
    const float c11 = fms(a00, a22, a02, a20);
    const float c12 = fms(a01, a20, a00, a21);
    const float c20 = fms(a01, a12, a02, a11);
    const float c21 = fms(a02, a10, a00, a12);
    const float c22 = fms(a00, a11, a01, a10);
    const float den = __fmaf_rn(det, det, 1e-12f);
    const float inv_det = __fdiv_rn(det, den);
    const float u0 = dot3(c00, g0, c01, g1, c02, g2);
    const float u1 = dot3(c10, g0, c11, g1, c12, g2);
    const float u2 = dot3(c20, g0, c21, g1, c22, g2);
    const float l0 = __fmul_rn(u0, inv_det), l1 = __fmul_rn(u1, inv_det),
                l2 = __fmul_rn(u2, inv_det);
    const float lc = lane == 0 ? l0 : (lane == 1 ? l1 : l2);
    if (live && lane < 3) {
        lam[3LL * row + lane] = lc;
        if (gb != nullptr) {
            float* o = gb + 3LL * row + lane;
            *o = accumulate ? *o + lc : lc;
        }
    }
    if (Form == kBwdNoGv) return;
    const float r[3] = {bj[0] - s0, bj[1] - s1, bj[2] - s2};
    const float h = __fmul_rn(
        __fdiv_rn(__fdiv_rn(__fmaf_rn(-det, det, 1e-12f), den), den),
        dot3(r[0], u0, r[1], u1, r[2], u2));
    // row p = lane (< 3) of the diagonal blocks' gradient:
    // r_{p-1} (D_{p+1} x g) + r_{p+1} (g x D_{p+2}), then s and s' terms,
    // entry (p, q) rounded as the first form rounded it: the P x g
    // component's difference fused on its second product in row 2 and
    // unfused in rows 0 and 1; the g x Q component's fused on its first
    // product in row 1 and unfused in rows 0 and 2; r_{p-1} (.) fused over
    // r_{p+1} (.); s (.) fused over s' (.) C_pq in columns 0 and 1, the
    // other way round in column 2
    const int p = lane < 3 ? lane : 0;
    const int pn = p == 2 ? 0 : p + 1, pm = p == 0 ? 2 : p - 1;
    const float P[3] = {pn == 0 ? a00 : (pn == 1 ? a10 : a20),
                        pn == 0 ? a01 : (pn == 1 ? a11 : a21),
                        pn == 0 ? a02 : (pn == 1 ? a12 : a22)};
    const float Q[3] = {pm == 0 ? a00 : (pm == 1 ? a10 : a20),
                        pm == 0 ? a01 : (pm == 1 ? a11 : a21),
                        pm == 0 ? a02 : (pm == 1 ? a12 : a22)};
    const float Cp[3] = {p == 0 ? c00 : (p == 1 ? c10 : c20),
                         p == 0 ? c01 : (p == 1 ? c11 : c21),
                         p == 0 ? c02 : (p == 1 ? c12 : c22)};
    const float G3[3] = {g0, g1, g2};
    const float rm = pm == 0 ? r[0] : (pm == 1 ? r[1] : r[2]);
    const float rp = pn == 0 ? r[0] : (pn == 1 ? r[1] : r[2]);
    float w[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        const int i1 = (q + 1) % 3, i2 = (q + 2) % 3;
        // (P x g)_q = P_i1 g_i2 - P_i2 g_i1, (g x Q)_q = g_i1 Q_i2 - g_i2 Q_i1
        const float pa = __fmul_rn(P[i1], G3[i2]);
        const float A = p == 2
                            ? __fmaf_rn(-P[i2], G3[i1], pa)
                            : __fsub_rn(pa, __fmul_rn(P[i2], G3[i1]));
        const float B = p == 1 ? fms(G3[i1], Q[i2], G3[i2], Q[i1])
                               : __fsub_rn(__fmul_rn(G3[i1], Q[i2]),
                                           __fmul_rn(G3[i2], Q[i1]));
        const float qv = __fmaf_rn(rm, A, __fmul_rn(rp, B));
        w[q] = q < 2 ? __fmaf_rn(inv_det, qv, __fmul_rn(h, Cp[q]))
                     : __fmaf_rn(h, Cp[q], __fmul_rn(inv_det, qv));
    }
    const float w0 = w[0], w1 = w[1], w2 = w[2];
    if (Form == kBwdZero && accumulate) {  // the diagonal slot alone
        if (live && lane < 3) {
            float* o = gv + 9 * (static_cast<long long>(row) * K + ds)
                       + 3 * lane;
            o[0] = o[0] + w0;
            o[1] = o[1] + w1;
            o[2] = o[2] + w2;
        }
        return;
    }
    // the block's span of gv: rows [first, first + R), 9 K floats a row;
    // span[pad + i] holds float i, pad giving it gv's alignment mod 16 bytes
    const int W = 9 * K;
    const int R = min(kRows, N - first);
    float* dst = gv + 9LL * K * first;
    const int pad = static_cast<int>(reinterpret_cast<size_t>(dst) >> 2) & 3;
    if (live) {
        float* mine = span + pad + (static_cast<int>(threadIdx.x) / G) * W;
        if (lane < 3) {
            mine[9 * ds + 3 * lane] = w0;
            mine[9 * ds + 3 * lane + 1] = w1;
            mine[9 * ds + 3 * lane + 2] = w2;
        }
        const float L3[3] = {l0, l1, l2};
#pragma unroll
        for (int j = 0; j < S; ++j) {
            const int k = lane + G * j;
            if (k < K && k != ds) {
#pragma unroll
                for (int a = 0; a < 3; ++a)
#pragma unroll
                    for (int q = 0; q < 3; ++q)
                        mine[9 * k + 3 * a + q] =
                            __fmul_rn(-1.0f, __fmul_rn(L3[a], xm[j][q]));
            }
        }
    }
    __syncthreads();
    const int nf = R * W;
    const int head = min((4 - pad) & 3, nf);
    for (int i = threadIdx.x; i < head; i += kThreads)
        dst[i] = accumulate ? __fadd_rn(dst[i], span[pad + i]) : span[pad + i];
    const int n4 = (nf - head) >> 2;
    float4* d4 = reinterpret_cast<float4*>(dst + head);
    const float4* s4 = reinterpret_cast<const float4*>(span + pad + head);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
        float4 o = s4[i];
        if (accumulate) {
            const float4 a = d4[i];
            o.x = __fadd_rn(a.x, o.x);
            o.y = __fadd_rn(a.y, o.y);
            o.z = __fadd_rn(a.z, o.z);
            o.w = __fadd_rn(a.w, o.w);
        }
        d4[i] = o;
    }
    for (int i = head + 4 * n4 + threadIdx.x; i < nf; i += kThreads)
        dst[i] = accumulate ? __fadd_rn(dst[i], span[pad + i]) : span[pad + i];
}

// -- ell_spmv_t: the transposed product --------------------------------------
//
// gx[col] = alpha * sum of mask[e] values[e]^T g[e / K] over the entries e
// of the column's transpose-table row (-1: padding), slot skip[e / K] of
// each row left out. The forms (the note at the top says what bounds each):
constexpr int kSpmvTLanes = 0;    // a lane group a column, whole entries
constexpr int kSpmvTStaged = 1;   // the same, the values staged by spans
constexpr int kSpmvTStrided = 2;  // the first form: a warp a column

// Component c of an entry's term, (v[c] g0 + v[c + 3] g1 + v[c + 6] g2) m,
// rounded as the first form's build rounded (v[0] g0 + v[3] g1 + v[6] g2) m.
__device__ __forceinline__ float spmv_t_term(const float* v, int c, float g0,
                                             float g1, float g2, float m) {
    return __fmul_rn(dot3(v[c], g0, v[c + 3], g1, v[c + 6], g2), m);
}

// The floats of a staged column's span: 9 P floats and room to offset the
// spans of a warp's 32 / L columns by L banks each, so that lane t reading
// float 9 (t + L j) + c of its column's span and the copy's stores are free
// of bank conflicts (9 is odd).
__host__ __device__ constexpr int spmv_t_span(int L, int P) {
    return 9 * P + (((L - 9 * P) % 32) + 32) % 32;
}

// Form kSpmvTStrided is the first form as it was written: a warp a column,
// lane t the entries t, t + 32, ... (any Kt). The others take a group of L
// lanes a column, lane t the S entries t + L j (S = 1 or 2, P = L S the
// smallest power of two >= Kt, at most 32): the lane adds its terms in
// lane_sum's order,
// which is the first log2 S steps of a width-P butterfly, and the group
// sums with a butterfly of width L; for Kt <= P < 32 the whole-warp
// butterfly's first steps add exact zeros, so every L gives its bits. The
// warp leaves only when all of its columns lie past N (the shuffles need
// every lane). Once the table gives e, every load of the entry (mask, g,
// skip and its values) is issued at once: a padded entry reads entry 0 and
// adds 0, and skip is a select on the term. KC > 0: K as a constant (e / K
// a multiply).
template <int Form, int L, int S, int KC>
__global__ void __launch_bounds__(kThreads)
ell_spmv_t_kernel(const float* __restrict__ values,
                  const float* __restrict__ mask, const int* __restrict__ tt,
                  const int* __restrict__ skip, const float* __restrict__ g,
                  float* __restrict__ gx, float alpha, int N, int Kn, int Kt) {
    const unsigned full = 0xffffffffu;
    if constexpr (Form == kSpmvTStrided) {
        const int K = Kn;
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
            const float g0 = g[3LL * i], g1 = g[3LL * i + 1],
                        g2 = g[3LL * i + 2];
            s0 += (v[0] * g0 + v[3] * g1 + v[6] * g2) * m;
            s1 += (v[1] * g0 + v[4] * g1 + v[7] * g2) * m;
            s2 += (v[2] * g0 + v[5] * g1 + v[8] * g2) * m;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            s0 += __shfl_down_sync(full, s0, off);
            s1 += __shfl_down_sync(full, s1, off);
            s2 += __shfl_down_sync(full, s2, off);
        }
        if (lane == 0) {
            float* out = gx + 3LL * col;
            out[0] = alpha * s0;
            out[1] = alpha * s1;
            out[2] = alpha * s2;
        }
    } else {
        constexpr int kCols = kThreads / L, P = L * S;
        constexpr bool kStaged = Form == kSpmvTStaged;
        constexpr int kSpan = spmv_t_span(L, P);
        // the staged form: a column's table row and the span of its
        // entries' values
        __shared__ int rows_of[kStaged ? kCols * (P + 1) : 1];
        __shared__ float stage[kStaged ? kCols * kSpan : 1];
        const unsigned K = KC > 0 ? KC : Kn;
        const int lane = threadIdx.x & (L - 1);
        const int first = blockIdx.x * kCols;
        if (first + static_cast<int>(threadIdx.x & ~31u) / L >= N)
            return;  // every column of the warp lies past N
        const int group = static_cast<int>(threadIdx.x) / L;
        const int col = first + group;
        // the entries' table slots, then every load but the values' (the
        // staged form's copy orders them after its warp barriers)
        int e[S], sk[S];
        unsigned es[S], row[S];
        float m[S], g0[S], g1[S], g2[S];
#pragma unroll
        for (int j = 0; j < S; ++j) {
            const int k = lane + L * j;
            e[j] = col < N && k < Kt
                       ? tt[static_cast<long long>(col) * Kt + k]
                       : -1;
            es[j] = e[j] < 0 ? 0u : static_cast<unsigned>(e[j]);
            row[j] = es[j] / K;
        }
#pragma unroll
        for (int j = 0; j < S; ++j) {
            m[j] = mask[es[j]];
            g0[j] = g[3LL * row[j]];
            g1[j] = g[3LL * row[j] + 1];
            g2[j] = g[3LL * row[j] + 2];
            sk[j] = skip != nullptr ? skip[row[j]] : -1;
        }
        float v[S][9];
        if constexpr (kStaged) {
            // float f of the column's 9 P by lane f mod L: one load
            // instruction covers consecutive floats of a few entries
            int* ent = rows_of + group * (P + 1);
            float* span = stage + group * kSpan;
#pragma unroll
            for (int j = 0; j < S; ++j) ent[lane + L * j] = e[j];
            __syncwarp();
            float w[9 * S];
#pragma unroll
            for (int r = 0; r < 9 * S; ++r) {
                const int f = r * L + lane, q = f / 9;
                const int eq = ent[q];
                w[r] = eq >= 0 ? values[9LL * eq + (f - 9 * q)] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < 9 * S; ++r) span[r * L + lane] = w[r];
            __syncwarp();
#pragma unroll
            for (int j = 0; j < S; ++j)
#pragma unroll
                for (int c = 0; c < 9; ++c)
                    v[j][c] = span[9 * (lane + L * j) + c];
        } else {
#pragma unroll
            for (int j = 0; j < S; ++j) {
                const float* q = values + 9LL * es[j];
#pragma unroll
                for (int c = 0; c < 9; ++c) v[j][c] = q[c];
            }
        }
        float p0[S], p1[S], p2[S];
#pragma unroll
        for (int j = 0; j < S; ++j) {
            const bool use =
                e[j] >= 0 && static_cast<int>(es[j] - row[j] * K) != sk[j];
            p0[j] = use ? spmv_t_term(v[j], 0, g0[j], g1[j], g2[j], m[j])
                        : 0.f;
            p1[j] = use ? spmv_t_term(v[j], 1, g0[j], g1[j], g2[j], m[j])
                        : 0.f;
            p2[j] = use ? spmv_t_term(v[j], 2, g0[j], g1[j], g2[j], m[j])
                        : 0.f;
        }
        float s0 = lane_sum<S>(p0), s1 = lane_sum<S>(p1), s2 = lane_sum<S>(p2);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) {
            s0 += __shfl_down_sync(full, s0, off, L);
            s1 += __shfl_down_sync(full, s1, off, L);
            s2 += __shfl_down_sync(full, s2, off, L);
        }
        if (col < N && lane == 0) {
            float* out = gx + 3LL * col;
            out[0] = __fmul_rn(alpha, s0);
            out[1] = __fmul_rn(alpha, s1);
            out[2] = __fmul_rn(alpha, s2);
        }
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

// The rows of a staged form's shared layout at `blocks` blocks: the most
// rows a block owns (cluster and resident forms) or the widest slice of
// one color (stream). Mirrored by ops/ell_kernels.gs_layout_rows.
int gs_layout_rows(const int* offs, int n_colors, int form, int blocks) {
    int most = 0;
    for (int r = 0; r < blocks; ++r) {
        int rows = 0;
        for (int c = 0; c < n_colors; ++c) {
            const int cnt = slice_start(offs, c, r + 1, blocks)
                            - slice_start(offs, c, r, blocks);
            if (form == kGsStream) most = max(most, cnt);
            rows += cnt;
        }
        if (form != kGsStream) most = max(most, rows);
    }
    return most;
}

// Dynamic shared memory of a form: the Tables of `rows` rows (two for the
// stream form) and the cluster forms' x. Mirrored by gs_smem_bytes.
long long gs_smem_bytes(int form, int N, int K, int rows) {
    const long long tables = 1LL * gs_row_floats(K) * rows;
    switch (form) {
        case kGsCluster: return 4 * (4LL * N + tables);
        case kGsResident: return 4 * tables;
        case kGsStream: return 8 * tables;
        default: return 0;
    }
}

// The cost model of ell_gs_plan, in device microseconds of an H100 (fitted
// by scripts/ell_tilings.py --fit to its --sweep of every form at the main
// paths' levels: the plan's picks within ~5% of the fastest launch
// measured), per
// form: {launch, a KB staged by a block, a pass, a block a pass, a round of
// a block's row groups a pass (the coop form: its warps' rows; the staged
// forms: the most rows a block relaxes in a pass over kGsGroups), a KB a
// block reads a pass}. Mirrored by ops/ell_kernels.GS_MODEL.
constexpr double kGsModel[kGsForms][6] = {
    {0.02696, 0.0, 0.2699, 0.00539, 0.0, 0.166},      // coop
    {8.294, 0.02867, 0.3159, 0.01804, 0.7804, 0.0},   // cluster
    {5.272, 0.02945, 1.553, 0.001241, 0.762, 0.0},    // resident
    {3.806, 0.0, 1.491, 0.007088, 0.0, 0.03735},      // stream
};

// The modelled device microseconds of a call of `passes` passes in a form
// at `blocks` blocks (the coop form: the blocks it launches for its widest
// color, at most 8 an SM). Mirrored by ops/ell_kernels.gs_cost.
double gs_cost(const int* offs, int n_colors, int N, int K, int passes,
               int form, int blocks) {
    int widest = 0;
    for (int c = 0; c < n_colors; ++c)
        widest = max(widest, offs[c + 1] - offs[c]);
    const double row_kb = gs_row_floats(K) * 4.0 / 1024.0;
    const double* m = kGsModel[form];
    double stage_kb = 0.0, pass_kb = 0.0, rounds;
    if (form == kGsCoop) {
        rounds = double((widest + blocks * kRowsPerBlock - 1)
                        / (blocks * kRowsPerBlock));
        pass_kb = rounds * kRowsPerBlock * row_kb;
    } else {
        const int wide = gs_layout_rows(offs, n_colors, kGsStream, blocks);
        rounds = double(wide) / kGsGroups;  // a block's rows a pass, in groups
        if (form == kGsStream)
            pass_kb = wide * row_kb;
        else
            stage_kb = gs_smem_bytes(form, N, K, gs_layout_rows(
                           offs, n_colors, form, blocks)) / 1024.0;
    }
    const double p = passes;
    return m[0] + m[1] * stage_kb + m[2] * p + m[3] * (p * blocks)
           + m[4] * (p * rounds) + m[5] * (p * pass_kb);
}

// The passes of a call of `iterations` with m non-empty colors.
int gs_passes(int m, int iterations) {
    if (iterations < 1 || m < 1) return 0;
    return m == 1 ? 1 : iterations * (2 * m - 2) + 1;
}

constexpr int kGsMaxDevices = 16;
const void* const kGsKernels[kGsForms] = {
    reinterpret_cast<const void*>(ell_gs_coop_kernel),
    reinterpret_cast<const void*>(ell_gs_cluster_kernel),
    reinterpret_cast<const void*>(ell_gs_grid_kernel<false>),
    reinterpret_cast<const void*>(ell_gs_grid_kernel<true>),
};

// Lets a staged form's kernel take up to kGsSmemCap bytes of dynamic shared
// memory (and the cluster forms clusters of up to 16 blocks), once per
// device.
cudaError_t gs_allow(int form) {
    static bool allowed[kGsMaxDevices][kGsForms] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kGsMaxDevices) return cudaErrorInvalidDevice;
    if (form == kGsCoop || allowed[dev][form]) return cudaSuccess;
    e = cudaFuncSetAttribute(kGsKernels[form],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kGsSmemCap);
    if (e == cudaSuccess && form == kGsCluster)
        e = cudaFuncSetAttribute(
            kGsKernels[form],
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    allowed[dev][form] = e == cudaSuccess;
    return e;
}

// The launch of a cluster form: one cluster of `blocks` blocks.
cudaLaunchConfig_t gs_cluster_config(int blocks, long long smem,
                                     cudaStream_t st,
                                     cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kGsThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// Whether a staged form at `blocks` blocks can be launched on the current
// device with `smem` bytes a block: within kGsSmemCap, a cluster of at most
// kMaxCluster blocks that the card can place (cudaOccupancyMaxActiveClusters
// >= 1), or at most one block an SM for the cooperative forms (which must
// all be resident). *ok false and cudaSuccess when it cannot.
cudaError_t gs_launchable(int form, int blocks, long long smem, bool* ok) {
    *ok = false;
    if (smem > kGsSmemCap || blocks < 1) return cudaSuccess;
    cudaError_t e = gs_allow(form);
    if (e != cudaSuccess) return e;
    if (form == kGsCluster) {
        if (blocks > kMaxCluster) return cudaSuccess;
        cudaLaunchAttribute attr[1];
        const cudaLaunchConfig_t cfg =
            gs_cluster_config(blocks, smem, nullptr, attr);
        int clusters = 0;
        e = cudaOccupancyMaxActiveClusters(&clusters, kGsKernels[form], &cfg);
        *ok = e == cudaSuccess && clusters >= 1;
        return e;
    }
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kGsKernels[form], kGsThreads, static_cast<size_t>(smem));
    *ok = e == cudaSuccess && per_sm >= 1 && blocks <= sms;
    return e;
}

// The lanes a row of ell_jacobi and ell_jacobi_bwd at N rows on a card of
// `sms` SMs: the most of 32 and 16 whose launch (256 / G rows a block)
// fits one wave at 8 blocks an SM, else 8. Mirrored by
// ops/ell_kernels.jacobi_lanes.
int jacobi_lanes(int N, int sms) {
    for (int G = 32; G > 8; G >>= 1)
        if (blocks_for_groups(N, G) <= 8 * sms) return G;
    return 8;
}

// The SMs of the current device, asked once per device.
cudaError_t device_sms(int* sms) {
    static int known[kGsMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kGsMaxDevices) return cudaErrorInvalidDevice;
    if (known[dev] == 0)
        e = cudaDeviceGetAttribute(&known[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    *sms = known[dev];
    return e;
}

// ell_spmv_t's form at P = row_lanes(Kt) <= 32 lanes a column: the staged
// form at P = 32 (the hex meshes' 27), the lanes form on narrower tables
// (the cloth's 7 on 8).
__host__ __device__ constexpr int spmv_t_form(int P) {
    return P == 32 ? kSpmvTStaged : kSpmvTLanes;
}

// Whether ell_spmv_t takes P / 2 lanes a column (two entries a lane) at N
// columns on a card of `sms` SMs rather than P: where the grid on P lanes
// would hold a block an SM in the staged form (2,025 to 74,273 columns of
// 27), two in the lanes form (16,641 columns of 7).
bool spmv_t_half(int N, int P, int sms) {
    return P >= 2 && blocks_for_groups(N, P) >=
                         (spmv_t_form(P) == kSpmvTStaged ? 1 : 2) * sms;
}

// ell_spmv_t's form and lanes a column at N columns of Kt entries on a
// card of `sms` SMs: plan = {form, lanes}, measured on an H100
// (scripts/spmv_t_forms.py forces each form and lane count). Kt > 32: the
// strided form at 32; else spmv_t_form and spmv_t_half. Mirrored by
// ops/ell_kernels.spmv_t_plan.
void spmv_t_plan(int N, int Kt, int sms, int* plan) {
    const int P = row_lanes(Kt);
    plan[0] = Kt > 32 ? kSpmvTStrided : spmv_t_form(P);
    plan[1] = Kt > 32 ? 32 : (spmv_t_half(N, P, sms) ? P / 2 : P);
}

struct SpmvTArgs {
    const float* values;
    const float* mask;
    const int* tt;
    const int* skip;
    const float* g;
    float* gx;
    float alpha;
    int N, K, Kt;
};

// One ell_spmv_t launch in the form of P lanes at L lanes and S entries a
// lane, K a constant where it is KC.
template <int P, int L, int S, int KC>
void spmv_t_launch(const SpmvTArgs& a, cudaStream_t st) {
    constexpr int Form = spmv_t_form(P);
    auto kernel = KC > 0 && a.K == KC ? ell_spmv_t_kernel<Form, L, S, KC>
                                      : ell_spmv_t_kernel<Form, L, S, 0>;
    kernel<<<blocks_for_groups(a.N, L), kThreads, 0, st>>>(
        a.values, a.mask, a.tt, a.skip, a.g, a.gx, a.alpha, a.N, a.K, a.Kt);
}

// The launch at P = row_lanes(Kt) lanes (an entry a lane) or P / 2 (two),
// as `lanes` says; K a constant at the widths of the hex meshes (27 of 32)
// and of the cloth (7 of 8).
template <int P>
void spmv_t_at(int lanes, const SpmvTArgs& a, cudaStream_t st) {
    constexpr int KC = P == 32 ? 27 : (P == 8 ? 7 : 0);
    if constexpr (P >= 2)
        if (lanes == P / 2) return spmv_t_launch<P, P / 2, 2, KC>(a, st);
    spmv_t_launch<P, P, 1, KC>(a, st);
}

// One ell_jacobi_bwd launch at G lanes a row in its form.
template <int G>
void jacobi_bwd_launch(const RelaxArgs& A, const float* xt, const float* gbar,
                       float* lam, float* gb, float* gv, int accumulate, int N,
                       cudaStream_t st) {
    const int blocks = blocks_for_groups(N, G);
    const size_t smem = 4 * static_cast<size_t>(bwd_span_floats(A.K, G));
    if (gv == nullptr)
        ell_jacobi_bwd_kernel<G, kBwdNoGv><<<blocks, kThreads, 0, st>>>(
            A, xt, gbar, lam, gb, gv, accumulate, N);
    else if (xt != nullptr)
        ell_jacobi_bwd_kernel<G, kBwdFromXt><<<blocks, kThreads, smem, st>>>(
            A, xt, gbar, lam, gb, gv, accumulate, N);
    else
        ell_jacobi_bwd_kernel<G, kBwdZero><<<blocks, kThreads,
                                             accumulate ? 0 : smem, st>>>(
            A, xt, gbar, lam, gb, gv, accumulate, N);
}

// One ell_jacobi iteration at G lanes a row, in the zero-start form or
// from xin.
template <int G>
void jacobi_launch(const RelaxArgs& A, bool zero, const float* xin,
                   float* xout, int N, cudaStream_t st) {
    const int blocks = blocks_for_groups(N, G);
    if (zero)
        ell_jacobi_kernel<G, true><<<blocks, kThreads, 0, st>>>(
            A, nullptr, xout, N);
    else
        ell_jacobi_kernel<G, false><<<blocks, kThreads, 0, st>>>(
            A, xin, xout, N);
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
// classes (a host array, copied). One launch, in the form and with the
// blocks that ell_gs_plan picked (or a caller chose): kGsCoop (blocks
// ignored), a cluster form (1 to 16 blocks) or a cooperative staged form
// (at most one block an SM). A form that cannot be launched so (its shared
// memory over 227 KB, a cluster the card cannot place, more blocks than
// SMs) returns cudaErrorLaunchOutOfResources; nothing else is run instead.
// Requires 1 <= K <= 32, 1 <= n_colors <= 16, iterations >= 0, and every
// color an independent set of the matrix graph.
int ell_gs(const float* values, const int* nbr, const float* mask,
           const int* diag_slot, const int* offs, int n_colors,
           const float* b, float* x, int N, int K, int iterations, int form,
           int blocks, void* stream) {
    if (N < 1 || K < 1 || K > 32 || n_colors < 1 || n_colors > kMaxColors
        || iterations < 0 || form < 0 || form >= kGsForms)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    GsArgs P = {};
    P.A = RelaxArgs{values, nbr, mask, diag_slot, b, K};
    P.x = x;
    P.N = N;
    int widest = 0;
    for (int c = 0; c <= n_colors; ++c) P.offs[c] = offs[c];
    for (int c = 0; c < n_colors; ++c) {
        widest = max(widest, offs[c + 1] - offs[c]);
        if (offs[c + 1] > offs[c]) P.seq[P.m++] = c;
    }
    P.passes = gs_passes(P.m, iterations);
    if (P.passes == 0) return 0;
    cudaError_t e;
    if (form == kGsCoop) {
        int dev = 0, sms = 0, per_sm = 0;
        e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, ell_gs_coop_kernel, kThreads, 0);
        if (e == cudaSuccess && per_sm < 1) e = cudaErrorLaunchOutOfResources;
        if (e != cudaSuccess) return static_cast<int>(e);
        const int want = blocks_for_rows(widest), cap = sms * per_sm;
        void* args[] = {&P};
        e = cudaLaunchCooperativeKernel(kGsKernels[kGsCoop],
                                        dim3(want < cap ? want : cap),
                                        dim3(kThreads), args, 0, st);
    } else {
        if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
        P.rows = gs_layout_rows(offs, n_colors, form, blocks);
        const long long smem = gs_smem_bytes(form, N, K, P.rows);
        bool ok = false;
        e = gs_launchable(form, blocks, smem, &ok);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (!ok) return static_cast<int>(cudaErrorLaunchOutOfResources);
        void* args[] = {&P, &n_colors};
        if (form == kGsCluster) {
            cudaLaunchAttribute attr[1];
            const cudaLaunchConfig_t cfg =
                gs_cluster_config(blocks, smem, st, attr);
            e = cudaLaunchKernelExC(&cfg, kGsKernels[form], args);
        } else {
            e = cudaLaunchCooperativeKernel(
                kGsKernels[form], dim3(blocks), dim3(kGsThreads), args,
                static_cast<size_t>(smem), st);
        }
    }
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : last);
}

// The form and blocks ell_gs runs a call of `iterations` in on the current
// device: plan = {form, blocks, modelled device us x 1000}, the least
// gs_cost among the coop form, every cluster of 1 to 16 blocks and every
// count of blocks up to the SM count of the resident and stream forms that
// gs_launchable takes (ties: the first in that order). Mirrored by
// ops/ell_kernels.gs_plan. Returns a CUDA error code.
int ell_gs_plan(int N, int K, const int* offs, int n_colors, int iterations,
                int* plan) {
    if (N < 1 || K < 1 || K > 32 || n_colors < 1 || n_colors > kMaxColors)
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0, m = 0, widest = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    for (int c = 0; c < n_colors; ++c) {
        m += offs[c + 1] > offs[c];
        widest = max(widest, offs[c + 1] - offs[c]);
    }
    const int passes = gs_passes(m, iterations > 0 ? iterations : 1);
    double best = gs_cost(offs, n_colors, N, K, passes, kGsCoop,
                          min(blocks_for_rows(widest), 8 * sms));
    plan[0] = kGsCoop;
    plan[1] = 0;
    for (int form = kGsCluster; form < kGsForms; ++form) {
        const bool cluster = form == kGsCluster;
        for (int blocks = 1; blocks <= (cluster ? kMaxCluster : sms);
             ++blocks) {
            const long long smem = gs_smem_bytes(
                form, N, K, gs_layout_rows(offs, n_colors, form, blocks));
            if (smem > kGsSmemCap) continue;
            const double cost =
                gs_cost(offs, n_colors, N, K, passes, form, blocks);
            if (cost >= best) continue;
            bool ok = false;
            e = gs_launchable(form, blocks, smem, &ok);
            if (e != cudaSuccess) return static_cast<int>(e);
            if (!ok) continue;
            best = cost;
            plan[0] = form;
            plan[1] = blocks;
        }
    }
    plan[2] = static_cast<int>(best * 1000.0);
    return 0;
}

// Block Jacobi, `iterations` times: xa (N, 3) holds x0 (zero_start != 0:
// x0 is zero and xa is not read); iteration t reads one buffer and writes
// the other, so the result is in xa for an even count and in xb for an
// odd one. One launch an iteration, the first in the zero-start form when
// zero_start is set; jacobi_lanes(N, sms) lanes a row.
int ell_jacobi(const float* values, const int* nbr, const float* mask,
               const int* diag_slot, const float* b, float* xa, float* xb,
               int N, int K, int iterations, int zero_start, void* stream) {
    if (N < 1 || K < 1 || K > 32 || iterations < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    int sms = 0;
    const cudaError_t e = device_sms(&sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int lanes = jacobi_lanes(N, sms);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const RelaxArgs A{values, nbr, mask, diag_slot, b, K};
    for (int it = 0; it < iterations; ++it) {
        const bool zero = zero_start && it == 0;
        float* in = it % 2 ? xb : xa;
        float* out = it % 2 ? xa : xb;
        switch (lanes) {
            case 8: jacobi_launch<8>(A, zero, in, out, N, st); break;
            case 16: jacobi_launch<16>(A, zero, in, out, N, st); break;
            default: jacobi_launch<32>(A, zero, in, out, N, st); break;
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// gx (N, 3) = alpha * (values^T-gather of g), through the transpose table
// tt (N, Kt) int32 of flat entries (-1 padded); skip (N,) int32 or null: the
// slot of each row to leave out (the diagonal, for the Jacobi adjoint).
// One launch in the form and at the lanes a column spmv_t_plan picks.
// Requires N >= 1, K >= 1, Kt >= 1 and every table entry < N * K.
int ell_spmv_t(const float* values, const float* mask, const int* tt,
               const int* skip, const float* g, float* gx, float alpha, int N,
               int K, int Kt, void* stream) {
    if (N < 1 || K < 1 || Kt < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    int sms = 0;
    const cudaError_t e = device_sms(&sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    int plan[2];
    spmv_t_plan(N, Kt, sms, plan);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const SpmvTArgs a{values, mask, tt, skip, g, gx, alpha, N, K, Kt};
    switch (Kt > 32 ? 0 : row_lanes(Kt)) {
        case 0:
            ell_spmv_t_kernel<kSpmvTStrided, 32, 1, 0>
                <<<blocks_for_rows(N), kThreads, 0, st>>>(
                    values, mask, tt, skip, g, gx, alpha, N, K, Kt);
            break;
        case 1: spmv_t_at<1>(plan[1], a, st); break;
        case 2: spmv_t_at<2>(plan[1], a, st); break;
        case 4: spmv_t_at<4>(plan[1], a, st); break;
        case 8: spmv_t_at<8>(plan[1], a, st); break;
        case 16: spmv_t_at<16>(plan[1], a, st); break;
        default: spmv_t_at<32>(plan[1], a, st); break;
    }
    return static_cast<int>(cudaGetLastError());
}

// ell_spmv_t's form and lanes a column for N columns of Kt entries on the
// current device (spmv_t_plan, what ell_spmv_t launches): plan = {form,
// lanes}. Returns a CUDA error code.
int ell_spmv_t_plan(int N, int Kt, int* plan) {
    if (N < 1 || Kt < 1) return static_cast<int>(cudaErrorInvalidValue);
    int sms = 0;
    const cudaError_t e = device_sms(&sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    spmv_t_plan(N, Kt, sms, plan);
    return 0;
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
    int sms = 0;
    const cudaError_t e = device_sms(&sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const RelaxArgs A{values, nbr, mask, diag_slot, b, K};
    // without the values' gradient a row's lanes all do the same work: the
    // fewest of them (8 lanes measured 1.58-1.63 us at 2,025-2,997 rows on
    // an H100, 32 lanes 1.76-2.25)
    switch (gv == nullptr ? 8 : jacobi_lanes(N, sms)) {
        case 32:
            jacobi_bwd_launch<32>(A, xt, gbar, lam, gb, gv, accumulate, N, st);
            break;
        case 16:
            jacobi_bwd_launch<16>(A, xt, gbar, lam, gb, gv, accumulate, N, st);
            break;
        default:
            jacobi_bwd_launch<8>(A, xt, gbar, lam, gb, gv, accumulate, N, st);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
