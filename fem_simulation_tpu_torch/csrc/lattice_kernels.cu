// Hand-written CUDA kernels of the structured-lattice dynamic step (sm_90a).
//
// Plain C interface, loaded with ctypes by ops/_cuda.py. Every entry point
// launches on the stream it is given, allocates nothing (the torch wrapper
// passes outputs and scratch), does not synchronise, and returns the CUDA
// error code of its launches (0 = success).
//
// Kernels and the TPU kernels they replace (fem_simulation_tpu/ops/
// pallas_lattice.py):
//
// * lat_force replaces _run (pallas_call at :306), reached through force_cf;
//   _chain/_chain_into at :61-126. Bound on this card: the chain is
//   arithmetic (449 FLOP per cell and quad point); the bytes are one read of
//   u and one write of the force. The Pallas kernel accumulated into a
//   VMEM-resident output by shifted read-modify-writes over the grid in
//   order; blocks here run in no order. Design: one launch, a block per
//   halo tile of vertices (plan: ops/lattice_kernels.force_plan), the
//   tile's vertex box staged in shared memory, a thread a cell with the
//   quadrature points in sequence, corner sums through shared memory in
//   fixed corner order: no cell scratch in device memory, no atomics, two
//   runs give identical bits. Halo tiles compute the cells between two
//   tiles twice; where that costs more than a second launch (the 74k beam)
//   the plan takes the two passes instead: a thread a cell writes its 8
//   corner contributions to a kept scratch, a vertex pass gathers them.
//   Eight lanes a cell, as the fused kernel runs, and exchange tiles (each
//   cell once, shared vertices' partial sums handed over through device
//   memory and tickets) were built and timed, and lost (PERF.md).
// * lat_hvp replaces the same _run through hvp_cf (763 FLOP per cell and
//   quad point), and serves the multigrid's level operator
//   (H(u) p + ctrl p) vm (JAX sim/lattice_mg.py:382-392) through the same
//   launch: the shift and mask are its vertex pass's epilogue. One launch,
//   a block per halo tile (lat_force's tiles, a thread a cell, corner sums
//   in shared memory in fixed order; plan: ops/lattice_kernels.hvp_plan),
//   or, where the plan's model says the cells computed twice cost more
//   than a second launch, PR 1's two passes: a thread a cell writes its 8
//   corner contributions to a scratch and a vertex pass gathers them.
// * lat_cheby and lat_power replace the same _run as the JAX multigrid's
//   Chebyshev smoother (LatticeMG._smooth_cheby, sim/lattice_mg.py:481-502)
//   and power iteration (LatticeMG._est_lmax, :469-479) apply it: a whole
//   smoothing call, or a level's whole power iteration, in one launch whose
//   blocks keep the level's fields in shared memory (see level_kernel).
// * lat_diag replaces _run_diag (pallas_call at :251), entry
//   hess_diag_lattice; _diag_into at :129-164 (930 FLOP per cell and quad
//   point, 6 symmetric channels a vertex), and with the multigrid's shift
//   and SPD projection in its vertex pass serves lat_diag_shift. As lat_hvp:
//   one launch on halo tiles, a thread a cell, or where its plan says the
//   two passes (see diag_tiles_kernel).
// * lat_energy replaces _run_energy (pallas_call at :200), entry
//   elastic_energy_lattice; _make_energy_kernel at :166-189. One launch:
//   psi per cell (eight lanes a cell, one quadrature point each, on small
//   lattices; a thread a cell on large ones), per-block partial sums, and
//   the last block to finish (an atomic ticket, reset for the next call)
//   adds the partials in index order; the scalar stays on the device.
//   Bound: latency (225 FLOP per cell and quad point are under 2 us of the
//   card's rate at 74k).
// * lat_fused_newton replaces _run_newton (pallas_call at :638), entry
//   fused_newton; _make_newton_kernel at :557-593, _pcg_in_kernel :480-535,
//   _sym_solve :462-477. One Newton iteration in one cooperative launch
//   (cudaLaunchCooperativeKernel) with grid.sync() between phases. Bound:
//   grid-wide barriers and the dependent reductions of PCG at the small
//   grids of the main path, the HVP chain at the large ones. Design: the
//   Pallas kernel kept r, p, ap and the diagonal in VMEM and walked the grid
//   in order. Here a block owns a tile of vertices and computes the cells
//   around them, eight lanes to a cell, one quadrature point each, and
//   sums the corner contributions through shared memory: the small
//   lattices fill the card, a thread holds a fraction of the accumulators
//   (128 registers, no spill by ptxas -v), and a PCG iteration needs 2 grid
//   barriers where a block computes its halo cells itself, 3 where blocks
//   exchange partial sums. r, z, p, ap and the diagonal live in device
//   memory (the 19k grid's whole PCG state is ~1 MB and stays in the 50 MB
//   L2). Every dot is summed as partials (a vector phase's per block, a
//   vertex pass's per tile, so that its bits do not depend on the tiles'
//   spread over the blocks); after the barrier EVERY block sums the same
//   partials in the same order, so all blocks hold bit-identical scalars
//   and take the same loop branch (a divergent branch around grid.sync()
//   would deadlock).
// * lat_fused_pcg replaces _run_pcg (pallas_call at :608), entry fused_pcg;
//   _make_pcg_kernel at :538-554 with the same _pcg_in_kernel. It is the
//   fused Newton kernel instantiated without its residual and trial phases
//   (template flag kPcg): the diagonal cell pass, the ctrl shift, and the
//   PCG loop on the given right-hand side, returning dx and k. Same bound
//   and the same deterministic partial sums and identical-branch guarantee.
// * The low-fill path: lat_force, lat_energy and lat_fused_newton take a
//   cover (ops/boxes.py), the counterpart of the JAX box cover
//   (fem_simulation_tpu/ops/boxes.py, box_vertex_op / box_scalar_op), which
//   ran every op box by box. Here each stays one launch and walks a list:
//   the active tiles (those whose vertices touch a real cell; Tiling::tiles)
//   in the fused Newton kernel's cell passes and in lat_force's halo tiles,
//   the real cells in lat_force's two-pass cell pass and in lat_energy's
//   walk. A cell computed is computed as on the dense grid and a vertex sums
//   its incident cells in the same corner order, so the force and the
//   residual equal the dense kernels' up to the sign of zero. What the
//   cover never writes (inactive tiles' vertices of the outputs) the kernel
//   zeroes; what it never writes in scratch (partial sums of inactive
//   exchange tiles, the cells the two passes skip) is the cover's own
//   zeroed workspace. Bound: as the dense kernels, over the real cells.
//
// No --use_fast_math: the build keeps IEEE division and square root.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "lattice_chain.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr float kEpsilon = 1e-7f;  // solvers.cg.EPSILON
// The fused kernels run 512 threads a block, one block an SM (128
// registers a thread fill the register file): 16 warps hide the latency of
// the per-point chains, and a grid of at most one block per SM keeps the
// grid barriers cheap.
constexpr int kFusedThreads = 512;
// Dynamic shared memory the fused kernels may ask for: the 48 corner
// channels of the diagonal pass for every cell of a tile (kScratchRows rows
// of `stride` floats), then two boxes of one float4 per vertex around the
// tile's cells. One block of this size fits an SM's 227 KB.
constexpr int kSmemCap = 200 * 1024;
constexpr int kScratchRows = 48;
// The standalone force and HVP tiles: a thread a cell, two blocks an SM.
constexpr int kForceThreads = 256;
constexpr int kForceRows = 24;              // 8 corners x 3 channels
// Dynamic shared memory of a force, HVP or diagonal tile, under the 48 KB a
// launch may take without opting in (the kernels have no static shared
// memory).
constexpr int kForceSmem = 48 * 1024;
// A diagonal tile's 48 rows of corner sums (96 with lat_diag_shift's
// partial sums) need more: it opts in to up to kDiagSmem (two blocks an SM
// still fit the SM's 228 KB).
constexpr int kDiagRows = 48;               // 8 corners x 6 channels
constexpr int kDiagSmem = 110 * 1024;
constexpr int kMaxDevices = 64;
// Blocks a covered lat_force on halo tiles adds to zero the vertices of the
// inactive tiles (each walks several).
constexpr int kZeroBlocks = 128;

ChainArgs make_chain_args(int X, int Y, int Z, const float* g_host,
                          float det, float mu, float la) {
    ChainArgs A;
    for (int i = 0; i < 8; ++i)
        for (int q = 0; q < 8; ++q)
            for (int d = 0; d < 3; ++d)
                A.G.g[i][q][d] = g_host[(i * 8 + q) * 3 + d];
    A.L.X = X;
    A.L.Y = Y;
    A.L.Z = Z;
    A.L.N = X * Y * Z;
    A.L.C = (X - 1) * (Y - 1) * (Z - 1);
    A.det = det;
    A.mu = mu;
    A.la = la;
    return A;
}

int blocks_for(int n) { return n > 0 ? (n + kThreads - 1) / kThreads : 1; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

// max that propagates NaN, as jnp.max does
__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
    return v;
}

// Block-wide sum in a fixed order; the result is returned to every thread.
// sh holds 33 floats. Every thread of the block must call it.
__device__ float block_sum(float v, float* sh) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    v = warp_sum(v);
    __syncthreads();  // sh may still be read from a previous call
    if (lane == 0) sh[w] = v;
    __syncthreads();
    if (w == 0) {
        v = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0.f;
        v = warp_sum(v);
        if (lane == 0) sh[32] = v;
    }
    __syncthreads();
    return sh[32];
}

// Two block-wide sums at once, behind one set of barriers; each is summed
// as block_sum sums it. sh holds 66 floats.
__device__ void block_sum2(float& a, float& b, float* sh) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    a = warp_sum(a);
    b = warp_sum(b);
    __syncthreads();
    if (lane == 0) {
        sh[w] = a;
        sh[33 + w] = b;
    }
    __syncthreads();
    if (w == 0) {
        const bool in = lane < (int)(blockDim.x >> 5);
        a = warp_sum(in ? sh[lane] : 0.f);
        b = warp_sum(in ? sh[33 + lane] : 0.f);
        if (lane == 0) {
            sh[32] = a;
            sh[65] = b;
        }
    }
    __syncthreads();
    a = sh[32];
    b = sh[65];
}

__device__ float block_max(float v, float* sh) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    v = warp_max(v);
    __syncthreads();
    if (lane == 0) sh[w] = v;
    __syncthreads();
    if (w == 0) {
        v = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0.f;
        v = warp_max(v);
        if (lane == 0) sh[32] = v;
    }
    __syncthreads();
    return sh[32];
}

// Sum of n partials: thread-strided then block_sum. Any block computes the
// same value from the same partials.
__device__ float partials_sum(const float* part, int n, float* sh) {
    float s = 0.f;
    for (int j = threadIdx.x; j < n; j += blockDim.x) s += part[j];
    return block_sum(s, sh);
}

// Two sums of n partials each at once (partials_sum's order).
__device__ void partials_sum2(const float* pa, const float* pb, int n,
                              float* sh, float& a, float& b) {
    a = 0.f;
    b = 0.f;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        a += pa[j];
        b += pb[j];
    }
    block_sum2(a, b, sh);
}

__device__ float partials_max(const float* part, int n, float* sh) {
    float m = 0.f;
    for (int j = threadIdx.x; j < n; j += blockDim.x) m = nan_max(m, part[j]);
    return block_max(m, sh);
}

// Adjugate solve of the symmetric 3x3 block (a b c; b dd e; c e f), masked
// by vm (pallas_lattice._sym_solve, ell.solve3x3 math).
__device__ __forceinline__ void sym_solve6(float a, float b, float c,
                                           float dd, float e, float f,
                                           const float r[3], float vm,
                                           float z[3]) {
    const float c00 = dd * f - e * e;
    const float c01 = e * c - b * f;
    const float c02 = b * e - dd * c;
    const float det = a * c00 + b * c01 + c * c02;
    const float c11 = a * f - c * c;
    const float c12 = b * c - a * e;
    const float c22 = a * dd - b * b;
    const float inv_det = det / (det * det + 1e-12f);
    z[0] = (c00 * r[0] + c01 * r[1] + c02 * r[2]) * inv_det * vm;
    z[1] = (c01 * r[0] + c11 * r[1] + c12 * r[2]) * inv_det * vm;
    z[2] = (c02 * r[0] + c12 * r[1] + c22 * r[2]) * inv_det * vm;
}

// The same of the 6-channel block at vertex v of d6 (6, N).
__device__ __forceinline__ void sym_solve(const float* d6, int N, int v,
                                          const float r[3], float vm,
                                          float z[3]) {
    sym_solve6(d6[v], d6[N + v], d6[2 * N + v], d6[3 * N + v], d6[4 * N + v],
               d6[5 * N + v], r, vm, z);
}

// ---------------------------------------------------------------------------
// Two-pass kernels: hvp, diag (its vertex pass is gather_diag)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
hvp_cells(const __grid_constant__ ChainArgs A, const float* __restrict__ u,
          const float* __restrict__ p, const float* __restrict__ cm,
          float* __restrict__ cf) {
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < A.L.C;
         c += gridDim.x * blockDim.x)
        cell_hvp(A, u, p, cm, cf, c);
}

// The diagonal's cell pass, a thread a cell (two blocks an SM): diag_chain
// (kPairs: its two slots of partial sums in shared memory, 96 floats a
// thread) with each corner read through the read-only cache at every
// point, the cell's 48 corner sums scaled by det * cell mask to the scratch
// cd[(corner * 6 + channel) * C + c].
template <bool kPairs>
__global__ void __launch_bounds__(kThreads, 2)
diag_cells(const __grid_constant__ ChainArgs A, const float* __restrict__ u,
           const float* __restrict__ cm, float* __restrict__ cd) {
    // kPairs: 96 rows of kThreads floats (a constant row stride, so that
    // every row's offset is an immediate)
    extern __shared__ float4 smem[];
    float* st = reinterpret_cast<float*>(smem) + threadIdx.x;
    const Lattice& L = A.L;
    const int N = L.N, YZ = L.Y * L.Z;
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < L.C;
         c += gridDim.x * blockDim.x) {
        int cx, cy, cz;
        cell_coords(L, c, cx, cy, cz);
        const int v0 = corner_vertex(L, cx, cy, cz, 0);
        float acc[8][6];
        diag_chain<kPairs>(
            A.G, A.mu, A.la,
            [&](int i) {
                const int v = v0 + ((i >> 2) & 1) * YZ + ((i >> 1) & 1) * L.Z
                            + (i & 1);
                return make_float3(__ldg(u + v), __ldg(u + N + v),
                                   __ldg(u + 2 * N + v));
            },
            [&](int slot, const float (*a)[6]) {
#pragma unroll
                for (int j = 0; j < 48; ++j)
                    st[(slot * 48 + j) * kThreads] = a[j / 6][j % 6];
            },
            [&](int slot, float (*a)[6]) {
#pragma unroll
                for (int j = 0; j < 48; ++j)
                    a[j / 6][j % 6] =
                        st[(slot * 48 + j) * kThreads] + a[j / 6][j % 6];
            },
            acc);
        const float w = A.det * cm[c];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int ch = 0; ch < 6; ++ch)
                cd[(i * 6 + ch) * L.C + c] = acc[i][ch] * w;
        }
    }
}

// out[ch][v] = sum over incident cells of scratch channel ch
template <int NCH>
__global__ void __launch_bounds__(kThreads)
gather_vertices(Lattice L, const float* __restrict__ cf,
                float* __restrict__ out) {
    for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < L.N;
         v += gridDim.x * blockDim.x) {
        int x, y, z;
        vertex_coords(L, v, x, y, z);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
            out[ch * L.N + v] = gather_vertex<NCH>(L, cf, ch, x, y, z);
    }
}

// ---------------------------------------------------------------------------
// Fused Newton iteration: one cooperative launch
// ---------------------------------------------------------------------------
//
// Work split. The vertex lattice is cut into tiles (a balanced partition
// along each axis, chosen on the host for the lattice and the card, see
// lat_newton_plan). A block owns a tile's vertices. Eight lanes share a
// cell, one quadrature point each (lattice_chain.cuh), and leave the cell's
// 8 corner contributions in shared memory; after a __syncthreads the
// block's threads sum, for each vertex, the incident cells in fixed corner
// order. The sums have a fixed order, so two runs give identical bits.
// Which cells a block computes is the tiling's mode:
//
// * halo (small lattices, where grid barriers are most of the time): every
//   cell that touches one of the tile's vertices, so neighbouring blocks
//   compute the cells between them twice, every vertex sum is complete
//   inside its block, and a cell pass and its vertex pass need no grid
//   barrier between them: 2 barriers per PCG iteration.
// * exchange (large lattices, where the chains are most of the time): each
//   cell once, by the tile that owns its lowest corner. A block writes, for
//   its own vertices and for those one plane above it, the partial sums of
//   its own cells to device memory (slot = which of the three upper faces
//   the vertex lies on); after one grid barrier each owner adds the up to 8
//   partials of a vertex in slot order: 3 barriers per PCG iteration.
//
// The direction p = z + beta p is never formed in a pass of its own: it is
// formed where it is consumed (at the cell corners and at the owner's
// vertex pass) from z and the previous p, which lives in the other half of
// a two-buffer p.

// How the vertex lattice is cut among blocks.
struct Tiling {
    int ntx, nty, ntz;  // tiles along each axis
    int stride;         // shared scratch: floats per (corner, channel) row,
                        // >= the cell count of the largest tile
    int box;            // shared vertex box: >= the vertex count of the box
                        // around the largest tile's cells
    int halo;           // 1: halo mode, 0: exchange mode
    // A cover (ops/boxes.py): the active tiles, those whose vertices touch a
    // real cell, in increasing order, then the inactive ones. A pass walks
    // tiles[0, n_active) only. Null: every tile, in index order.
    const int* tiles;
    int n_active;
};

// One tile: its vertices [x0, x0 + nx) x ... and the cells it computes
// [cx0, cx0 + ex) x ... (halo mode: every cell incident to one of its
// vertices; exchange mode: the cells whose lowest corner it owns).
struct Tile {
    int x0, y0, z0, nx, ny, nz;
    int cx0, cy0, cz0, ex, ey, ez;
    int ix, iy, iz;
};

__host__ __device__ __forceinline__ void tile_axis(int n, int nt, int it,
                                                   int halo, int& v0, int& nv,
                                                   int& c0, int& nc) {
    v0 = it * n / nt;
    const int v1 = (it + 1) * n / nt;
    nv = v1 - v0;
    c0 = halo && v0 > 0 ? v0 - 1 : v0;
    const int c1 = v1 - 1 < n - 2 ? v1 - 1 : n - 2;  // last cell, inclusive
    nc = c1 - c0 + 1;                                // may be 0 (exchange)
}

// The tiles a pass walks, and the j-th of them (see Tiling::tiles).
__device__ __forceinline__ int tiles_walked(const Tiling& T) {
    return T.tiles ? T.n_active : T.ntx * T.nty * T.ntz;
}
__device__ __forceinline__ int tile_id(const Tiling& T, int j) {
    return T.tiles ? T.tiles[j] : j;
}

__device__ __forceinline__ Tile tile_of(const Lattice& L, const Tiling& T,
                                        int t) {
    Tile R;
    R.iz = t % T.ntz;
    const int r = t / T.ntz;
    R.iy = r % T.nty;
    R.ix = r / T.nty;
    tile_axis(L.X, T.ntx, R.ix, T.halo, R.x0, R.nx, R.cx0, R.ex);
    tile_axis(L.Y, T.nty, R.iy, T.halo, R.y0, R.ny, R.cy0, R.ey);
    tile_axis(L.Z, T.ntz, R.iz, T.halo, R.z0, R.nz, R.cz0, R.ez);
    return R;
}

// Under a cover: zero the 3-channel fields a (and b, if given) at the
// vertices of the inactive tiles TL.tiles[n_active, ntiles), the j-th from
// `first` in steps of `step`. No real cell touches those vertices, so the
// dense kernels give them +-0 there; a covered pass never reaches them.
__device__ __forceinline__ void zero_inactive(const Lattice& L,
                                              const Tiling& TL, int first,
                                              int step, float* a, float* b) {
    const int N = L.N, ntiles = TL.ntx * TL.nty * TL.ntz;
    for (int j = TL.n_active + first; j < ntiles; j += step) {
        const Tile T = tile_of(L, TL, TL.tiles[j]);
        for (int vl = threadIdx.x; vl < T.nx * T.ny * T.nz; vl += blockDim.x) {
            const int z = T.z0 + vl % T.nz, t = vl / T.nz;
            const int v = ((T.x0 + t / T.ny) * L.Y + T.y0 + t % T.ny) * L.Z + z;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                a[c * N + v] = 0.f;
                if (b) b[c * N + v] = 0.f;
            }
        }
    }
}

struct NewtonArgs {
    ChainArgs A;
    Tiling T;
    const float* u;     // (3, N) displacement
    const float* s;     // (3, N) affine residual part (includes -rc*x0);
                        // with kPcg the right-hand side of the solve
    const float* cm;    // (C,) cell mask
    const float* ctrl;  // (N,) Hessian diagonal shift
    const float* rc;    // (N,) residual linear coefficient (not kPcg)
    const float* vm;    // (N,) vertex mask
    float* dx;          // (3, N) out: Newton step
    float* f;           // (3, N) out: residual at u (not kPcg)
    float* fn;          // (1,) out: ||f(u + dx vm)||_inf (not kPcg)
    int* k;             // (1,) out: PCG count (matvecs = k - 1)
    float* r;           // (3, N) scratch: residual of the solve
    float* z;           // (3, N) scratch: preconditioned residual
    float* p;           // (2, 3, N) scratch: this and the previous direction
    float* ap;          // (3, N) scratch
    float* xacc;        // (3, N) scratch: the normalized solution
    float* d6;          // (6, N) scratch: ctrl-shifted diagonal blocks
    float* part;        // (5 gridDim.x + ntiles) scratch: per-block
                        // partials, then per-tile partials
    float* pbuf;        // (8, 9, N) scratch, exchange mode: partial vertex
                        // sums by slot; rows 0-2 force / hvp, 3-8 diagonal
    float tol;          // PCG tolerance, relative on ||r||^2
    int iterations;     // PCG budget
};

// The standalone HVP on halo tiles (lat_hvp), with the level operator's
// epilogue when ctrl is given.
struct HvpArgs {
    ChainArgs A;
    Tiling T;
    const float* u;     // (3, N) displacement
    const float* p;     // (3, N) direction
    const float* cm;    // (C,) cell mask
    const float* ctrl;  // (N,) diagonal shift, or null: H(u) p alone
    const float* vm;    // (N,) vertex mask (with ctrl)
    float* out;         // (3, N) H(u) p, or (H(u) p + ctrl p) vm
};

enum CellOp { kForce, kTrial, kHvp, kDiag };

// What a cell pass reads besides u: the step scale of the trial pass, or
// the previous direction and beta of the HVP pass.
struct CellIn {
    float sb;
    const float* pprev;
    float beta;
    bool have_prev;
};

// The first term of the HVP pass's direction: z for the PCG of the fused
// kernels (p = z + beta p_prev); the standalone HVP passes the whole
// direction in CellIn::pprev with have_prev false.
__device__ __forceinline__ const float* hvp_dir(const NewtonArgs& P,
                                                const CellIn&) {
    return P.z;
}
template <class Args>
__device__ __forceinline__ const float* hvp_dir(const Args&,
                                                const CellIn& in) {
    return in.pprev;
}

// Component r at vertex v of the HVP pass's direction.
template <class Args>
__device__ __forceinline__ float hvp_dir_at(const Args& P, const CellIn& in,
                                            int N, int r, int v) {
    float a = hvp_dir(P, in)[r * N + v];
    if (in.have_prev) a += in.beta * in.pprev[r * N + v];
    return a;
}
// Stage the fields at the vertex box around T's cells into shared memory,
// one float4 a vertex: su holds u (kTrial: u + (xacc sb) vm) and, for kHvp,
// sp the direction p = z (+ beta p_prev when have_prev; hvp_dir_at). Args:
// NewtonArgs, ForceArgs for kForce, HvpArgs for kHvp, DiagArgs for kDiag.
template <int OP, class Args>
__device__ __forceinline__ void stage_box(const Args& P, const Tile& T,
                                          float4* su, float4* sp,
                                          const CellIn& in) {
    const Lattice& L = P.A.L;
    const int N = L.N;
    const int byn = T.ey + 1, bzn = T.ez + 1;
    if (T.ex * T.ey * T.ez == 0) return;
    for (int bl = threadIdx.x; bl < (T.ex + 1) * byn * bzn; bl += blockDim.x) {
        const int lz = bl % bzn, t = bl / bzn;
        const int v = ((T.cx0 + t / byn) * L.Y + T.cy0 + t % byn) * L.Z
                    + T.cz0 + lz;
        float a[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) a[r] = P.u[r * N + v];
        if constexpr (OP == kTrial) {
            const float vm = P.vm[v];
#pragma unroll
            for (int r = 0; r < 3; ++r) a[r] += (P.xacc[r * N + v] * in.sb) * vm;
        }
        su[bl] = make_float4(a[0], a[1], a[2], 0.f);
        if constexpr (OP == kHvp) {
#pragma unroll
            for (int r = 0; r < 3; ++r) a[r] = hvp_dir_at(P, in, N, r, v);
            sp[bl] = make_float4(a[0], a[1], a[2], 0.f);
        }
    }
}

// The cell pass of one tile: every cell's corner contributions, summed over
// the quadrature points, scaled by +-det * cell mask, to the shared scratch
// sc[(corner * NCH + channel) * stride + local cell].
//   kForce: the force chain at u.          kTrial: at u + (xacc sb) vm.
//   kHvp: the HVP chain at u along p = z (+ beta p_prev when have_prev).
//   kDiag: the 6-channel vertex-diagonal chain at u.
// The fields are first staged, once per vertex, into the shared box around
// the tile's cells (su, and sp for the direction: one float4 a vertex), so
// a lane reads a corner with one shared load instead of 3 to 9 loads from
// device memory, and p = z + beta p_prev is formed once per vertex.
// Every thread of the block must call it (barriers and full-warp shuffles
// inside).
template <int OP, class Args>
__device__ __forceinline__ void tile_cells(const Args& P, const Tile& T,
                                           const QuadLane& ql, float* sc,
                                           const CellIn& in) {
    constexpr int NCH = OP == kDiag ? 6 : 3;
    const Lattice& L = P.A.L;
    const int stride = P.T.stride;
    const int lane = threadIdx.x & 31;
    const int n_ext = T.ex * T.ey * T.ez;
    const float mu = P.A.mu, la = P.A.la;
    float4* su = reinterpret_cast<float4*>(sc + kScratchRows * stride);
    float4* sp = su + P.T.box;
    const int byn = T.ey + 1, bzn = T.ez + 1;
    stage_box<OP>(P, T, su, sp, in);
    __syncthreads();
    for (int base = (threadIdx.x >> 5) * 4; base < n_ext;
         base += (blockDim.x >> 5) * 4) {
        const int cl_raw = base + (lane >> 3);
        const bool valid = cl_raw < n_ext;
        const int cl = valid ? cl_raw : n_ext - 1;  // idle lanes redo the last
        const int lz = cl % T.ez, t = cl / T.ez;
        const int lx = t / T.ey, ly = t % T.ey;
        const int b0 = (lx * byn + ly) * bzn + lz;  // corner 0 in the box
        float F[3][3], dF[3][3];
        zero3x3(F);
        zero3x3(dF);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int bi = b0 + (((i >> 2) & 1) * byn + ((i >> 1) & 1)) * bzn
                         + (i & 1);
            const float4 a = su[bi];
            const float us[3] = {a.x, a.y, a.z};
            grad_add(us, ql.gq[i], F);
            if constexpr (OP == kHvp) {
                const float4 d = sp[bi];
                const float ps[3] = {d.x, d.y, d.z};
                grad_add(ps, ql.gq[i], dF);
            }
        }
        float M[3][3], out[NCH];
        deformation_stress(F, mu, la, M);
        if constexpr (OP == kDiag) {
            float Gm[6];
#pragma unroll
            for (int ch = 0; ch < 6; ++ch) {
                const int r = diag_r(ch), c = diag_s(ch);
                Gm[ch] = F[r][0] * F[c][0] + F[r][1] * F[c][1]
                       + F[r][2] * F[c][2];
            }
            sum_points_to_corners<6>(
                [&](int i, float* o) {
                    diag_corner(F, M, Gm, ql.gq[i], mu, la, o);
                },
                lane, out);
        } else {
            float S[3][3];
            if constexpr (OP == kHvp) {
                hvp_stress(F, M, dF, mu, la, S);
            } else {
                force_stress(F, M, S);
            }
            sum_points_to_corners<3>(
                [&](int i, float* o) { emit_corner(S, ql.gq[i], o); }, lane,
                out);
        }
        if (valid) {
            const int c = ((T.cx0 + lx) * (L.Y - 1) + T.cy0 + ly) * (L.Z - 1)
                        + T.cz0 + lz;
            const float w = (OP == kForce || OP == kTrial ? -P.A.det : P.A.det)
                          * P.cm[c];
            const int i = lane & 7;
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch)
                sc[(i * NCH + ch) * stride + cl] = out[ch] * w;
        }
    }
}

// The sum of channel ch over the tile's cells incident to vertex (x, y, z),
// from the shared scratch, in fixed corner order. In halo mode the tile
// holds every cell incident to its own vertices, so the sum is complete.
template <int NCH>
__device__ __forceinline__ float tile_gather(const Tile& T, const float* sc,
                                             int stride, int ch, int x, int y,
                                             int z) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int lx = x - ((i >> 2) & 1) - T.cx0, ly = y - ((i >> 1) & 1) - T.cy0,
                  lz = z - (i & 1) - T.cz0;
        if (lx >= 0 && lx < T.ex && ly >= 0 && ly < T.ey && lz >= 0
            && lz < T.ez)
            s += sc[(i * NCH + ch) * stride + (lx * T.ey + ly) * T.ez + lz];
    }
    return s;
}

// The vertex pass of a halo tile: finish(v, tot) for every vertex of T with
// its NCH complete sums from the shared scratch.
template <int NCH, class Finish>
__device__ __forceinline__ void halo_vertices(const Lattice& L, const Tile& T,
                                              const float* sc, int stride,
                                              Finish finish) {
    for (int vl = threadIdx.x; vl < T.nx * T.ny * T.nz; vl += blockDim.x) {
        const int z = T.z0 + vl % T.nz, t = vl / T.nz;
        const int y = T.y0 + t % T.ny, x = T.x0 + t / T.ny;
        float tot[NCH];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
            tot[ch] = tile_gather<NCH>(T, sc, stride, ch, x, y, z);
        finish((x * L.Y + y) * L.Z + z, tot);
    }
}

// One cell pass and its vertex pass over this block's tiles: finish(v, tot)
// is called once for every vertex the block owns with its NCH complete sums,
// and tile_done(t) by every thread once a tile's vertices are finished.
// Exchange mode runs one grid barrier inside, so every block must call it.
// row0: the first of the NCH pbuf rows this pass uses.
template <int OP, class Args, class Finish, class TileDone>
__device__ __forceinline__ void cell_vertex_pass(const Args& P,
                                                 const QuadLane& ql, float* sc,
                                                 const CellIn& in, int row0,
                                                 cg::grid_group& grid,
                                                 Finish finish,
                                                 TileDone tile_done) {
    constexpr int NCH = OP == kDiag ? 6 : 3;
    const Lattice& L = P.A.L;
    const int N = L.N, stride = P.T.stride;
    const int walked = tiles_walked(P.T);
    for (int j = blockIdx.x; j < walked; j += gridDim.x) {
        const Tile T = tile_of(L, P.T, tile_id(P.T, j));
        tile_cells<OP>(P, T, ql, sc, in);
        __syncthreads();
        if (P.T.halo) {
            halo_vertices<NCH>(L, T, sc, stride, finish);
            tile_done(tile_id(P.T, j));
        } else {
            // own vertices and the plane above them along each axis
            const int bx = T.x0 + T.nx < L.X ? T.nx + 1 : T.nx;
            const int by = T.y0 + T.ny < L.Y ? T.ny + 1 : T.ny;
            const int bz = T.z0 + T.nz < L.Z ? T.nz + 1 : T.nz;
            for (int vl = threadIdx.x; vl < bx * by * bz; vl += blockDim.x) {
                const int lz = vl % bz, t = vl / bz;
                const int ly = t % by, lx = t / by;
                const int x = T.x0 + lx, y = T.y0 + ly, z = T.z0 + lz;
                const int slot = 4 * (lx == T.nx) + 2 * (ly == T.ny)
                               + (lz == T.nz);
                const int v = (x * L.Y + y) * L.Z + z;
#pragma unroll
                for (int ch = 0; ch < NCH; ++ch)
                    P.pbuf[(slot * 9 + row0 + ch) * N + v] =
                        tile_gather<NCH>(T, sc, stride, ch, x, y, z);
            }
        }
        __syncthreads();  // sc is rewritten by the next cell pass
    }
    if (P.T.halo) return;
    grid.sync();
    for (int j = blockIdx.x; j < walked; j += gridDim.x) {
        const Tile T = tile_of(L, P.T, tile_id(P.T, j));
        for (int vl = threadIdx.x; vl < T.nx * T.ny * T.nz; vl += blockDim.x) {
            const int lz = vl % T.nz, t = vl / T.nz;
            const int ly = t % T.ny, lx = t / T.ny;
            const int v = ((T.x0 + lx) * L.Y + T.y0 + ly) * L.Z + T.z0 + lz;
            // a lower neighbour tile along an axis wrote the slots with
            // that axis' bit set, for the vertices of this tile's low face
            // (under a cover an inactive neighbour writes none: its slots
            // keep the zeros of the cover's own workspace)
            const bool px = lx == 0 && T.ix > 0, py = ly == 0 && T.iy > 0,
                       pz = lz == 0 && T.iz > 0;
            float tot[NCH];
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch) tot[ch] = 0.f;
#pragma unroll
            for (int slot = 0; slot < 8; ++slot) {
                if (((slot & 4) && !px) || ((slot & 2) && !py)
                    || ((slot & 1) && !pz))
                    continue;
#pragma unroll
                for (int ch = 0; ch < NCH; ++ch)
                    tot[ch] += P.pbuf[(slot * 9 + row0 + ch) * N + v];
            }
            finish(v, tot);
        }
        tile_done(tile_id(P.T, j));
    }
}

template <int OP, class Args, class Finish>
__device__ __forceinline__ void cell_vertex_pass(const Args& P,
                                                 const QuadLane& ql, float* sc,
                                                 const CellIn& in, int row0,
                                                 cg::grid_group& grid,
                                                 Finish finish) {
    cell_vertex_pass<OP>(P, ql, sc, in, row0, grid, finish, [](int) {});
}

// Ends tile t's share of a dot summed in a vertex pass: the block's sum of
// acc (block_sum's order) to tpart[t]; acc restarts from zero. Every thread
// of the block must call it.
__device__ __forceinline__ void tile_partial(float& acc, float* tpart, int t,
                                             float* sh) {
    const float s = block_sum(acc, sh);
    if (threadIdx.x == 0) tpart[t] = s;
    acc = 0.f;
}

// kPcg = false: one Newton iteration (_make_newton_kernel).
// kPcg = true: the PCG solve alone on the right-hand side s
// (_make_pcg_kernel): no residual phase, no trial phase.
template <bool kPcg>
__global__ void __launch_bounds__(kFusedThreads, 1)
fused_newton_kernel(const __grid_constant__ NewtonArgs P) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ float4 smem[];  // scratch rows, then the vertex boxes
    float* sc = reinterpret_cast<float*>(smem);
    __shared__ float sh[66];
    const int N = P.A.L.N;
    const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
    const int gstride = gridDim.x * blockDim.x;
    const int nb = gridDim.x;
    const QuadLane ql = quad_lane(P.A.G, threadIdx.x & 7);
    const CellIn at_u = {0.f, nullptr, 0.f, false};
    float* part_rz0 = P.part;
    float* part_rr0 = P.part + nb;
    float* part_rz = P.part + 2 * nb;
    float* part_rr = P.part + 3 * nb;
    float* part_fn = P.part + 4 * nb;
    // The dots summed in a vertex pass (||b||^2, p.Ap) are summed a tile at
    // a time, then over the tiles in tile order, whichever block walked a
    // tile: their bits do not depend on how the tiles are spread over the
    // blocks, so a cover (which walks its active tiles only, their partials
    // for the others staying zero) gives the dense kernel's bits under the
    // same tiling and grid. The vector phases' dots are per-block partials.
    float* tpart = P.part + 5 * nb;
    const int ntiles = P.T.ntx * P.T.nty * P.T.ntz;

    // -- right-hand side b: the residual f = (f_el(u) + s - rc u) vm, or s
    //    itself with kPcg; d6 = diag + ctrl I; ||b||^2 --
    const float* b = kPcg ? P.s : P.f;
    float acc = 0.f;
    // a cover's passes never reach the inactive tiles: their f and dx are
    // zero (ordered before any read by the barrier that ends the diagonal)
    if (!kPcg && P.T.tiles)
        zero_inactive(P.A.L, P.T, blockIdx.x, gridDim.x, P.f, P.dx);
    if (!kPcg) {
        cell_vertex_pass<kForce>(
            P, ql, sc, at_u, 0, grid,
            [&](int v, const float* tot) {
                const float vm = P.vm[v], rc = P.rc[v];
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float fr = (tot[c] + P.s[c * N + v]
                                      - rc * P.u[c * N + v]) * vm;
                    P.f[c * N + v] = fr;
                    acc += fr * fr;
                }
            },
            [&](int t) { tile_partial(acc, tpart, t, sh); });
    }
    cell_vertex_pass<kDiag>(
        P, ql, sc, at_u, 3, grid, [&](int v, const float* tot) {
            const float ct = P.ctrl[v];
#pragma unroll
            for (int ch = 0; ch < 6; ++ch)
                P.d6[ch * N + v] =
                    ch == 0 || ch == 3 || ch == 5 ? tot[ch] + ct : tot[ch];
            if (kPcg) {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float fr = P.s[c * N + v];
                    acc += fr * fr;
                }
            }
        },
        [&](int t) {
            if (kPcg) tile_partial(acc, tpart, t, sh);
        });
    grid.sync();

    // -- normalized RHS (solvers.cg._normalize_rhs), x = 0, z = M^-1 r --
    const float rr_b = partials_sum(tpart, ntiles, sh);
    const bool ok_b = rr_b > 0.f;
    const float inv_scale = sqrtf(ok_b ? rr_b : 1.f);
    const float scale_back = ok_b ? inv_scale : 0.f;
    float a_rz = 0.f, a_rr = 0.f;
    for (int v = t0; v < N; v += gstride) {
        const float vm = P.vm[v];
        float r[3], z[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            r[c] = b[c * N + v] / inv_scale;
            P.r[c * N + v] = r[c];
            P.xacc[c * N + v] = 0.f;
        }
        sym_solve(P.d6, N, v, r, vm, z);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            P.z[c * N + v] = z[c];
            a_rz += r[c] * z[c];
            a_rr += r[c] * r[c];
        }
    }
    block_sum2(a_rz, a_rr, sh);
    if (threadIdx.x == 0) {
        part_rz0[blockIdx.x] = a_rz;
        part_rr0[blockIdx.x] = a_rr;
    }
    grid.sync();
    float rz, rr;
    partials_sum2(part_rz0, part_rr0, nb, sh, rz, rr);
    const float rr0 = rr;
    float beta = 0.f;
    int k = 1;
    bool alive = ok_b;

    // -- block-Jacobi PCG on (H(u) + diag(ctrl)) dx = f (pcg_operator) --
    while (alive && k <= P.iterations && rr > P.tol * rr0 && rr0 > kEpsilon
           && isfinite(rr)) {
        // p = z + beta p_prev (p = z in the first iteration), formed at the
        // cell corners and, for the record, at each owner's vertex
        const bool have_prev = k > 1;
        float* pcur = P.p + (k & 1) * 3 * N;
        const float* pprev = P.p + ((k & 1) ^ 1) * 3 * N;
        const CellIn along_p = {0.f, pprev, beta, have_prev};
        float a_pap = 0.f;
        cell_vertex_pass<kHvp>(
            P, ql, sc, along_p, 0, grid,
            [&](int v, const float* tot) {
                const float vm = P.vm[v], ct = P.ctrl[v];
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    float pv = P.z[c * N + v];
                    if (have_prev) pv += beta * pprev[c * N + v];
                    pcur[c * N + v] = pv;
                    const float apv = (tot[c] + ct * pv) * vm;
                    P.ap[c * N + v] = apv;
                    a_pap += pv * apv;
                }
            },
            [&](int t) { tile_partial(a_pap, tpart, t, sh); });
        grid.sync();

        const float pap = partials_sum(tpart, ntiles, sh);
        const bool ok = pap >= 1e-12f;
        const float alpha = ok ? rz / pap : 0.f;
        a_rz = 0.f;
        a_rr = 0.f;
        for (int v = t0; v < N; v += gstride) {
            const float vm = P.vm[v];
            float r[3], z[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                P.xacc[c * N + v] += alpha * pcur[c * N + v];
                r[c] = P.r[c * N + v] - alpha * P.ap[c * N + v];
                P.r[c * N + v] = r[c];
            }
            sym_solve(P.d6, N, v, r, vm, z);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                P.z[c * N + v] = z[c];
                a_rz += r[c] * z[c];
                a_rr += r[c] * r[c];
            }
        }
        block_sum2(a_rz, a_rr, sh);
        if (threadIdx.x == 0) {
            part_rz[blockIdx.x] = a_rz;
            part_rr[blockIdx.x] = a_rr;
        }
        grid.sync();

        float rz_new, rr_new;
        partials_sum2(part_rz, part_rr, nb, sh, rz_new, rr_new);
        beta = rz_new / rz;  // unguarded, as in pcg_operator
        rz = rz_new;
        rr = rr_new;
        k += 1;
        alive = alive && ok;
    }

    if (kPcg) {
        for (int v = t0; v < N; v += gstride) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                P.dx[c * N + v] = P.xacc[c * N + v] * scale_back;
        }
        if (blockIdx.x == 0 && threadIdx.x == 0) P.k[0] = k;
        return;
    }

    // -- trial full step: dx = xacc scale_back, ||f(u + dx vm)||_inf --
    float m = 0.f;
    const CellIn trial = {scale_back, nullptr, 0.f, false};
    cell_vertex_pass<kTrial>(
        P, ql, sc, trial, 0, grid, [&](int v, const float* tot) {
            const float vm = P.vm[v], rc = P.rc[v];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float d = P.xacc[c * N + v] * scale_back;
                P.dx[c * N + v] = d;
                const float ut = P.u[c * N + v] + d * vm;
                const float fr = (tot[c] + P.s[c * N + v] - rc * ut) * vm;
                m = nan_max(m, fabsf(fr));
            }
        });
    {
        const float t = block_max(m, sh);
        if (threadIdx.x == 0) part_fn[blockIdx.x] = t;
    }
    grid.sync();
    if (blockIdx.x == 0) {
        const float fn = partials_max(part_fn, nb, sh);
        if (threadIdx.x == 0) {
            P.fn[0] = fn;
            P.k[0] = k;
        }
    }
}

// A tile's width in vertices along x and y, at most (lat_newton_plan).
constexpr int kTileWidth = 5;
// Cells a block takes per round of its cell pass: 4 a warp.
constexpr int kCellsPerRound = kFusedThreads / 8;

template <bool kPcg>
cudaError_t launch_fused(NewtonArgs& P, int grid, cudaStream_t st) {
    void* args[] = {&P};
    const size_t smem =
        sizeof(float) * (kScratchRows * P.T.stride + 8 * P.T.box);
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(fused_newton_kernel<kPcg>), dim3(grid),
        dim3(kFusedThreads), args, smem, st);
    const cudaError_t last = cudaGetLastError();
    return e != cudaSuccess ? e : last;
}

// ---------------------------------------------------------------------------
// Lattice multigrid level operators: the shifted, SPD-projected vertex
// diagonal (the smoother and the power iteration: level_kernel, below)
// ---------------------------------------------------------------------------
//
// The lattice multigrid (sim/lattice_mg.py) runs, on every level, a
// Chebyshev smoother around the HVP and a linearization that takes the
// vertex-diagonal blocks, shifts them and projects them onto SPD. As chains
// of torch ops around the two-pass lat_hvp / lat_diag, a V-cycle was ~1,400
// ops and a linearization ~2,800 (PERF.md), the card idle ~92% of a solve.
// Here each of the two is one launch.
//
// lat_diag_shift replaces, on the same path, hess_diag_lattice (_run_diag,
// pallas_call at :251) together with what the JAX LatticeMG.linearize does
// to its blocks (:393-406): + (ctrl + 1 - vm) I, then
// ell.spd_project(eps 1e-6, rel_floor 1e-3). It is lat_diag (below) with
// these in its vertex pass, in registers: the shift, 6 cyclic-Jacobi sweeps
// of rotations (0,1), (0,2), (1,2), the eigenvalue floor and the rebuild
// V diag(w) V^T, whose upper triangle is stored as the 6 channels
// (spd_project). The projection repeats ell.spd_project's float32
// operations one by one, each rounded as torch rounds it (no contraction
// into fma), with sign(0) = 0 as torch.sign has it: a block with app == aqq
// gets no rotation.

struct DiagArgs {
    ChainArgs A;
    Tiling T;
    const float* u;     // (3, N) displacement
    const float* cm;    // (C,) cell mask
    const float* ctrl;  // (N,) diagonal shift, or null: the blocks alone
    const float* vm;    // (N,) vertex mask (with ctrl)
    float* out;         // (6, N) the (shifted, projected) blocks
    int project;        // 1: SPD-project the shifted blocks (with ctrl)
    int lane_cells;     // with ctrl: a tile of at most this many cells runs
                        // eight lanes a cell
};

// One cyclic-Jacobi rotation zeroing A[p][q] of a symmetric block, with
// the rotations accumulated in V: ops/ell.py _jacobi_rotation, operation by
// operation (__f*_rn: each rounded alone, never fused).
template <int p, int q>
__device__ __forceinline__ void jacobi_rotation(float A[3][3], float V[3][3]) {
    constexpr int r = 3 - p - q;  // the untouched index
    const float apq = A[p][q], app = A[p][p], aqq = A[q][q];
    const bool tiny = fabsf(apq) < 1e-30f;
    const float tau = __fdiv_rn(__fsub_rn(aqq, app),
                                __fmul_rn(2.f, tiny ? 1e-30f : apq));
    // torch.sign: 0 for 0 (and for NaN), so app == aqq gets no rotation
    const float sg = float((tau > 0.f) - (tau < 0.f));
    float t = __fdiv_rn(sg, __fadd_rn(fabsf(tau),
                                      __fsqrt_rn(__fadd_rn(
                                          1.f, __fmul_rn(tau, tau)))));
    if (tiny) t = 0.f;
    const float c = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(t, t))));
    const float s = __fmul_rn(t, c);
    const float arp = A[r][p], arq = A[r][q];
    A[p][p] = __fsub_rn(app, __fmul_rn(t, apq));
    A[q][q] = __fadd_rn(aqq, __fmul_rn(t, apq));
    A[p][q] = A[q][p] = 0.f;
    const float arp_n = __fsub_rn(__fmul_rn(c, arp), __fmul_rn(s, arq));
    const float arq_n = __fadd_rn(__fmul_rn(s, arp), __fmul_rn(c, arq));
    A[r][p] = A[p][r] = arp_n;
    A[r][q] = A[q][r] = arq_n;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float vp = V[i][p], vq = V[i][q];
        V[i][p] = __fsub_rn(__fmul_rn(c, vp), __fmul_rn(s, vq));
        V[i][q] = __fadd_rn(__fmul_rn(s, vp), __fmul_rn(c, vq));
    }
}

// torch.maximum: NaN when either is NaN
__device__ __forceinline__ float nan_maximum(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : (a > b ? a : b));
}

// ell.spd_project(eps = 1e-6, rel_floor = 1e-3) of the symmetric block held
// as 6 channels (xx xy xz yy yz zz), in place: every eigenvalue floored at
// 1e-3 max|w| + 1e-6, rebuilt as sum_j (w_j V_rj) V_cj in j order, the upper
// triangle (r <= c) kept. Its symmetrization 0.5 (A + A^T) is the block
// itself, bit for bit, for a block built symmetric.
__device__ __forceinline__ void spd_project(float a[6]) {
    float A[3][3] = {{a[0], a[1], a[2]}, {a[1], a[3], a[4]},
                     {a[2], a[4], a[5]}};
    float V[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}};
#pragma unroll
    for (int sweep = 0; sweep < 6; ++sweep) {
        jacobi_rotation<0, 1>(A, V);
        jacobi_rotation<0, 2>(A, V);
        jacobi_rotation<1, 2>(A, V);
    }
    float w[3] = {A[0][0], A[1][1], A[2][2]};
    const float wmax = nan_max(nan_max(fabsf(w[0]), fabsf(w[1])), fabsf(w[2]));
    const float floor_w = __fadd_rn(__fmul_rn(1e-3f, wmax), 1e-6f);
#pragma unroll
    for (int j = 0; j < 3; ++j) w[j] = nan_maximum(w[j], floor_w);
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) {
        const int r = diag_r(ch), c = diag_s(ch);
        float o = __fmul_rn(__fmul_rn(w[0], V[r][0]), V[c][0]);
#pragma unroll
        for (int j = 1; j < 3; ++j)
            o = __fadd_rn(o, __fmul_rn(__fmul_rn(w[j], V[r][j]), V[c][j]));
        a[ch] = o;
    }
}

// ---------------------------------------------------------------------------
// The standalone HVP
// ---------------------------------------------------------------------------
//
// lat_hvp, one launch: a block per halo tile of ops/lattice_kernels.
// hvp_plan (lat_force's tiles: the vertex box of u and p staged once in
// shared memory, a thread a cell, two blocks an SM) and the halo vertex
// pass, whose epilogue writes H(u) p, or with ctrl the multigrid's level
// operator (H(u) p + ctrl p) vm: the level matvec is one launch where it
// was the HVP and three torch ops. No cell scratch in device memory, no
// grid barrier (a block computes every cell around its own vertices).
// Eight lanes a cell on the fused kernels' tiles was built and timed, and
// lost at every level shape (PERF.md). Where the plan's model says the
// cells computed twice cost more than a second launch (the 19k and 74k
// fine levels), the two passes of PR 1 run instead, the epilogue in their
// gather (gather_level).
//
// out at vertex v from the complete sums tot of H(u) p there.
__device__ __forceinline__ void hvp_out(const HvpArgs& P, int N, int v,
                                        const float* tot) {
    if (P.ctrl == nullptr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) P.out[c * N + v] = tot[c];
        return;
    }
    const float vm = P.vm[v], ct = P.ctrl[v];
#pragma unroll
    for (int c = 0; c < 3; ++c)
        P.out[c * N + v] = (tot[c] + ct * P.p[c * N + v]) * vm;
}

// A block per halo tile, as lat_force's tiles run (kForceThreads threads,
// two blocks an SM, kForceRows rows of scratch), a thread a cell: the
// points in sequence, each corner of u and p read from the shared box at
// every point (registers hold the 24 corner sums, not the 48 corner
// values), then the halo vertex pass.
__global__ void __launch_bounds__(kForceThreads, 2)
hvp_tiles_kernel(const __grid_constant__ HvpArgs P) {
    extern __shared__ float4 smem[];  // scratch rows, then the vertex boxes
    float* sc = reinterpret_cast<float*>(smem);
    const Lattice& L = P.A.L;
    const int stride = P.T.stride;
    const Tile T = tile_of(L, P.T, blockIdx.x);
    const int n_ext = T.ex * T.ey * T.ez;
    float4* su = reinterpret_cast<float4*>(sc + kForceRows * stride);
    float4* sp = su + P.T.box;
    const CellIn along_p = {0.f, P.p, 0.f, false};
    stage_box<kHvp>(P, T, su, sp, along_p);
    __syncthreads();
    const int byn = T.ey + 1, bzn = T.ez + 1;
    for (int cl = threadIdx.x; cl < n_ext; cl += blockDim.x) {
        const int lz = cl % T.ez, t = cl / T.ez;
        const int lx = t / T.ey, ly = t % T.ey;
        const int b0 = (lx * byn + ly) * bzn + lz;
        float acc[8][3];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
#pragma unroll 1
        for (int q = 0; q < 8; ++q) {
            const QuadLane g = quad_lane(P.A.G, q);
            float F[3][3], dF[3][3], M[3][3], S[3][3];
            zero3x3(F);
            zero3x3(dF);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int bi = b0 + (((i >> 2) & 1) * byn + ((i >> 1) & 1))
                                        * bzn + (i & 1);
                const float4 a = su[bi], d = sp[bi];
                const float us[3] = {a.x, a.y, a.z}, ps[3] = {d.x, d.y, d.z};
                grad_add(us, g.gq[i], F);
                grad_add(ps, g.gq[i], dF);
            }
            deformation_stress(F, P.A.mu, P.A.la, M);
            hvp_stress(F, M, dF, P.A.mu, P.A.la, S);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float o[3];
                emit_corner(S, g.gq[i], o);
#pragma unroll
                for (int r = 0; r < 3; ++r) acc[i][r] += o[r];
            }
        }
        const int c = ((T.cx0 + lx) * (L.Y - 1) + T.cy0 + ly) * (L.Z - 1)
                    + T.cz0 + lz;
        const float w = P.A.det * P.cm[c];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int r = 0; r < 3; ++r)
                sc[(i * 3 + r) * stride + cl] = acc[i][r] * w;
        }
    }
    __syncthreads();
    halo_vertices<3>(L, T, sc, stride, [&](int v, const float* tot) {
        hvp_out(P, L.N, v, tot);
    });
}

// The two-pass form's vertex pass with the level operator's epilogue:
// (the gathered H(u) p + ctrl p) vm.
__global__ void __launch_bounds__(kThreads)
gather_level(Lattice L, const float* __restrict__ cf,
             const float* __restrict__ p, const float* __restrict__ ctrl,
             const float* __restrict__ vm, float* __restrict__ out) {
    for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < L.N;
         v += gridDim.x * blockDim.x) {
        int x, y, z;
        vertex_coords(L, v, x, y, z);
        const float ct = ctrl[v], m = vm[v];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
            out[ch * L.N + v] =
                (gather_vertex<3>(L, cf, ch, x, y, z) + ct * p[ch * L.N + v])
                * m;
    }
}

// ---------------------------------------------------------------------------
// The multigrid's level kernels: lat_cheby and lat_power
// ---------------------------------------------------------------------------
//
// lat_cheby replaces, on the lattice multigrid's path, the HVP (_run(hvp=
// True), pallas_call at :306) as the JAX LatticeMG._smooth_cheby applies it
// (sim/lattice_mg.py:481-502): all the sweeps of one smoothing call. A
// sweep is
//   A x = (HVP(u; x) + ctrl x) vm,  r = b - A x,  z = D^-1 r vm (sym_solve),
//   d = z / theta (first sweep) or a d + b z,  x = x + d;
// the first sweep from zero skips the HVP (r = b). With a residual asked
// for, one more HVP gives r = b - A x, what the V-cycle restricts. The
// coefficients (host float32, the plain version's recurrence) travel in the
// argument struct. lat_power replaces the same _run as the JAX
// LatticeMG._est_lmax applies it (:469-479): every iteration of a level's
// power iteration on D^-1 A,
//   ax = (H(u) v + ctrl v) vm,  w = D^-1 ax vm,  lambda = |w| / |v|,
//   v = w / max(|w|, 1e-30),
// from v = vm sin(0, 1, ..., N - 1); 1.1 lambda of the last iteration out.
//
// Bound: at the level shapes the HVP chain is microseconds of the card's
// f32 rate (~6 us at the 74k fine level) and the fields are KB to ~1 MB;
// what a call costs is its rounds of cells and the wait for the
// neighbours' new x between sweeps. Design: a block owns one tile of
// vertices and keeps, for the whole call, in shared memory: u and x on the
// vertex box around the cells it computes, the cells' mask, and b, d6,
// ctrl, vm and the direction d at its own vertices. A sweep reads no input
// from device memory; only the final x (and r) is written there. Eight
// lanes a cell (512 threads, one block an SM), one quadrature point each,
// summed in sum_points_to_corners' order: the first form's chain. The
// forms (lat_level_plan picks one, with its tiles, per level and call):
//   kLevelCluster  a thread-block cluster of at most 16 blocks whose tiles
//       are z-slabs of whole planes. A block stores its two boundary
//       planes of the new x into its neighbours' boxes with st.async, each
//       16-byte store completing its bytes on that block's mbarrier, and
//       waits on its own mbarrier for its halo planes: no grid or cluster
//       barrier between sweeps. A block reads x_s while a neighbour may
//       store x_{s+1} into its other buffer; two mbarriers, sweep s on
//       s & 1, and a block never gets two sweeps ahead of a neighbour, so
//       no store meets a read. One block waits on none.
//   kLevelTiles  a cooperative launch, one block a tile: the new x at a
//       block's own vertices to device memory (two buffers), a grid
//       barrier, then the box's other vertices staged from there.
//   kLevelExchange  where the first form took exchange tiles (its halo
//       tiles, 5 vertices wide in x and y, fitting its 200 KB of scratch
//       only at more tiles than SMs: the 74k fine level), its arithmetic:
//       a block computes the cells whose lowest corner it owns; the
//       partial sums of the vertices one plane above its own go to device
//       memory by slot (which upper faces the vertex lies on), a grid
//       barrier, and an owner adds its own partial and the lower tiles' in
//       slot order; kLevelTiles' launch otherwise. lat_cheby runs it on the
//       first form's tiles (its bits), lat_power on as many along x and z
//       with y whole (its dots); there it is their only form.
// In the cluster and tiles forms a block computes every cell around its
// vertices (halo tiles) and a vertex adds its cells in corner order, the
// first form's order wherever it ran halo tiles: lat_cheby keeps the first
// form's bits in every form at every level. Three more forms were built
// and swept at every level shape, and lost at all of them (PERF.md): a
// thread a cell (the points in the same pair order, the first pairs'
// partial sums in shared memory; its round is ~4x one of eight lanes), and
// each cell once, the corner sums through device memory (all of them, or
// the upper faces' only) and a second grid barrier a sweep.
// lat_power's dots: a vertex's w.w and v.v (each an fma chain in component
// order) are added, on a level of at most kSlots vertices, as the first
// form's one block added them (vertex v in slot v; warp_sum over each 32
// slots, then over those 16 sums: its bits), and on a larger level along y
// in order to a row partial (x, z), the rows of a plane along x in order to
// the plane's, and the planes by lane_ordered_sum.
// Its tiles never split y, so a block owns whole rows: the cluster form's
// z-slabs own whole planes and store each plane's partials into every
// block (st.async, on the halo's mbarrier); kLevelTiles writes its rows'
// partials to device memory, and after the grid barrier every block adds
// each plane's rows. Every block sums the same partials in the same order:
// one lambda, the same bits in every form and tiling.

constexpr int kLevelCluster = 0;
constexpr int kLevelTiles = 1;
constexpr int kLevelExchange = 2;
constexpr int kLevelForms = 3;
constexpr int kMaxLevelCluster = 16;
constexpr int kLevelThreads = kFusedThreads;  // eight lanes a cell
constexpr int kLevelCellsPerRound = kLevelThreads / 8;
// the most dynamic shared memory a block takes: 227 KB less the static
constexpr int kLevelSmemCap = 230400;
// floats a block keeps for each vertex it owns: b (lat_power: the vertex's
// w.w and v.v), d6, ctrl, vm, d
constexpr int kOwnFloats = 14;
constexpr int kMaxSweeps = 32;
// lat_power: the levels of at most this many vertices sum their dots by
// vertex slots (the first form's block of kFusedThreads threads)
constexpr int kSlots = kFusedThreads;

struct LevelArgs {
    ChainArgs A;
    Tiling T;            // the tiles; stride and box of the largest tile
    int own;             // vertices of the largest tile
    const float* u;      // (3, N) the level's displacement
    const float* cm;     // (C,) cell mask
    const float* ctrl;   // (N,) the level's diagonal shift
    const float* vm;     // (N,) vertex mask
    const float* d6;     // (6, N) the smoother's blocks (xx xy xz yy yz zz)
    const float* b;      // lat_cheby: (3, N) right-hand side
    const float* x0;     // lat_cheby: (3, N) start, or null: from zero
    const float* start;  // lat_power: (N,) sin(0, 1, ..., N - 1)
    float* x;            // lat_cheby out: (3, N) the smoothed iterate
    float* r;            // lat_cheby out: (3, N) b - A x, or null
    float* out;          // lat_power out: (1,) 1.1 lambda
    float4* xs;          // kLevelTiles: (2, N) the iterates, x y z 0
    float* part;         // cooperative forms, lat_power: (2, max(Z X,
                         // kSlots), 2) rows' or slots' partials
    float* pbuf;         // kLevelExchange: (8, 3, N) partial sums by slot
    int sweeps;          // lat_cheby: sweeps; lat_power: iterations
    float coef[2 * kMaxSweeps - 1];  // theta, then (a, b) of sweeps 1, 2, ...
};

// Floats of a level kernel's shared layout: u and the two buffers of x on
// the box (a float4 a vertex), lat_power's two buffers of the planes' or
// slots' partials (a float4 each, level_partials), the corner sums
// (kForceRows rows of stride) and the cell mask (stride), and kOwnFloats a
// vertex the block owns. Mirrored by ops/lattice_kernels.level_layout.
__host__ __device__ __forceinline__ int level_partials(bool power, int Z) {
    return power ? (Z > kSlots ? Z : kSlots) : 0;
}
__host__ __device__ __forceinline__ long long level_smem_floats(
    int box, int stride, int own, int Z, bool power) {
    return 12LL * box + 8LL * level_partials(power, Z)
           + (kForceRows + 1LL) * stride + 1LL * kOwnFloats * own;
}

// The cell pass of a level kernel's tile: the HVP chain of every cell of T
// at u (su) along p (sp), eight lanes a cell, one quadrature point each
// (tile_cells' chain and order), times det * the cell mask (scm), its 24
// corner sums handed to put(j, cell) (j = corner * 3 + channel). Every
// thread of the block must call it (full-warp shuffles).
template <class Put>
__device__ __forceinline__ void level_cells(const ChainArgs& A, const Tile& T,
                                            const float4* su,
                                            const float4* sp,
                                            const float* scm, Put put) {
    const int lane = threadIdx.x & 31;
    const int n_ext = T.ex * T.ey * T.ez;
    const int byn = T.ey + 1, bzn = T.ez + 1;
    const QuadLane ql = quad_lane(A.G, threadIdx.x & 7);
    for (int base = (threadIdx.x >> 5) * 4; base < n_ext;
         base += (blockDim.x >> 5) * 4) {
        const int cl_raw = base + (lane >> 3);
        const bool valid = cl_raw < n_ext;
        const int cl = valid ? cl_raw : n_ext - 1;  // idle lanes redo the last
        const int t = cl / T.ez;
        const int b0 = ((t / T.ey) * byn + t % T.ey) * bzn + cl % T.ez;
        float F[3][3], dF[3][3];
        zero3x3(F);
        zero3x3(dF);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int bi = b0 + (((i >> 2) & 1) * byn + ((i >> 1) & 1)) * bzn
                         + (i & 1);
            const float4 a = su[bi], d = sp[bi];
            const float us[3] = {a.x, a.y, a.z}, ps[3] = {d.x, d.y, d.z};
            grad_add(us, ql.gq[i], F);
            grad_add(ps, ql.gq[i], dF);
        }
        float M[3][3], S[3][3], out[3];
        deformation_stress(F, A.mu, A.la, M);
        hvp_stress(F, M, dF, A.mu, A.la, S);
        sum_points_to_corners<3>(
            [&](int i, float* o) { emit_corner(S, ql.gq[i], o); }, lane, out);
        if (valid) {
            const float w = A.det * scm[cl];
            const int i = lane & 7;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) put(i * 3 + ch, cl, out[ch] * w);
        }
    }
}

// The dots' fixed order: lane l of the calling warp adds term(l),
// term(l + 32), ... (i < n) in order, then warp_sum's shuffle tree; the sum
// is returned to lane 0. Every lane of the warp must call it.
template <class Term>
__device__ __forceinline__ float lane_ordered_sum(int n, Term term) {
    float s = 0.f;
    for (int i = threadIdx.x & 31; i < n; i += 32) s = __fadd_rn(s, term(i));
    return warp_sum(s);
}

// lat_cheby (kPower false) or lat_power (kPower true) in form kForm, a block
// a tile of P.T (see above).
template <bool kPower, int kForm>
__global__ void __launch_bounds__(kLevelThreads, 1)
level_kernel(const __grid_constant__ LevelArgs P) {
    constexpr bool kCluster = kForm == kLevelCluster;
    constexpr bool kExchange = kForm == kLevelExchange;
    static_assert(kLevelThreads == kSlots, "a thread a slot");
    extern __shared__ float4 smem[];
    __shared__ float sh[2], red[2 * kSlots / 32];
    __shared__ __align__(8) unsigned long long bars[2];
    const Lattice& L = P.A.L;
    const int N = L.N, Z = L.Z, XY = L.X * L.Y;
    const int rank = blockIdx.x, nb = gridDim.x;
    const Tile T = tile_of(L, P.T, rank);
    const int byn = T.ey + 1, bzn = T.ez + 1;
    const int n_box = (T.ex + 1) * byn * bzn, n_ext = T.ex * T.ey * T.ez;
    const int n_own = T.nx * T.ny * T.nz;
    const int stride = P.T.stride, box = P.T.box, on = P.own;
    const int np = level_partials(kPower, Z);  // a buffer of partials
    float4* const su = smem;
    float4* const sx0 = smem + box;  // x, buffer j at sx0 + j * box
    float4* const pl0 = smem + 3 * box;  // partials, j at pl0 + j * np
    float* const sc = reinterpret_cast<float*>(smem + 3 * box + 2 * np);
    float* const scm = sc + kForceRows * stride;
    float* const own = scm + stride;  // own[k * on + vl], k < kOwnFloats
    float* const od = own + 11 * on;  // d (lat_cheby)
    // own vertex vl: its coordinates, vertex and box index
    auto own_at = [&](int vl, int& x, int& y, int& z, int& v, int& bi) {
        z = T.z0 + vl % T.nz;
        const int t = vl / T.nz;
        y = T.y0 + t % T.ny;
        x = T.x0 + t / T.ny;
        v = (x * L.Y + y) * Z + z;
        bi = ((x - T.cx0) * byn + y - T.cy0) * bzn + z - T.cz0;
    };
    auto cell_of = [&](int cl) {  // the lattice cell of local cell cl
        const int t = cl / T.ez;
        return ((T.cx0 + t / T.ey) * (L.Y - 1) + T.cy0 + t % T.ey) * (Z - 1)
               + T.cz0 + cl % T.ez;
    };
    // the inputs, all in flight at once (cp.async; a float4's w unused)
    for (int bl = threadIdx.x; bl < n_box; bl += blockDim.x) {
        const int t = bl / bzn;
        const int v = ((T.cx0 + t / byn) * L.Y + T.cy0 + t % byn) * Z
                      + T.cz0 + bl % bzn;
        float* su_f = reinterpret_cast<float*>(su + bl);
        float* sx_f = reinterpret_cast<float*>(sx0 + bl);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            cp_async4(su_f + c, P.u + c * N + v);
            if (!kPower && P.x0 != nullptr)
                cp_async4(sx_f + c, P.x0 + c * N + v);
        }
        if (kPower) {
            const float s = P.vm[v] * P.start[v];
            sx0[bl] = make_float4(s, s, s, 0.f);
        }
    }
    for (int cl = threadIdx.x; cl < n_ext; cl += blockDim.x)
        cp_async4(scm + cl, P.cm + cell_of(cl));
    for (int vl = threadIdx.x; vl < n_own; vl += blockDim.x) {
        int x, y, z, v, bi;
        own_at(vl, x, y, z, v, bi);
        if (!kPower) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                cp_async4(own + c * on + vl, P.b + c * N + v);
        }
#pragma unroll
        for (int k = 0; k < 6; ++k)
            cp_async4(own + (3 + k) * on + vl, P.d6 + k * N + v);
        cp_async4(own + 9 * on + vl, P.ctrl + v);
        cp_async4(own + 10 * on + vl, P.vm + v);
    }
    cp_async_commit();
    cp_async_wait_all();
    // kLevelCluster: the neighbours' first x buffer (h 0: the block below,
    // 1: above) and mbarriers, mapped once
    unsigned nbx[2] = {}, nbar[2] = {};
    int ncz[2] = {}, nbz[2] = {};
    const int nbrs = (rank > 0) + (rank + 1 < nb);
    if constexpr (kCluster) {
        if (threadIdx.x == 0) {
            mbar_init(smem_addr(&bars[0]), 1);
            mbar_init(smem_addr(&bars[1]), 1);
            asm volatile("fence.mbarrier_init.release.cluster;\n" :::
                             "memory");
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int q = h ? rank + 1 : rank - 1;
            if (q < 0 || q >= nb) continue;
            const Tile Q = tile_of(L, P.T, q);
            ncz[h] = Q.cz0;
            nbz[h] = Q.ez + 1;
            nbx[h] = map_rank(smem_addr(sx0), q);
            nbar[h] = map_rank(smem_addr(&bars[0]), q);
        }
    }
    __syncthreads();
    if constexpr (kCluster) cg::this_cluster().sync();
    // one cell pass along the box's x buffer p; then tot(x, y, z, t): a
    // vertex's complete sums, each channel's cells in corner order
    // (tile_gather's)
    auto cell_pass = [&](const float4* p) {
        level_cells(P.A, T, su, p, scm, [&](int j, int cl, float a) {
            sc[j * stride + cl] = a;
        });
        __syncthreads();
        if constexpr (kExchange) {
            // the partial sums of the plane above each own face, by slot
            const int bx = T.x0 + T.nx < L.X ? T.nx + 1 : T.nx;
            const int by = T.y0 + T.ny < L.Y ? T.ny + 1 : T.ny;
            const int bz = T.z0 + T.nz < Z ? T.nz + 1 : T.nz;
            for (int k = threadIdx.x; k < bx * by * bz; k += blockDim.x) {
                const int lz = k % bz, t = k / bz;
                const int ly = t % by, lx = t / by;
                const int slot = 4 * (lx == T.nx) + 2 * (ly == T.ny)
                                 + (lz == T.nz);
                if (slot == 0) continue;
                const int x = T.x0 + lx, y = T.y0 + ly, z = T.z0 + lz;
                const int v = (x * L.Y + y) * Z + z;
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    P.pbuf[(slot * 3 + c) * N + v] =
                        tile_gather<3>(T, sc, stride, c, x, y, z);
            }
            cg::this_grid().sync();
        }
    };
    auto tot = [&](int x, int y, int z, float t[3]) {
        t[0] = t[1] = t[2] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int lx = x - ((i >> 2) & 1) - T.cx0,
                      ly = y - ((i >> 1) & 1) - T.cy0,
                      lz = z - (i & 1) - T.cz0;
            if (lx >= 0 && lx < T.ex && ly >= 0 && ly < T.ey && lz >= 0
                && lz < T.ez) {
                const int cl = (lx * T.ey + ly) * T.ez + lz;
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    t[c] += sc[(i * 3 + c) * stride + cl];
            }
        }
        if constexpr (kExchange) {
            // the lower tiles' partials (the own one is slot 0), in order
            const bool px = x == T.x0 && T.ix > 0, py = y == T.y0 && T.iy > 0,
                       pz = z == T.z0 && T.iz > 0;
            const int v = (x * L.Y + y) * Z + z;
#pragma unroll
            for (int slot = 1; slot < 8; ++slot) {
                if (((slot & 4) && !px) || ((slot & 2) && !py)
                    || ((slot & 1) && !pz))
                    continue;
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    t[c] += P.pbuf[(slot * 3 + c) * N + v];
            }
        }
    };
    // the new value at own vertex (x, y, z) of buffer j to the blocks whose
    // boxes hold it: kLevelCluster its neighbours (their mbarrier bj),
    // kLevelTiles device memory
    auto publish = [&](int x, int y, int z, int v, const float* a, int j,
                       int bj) {
        if constexpr (kCluster) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const bool edge = h ? z == T.z0 + T.nz - 1 && rank + 1 < nb
                                    : z == T.z0 && rank > 0;
                if (edge)
                    st_async4(nbx[h] + 16u * (j * box + (x * L.Y + y) * nbz[h]
                                              + z - ncz[h]),
                              a[0], a[1], a[2], nbar[h] + 8u * bj);
            }
        } else {
            P.xs[j * N + v] = make_float4(a[0], a[1], a[2], 0.f);
        }
    };
    // the wait for what other blocks published in sweep or iteration s
    // (halo: the new values of buffer j at this block's box)
    auto exchange = [&](int s, int j, bool halo) {
        if constexpr (kCluster) {
            __syncthreads();  // this block's own new values
            if (nb > 1) mbar_wait(smem_addr(&bars[s & 1]), (s >> 1) & 1);
        } else {
            cg::this_grid().sync();
            if (!halo) return;
            const float4* src = P.xs + j * N;
            for (int bl = threadIdx.x; bl < n_box; bl += blockDim.x) {
                const int lz = bl % bzn, t = bl / bzn;
                const int x = T.cx0 + t / byn, y = T.cy0 + t % byn,
                          z = T.cz0 + lz;
                if (x >= T.x0 && x < T.x0 + T.nx && y >= T.y0
                    && y < T.y0 + T.ny && z >= T.z0 && z < T.z0 + T.nz)
                    continue;  // its own: in shared memory already
                cp_async16(sx0 + j * box + bl, src + (x * L.Y + y) * Z + z);
            }
            cp_async_commit();
            cp_async_wait_all();
            __syncthreads();
        }
    };
    int cur = 0;
    if constexpr (!kPower) {
        const bool warm = P.x0 != nullptr;
        // s == sweeps: the residual pass
        for (int s = 0; s < P.sweeps || (s == P.sweeps && P.r != nullptr);
             ++s) {
            const bool resid = s == P.sweeps;
            const int nxt = cur ^ 1;
            const bool hvp = s > 0 || warm;
            const bool send = !resid && (s + 1 < P.sweeps || P.r != nullptr);
            const float4* xc = sx0 + cur * box;
            float4* xn4 = sx0 + nxt * box;
            if (kCluster && send && nb > 1 && threadIdx.x == 0)
                mbar_expect(smem_addr(&bars[s & 1]), 16u * XY * nbrs);
            if (hvp) cell_pass(xc);
            for (int vl = threadIdx.x; vl < n_own; vl += blockDim.x) {
                int x, y, z, v, bi;
                own_at(vl, x, y, z, v, bi);
                const float4 xv = xc[bi];
                const float xr[3] = {xv.x, xv.y, xv.z};
                const float vm = own[10 * on + vl], ct = own[9 * on + vl];
                float r[3], t[3];
                if (hvp) tot(x, y, z, t);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    r[c] = own[c * on + vl];
                    if (hvp) r[c] = r[c] - (t[c] + ct * xr[c]) * vm;
                }
                if (resid) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) P.r[c * N + v] = r[c];
                    continue;
                }
                float zz[3], xn[3];
                sym_solve6(own[3 * on + vl], own[4 * on + vl],
                           own[5 * on + vl], own[6 * on + vl],
                           own[7 * on + vl], own[8 * on + vl], r, vm, zz);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float dn =
                        s == 0 ? zz[c] / P.coef[0]
                               : P.coef[2 * s - 1] * od[c * on + vl]
                                     + P.coef[2 * s] * zz[c];
                    od[c * on + vl] = dn;
                    xn[c] = hvp ? xr[c] + dn : dn;
                }
                xn4[bi] = make_float4(xn[0], xn[1], xn[2], 0.f);
                if (s + 1 == P.sweeps) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) P.x[c * N + v] = xn[c];
                }
                if (send) publish(x, y, z, v, xn, nxt, s & 1);
            }
            if (send) exchange(s, nxt, true);
            cur = nxt;
        }
    } else {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        const bool slots = N <= kSlots;
        float lam = 0.f;
        for (int it = 0; it < P.sweeps; ++it) {
            const int nxt = cur ^ 1;
            const bool more = it + 1 < P.sweeps;
            const float4* vc4 = sx0 + cur * box;
            float4* wn4 = sx0 + nxt * box;
            float4* pl = pl0 + cur * np;
            float* part = P.part + 2 * cur * (Z * L.X > kSlots ? Z * L.X
                                                                : kSlots);
            if (kCluster && nb > 1 && threadIdx.x == 0)
                mbar_expect(smem_addr(&bars[it & 1]),
                            16u * ((more ? XY * nbrs : 0)
                                   + (slots ? N - n_own : Z - T.nz)));
            cell_pass(vc4);
            for (int vl = threadIdx.x; vl < n_own; vl += blockDim.x) {
                int x, y, z, v, bi;
                own_at(vl, x, y, z, v, bi);
                const float4 p = vc4[bi];
                const float vc[3] = {p.x, p.y, p.z};
                const float vm = own[10 * on + vl], ct = own[9 * on + vl];
                float ax[3], w[3], t[3];
                tot(x, y, z, t);
#pragma unroll
                for (int c = 0; c < 3; ++c) ax[c] = (t[c] + ct * vc[c]) * vm;
                sym_solve6(own[3 * on + vl], own[4 * on + vl],
                           own[5 * on + vl], own[6 * on + vl],
                           own[7 * on + vl], own[8 * on + vl], ax, vm, w);
                own[vl] = __fmaf_rn(w[2], w[2], __fmaf_rn(
                    w[1], w[1], __fmul_rn(w[0], w[0])));
                own[on + vl] = __fmaf_rn(vc[2], vc[2], __fmaf_rn(
                    vc[1], vc[1], __fmul_rn(vc[0], vc[0])));
                wn4[bi] = make_float4(w[0], w[1], w[2], 0.f);
                if (more) publish(x, y, z, v, w, nxt, it & 1);
                if (!slots) continue;
                // slot v: to every block's partials (cluster), or device
                // memory
                if constexpr (kCluster) {
                    const float ww = own[vl], vv = own[on + vl];
                    pl[v] = make_float4(ww, vv, 0.f, 0.f);
                    for (int q = 0; q < nb; ++q) {
                        if (q == rank) continue;
                        st_async4(map_rank(smem_addr(&pl[v]), q), ww, vv, 0.f,
                                  map_rank(smem_addr(&bars[it & 1]), q));
                    }
                } else {
                    part[2 * v] = own[vl];
                    part[2 * v + 1] = own[on + vl];
                }
            }
            __syncthreads();
            // larger levels: each own row's partials (tiles never split y:
            // T.ny = Y), its vertices in y order; the cluster's z-slabs add
            // a plane's rows in x order and publish the planes
            for (int k = threadIdx.x; !slots && k < T.nx * T.nz;
                 k += blockDim.x) {
                const int ox = k / T.nz, oz = k % T.nz;
                float ww = 0.f, vv = 0.f;
                for (int oy = 0; oy < T.ny; ++oy) {
                    const int vl = (ox * T.ny + oy) * T.nz + oz;
                    ww = __fadd_rn(ww, own[vl]);
                    vv = __fadd_rn(vv, own[on + vl]);
                }
                if constexpr (!kCluster) {
                    float* row = part + 2 * ((T.z0 + oz) * L.X + T.x0 + ox);
                    row[0] = ww;
                    row[1] = vv;
                } else {
                    sc[2 * k] = ww;  // the corner sums are spent
                    sc[2 * k + 1] = vv;
                }
            }
            if (kCluster && !slots) {
                __syncthreads();
                for (int oz = threadIdx.x; oz < T.nz; oz += blockDim.x) {
                    float ww = 0.f, vv = 0.f;
                    for (int ox = 0; ox < T.nx; ++ox) {
                        ww = __fadd_rn(ww, sc[2 * (ox * T.nz + oz)]);
                        vv = __fadd_rn(vv, sc[2 * (ox * T.nz + oz) + 1]);
                    }
                    const int z = T.z0 + oz;
                    pl[z] = make_float4(ww, vv, 0.f, 0.f);
                    for (int q = 0; q < nb; ++q) {
                        if (q == rank) continue;
                        st_async4(map_rank(smem_addr(&pl[z]), q), ww, vv, 0.f,
                                  map_rank(smem_addr(&bars[it & 1]), q));
                    }
                }
            }
            exchange(it, nxt, more);
            if (!kCluster && slots) {  // the slots from device memory
                for (int v = threadIdx.x; v < N; v += blockDim.x)
                    pl[v] = make_float4(part[2 * v], part[2 * v + 1], 0.f,
                                        0.f);
                __syncthreads();
            } else if (!kCluster) {
                // every plane's partials from its rows, in x order
                for (int z = threadIdx.x; z < Z; z += blockDim.x) {
                    float ww = 0.f, vv = 0.f;
                    for (int x = 0; x < L.X; ++x) {
                        ww = __fadd_rn(ww, part[2 * (z * L.X + x)]);
                        vv = __fadd_rn(vv, part[2 * (z * L.X + x) + 1]);
                    }
                    pl[z] = make_float4(ww, vv, 0.f, 0.f);
                }
                __syncthreads();
            }
            if (slots) {
                // warp w adds slots 32 w .. 32 w + 31 (thread t holds slot
                // t), warp 0 the 16 sums: the first form's block_sum2
                const int v = threadIdx.x;
                const float a = warp_sum(v < N ? pl[v].x : 0.f);
                const float b = warp_sum(v < N ? pl[v].y : 0.f);
                if (lane == 0) {
                    red[warp] = a;
                    red[kSlots / 32 + warp] = b;
                }
                __syncthreads();
            }
            if (warp == 0) {
                float ww, vv;
                if (slots) {
                    const bool in = lane < kSlots / 32;
                    ww = warp_sum(in ? red[lane] : 0.f);
                    vv = warp_sum(in ? red[kSlots / 32 + lane] : 0.f);
                } else {
                    ww = lane_ordered_sum(Z, [&](int z) { return pl[z].x; });
                    vv = lane_ordered_sum(Z, [&](int z) { return pl[z].y; });
                }
                if (lane == 0) {
                    sh[0] = ww;
                    sh[1] = vv;
                }
            }
            __syncthreads();
            const float ww = sh[0], vv = sh[1];
            lam = sqrtf(ww / fmaxf(vv, 1e-30f));
            if (more) {  // v = w / norm on the whole box
                const float norm = fmaxf(sqrtf(ww), 1e-30f);
                for (int bl = threadIdx.x; bl < n_box; bl += blockDim.x) {
                    const float4 a = wn4[bl];
                    wn4[bl] = make_float4(a.x / norm, a.y / norm, a.z / norm,
                                          0.f);
                }
                __syncthreads();
            }
            cur = nxt;
        }
        if (rank == 0 && threadIdx.x == 0) P.out[0] = lam * 1.1f;
    }
    // no block leaves while another may still store to it
    if constexpr (kCluster) cg::this_cluster().sync();
}

// A tiling's shared layout: the largest tile's vertex box, cells (stride:
// their count made odd) and own vertices, by the most along each axis
// (halo tiles; kLevelExchange: the cells a tile owns), and its bytes.
struct LevelLayout {
    int box, cells, stride, own;
    long long bytes;
};

LevelLayout level_layout(int X, int Y, int Z, int ntx, int nty, int ntz,
                         bool power, int halo = 1) {
    const int n[3] = {X, Y, Z}, nt[3] = {ntx, nty, ntz};
    int own[3] = {}, ext[3] = {};
    for (int a = 0; a < 3; ++a) {
        for (int it = 0; it < nt[a]; ++it) {
            int v0, nv, c0, nc;
            tile_axis(n[a], nt[a], it, halo, v0, nv, c0, nc);
            own[a] = nv > own[a] ? nv : own[a];
            ext[a] = nc > ext[a] ? nc : ext[a];
        }
    }
    LevelLayout lay;
    lay.box = (ext[0] + 1) * (ext[1] + 1) * (ext[2] + 1);
    lay.cells = ext[0] * ext[1] * ext[2];
    lay.stride = lay.cells | 1;
    lay.own = own[0] * own[1] * own[2];
    lay.bytes = 4 * level_smem_floats(lay.box, lay.stride, lay.own, Z, power);
    return lay;
}

// The cost model of lat_level_plan, in device microseconds of an H100, per
// modelled form (kLevelCluster, kLevelTiles): {launch, a KB of a block's
// shared layout, a round of a block's cell pass (kLevelCellsPerRound
// cells) an HVP, a wait between sweeps, a wait and block, a KB of x a block
// receives a wait, a round of a block's vertex pass (kLevelThreads
// vertices) a sweep, an HVP, the first round's share of its lanes an HVP,
// a block's own vertices over kLevelThreads a sweep, a block's cells over a
// round's an HVP}. Fitted by scripts/level_tilings.py --fit to its --sweep
// of both forms at the main paths' level shapes (rms 2.1 / 3.1 us; the
// picks within 2.7% of the fastest launch measured). Mirrored by
// ops/lattice_kernels.LEVEL_MODEL.
constexpr double kLevelModel[2][11] = {
    {5.71, 0.009732, 0.08189, 1.57, 0.009467, 0.196, 0.0, 0.0, 2.143, 0.0,
     1.595},                                                  // cluster
    {3.01, 0.02291, 0.3062, 0.5013, 0.00286, 0.2154, 1.449, 0.5969, 2.048,
     0.4956, 1.07},                                           // tiles
};
// kLevelTiles' tile counts along x and y (those its model was fitted
// over; lat_power's never split y). Mirrored by LEVEL_XY_TILES.
constexpr int kLevelXY[5][2] = {{1, 1}, {2, 1}, {4, 1}, {2, 2}, {4, 4}};

// The modelled device us of a call of `sweeps` sweeps (lat_power:
// iterations) with `hvps` cell passes and `waits` waits between them, in
// `form` on tiles (ntx, nty, ntz), for lat_power or lat_cheby. Mirrored by
// ops/lattice_kernels.level_cost.
double level_cost(int X, int Y, int Z, int form, int ntx, int nty, int ntz,
                  bool power, int sweeps, int hvps, int waits) {
    const LevelLayout lay = level_layout(X, Y, Z, ntx, nty, ntz, power);
    const int blocks = ntx * nty * ntz;
    const double rounds = double((lay.cells + kLevelCellsPerRound - 1)
                                 / kLevelCellsPerRound);
    const double vrounds = double((lay.own + kLevelThreads - 1)
                                  / kLevelThreads);
    const int nbrs = blocks - 1 < 2 ? blocks - 1 : 2;
    const double halo_kb = form == kLevelCluster
                               ? 16.0 * X * Y * nbrs / 1024.0
                               : 16.0 * (lay.box - lay.own) / 1024.0;
    const int first = lay.cells < kLevelCellsPerRound ? lay.cells
                                                      : kLevelCellsPerRound;
    const double* m = kLevelModel[form];
    return m[0] + m[1] * (lay.bytes / 1024.0) + m[2] * (hvps * rounds)
           + m[3] * waits + m[4] * (double(waits) * blocks)
           + m[5] * (waits * halo_kb) + m[6] * (sweeps * vrounds)
           + m[7] * hvps
           + m[8] * (hvps * double(first) / kLevelCellsPerRound)
           + m[9] * (sweeps * double(lay.own) / kLevelThreads)
           + m[10] * (hvps * double(lay.cells) / kLevelCellsPerRound);
}

// Where the first form took exchange tiles: true, where its halo tiles
// (kTileWidth wide in x and y) fit its shared scratch (kScratchRows rows of
// cells and 8 floats a box vertex in kSmemCap) only at more tiles than
// `sms`, and *ntz: the exchange tiles along z, as many as the card holds
// blocks of them (kTileWidth wide in x, and in y for lat_cheby: the first
// form's; y whole for lat_power). Mirrored by
// ops/lattice_kernels.level_exchange.
bool level_exchange(int X, int Y, int Z, int sms, bool power,
                    int* ntz_out) {
    const int ntx = (X + kTileWidth - 1) / kTileWidth,
              nty = (Y + kTileWidth - 1) / kTileWidth;
    const int ex = min((X + ntx - 1) / ntx + 1, X - 1),
              ey = min((Y + nty - 1) / nty + 1, Y - 1);
    for (int ntz = 1; ntz <= Z && ntx * nty * ntz <= sms; ++ntz) {
        const int ez = min((Z + ntz - 1) / ntz + 1, Z - 1);
        if (kScratchRows * ((ex * ey * ez) | 1)
                + 8LL * (ex + 1) * (ey + 1) * (ez + 1)
            <= kSmemCap / 4)
            return false;
    }
    *ntz_out = min(Z, sms / (ntx * (power ? 1 : nty)));
    return true;
}

constexpr int kLevelMaxDevices = 16;
const void* const kLevelKernels[2][kLevelForms] = {
    {reinterpret_cast<const void*>(level_kernel<false, kLevelCluster>),
     reinterpret_cast<const void*>(level_kernel<false, kLevelTiles>),
     reinterpret_cast<const void*>(level_kernel<false, kLevelExchange>)},
    {reinterpret_cast<const void*>(level_kernel<true, kLevelCluster>),
     reinterpret_cast<const void*>(level_kernel<true, kLevelTiles>),
     reinterpret_cast<const void*>(level_kernel<true, kLevelExchange>)},
};

// The launch of a cluster form: one cluster of `blocks` blocks.
cudaLaunchConfig_t level_cluster_config(int blocks, long long bytes,
                                        cudaStream_t st,
                                        cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kLevelThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// Whether kernel (0 lat_cheby, 1 lat_power) in `form` at `blocks` blocks of
// `bytes` of shared memory can be launched on the current device: within
// kLevelSmemCap; a cluster of at most kMaxLevelCluster blocks that the
// card can place (cudaOccupancyMaxActiveClusters >= 1), or a cooperative
// grid whose blocks are all resident. Lets the kernel take its cap (and
// clusters of up to 16 blocks) once per device. *ok false and cudaSuccess
// when it cannot.
cudaError_t level_launchable(int kernel, int form, int blocks,
                             long long bytes, bool* ok) {
    static bool allowed[kLevelMaxDevices][2][kLevelForms] = {};
    *ok = false;
    if (bytes > kLevelSmemCap || blocks < 1) return cudaSuccess;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kLevelMaxDevices) return cudaErrorInvalidDevice;
    const void* fn = kLevelKernels[kernel][form];
    if (!allowed[dev][kernel][form]) {
        e = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kLevelSmemCap);
        if (e == cudaSuccess && form == kLevelCluster)
            e = cudaFuncSetAttribute(
                fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
        allowed[dev][kernel][form] = true;
    }
    if (form == kLevelCluster) {
        if (blocks > kMaxLevelCluster) return cudaSuccess;
        cudaLaunchAttribute attr[1];
        const cudaLaunchConfig_t cfg =
            level_cluster_config(blocks, bytes, nullptr, attr);
        int clusters = 0;
        e = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
        *ok = e == cudaSuccess && clusters >= 1;
        return e;
    }
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fn, kLevelThreads, static_cast<size_t>(bytes));
    *ok = e == cudaSuccess && blocks <= sms * per_sm;
    return e;
}

// One launch of level_kernel<kPower, form> on tiles (ntx, nty, ntz): no
// form splits y, the cluster form takes z-slabs (ntx = 1) of at most
// kMaxLevelCluster blocks. A launch that cannot be made so returns
// cudaErrorLaunchOutOfResources; nothing else is run instead.
template <bool kPower>
cudaError_t launch_level(LevelArgs& P, int form, int ntx, int nty, int ntz,
                         cudaStream_t st) {
    const Lattice& L = P.A.L;
    if (form < 0 || form >= kLevelForms || ntx < 1 || nty < 1 || ntz < 1
        || ntx > L.X || nty > L.Y || ntz > L.Z
        || (kPower && nty != 1)
        || (form == kLevelCluster && ntx * nty != 1)
        || (form == kLevelExchange && P.pbuf == nullptr))
        return cudaErrorInvalidValue;
    const int halo = form != kLevelExchange;
    const LevelLayout lay =
        level_layout(L.X, L.Y, L.Z, ntx, nty, ntz, kPower, halo);
    const int blocks = ntx * nty * ntz;
    P.T = Tiling{ntx, nty, ntz, lay.stride, lay.box, halo};
    P.own = lay.own;
    bool ok = false;
    cudaError_t e = level_launchable(kPower, form, blocks, lay.bytes, &ok);
    if (e != cudaSuccess) return e;
    if (!ok) return cudaErrorLaunchOutOfResources;
    void* args[] = {&P};
    const void* fn = kLevelKernels[kPower][form];
    if (form == kLevelCluster) {
        cudaLaunchAttribute attr[1];
        const cudaLaunchConfig_t cfg =
            level_cluster_config(blocks, lay.bytes, st, attr);
        e = cudaLaunchKernelExC(&cfg, fn, args);
    } else {
        e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kLevelThreads),
                                        args, static_cast<size_t>(lay.bytes),
                                        st);
    }
    const cudaError_t last = cudaGetLastError();
    return e != cudaSuccess ? e : last;
}

// ---------------------------------------------------------------------------
// The vertex-diagonal blocks: lat_diag, and lat_diag_shift's shift and
// projection
// ---------------------------------------------------------------------------
//
// One kernel for both: the 6-channel diagonal chain (diag_chain, 930 FLOP
// per cell and quad point) and a vertex pass whose epilogue writes the
// blocks, or with ctrl the blocks + (ctrl + 1 - vm) I, SPD-projected when
// asked (spd_project, in registers). Bound on this card: the chain's
// float32 operations (7.3 us at the 74k beam); the bytes are one read of u
// and one write of 6 channels. At the small shapes of the multigrid's
// levels a launch's fixed cost and, with the projection, its serial chain
// of 18 rotations (each with three IEEE divisions and two square roots)
// set the time instead. The plan (ops/lattice_kernels.diag_plan: force_plan
// under a cost model fitted to scripts/diag_tilings.py on an H100) picks
// one of two forms:
// * halo tiles, one launch: a block per halo tile of lat_force's tiles, the
//   tile's vertex box of u staged once in shared memory, a thread a cell
//   with the quadrature points in sequence or in pairs (the 8 corners' 48
//   sums in registers, 128 of them a thread), the corner sums through
//   shared memory and each vertex's in the fixed corner order of the gather
//   below: no cell scratch in device memory, and the two passes' bits.
// * two passes (where the cells computed twice cost more than a second
//   launch: the 74k beam): diag_cells writes every cell's 48 corner sums to
//   a cell scratch, gather_diag sums each vertex's 8 cells and applies the
//   epilogue.
// A cell's points are summed in sequence for lat_diag and in pairs for
// lat_diag_shift (the eight-lane exchange's order; diag_chain), so each
// keeps the bits of its first form: for lat_diag the two passes with the
// chain fully unrolled (255 registers, one block an SM), for
// lat_diag_shift eight lanes a cell on the fused kernels' halo tiles.
// Exchange tiles (each cell once, the tiles' upper-face partial sums
// through device memory, a second launch for the vertex pass) were built
// and timed, and lost at every shape (PERF.md).

// The blocks at vertex v from the complete sums tot of its 6 channels.
__device__ __forceinline__ void diag_out(const DiagArgs& P, int N, int v,
                                         const float* tot) {
    float a[6];
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) a[ch] = tot[ch];
    if (P.ctrl != nullptr) {
        const float shift = P.ctrl[v] + (1.f - P.vm[v]);
        a[0] += shift;
        a[3] += shift;
        a[5] += shift;
        if (P.project) spd_project(a);
    }
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) P.out[ch * N + v] = a[ch];
}

// A block per halo tile, kForceThreads threads, two blocks an SM, a thread
// a cell: diag_chain with each corner of u read from the shared box at
// every point (kPairs: its two slots of partial sums are the cell's scratch
// rows and 48 rows more), the 48 sums scaled by det * cell mask into the
// shared scratch sc[(corner * 6 + channel) * stride + cell], then the halo
// vertex pass. kPairs on a tile of at most lane_cells cells: eight lanes a
// cell instead (tile_cells, the fused kernels' diagonal pass, whose point
// exchange sums in diag_chain's pair order), where a chain's latency is
// what a launch waits for.
template <bool kPairs>
__global__ void __launch_bounds__(kForceThreads, 2)
diag_tiles_kernel(const __grid_constant__ DiagArgs P) {
    extern __shared__ float4 smem[];  // scratch rows, then the vertex box
    float* sc = reinterpret_cast<float*>(smem);
    const Lattice& L = P.A.L;
    // kPairs: rows of kForceThreads floats (a constant row stride, so that
    // every row's offset is an immediate), the tile's cells one round
    const int stride = kPairs ? kForceThreads : P.T.stride;
    const Tile T = tile_of(L, P.T, blockIdx.x);
    const int n_ext = T.ex * T.ey * T.ez;
    float4* su = reinterpret_cast<float4*>(sc + (kPairs ? 2 : 1) * kDiagRows
                                                    * stride);
    const CellIn at_u = {0.f, nullptr, 0.f, false};
    if (kPairs && n_ext <= P.lane_cells) {
        // a small tile: eight lanes a cell, the points summed in the same
        // order, and a cell's chain eight times shorter
        tile_cells<kDiag>(P, T, quad_lane(P.A.G, threadIdx.x & 7), sc, at_u);
        __syncthreads();
        halo_vertices<6>(L, T, sc, P.T.stride, [&](int v, const float* tot) {
            diag_out(P, L.N, v, tot);
        });
        return;
    }
    stage_box<kDiag>(P, T, su, nullptr, at_u);
    __syncthreads();
    const int byn = T.ey + 1, bzn = T.ez + 1;
    for (int cl = threadIdx.x; cl < n_ext; cl += blockDim.x) {
        const int lz = cl % T.ez, t = cl / T.ez;
        const int lx = t / T.ey, ly = t % T.ey;
        const int b0 = (lx * byn + ly) * bzn + lz;
        float acc[8][6];
        diag_chain<kPairs>(
            P.A.G, P.A.mu, P.A.la,
            [&](int i) {
                const float4 a = su[b0 + (((i >> 2) & 1) * byn
                                          + ((i >> 1) & 1)) * bzn + (i & 1)];
                return make_float3(a.x, a.y, a.z);
            },
            [&](int slot, const float (*a)[6]) {
#pragma unroll
                for (int j = 0; j < 48; ++j)
                    sc[(slot * 48 + j) * stride + cl] = a[j / 6][j % 6];
            },
            [&](int slot, float (*a)[6]) {
#pragma unroll
                for (int j = 0; j < 48; ++j)
                    a[j / 6][j % 6] =
                        sc[(slot * 48 + j) * stride + cl] + a[j / 6][j % 6];
            },
            acc);
        const int c = ((T.cx0 + lx) * (L.Y - 1) + T.cy0 + ly) * (L.Z - 1)
                    + T.cz0 + lz;
        const float w = P.A.det * P.cm[c];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int ch = 0; ch < 6; ++ch)
                sc[(i * 6 + ch) * stride + cl] = acc[i][ch] * w;
        }
    }
    __syncthreads();
    halo_vertices<6>(L, T, sc, stride, [&](int v, const float* tot) {
        diag_out(P, L.N, v, tot);
    });
}

// The two passes' vertex pass: a vertex's 8 incident cells from the cell
// scratch cd in fixed corner order, then diag_out.
__global__ void __launch_bounds__(kThreads)
gather_diag(const __grid_constant__ DiagArgs P, const float* __restrict__ cd) {
    const Lattice& L = P.A.L;
    for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < L.N;
         v += gridDim.x * blockDim.x) {
        int x, y, z;
        vertex_coords(L, v, x, y, z);
        float tot[6];
#pragma unroll
        for (int ch = 0; ch < 6; ++ch)
            tot[ch] = gather_vertex<6>(L, cd, ch, x, y, z);
        diag_out(P, L.N, v, tot);
    }
}

// ---------------------------------------------------------------------------
// Standalone force and energy
// ---------------------------------------------------------------------------
//
// lat_force, one launch: one block per halo tile of a vertex tiling (the
// plan is ops/lattice_kernels.force_plan, a function of the lattice and
// the SM count). The block stages its vertex box in shared memory, computes
// every cell incident to its vertices with a thread a cell, the quadrature
// points in sequence (the per-point arithmetic of the fused kernel's lanes,
// g at the warp-uniform point from the parameters), into the shared
// scratch, and sums each vertex's corners in fixed order (the fused
// kernel's halo vertex pass). Where the plan's model says the cells computed
// twice cost more than a second launch (the 74k beam), lat_force runs the
// two passes instead: force_cells, a thread a cell with the fully unrolled
// chain, into a kept scratch, then gather_vertices.

constexpr int kEnergyThreads = 256;

struct ForceArgs {
    ChainArgs A;
    Tiling T;
    const float* u;    // (3, N) displacement
    const float* cm;   // (C,) cell mask
    float* out;        // (3, N) force
};

// The cell pass of a force tile with a thread a cell: the points in
// sequence, each with the lanes' arithmetic for one point, the corner sums
// in point order, scaled by -det * cell mask, to the shared scratch
// sc[(corner * 3 + channel) * stride + local cell].
__device__ __forceinline__ void tile_cells_serial(const ForceArgs& P,
                                                  const Tile& T, float* sc) {
    const Lattice& L = P.A.L;
    const int stride = P.T.stride;
    const int n_ext = T.ex * T.ey * T.ez;
    float4* su = reinterpret_cast<float4*>(sc + kForceRows * stride);
    const CellIn at_u = {0.f, nullptr, 0.f, false};
    stage_box<kForce>(P, T, su, nullptr, at_u);
    __syncthreads();
    const int byn = T.ey + 1, bzn = T.ez + 1;
    for (int cl = threadIdx.x; cl < n_ext; cl += blockDim.x) {
        const int lz = cl % T.ez, t = cl / T.ez;
        const int lx = t / T.ey, ly = t % T.ey;
        const int b0 = (lx * byn + ly) * bzn + lz;
        float us[8][3], acc[8][3];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float4 a = su[b0 + (((i >> 2) & 1) * byn + ((i >> 1) & 1))
                                         * bzn + (i & 1)];
            us[i][0] = a.x;
            us[i][1] = a.y;
            us[i][2] = a.z;
            acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
        }
#pragma unroll 1
        for (int q = 0; q < 8; ++q) {
            const QuadLane g = quad_lane(P.A.G, q);
            float F[3][3], M[3][3], S[3][3];
            zero3x3(F);
#pragma unroll
            for (int i = 0; i < 8; ++i) grad_add(us[i], g.gq[i], F);
            deformation_stress(F, P.A.mu, P.A.la, M);
            force_stress(F, M, S);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float o[3];
                emit_corner(S, g.gq[i], o);
#pragma unroll
                for (int r = 0; r < 3; ++r) acc[i][r] += o[r];
            }
        }
        const int c = ((T.cx0 + lx) * (L.Y - 1) + T.cy0 + ly) * (L.Z - 1)
                    + T.cz0 + lz;
        const float w = -P.A.det * P.cm[c];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int r = 0; r < 3; ++r)
                sc[(i * 3 + r) * stride + cl] = acc[i][r] * w;
        }
    }
}

__global__ void __launch_bounds__(kForceThreads, 2)
force_tiles_kernel(const __grid_constant__ ForceArgs P) {
    extern __shared__ float4 smem[];  // scratch rows, then the vertex box
    float* sc = reinterpret_cast<float*>(smem);
    const Lattice& L = P.A.L;
    const int N = L.N;
    if (P.T.tiles && static_cast<int>(blockIdx.x) >= P.T.n_active) {
        // a cover's last blocks zero the inactive tiles' vertices
        zero_inactive(L, P.T, blockIdx.x - P.T.n_active,
                      gridDim.x - P.T.n_active, P.out, nullptr);
        return;
    }
    const Tile T = tile_of(L, P.T, tile_id(P.T, blockIdx.x));
    tile_cells_serial(P, T, sc);
    __syncthreads();
    halo_vertices<3>(L, T, sc, P.T.stride, [&](int v, const float* tot) {
#pragma unroll
        for (int c = 0; c < 3; ++c) P.out[c * N + v] = tot[c];
    });
}

// The two-pass form's cell pass: a thread a cell, the 8 points unrolled
// (g as immediate operands), the cell's corner contributions to the scratch
// cf[(corner * 3 + channel) * C + c]. cells: the n cells to compute (a
// cover's real cells), or null: every cell, n = C.
__global__ void __launch_bounds__(kThreads)
force_cells(const __grid_constant__ ChainArgs A, const float* __restrict__ u,
            const float* __restrict__ cm, float* __restrict__ cf,
            const int* __restrict__ cells, int n) {
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
         j += gridDim.x * blockDim.x)
        cell_force(A, u, cm, cf, cells ? cells[j] : j);
}

// The g table in shared memory. A lane's quad_lane reads the column of its
// own point: 8 different addresses a warp, which shared memory serves at
// once and the kernel's parameter space would serve one by one.
__device__ __forceinline__ const GTab& shared_gtab(const GTab& G, GTab* s) {
    const float* src = &G.g[0][0][0];
    float* dst = &s->g[0][0][0];
    for (int j = threadIdx.x; j < 8 * 8 * 3; j += blockDim.x) dst[j] = src[j];
    __syncthreads();
    return *s;
}

// The energy of the cells the calling thread walks (a fixed grid-stride
// walk over cells[0, n), or over every cell when cells is null), scaled by
// det * cell mask. kLanes: eight lanes a cell, lane q
// takes point q, lane i loads corner i and the cell's lanes pass the
// corners round, the 8 points summed by a fixed xor exchange and added by
// the cell's lane 0. Otherwise a thread a cell, the points in sequence.
template <bool kLanes>
__device__ __forceinline__ float walk_energy(const ChainArgs& A,
                                             const float* __restrict__ u,
                                             const float* __restrict__ cm,
                                             const int* __restrict__ cells,
                                             int n, GTab* gs) {
    const Lattice& L = A.L;
    const int lane = threadIdx.x & 31;
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int nthreads = gridDim.x * blockDim.x;
    float s = 0.f;
    if constexpr (kLanes) {
        const int first = lane & 24;                  // the cell's lane 0
        const unsigned group = 0xffu << first;        // the cell's 8 lanes
        const QuadLane ql = quad_lane(shared_gtab(A.G, gs), lane & 7);
        for (int j = tid >> 3; j < n; j += nthreads >> 3) {
            const int c = cells ? cells[j] : j;
            int cx, cy, cz;
            cell_coords(L, c, cx, cy, cz);
            const float* ui = u + 3 * corner_vertex(L, cx, cy, cz, lane & 7);
            const float mine[3] = {__ldg(ui), __ldg(ui + 1), __ldg(ui + 2)};
            float F[3][3];
            zero3x3(F);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float us[3];
#pragma unroll
                for (int r = 0; r < 3; ++r)
                    us[r] = __shfl_sync(group, mine[r], first + i);
                grad_add(us, ql.gq[i], F);
            }
            float e = point_energy(F, A.mu, A.la);
            e += __shfl_xor_sync(group, e, 4);
            e += __shfl_xor_sync(group, e, 2);
            e += __shfl_xor_sync(group, e, 1);
            if (lane == first) s += (A.det * e) * cm[c];
        }
    } else {
        for (int j = tid; j < n; j += nthreads) {
            const int c = cells ? cells[j] : j;
            int cx, cy, cz;
            cell_coords(L, c, cx, cy, cz);
            float us[8][3];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float* ui = u + 3 * corner_vertex(L, cx, cy, cz, i);
#pragma unroll
                for (int r = 0; r < 3; ++r) us[i][r] = __ldg(ui + r);
            }
            float e = 0.f;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const QuadLane g = quad_lane(A.G, q);
                float F[3][3];
                zero3x3(F);
#pragma unroll
                for (int i = 0; i < 8; ++i) grad_add(us[i], g.gq[i], F);
                e += point_energy(F, A.mu, A.la);
            }
            s += (A.det * e) * cm[c];
        }
    }
    return s;
}

// lat_energy: each thread's walk, per-block partials, and the block that
// takes the last ticket adds the partials in index order (block_sum's
// order, whichever block it is) and resets the ticket for the next call.
template <bool kLanes>
__global__ void __launch_bounds__(kEnergyThreads)
energy_kernel(const __grid_constant__ ChainArgs A, const float* __restrict__ u,
              const float* __restrict__ cm, const int* __restrict__ cells,
              int n, float* __restrict__ part, unsigned* __restrict__ ticket,
              float* __restrict__ out) {
    __shared__ GTab gs;
    __shared__ float sh[33];
    __shared__ bool is_last;
    const float t = block_sum(walk_energy<kLanes>(A, u, cm, cells, n, &gs),
                              sh);
    if (threadIdx.x == 0) {
        part[blockIdx.x] = t;
        __threadfence();
        is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
        __threadfence();
    }
    __syncthreads();
    if (!is_last) return;
    float a = 0.f;
    for (int j = threadIdx.x; j < (int)gridDim.x; j += blockDim.x)
        a += __ldcg(part + j);
    a = block_sum(a, sh);
    if (threadIdx.x == 0) {
        out[0] = a;
        ticket[0] = 0u;
    }
}

// Blocks of kFusedThreads threads with kSmemCap bytes of dynamic shared
// memory that the current card holds at once running the kernel fn, after
// allowing fn that much shared memory (needed before any launch above 48 KB)
// and checking that the card takes cooperative launches.
cudaError_t fused_capacity(const void* fn, int* cap) {
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fn, kFusedThreads, kSmemCap);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorLaunchOutOfResources;
    *cap = sms * per_sm;
    return e;
}

// The least-cost tiling of an X x Y x Z vertex lattice for the tiled
// kernels: tiles at most kTileWidth vertices wide in x and y, ntz of them
// along z (the contiguous axis), in halo or exchange mode, that fit the
// shared scratch (kScratchRows rows of the tile's cells and box_floats
// floats per vertex of the box around them). cost(ntiles, blocks, waves,
// rounds, halo) in microseconds, rounds: ceil(cells of a tile /
// kCellsPerRound). Candidates in a fixed order, the first of least cost
// kept. mode 0: every candidate; 1: halo only; 2: exchange only.
// plan = {grid = min(tiles, cap), ntx, nty, ntz, stride, box, halo}; false
// when nothing fits.
template <class Cost>
bool best_tiling(int X, int Y, int Z, int mode, int cap, int box_floats,
                 Cost cost, int* plan) {
    const long long max_floats = kSmemCap / (int)sizeof(float);
    const int ntx = (X + kTileWidth - 1) / kTileWidth,
              nty = (Y + kTileWidth - 1) / kTileWidth;
    double best = 0.0;
    bool have = false;
    for (int halo = 1; halo >= 0; --halo) {
        if ((mode == 1 && !halo) || (mode == 2 && halo)) continue;
        const int mx = (X + ntx - 1) / ntx + halo, ex = mx < X - 1 ? mx : X - 1;
        const int my = (Y + nty - 1) / nty + halo, ey = my < Y - 1 ? my : Y - 1;
        for (int ntz = 1; ntz <= Z; ++ntz) {
            const int mz = (Z + ntz - 1) / ntz + halo,
                      ez = mz < Z - 1 ? mz : Z - 1;
            const long long ext = 1LL * ex * ey * ez;
            const long long box = 1LL * (ex + 1) * (ey + 1) * (ez + 1);
            if (kScratchRows * (ext | 1) + box_floats * box > max_floats)
                continue;
            const long long ntiles = 1LL * ntx * nty * ntz;
            const long long blocks = ntiles < cap ? ntiles : cap;
            const double waves = double((ntiles + cap - 1) / cap);
            const double rounds =
                double((ext + kCellsPerRound - 1) / kCellsPerRound);
            const double c = cost(ntiles, blocks, waves, rounds, halo);
            if (have && c >= best) continue;
            have = true;
            best = c;
            plan[0] = static_cast<int>(blocks);
            plan[1] = ntx;
            plan[2] = nty;
            plan[3] = ntz;
            plan[4] = static_cast<int>(ext) | 1;
            plan[5] = static_cast<int>(box);
            plan[6] = halo;
        }
    }
    return have;
}

// Lets fn (one of kOptIns kernels, `which`) take `smem` bytes of dynamic
// shared memory where that is more than the 48 KB a launch may take
// without opting in (up to kDiagSmem), once per device.
constexpr int kOptIns = 3;
cudaError_t allow_smem(const void* fn, int which, size_t smem) {
    static bool allowed[kMaxDevices][kOptIns] = {};
    if (smem <= kForceSmem) return cudaSuccess;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!allowed[dev][which]) {
        e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kDiagSmem);
        allowed[dev][which] = e == cudaSuccess;
    }
    return e;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

extern "C" {

const char* lat_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Tiling (ntx, nty, ntz, stride, box) from ops/lattice_kernels.force_plan:
// one launch, a block per halo tile, kForceRows * stride + 4 * box floats
// of shared memory, at most 48 KB. ntx = 0: the two passes, with cf a
// scratch of 24*C floats (calls that share it must be ordered on one
// stream). A cover (list non-null): in the two passes, list holds the
// n_list real cells the cell pass computes and cf is the cover's own
// scratch, zero at every other cell (the gather reads them all); on halo
// tiles, list holds every tile, the n_list active ones first, and up to
// kZeroBlocks more blocks zero the inactive tiles' vertices.
int lat_force(const float* u, const float* cm, float* out, float* cf,
              const int* list, int n_list, int ntx, int nty, int ntz,
              int stride, int box, int X, int Y, int Z, const float* g,
              float det, float mu, float la, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const ChainArgs A = make_chain_args(X, Y, Z, g, det, mu, la);
    if (ntx == 0) {
        if (list && (n_list < 1 || n_list > A.L.C))
            return static_cast<int>(cudaErrorInvalidValue);
        const int n = list ? n_list : A.L.C;
        force_cells<<<blocks_for(n), kThreads, 0, st>>>(A, u, cm, cf, list,
                                                        n);
        gather_vertices<3><<<blocks_for(A.L.N), kThreads, 0, st>>>(A.L, cf,
                                                                   out);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t smem = sizeof(float) * (kForceRows * stride + 4 * box);
    const int ntiles = ntx * nty * ntz;
    if (smem > kForceSmem || nty < 1 || ntz < 1
        || (list && (n_list < 1 || n_list > ntiles)))
        return static_cast<int>(cudaErrorInvalidValue);
    ForceArgs P;
    P.A = A;
    P.T = Tiling{ntx, nty, ntz, stride, box, 1, list, n_list};
    P.u = u;
    P.cm = cm;
    P.out = out;
    const int rest = ntiles - n_list;
    const int grid =
        list ? n_list + (rest < kZeroBlocks ? rest : kZeroBlocks) : ntiles;
    force_tiles_kernel<<<grid, kForceThreads, smem, st>>>(P);
    return static_cast<int>(cudaGetLastError());
}

// H(u) p, or with ctrl (and vm) the level operator (H(u) p + ctrl p) vm;
// out (3, N). ntx > 0: one launch, a block per halo tile (tiling from
// ops/lattice_kernels.hvp_plan), kForceRows * stride + 8 * box floats of
// shared memory, at most 48 KB; ntx = 0: the two passes, with cf a scratch
// of 24*C floats (calls that share it must be ordered on one stream).
int lat_hvp(const float* u, const float* p, const float* cm,
            const float* ctrl, const float* vm, float* out, float* cf,
            int ntx, int nty, int ntz, int stride, int box, int X, int Y,
            int Z, const float* g, float det, float mu, float la,
            void* stream) {
    if ((ctrl == nullptr) != (vm == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const ChainArgs A = make_chain_args(X, Y, Z, g, det, mu, la);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (ntx == 0) {
        hvp_cells<<<blocks_for(A.L.C), kThreads, 0, st>>>(A, u, p, cm, cf);
        if (ctrl == nullptr)
            gather_vertices<3><<<blocks_for(A.L.N), kThreads, 0, st>>>(
                A.L, cf, out);
        else
            gather_level<<<blocks_for(A.L.N), kThreads, 0, st>>>(
                A.L, cf, p, ctrl, vm, out);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t smem = sizeof(float) * (kForceRows * stride + 8 * box);
    if (smem > kForceSmem || nty < 1 || ntz < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    HvpArgs P = {};
    P.A = A;
    P.T = Tiling{ntx, nty, ntz, stride, box, 1};
    P.u = u;
    P.p = p;
    P.cm = cm;
    P.ctrl = ctrl;
    P.vm = vm;
    P.out = out;
    hvp_tiles_kernel<<<ntx * nty * ntz, kForceThreads, smem, st>>>(P);
    return static_cast<int>(cudaGetLastError());
}

// The vertex-diagonal blocks of u, out (6, N) in the channel order xx xy
// xz yy yz zz; with ctrl (and vm) shifted by ctrl + 1 - vm and, with
// project, SPD-projected (lat_diag_shift). Tiling (ntx, nty, ntz, stride,
// box) from ops/lattice_kernels.diag_plan: one launch, a block per halo
// tile, kDiagRows * stride + 4 * box floats of shared memory (with ctrl:
// 2 * kDiagRows rows of kForceThreads floats, stride the tile's cells, at
// most kForceThreads; a tile of at most lane_cells cells runs eight lanes a
// cell), at most kDiagSmem; ntx = 0: the two passes, with cd a scratch of
// 48*C floats (calls that share it must be ordered on one stream).
int lat_diag(const float* u, const float* cm, const float* ctrl,
             const float* vm, float* out, float* cd, int project,
             int lane_cells, int ntx, int nty, int ntz, int stride, int box,
             int X, int Y, int Z, const float* g, float det, float mu,
             float la, void* stream) {
    if ((ctrl == nullptr) != (vm == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    DiagArgs P = {};
    P.A = make_chain_args(X, Y, Z, g, det, mu, la);
    P.u = u;
    P.cm = cm;
    P.ctrl = ctrl;
    P.vm = vm;
    P.out = out;
    P.project = project;
    P.lane_cells = lane_cells;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // lat_diag_shift sums a cell's points in pairs (see diag_chain), with
    // twice the shared scratch
    const bool pairs = ctrl != nullptr;
    const int rows = (pairs ? 2 : 1) * kDiagRows;
    cudaError_t e = cudaSuccess;
    if (ntx == 0) {
        if (cd == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        const int blocks = blocks_for(P.A.L.C);
        if (pairs) {
            const size_t smem = sizeof(float) * rows * kThreads;
            e = allow_smem(reinterpret_cast<const void*>(diag_cells<true>),
                           0, smem);
            if (e != cudaSuccess) return static_cast<int>(e);
            diag_cells<true><<<blocks, kThreads, smem, st>>>(P.A, u, cm, cd);
        } else {
            diag_cells<false><<<blocks, kThreads, 0, st>>>(P.A, u, cm, cd);
        }
        gather_diag<<<blocks_for(P.A.L.N), kThreads, 0, st>>>(P, cd);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t smem =
        sizeof(float) * (rows * (pairs ? kForceThreads : stride) + 4 * box);
    if (smem > kDiagSmem || nty < 1 || ntz < 1
        || (pairs && stride > kForceThreads))
        return static_cast<int>(cudaErrorInvalidValue);
    e = allow_smem(pairs ? reinterpret_cast<const void*>(
                               diag_tiles_kernel<true>)
                         : reinterpret_cast<const void*>(
                               diag_tiles_kernel<false>),
                   pairs ? 1 : 2, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    P.T = Tiling{ntx, nty, ntz, stride, box, 1};
    if (pairs)
        diag_tiles_kernel<true><<<ntx * nty * ntz, kForceThreads, smem, st>>>(
            P);
    else
        diag_tiles_kernel<false><<<ntx * nty * ntz, kForceThreads, smem,
                                   st>>>(P);
    return static_cast<int>(cudaGetLastError());
}

// One launch of `grid` blocks, eight lanes a cell (lanes = 1) or a thread
// a cell (ops/lattice_kernels.energy_plan). u: the channel-last
// (X, Y, Z, 3) field; out: 1 float; part: grid floats; ticket: 1 zero that
// the kernel leaves zero. cells: a cover's n_cells real cells, the only
// ones walked; null: every cell. Calls that share part and ticket must be
// ordered on one stream.
int lat_energy(const float* u, const float* cm, float* out, float* part,
               unsigned* ticket, const int* cells, int n_cells, int grid,
               int lanes, int X, int Y, int Z, const float* g, float det,
               float mu, float la, void* stream) {
    const ChainArgs A = make_chain_args(X, Y, Z, g, det, mu, la);
    if (grid < 1 || (cells && (n_cells < 1 || n_cells > A.L.C)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int n = cells ? n_cells : A.L.C;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (lanes)
        energy_kernel<true><<<grid, kEnergyThreads, 0, st>>>(
            A, u, cm, cells, n, part, ticket, out);
    else
        energy_kernel<false><<<grid, kEnergyThreads, 0, st>>>(
            A, u, cm, cells, n, part, ticket, out);
    return static_cast<int>(cudaGetLastError());
}

// The launch plan of the fused Newton kernel (pcg = 0) or the fused PCG
// kernel (pcg = 1) for this lattice on the current device:
// plan = {grid, ntx, nty, ntz, stride, box, halo}. Tiles are at most 5
// vertices wide in x and y and as long in z (the contiguous axis) as the
// plan's cost model likes, in halo or in exchange mode (mode 0; 1 forces
// halo, 2 exchange). The model, in microseconds as measured on an H100:
// a kernel runs 5 cell passes of ceil(cells / 64) rounds per tile (0.9 us a
// round of a block's 16 warps, times the tiles a block walks) and 7 (halo)
// or 12 (exchange) grid barriers of 2 us + 0.016 us a block. Few long tiles
// make cheap barriers, many short ones short passes; a tile too large for
// the shared scratch is not a candidate, which is what sends large lattices
// to exchange mode. Returns a CUDA error code.
int lat_newton_plan(int X, int Y, int Z, int pcg, int mode, int* plan) {
    if (X < 2 || Y < 2 || Z < 2 || mode < 0 || mode > 2)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* fn = pcg ? reinterpret_cast<const void*>(
                               fused_newton_kernel<true>)
                         : reinterpret_cast<const void*>(
                               fused_newton_kernel<false>);
    int cap = 0;
    const cudaError_t e = fused_capacity(fn, &cap);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool have = best_tiling(
        X, Y, Z, mode, cap, 8,
        [](long long, long long blocks, double waves, double rounds,
           int halo) {
            return 5.0 * rounds * 0.9 * waves
                   + (halo ? 7.0 : 12.0) * (2.0 + 0.016 * double(blocks));
        },
        plan);
    return have ? 0 : static_cast<int>(cudaErrorLaunchOutOfResources);
}

// The form and tiles a multigrid level kernel runs a call in on the current
// device: kernel 0 lat_cheby (sweeps; warm: from a start; residual: b - A x
// asked for) or 1 lat_power (sweeps = iterations); plan = {form, ntx, nty,
// ntz, modelled device us x 1000}: where level_exchange holds,
// kLevelExchange on its tiles (the model's us 0);
// else the least level_cost among clusters of 1 to kMaxLevelCluster
// z-slabs and kLevelTiles' tiles ((ntx, nty) of kLevelXY, any ntz; at most
// one block an SM) that level_launchable takes (ties: the first in that
// order). Mirrored by ops/lattice_kernels.level_plan. Returns a CUDA error
// code.
int lat_level_plan(int X, int Y, int Z, int kernel, int sweeps, int warm,
                   int residual, int* plan) {
    if (X < 2 || Y < 2 || Z < 2 || kernel < 0 || kernel > 1 || sweeps < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool power = kernel == 1;
    const int hvps = power ? sweeps : sweeps - !warm + (residual != 0);
    const int waits = power ? sweeps : sweeps - 1 + (residual != 0);
    int ez_tiles = 0;
    if (level_exchange(X, Y, Z, sms, power, &ez_tiles)) {
        const int ntx = (X + kTileWidth - 1) / kTileWidth,
                  nty = power ? 1 : (Y + kTileWidth - 1) / kTileWidth;
        bool ok = false;
        e = level_launchable(kernel, kLevelExchange, ntx * nty * ez_tiles,
                             level_layout(X, Y, Z, ntx, nty, ez_tiles, power,
                                          0).bytes,
                             &ok);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (!ok) return static_cast<int>(cudaErrorLaunchOutOfResources);
        plan[0] = kLevelExchange;
        plan[1] = ntx;
        plan[2] = nty;
        plan[3] = ez_tiles;
        plan[4] = 0;
        return 0;
    }
    bool have = false;
    double best = 0.0;
    for (int form = 0; form < 2; ++form) {
        const bool cluster = form == kLevelCluster;
        for (int k = 0; k < (cluster ? 1 : 5); ++k) {
            const int ntx = kLevelXY[k][0], nty = kLevelXY[k][1];
            if (ntx > X || nty > Y || (power && nty > 1)) continue;
            const int mz = cluster && Z > kMaxLevelCluster ? kMaxLevelCluster
                                                           : Z;
            for (int ntz = 1; ntz <= mz; ++ntz) {
                const int blocks = ntx * nty * ntz;
                if (!cluster && blocks > sms) break;
                const LevelLayout lay =
                    level_layout(X, Y, Z, ntx, nty, ntz, power);
                if (lay.bytes > kLevelSmemCap) continue;
                const double cost = level_cost(X, Y, Z, form, ntx, nty, ntz,
                                               power, sweeps, hvps, waits);
                if (have && cost >= best) continue;
                bool ok = false;
                e = level_launchable(kernel, form, blocks, lay.bytes, &ok);
                if (e != cudaSuccess) return static_cast<int>(e);
                if (!ok) continue;
                have = true;
                best = cost;
                plan[0] = form;
                plan[1] = ntx;
                plan[2] = nty;
                plan[3] = ntz;
            }
        }
    }
    if (!have) return static_cast<int>(cudaErrorLaunchOutOfResources);
    plan[4] = static_cast<int>(best * 1000.0);
    return 0;
}

// All the sweeps of one Chebyshev smoothing call on a multigrid level (see
// level_kernel): x0 null starts from zero, r null skips the residual;
// scratch: xs 8*N floats, 16-byte aligned (kLevelTiles, kLevelExchange),
// pbuf 24*N (kLevelExchange); coef: 2 * sweeps - 1 floats
// (theta, then a and b of every later sweep), at most kMaxSweeps sweeps.
// form and tiles as lat_level_plan(X, Y, Z, 0, sweeps, x0 != null, r !=
// null) picks them, or as a caller chose: a launch that cannot be made so
// returns cudaErrorLaunchOutOfResources, and nothing else runs instead.
// Calls that share the scratch must be ordered on one stream.
int lat_cheby(const float* u, const float* b, const float* x0,
              const float* cm, const float* ctrl, const float* vm,
              const float* d6, float* x, float* r, float* xs, float* pbuf,
              const float* coef, int sweeps, int form, int ntx, int nty,
              int ntz, int X, int Y, int Z, const float* g, float det,
              float mu, float la, void* stream) {
    if (sweeps < 1 || sweeps > kMaxSweeps)
        return static_cast<int>(cudaErrorInvalidValue);
    LevelArgs P = {};
    P.A = make_chain_args(X, Y, Z, g, det, mu, la);
    P.u = u;
    P.cm = cm;
    P.ctrl = ctrl;
    P.vm = vm;
    P.d6 = d6;
    P.b = b;
    P.x0 = x0;
    P.x = x;
    P.r = r;
    P.xs = reinterpret_cast<float4*>(xs);
    P.pbuf = pbuf;
    P.sweeps = sweeps;
    for (int j = 0; j < 2 * sweeps - 1; ++j) P.coef[j] = coef[j];
    return static_cast<int>(launch_level<false>(
        P, form, ntx, nty, ntz, static_cast<cudaStream_t>(stream)));
}

// One level's power iteration (see level_kernel): iters iterations from
// vm start, 1.1 lambda to out[0]; scratch: xs 8*N floats, 16-byte aligned,
// and part 4*max(Z*X, kSlots) (kLevelTiles, kLevelExchange), pbuf 24*N
// (kLevelExchange).
// form and tiles (nty =
// 1) as lat_level_plan(X, Y, Z, 1, iters, 0, 0) picks them, or as a caller
// chose;
// a launch that cannot be made so returns cudaErrorLaunchOutOfResources.
// Calls that share the scratch must be ordered on one stream.
int lat_power(const float* u, const float* cm, const float* ctrl,
              const float* vm, const float* d6, const float* start,
              float* out, float* xs, float* part, float* pbuf, int iters,
              int form, int ntx, int nty, int ntz, int X, int Y, int Z,
              const float* g, float det, float mu, float la, void* stream) {
    if (iters < 1) return static_cast<int>(cudaErrorInvalidValue);
    LevelArgs P = {};
    P.A = make_chain_args(X, Y, Z, g, det, mu, la);
    P.u = u;
    P.cm = cm;
    P.ctrl = ctrl;
    P.vm = vm;
    P.d6 = d6;
    P.start = start;
    P.out = out;
    P.xs = reinterpret_cast<float4*>(xs);
    P.part = part;
    P.pbuf = pbuf;
    P.sweeps = iters;
    return static_cast<int>(launch_level<true>(
        P, form, ntx, nty, ntz, static_cast<cudaStream_t>(stream)));
}

// One Newton iteration in one cooperative launch. p: 6*N floats, d6: 6*N,
// r, z, ap, xacc: 3*N each, part: 5*grid + ntx*nty*ntz, pbuf: 72*N (read
// and written in
// exchange mode only); grid, ntx, nty, ntz, stride, box, halo from
// lat_newton_plan(..., pcg = 0, ...). A cover (tiles non-null): tiles holds
// every tile, the n_active active ones first (the plan from
// ops/lattice_kernels.newton_tiling over the cover, grid at most
// n_active); the cell passes walk the active tiles only, and p, ap, d6,
// part and pbuf must be the cover's own scratch, zero wherever no active
// tile writes them. Calls that share the scratch must be ordered on one stream.
int lat_fused_newton(float tol, const float* u, const float* s,
                     const float* cm, const float* ctrl, const float* rc,
                     const float* vm, float* dx, float* f, float* fn, int* k,
                     float* r, float* z, float* p, float* ap, float* xacc,
                     float* d6, float* part, float* pbuf, const int* tiles,
                     int n_active, int grid, int ntx, int nty, int ntz,
                     int stride, int box, int halo, int X, int Y, int Z,
                     const float* g, float det, float mu, float la,
                     int iterations, void* stream) {
    if (grid < 1 || (tiles && (n_active < 1 || n_active > ntx * nty * ntz)))
        return static_cast<int>(cudaErrorInvalidValue);
    NewtonArgs P;
    P.A = make_chain_args(X, Y, Z, g, det, mu, la);
    P.T = Tiling{ntx, nty, ntz, stride, box, halo, tiles, n_active};
    P.u = u;
    P.s = s;
    P.cm = cm;
    P.ctrl = ctrl;
    P.rc = rc;
    P.vm = vm;
    P.dx = dx;
    P.f = f;
    P.fn = fn;
    P.k = k;
    P.r = r;
    P.z = z;
    P.p = p;
    P.ap = ap;
    P.xacc = xacc;
    P.d6 = d6;
    P.part = part;
    P.pbuf = pbuf;
    P.tol = tol;
    P.iterations = iterations;
    return static_cast<int>(
        launch_fused<false>(P, grid, static_cast<cudaStream_t>(stream)));
}

// One-launch PCG solve of (H(u) + diag(ctrl)) dx = f; scratch as
// lat_fused_newton, plan from lat_newton_plan(..., pcg = 1, ...).
int lat_fused_pcg(float tol, const float* u, const float* f, const float* cm,
                  const float* ctrl, const float* vm, float* dx, int* k,
                  float* r, float* z, float* p, float* ap, float* xacc,
                  float* d6, float* part, float* pbuf, int grid, int ntx,
                  int nty, int ntz, int stride, int box, int halo, int X,
                  int Y, int Z, const float* g, float det, float mu, float la,
                  int iterations, void* stream) {
    NewtonArgs P = {};
    P.A = make_chain_args(X, Y, Z, g, det, mu, la);
    P.T = Tiling{ntx, nty, ntz, stride, box, halo};
    P.u = u;
    P.s = f;
    P.cm = cm;
    P.ctrl = ctrl;
    P.vm = vm;
    P.dx = dx;
    P.k = k;
    P.r = r;
    P.z = z;
    P.p = p;
    P.ap = ap;
    P.xacc = xacc;
    P.d6 = d6;
    P.part = part;
    P.pbuf = pbuf;
    P.tol = tol;
    P.iterations = iterations;
    return static_cast<int>(
        launch_fused<true>(P, grid, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
