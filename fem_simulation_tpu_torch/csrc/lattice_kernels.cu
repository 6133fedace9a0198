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
// * lat_force / lat_hvp replace _run (pallas_call at :306), reached through
//   force_cf and hvp_cf; _chain/_chain_into at :61-126.
//   Bound on this card: the per-cell chain is arithmetic (449 and 763 FLOP
//   per cell and quad point); the bytes are 24 floats of corner data in
//   (neighbouring cells share them through L1/L2) and 24 floats of corner
//   contributions out. The Pallas kernel accumulated into a VMEM-resident
//   output by shifted read-modify-writes over the whole grid; blocks here
//   run in no order, so the design is two passes: a cell pass writes each
//   cell's 8 corner contributions to a scratch (coalesced, channel-major)
//   and a vertex pass gathers its up-to-8 incident cells in fixed corner
//   order. No float atomics, so the result is deterministic.
// * lat_diag replaces _run_diag (pallas_call at :251), entry
//   hess_diag_lattice; _diag_into at :129-164. Same two passes with 6
//   symmetric channels (930 FLOP per cell and quad point, 48 floats of
//   scratch per cell).
// * lat_energy replaces _run_energy (pallas_call at :200), entry
//   elastic_energy_lattice; _make_energy_kernel at :166-189. Per-cell psi,
//   per-block partial sums, then one block sums the partials in a fixed
//   order; the scalar stays on the device. Bound: launch latency at these
//   sizes (one float out per cell).
// * lat_fused_newton replaces _run_newton (pallas_call at :638), entry
//   fused_newton; _make_newton_kernel at :557-593, _pcg_in_kernel :480-535,
//   _sym_solve :462-477. One Newton iteration in one cooperative launch
//   (cudaLaunchCooperativeKernel) with grid-stride loops and grid.sync()
//   between phases. Bound: grid-wide barriers and the dependent reductions
//   of PCG (4 barriers per CG iteration) at the small grids of the main
//   path, the HVP chain at the large ones. Design: the Pallas kernel kept
//   r, p, ap and the diagonal in VMEM; here they live in device memory
//   (the 19k grid's whole PCG state is ~1 MB and stays in the 50 MB L2).
//   Every dot is summed as per-block partials; after the barrier EVERY
//   block sums the same partials in the same order, so all blocks hold
//   bit-identical scalars and take the same loop branch (a divergent
//   branch around grid.sync() would deadlock).
// * lat_fused_pcg replaces _run_pcg (pallas_call at :608), entry fused_pcg;
//   _make_pcg_kernel at :538-554 with the same _pcg_in_kernel. It is the
//   fused Newton kernel instantiated without its residual and trial phases
//   (template flag kPcg): the diagonal cell pass, the ctrl shift, and the
//   PCG loop on the given right-hand side, returning dx and k. Same bound
//   and the same deterministic partial sums and identical-branch guarantee.
//
// No --use_fast_math: the build keeps IEEE division and square root.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lattice_chain.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr float kEpsilon = 1e-7f;  // solvers.cg.EPSILON

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

__device__ float partials_max(const float* part, int n, float* sh) {
    float m = 0.f;
    for (int j = threadIdx.x; j < n; j += blockDim.x) m = nan_max(m, part[j]);
    return block_max(m, sh);
}

// Adjugate solve of the 6-channel symmetric 3x3 block at vertex v, masked
// by vm (pallas_lattice._sym_solve, ell.solve3x3 math).
__device__ __forceinline__ void sym_solve(const float* d6, int N, int v,
                                          const float r[3], float vm,
                                          float z[3]) {
    const float a = d6[v], b = d6[N + v], c = d6[2 * N + v],
                dd = d6[3 * N + v], e = d6[4 * N + v], f = d6[5 * N + v];
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

// ---------------------------------------------------------------------------
// Standalone kernels: force, hvp, diag, energy
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
force_cells(const __grid_constant__ ChainArgs A, const float* __restrict__ u,
            const float* __restrict__ cm, float* __restrict__ cf) {
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < A.L.C;
         c += gridDim.x * blockDim.x)
        cell_force(A, u, cm, cf, c);
}

__global__ void __launch_bounds__(kThreads)
hvp_cells(const __grid_constant__ ChainArgs A, const float* __restrict__ u,
          const float* __restrict__ p, const float* __restrict__ cm,
          float* __restrict__ cf) {
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < A.L.C;
         c += gridDim.x * blockDim.x)
        cell_hvp(A, u, p, cm, cf, c);
}

__global__ void __launch_bounds__(kThreads)
diag_cells(const __grid_constant__ ChainArgs A, const float* __restrict__ u,
           const float* __restrict__ cm, float* __restrict__ cd) {
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < A.L.C;
         c += gridDim.x * blockDim.x)
        cell_diag(A, u, cm, cd, c);
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

__global__ void __launch_bounds__(kThreads)
energy_cells(const __grid_constant__ ChainArgs A, const float* __restrict__ u,
             const float* __restrict__ cm, float* __restrict__ part) {
    __shared__ float sh[33];
    float s = 0.f;
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < A.L.C;
         c += gridDim.x * blockDim.x) {
        int cx, cy, cz;
        cell_coords(A.L, c, cx, cy, cz);
        float us[8][3];
        load_corners(u, A.L, cx, cy, cz, us);
        s += (A.det * energy_chain(us, A.G, A.mu, A.la)) * cm[c];
    }
    const float t = block_sum(s, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = t;
}

__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ part, int n, float* __restrict__ out) {
    __shared__ float sh[33];
    const float t = partials_sum(part, n, sh);
    if (threadIdx.x == 0) out[0] = t;
}

// ---------------------------------------------------------------------------
// Fused Newton iteration: one cooperative launch
// ---------------------------------------------------------------------------

struct NewtonArgs {
    ChainArgs A;
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
    float* r;           // (3, N) scratch
    float* p;           // (3, N) scratch
    float* ap;          // (3, N) scratch
    float* d6;          // (6, N) scratch: ctrl-shifted diagonal blocks
    float* cf;          // (24, C) scratch: force / hvp corner contributions
    float* cd;          // (48, C) scratch: diag corner contributions
    float* part;        // (7, gridDim.x) scratch: per-block partials
    float tol;          // PCG tolerance, relative on ||r||^2
    int iterations;     // PCG budget
};

// kPcg = false: one Newton iteration (_make_newton_kernel).
// kPcg = true: the PCG solve alone on the right-hand side s
// (_make_pcg_kernel): no residual phase, no trial phase.
template <bool kPcg>
__global__ void __launch_bounds__(kThreads, 1)
fused_newton_kernel(const __grid_constant__ NewtonArgs P) {
    cg::grid_group grid = cg::this_grid();
    __shared__ float sh[33];
    const Lattice& L = P.A.L;
    const int N = L.N;
    const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
    const int stride = gridDim.x * blockDim.x;
    const int nb = gridDim.x;
    float* part_rrb = P.part;
    float* part_rz0 = P.part + nb;
    float* part_rr0 = P.part + 2 * nb;
    float* part_pap = P.part + 3 * nb;
    float* part_rz = P.part + 4 * nb;
    float* part_rr = P.part + 5 * nb;
    float* part_fn = P.part + 6 * nb;

    // -- force (not kPcg) and diagonal cell passes at u --
    for (int c = t0; c < L.C; c += stride) {
        if (!kPcg) cell_force(P.A, P.u, P.cm, P.cf, c);
        cell_diag(P.A, P.u, P.cm, P.cd, c);
    }
    grid.sync();

    // -- right-hand side b: the residual f = (f_el(u) + s - rc u) vm, or s
    //    itself with kPcg; d6 = diag + ctrl I; ||b||^2 --
    const float* b = kPcg ? P.s : P.f;
    float acc = 0.f;
    for (int v = t0; v < N; v += stride) {
        int x, y, z;
        vertex_coords(L, v, x, y, z);
        const float ct = P.ctrl[v];
        const float vm = kPcg ? 0.f : P.vm[v], rc = kPcg ? 0.f : P.rc[v];
#pragma unroll
        for (int rr = 0; rr < 3; ++rr) {
            float fr;
            if (kPcg) {
                fr = P.s[rr * N + v];
            } else {
                fr = (gather_vertex<3>(L, P.cf, rr, x, y, z) + P.s[rr * N + v]
                      - rc * P.u[rr * N + v]) * vm;
                P.f[rr * N + v] = fr;
            }
            acc += fr * fr;
        }
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) {
            float d = gather_vertex<6>(L, P.cd, ch, x, y, z);
            if (ch == 0 || ch == 3 || ch == 5) d += ct;
            P.d6[ch * N + v] = d;
        }
    }
    {
        const float t = block_sum(acc, sh);
        if (threadIdx.x == 0) part_rrb[blockIdx.x] = t;
    }
    grid.sync();

    // -- normalized RHS (solvers.cg._normalize_rhs), x = 0, z = M^-1 r --
    const float rr_b = partials_sum(part_rrb, nb, sh);
    const bool ok_b = rr_b > 0.f;
    const float inv_scale = sqrtf(ok_b ? rr_b : 1.f);
    const float scale_back = ok_b ? inv_scale : 0.f;
    float a_rz = 0.f, a_rr = 0.f;
    for (int v = t0; v < N; v += stride) {
        const float vm = P.vm[v];
        float r[3], z[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            r[c] = b[c * N + v] / inv_scale;
            P.r[c * N + v] = r[c];
            P.dx[c * N + v] = 0.f;
        }
        sym_solve(P.d6, N, v, r, vm, z);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            P.p[c * N + v] = z[c];
            a_rz += r[c] * z[c];
            a_rr += r[c] * r[c];
        }
    }
    {
        const float t1 = block_sum(a_rz, sh);
        const float t2 = block_sum(a_rr, sh);
        if (threadIdx.x == 0) {
            part_rz0[blockIdx.x] = t1;
            part_rr0[blockIdx.x] = t2;
        }
    }
    grid.sync();
    float rz = partials_sum(part_rz0, nb, sh);
    const float rr0 = partials_sum(part_rr0, nb, sh);
    float rr = rr0;
    int k = 1;
    bool alive = ok_b;

    // -- block-Jacobi PCG on (H(u) + diag(ctrl)) dx = f (pcg_operator) --
    while (alive && k <= P.iterations && rr > P.tol * rr0 && rr0 > kEpsilon
           && isfinite(rr)) {
        for (int c = t0; c < L.C; c += stride)
            cell_hvp(P.A, P.u, P.p, P.cm, P.cf, c);
        grid.sync();

        float a_pap = 0.f;
        for (int v = t0; v < N; v += stride) {
            int x, y, z;
            vertex_coords(L, v, x, y, z);
            const float vm = P.vm[v], ct = P.ctrl[v];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float pv = P.p[c * N + v];
                const float apv =
                    (gather_vertex<3>(L, P.cf, c, x, y, z) + ct * pv) * vm;
                P.ap[c * N + v] = apv;
                a_pap += pv * apv;
            }
        }
        {
            const float t = block_sum(a_pap, sh);
            if (threadIdx.x == 0) part_pap[blockIdx.x] = t;
        }
        grid.sync();

        const float pap = partials_sum(part_pap, nb, sh);
        const bool ok = pap >= 1e-12f;
        const float alpha = ok ? rz / pap : 0.f;
        a_rz = 0.f;
        a_rr = 0.f;
        for (int v = t0; v < N; v += stride) {
            const float vm = P.vm[v];
            float r[3], z[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                P.dx[c * N + v] += alpha * P.p[c * N + v];
                r[c] = P.r[c * N + v] - alpha * P.ap[c * N + v];
                P.r[c * N + v] = r[c];
            }
            sym_solve(P.d6, N, v, r, vm, z);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                P.ap[c * N + v] = z[c];  // ap is free until the next matvec
                a_rz += r[c] * z[c];
                a_rr += r[c] * r[c];
            }
        }
        {
            const float t1 = block_sum(a_rz, sh);
            const float t2 = block_sum(a_rr, sh);
            if (threadIdx.x == 0) {
                part_rz[blockIdx.x] = t1;
                part_rr[blockIdx.x] = t2;
            }
        }
        grid.sync();

        const float rz_new = partials_sum(part_rz, nb, sh);
        const float rr_new = partials_sum(part_rr, nb, sh);
        const float beta = rz_new / rz;  // unguarded, as in pcg_operator
        for (int v = t0; v < N; v += stride) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                P.p[c * N + v] = P.ap[c * N + v] + beta * P.p[c * N + v];
        }
        rz = rz_new;
        rr = rr_new;
        k += 1;
        alive = alive && ok;
        grid.sync();
    }

    if (kPcg) {
        for (int v = t0; v < N; v += stride) {
#pragma unroll
            for (int c = 0; c < 3; ++c) P.dx[c * N + v] *= scale_back;
        }
        if (blockIdx.x == 0 && threadIdx.x == 0) P.k[0] = k;
        return;
    }

    // -- trial full step: ||f(u + dx vm)||_inf (ap holds u + dx vm) --
    for (int v = t0; v < N; v += stride) {
        const float vm = P.vm[v];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float d = P.dx[c * N + v] * scale_back;
            P.dx[c * N + v] = d;
            P.ap[c * N + v] = P.u[c * N + v] + d * vm;
        }
    }
    grid.sync();
    for (int c = t0; c < L.C; c += stride) cell_force(P.A, P.ap, P.cm, P.cf, c);
    grid.sync();
    float m = 0.f;
    for (int v = t0; v < N; v += stride) {
        int x, y, z;
        vertex_coords(L, v, x, y, z);
        const float vm = P.vm[v], rc = P.rc[v];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float fr = (gather_vertex<3>(L, P.cf, c, x, y, z)
                              + P.s[c * N + v] - rc * P.ap[c * N + v]) * vm;
            m = nan_max(m, fabsf(fr));
        }
    }
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

}  // namespace

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

extern "C" {

const char* lat_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// cf: scratch of 24*C floats
int lat_force(const float* u, const float* cm, float* out, float* cf, int X,
              int Y, int Z, const float* g, float det, float mu, float la,
              void* stream) {
    const ChainArgs A = make_chain_args(X, Y, Z, g, det, mu, la);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    force_cells<<<blocks_for(A.L.C), kThreads, 0, st>>>(A, u, cm, cf);
    gather_vertices<3><<<blocks_for(A.L.N), kThreads, 0, st>>>(A.L, cf, out);
    return static_cast<int>(cudaGetLastError());
}

int lat_hvp(const float* u, const float* p, const float* cm, float* out,
            float* cf, int X, int Y, int Z, const float* g, float det,
            float mu, float la, void* stream) {
    const ChainArgs A = make_chain_args(X, Y, Z, g, det, mu, la);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    hvp_cells<<<blocks_for(A.L.C), kThreads, 0, st>>>(A, u, p, cm, cf);
    gather_vertices<3><<<blocks_for(A.L.N), kThreads, 0, st>>>(A.L, cf, out);
    return static_cast<int>(cudaGetLastError());
}

// cd: scratch of 48*C floats; out: (6, N)
int lat_diag(const float* u, const float* cm, float* out, float* cd, int X,
             int Y, int Z, const float* g, float det, float mu, float la,
             void* stream) {
    const ChainArgs A = make_chain_args(X, Y, Z, g, det, mu, la);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    diag_cells<<<blocks_for(A.L.C), kThreads, 0, st>>>(A, u, cm, cd);
    gather_vertices<6><<<blocks_for(A.L.N), kThreads, 0, st>>>(A.L, cd, out);
    return static_cast<int>(cudaGetLastError());
}

// Number of per-block partials lat_energy needs for this grid.
int lat_energy_partials(int X, int Y, int Z) {
    const int n = blocks_for((X - 1) * (Y - 1) * (Z - 1));
    return n < 1024 ? n : 1024;
}

// out: 1 float; part: lat_energy_partials(X, Y, Z) floats
int lat_energy(const float* u, const float* cm, float* out, float* part,
               int X, int Y, int Z, const float* g, float det, float mu,
               float la, void* stream) {
    const ChainArgs A = make_chain_args(X, Y, Z, g, det, mu, la);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nb = lat_energy_partials(X, Y, Z);
    energy_cells<<<nb, kThreads, 0, st>>>(A, u, cm, part);
    sum_partials<<<1, kThreads, 0, st>>>(part, nb, out);
    return static_cast<int>(cudaGetLastError());
}

// Cooperative grid of the fused Newton kernel (pcg = 0) or the fused PCG
// kernel (pcg = 1) for this lattice: at most what can be co-resident (SMs x
// occupancy), at most one thread per cell or vertex. Returns a CUDA error
// code; *grid is set on success.
int lat_newton_grid(int X, int Y, int Z, int pcg, int* grid) {
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = pcg ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, fused_newton_kernel<true>, kThreads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, fused_newton_kernel<false>, kThreads, 0);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorLaunchOutOfResources;
    if (e != cudaSuccess) return static_cast<int>(e);
    const int N = X * Y * Z, C = (X - 1) * (Y - 1) * (Z - 1);
    const int want = blocks_for(N > C ? N : C);
    const int cap = sms * per_sm;
    *grid = want < cap ? want : cap;
    return 0;
}

// part: 7*grid floats; grid from lat_newton_grid.
int lat_fused_newton(float tol, const float* u, const float* s,
                     const float* cm, const float* ctrl, const float* rc,
                     const float* vm, float* dx, float* f, float* fn, int* k,
                     float* r, float* p, float* ap, float* d6, float* cf,
                     float* cd, float* part, int grid, int X, int Y, int Z,
                     const float* g, float det, float mu, float la,
                     int iterations, void* stream) {
    NewtonArgs P;
    P.A = make_chain_args(X, Y, Z, g, det, mu, la);
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
    P.p = p;
    P.ap = ap;
    P.d6 = d6;
    P.cf = cf;
    P.cd = cd;
    P.part = part;
    P.tol = tol;
    P.iterations = iterations;
    void* args[] = {&P};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(fused_newton_kernel<false>), dim3(grid),
        dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : last);
}

// One-launch PCG solve of (H(u) + diag(ctrl)) dx = f. part: 7*grid floats;
// grid from lat_newton_grid(..., pcg = 1, ...).
int lat_fused_pcg(float tol, const float* u, const float* f, const float* cm,
                  const float* ctrl, const float* vm, float* dx, int* k,
                  float* r, float* p, float* ap, float* d6, float* cf,
                  float* cd, float* part, int grid, int X, int Y, int Z,
                  const float* g, float det, float mu, float la,
                  int iterations, void* stream) {
    NewtonArgs P = {};
    P.A = make_chain_args(X, Y, Z, g, det, mu, la);
    P.u = u;
    P.s = f;
    P.cm = cm;
    P.ctrl = ctrl;
    P.vm = vm;
    P.dx = dx;
    P.k = k;
    P.r = r;
    P.p = p;
    P.ap = ap;
    P.d6 = d6;
    P.cf = cf;
    P.cd = cd;
    P.part = part;
    P.tol = tol;
    P.iterations = iterations;
    void* args[] = {&P};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(fused_newton_kernel<true>), dim3(grid),
        dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // extern "C"
