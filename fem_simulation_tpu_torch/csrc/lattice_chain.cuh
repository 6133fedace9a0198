// Per-cell StVK chains of the structured-lattice kernels (lattice_kernels.cu).
//
// Layout: channel-first vertex fields (C, X, Y, Z) in float32, Z minor (the
// energy kernel reads the channel-last (X, Y, Z, 3) field); the cell mask
// is (X-1, Y-1, Z-1). Vertex index v = (x*Y + y)*Z + z, cell index
// c = (cx*(Y-1) + cy)*(Z-1) + cz. Local corner i = 4*di + 2*dj + dk.
//
// All chains take DISPLACEMENTS u = x - x0: F = I + sum_i u_i g_iq^T with the
// identity added analytically (the position form cancels |x|*(2/dx)-sized
// terms and sets a coordinate-dependent f32 noise floor).
//
// The force and HVP chains unroll their loops over corners, quadrature
// points and 3x3 components fully, so every index into the g table is a
// compile-time constant and the per-cell state (8 corners x 3, F, M, dF, dM,
// the 24 corner accumulators) lives in registers. The diagonal chain
// (diag_chain, at the end) runs its points in sequence or in pairs and
// keeps its 48 corner sums in registers.
#pragma once

#include <cuda_runtime.h>

// g[i][q][d] = dN_i/dxi_d at Gauss point q, times 2/dx (uniform lattice:
// J = (dx/2) I, so the table is the same for every cell).
struct GTab {
    float g[8][8][3];
};

struct Lattice {
    int X, Y, Z;  // vertex grid
    int N;        // X*Y*Z vertices
    int C;        // (X-1)*(Y-1)*(Z-1) cells
};

// Everything a cell chain needs besides the fields.
struct ChainArgs {
    GTab G;
    Lattice L;
    float det;  // (dx/2)^3
    float mu;
    float la;
};

__device__ __forceinline__ void cell_coords(const Lattice& L, int c, int& cx,
                                            int& cy, int& cz) {
    const int Cz = L.Z - 1, Cy = L.Y - 1;
    cz = c % Cz;
    const int t = c / Cz;
    cy = t % Cy;
    cx = t / Cy;
}

__device__ __forceinline__ int corner_vertex(const Lattice& L, int cx, int cy,
                                             int cz, int i) {
    const int di = (i >> 2) & 1, dj = (i >> 1) & 1, dk = i & 1;
    return ((cx + di) * L.Y + (cy + dj)) * L.Z + (cz + dk);
}

// The 8 corners x 3 channels of a channel-first field around one cell.
__device__ __forceinline__ void load_corners(const float* f, const Lattice& L,
                                             int cx, int cy, int cz,
                                             float us[8][3]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int v = corner_vertex(L, cx, cy, cz, i);
#pragma unroll
        for (int r = 0; r < 3; ++r) us[i][r] = f[r * L.N + v];
    }
}

// sum_i us[i][r] g[i][q][c] for all r, c (no identity).
__device__ __forceinline__ void grad_at(const float us[8][3], const GTab& G,
                                        int q, float F[3][3]) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            float s = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) s += us[i][r] * G.g[i][q][c];
            F[r][c] = s;
        }
    }
}

// F = I + grad u at quad point q.
__device__ __forceinline__ void deformation(const float us[8][3],
                                            const GTab& G, int q,
                                            float F[3][3]) {
    grad_at(us, G, q, F);
    F[0][0] += 1.f;
    F[1][1] += 1.f;
    F[2][2] += 1.f;
}

// Green strain E = (F^T F - I)/2; returns tr E.
__device__ __forceinline__ float green_strain(const float F[3][3],
                                              float E[3][3]) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = a; b < 3; ++b) {
            const float s = F[0][a] * F[0][b] + F[1][a] * F[1][b]
                          + F[2][a] * F[2][b];
            E[a][b] = 0.5f * (s - (a == b ? 1.f : 0.f));
            E[b][a] = E[a][b];
        }
    }
    return E[0][0] + E[1][1] + E[2][2];
}

// M = 2 mu E + la tr(E) I
__device__ __forceinline__ void stvk_stress(const float E[3][3], float trE,
                                            float mu, float la,
                                            float M[3][3]) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b)
            M[a][b] = 2.f * mu * E[a][b] + (a == b ? la * trE : 0.f);
    }
}

// acc[i][r] += sum_c P[r][c] g[i][q][c]
__device__ __forceinline__ void emit_corners(const float P[3][3],
                                             const GTab& G, int q,
                                             float acc[8][3]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int r = 0; r < 3; ++r)
            acc[i][r] += P[r][0] * G.g[i][q][0] + P[r][1] * G.g[i][q][1]
                       + P[r][2] * G.g[i][q][2];
    }
}

// Force chain: acc[i][r] = sum_q (P(F_q) g_iq)[r], P = F M. The caller
// scales by -det * cell mask.
__device__ __forceinline__ void force_chain(const float us[8][3],
                                            const GTab& G, float mu, float la,
                                            float acc[8][3]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int r = 0; r < 3; ++r) acc[i][r] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        float F[3][3], E[3][3], M[3][3], P[3][3];
        deformation(us, G, q, F);
        const float trE = green_strain(F, E);
        stvk_stress(E, trE, mu, la, M);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                P[r][c] = F[r][0] * M[0][c] + F[r][1] * M[1][c]
                        + F[r][2] * M[2][c];
        }
        emit_corners(P, G, q, acc);
    }
}

// Analytic HVP chain along ps: dF = grad p, dE = (dF^T F + F^T dF)/2,
// dM = 2 mu dE + la tr(dE) I, dP = dF M + F dM; acc[i][r] = sum_q (dP g_iq)[r].
// The caller scales by +det * cell mask (positive-definite convention).
__device__ __forceinline__ void hvp_chain(const float us[8][3],
                                          const float ps[8][3],
                                          const GTab& G, float mu, float la,
                                          float acc[8][3]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int r = 0; r < 3; ++r) acc[i][r] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        float F[3][3], E[3][3], M[3][3], dF[3][3], dE[3][3], dM[3][3],
            dP[3][3];
        deformation(us, G, q, F);
        const float trE = green_strain(F, E);
        stvk_stress(E, trE, mu, la, M);
        grad_at(ps, G, q, dF);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
            for (int b = a; b < 3; ++b) {
                float s = 0.f;
#pragma unroll
                for (int r = 0; r < 3; ++r)
                    s += dF[r][a] * F[r][b] + F[r][a] * dF[r][b];
                dE[a][b] = 0.5f * s;
                dE[b][a] = dE[a][b];
            }
        }
        const float trdE = dE[0][0] + dE[1][1] + dE[2][2];
        stvk_stress(dE, trdE, mu, la, dM);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                float s = 0.f;
#pragma unroll
                for (int b = 0; b < 3; ++b)
                    s += dF[r][b] * M[b][c] + F[r][b] * dM[b][c];
                dP[r][c] = s;
            }
        }
        emit_corners(dP, G, q, acc);
    }
}

// Symmetric channel order of the 3x3 vertex-diagonal blocks.
__device__ __forceinline__ int diag_r(int ch) {
    return ch < 3 ? 0 : (ch < 5 ? 1 : 2);
}
__device__ __forceinline__ int diag_s(int ch) {
    // (0,0) (0,1) (0,2) (1,1) (1,2) (2,2)
    return ch < 3 ? ch : (ch < 5 ? ch - 2 : 2);
}

// Cell passes: write one cell's corner contributions, summed over q, to the
// scratch cf[(i*NCH + ch)*C + c] (coalesced across neighbouring cells).
__device__ __forceinline__ void cell_force(const ChainArgs& A, const float* u,
                                           const float* cm, float* cf, int c) {
    int cx, cy, cz;
    cell_coords(A.L, c, cx, cy, cz);
    float us[8][3], acc[8][3];
    load_corners(u, A.L, cx, cy, cz, us);
    force_chain(us, A.G, A.mu, A.la, acc);
    const float w = -A.det * cm[c];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int r = 0; r < 3; ++r) cf[(i * 3 + r) * A.L.C + c] = acc[i][r] * w;
    }
}

__device__ __forceinline__ void cell_hvp(const ChainArgs& A, const float* u,
                                         const float* p, const float* cm,
                                         float* cf, int c) {
    int cx, cy, cz;
    cell_coords(A.L, c, cx, cy, cz);
    float us[8][3], ps[8][3], acc[8][3];
    load_corners(u, A.L, cx, cy, cz, us);
    load_corners(p, A.L, cx, cy, cz, ps);
    hvp_chain(us, ps, A.G, A.mu, A.la, acc);
    const float w = A.det * cm[c];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int r = 0; r < 3; ++r) cf[(i * 3 + r) * A.L.C + c] = acc[i][r] * w;
    }
}

// Vertex pass: the sum of channel ch over the up-to-8 cells incident to
// vertex (x, y, z), in fixed corner order (deterministic, no atomics).
template <int NCH>
__device__ __forceinline__ float gather_vertex(const Lattice& L,
                                               const float* cf, int ch, int x,
                                               int y, int z) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int cx = x - ((i >> 2) & 1), cy = y - ((i >> 1) & 1),
                  cz = z - (i & 1);
        if (cx >= 0 && cx < L.X - 1 && cy >= 0 && cy < L.Y - 1 && cz >= 0
            && cz < L.Z - 1)
            s += cf[(i * NCH + ch) * L.C + (cx * (L.Y - 1) + cy) * (L.Z - 1)
                    + cz];
    }
    return s;
}

__device__ __forceinline__ void vertex_coords(const Lattice& L, int v, int& x,
                                              int& y, int& z) {
    z = v % L.Z;
    const int t = v / L.Z;
    y = t % L.Y;
    x = t / L.Y;
}

// ---------------------------------------------------------------------------
// One quadrature point per lane (the fused Newton / PCG kernel, the
// standalone force and energy kernels)
// ---------------------------------------------------------------------------
//
// Eight neighbouring lanes share a cell, lane q of the eight takes
// quadrature point q. A lane keeps its column of the g table in registers
// (gq[i][d] = g[i][q][d], 24 floats: q is not a compile-time constant
// here), streams the 8 corners' values through F (and dF), and forms the
// contributions of its point to the 8 corners. A three-step exchange
// between the eight lanes (xor 4, 2, 1) sums the points in a fixed order and
// leaves lane i with corner i's total: every lane ends with NCH values
// instead of 8 * NCH accumulators.

struct QuadLane {
    float gq[8][3];
};

__device__ __forceinline__ QuadLane quad_lane(const GTab& G, int q) {
    QuadLane L;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int d = 0; d < 3; ++d) L.gq[i][d] = G.g[i][q][d];
    }
    return L;
}

// F += us_i gq_i^T for corner i (us: the corner's 3 components)
__device__ __forceinline__ void grad_add(const float us[3], const float gq[3],
                                         float F[3][3]) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) F[r][c] += us[r] * gq[c];
    }
}

__device__ __forceinline__ void zero3x3(float A[3][3]) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) A[r][c] = 0.f;
    }
}

// (F, M) of the displacement gradient Du accumulated by grad_add: F = I + Du,
// M = 2 mu E + la tr(E) I.
__device__ __forceinline__ void deformation_stress(float F[3][3], float mu,
                                                   float la, float M[3][3]) {
    float E[3][3];
    F[0][0] += 1.f;
    F[1][1] += 1.f;
    F[2][2] += 1.f;
    const float trE = green_strain(F, E);
    stvk_stress(E, trE, mu, la, M);
}

// StVK energy density mu |E|^2 + la/2 tr(E)^2 at one point, from the
// displacement gradient Du accumulated by grad_add (F = I + Du).
__device__ __forceinline__ float point_energy(float F[3][3], float mu,
                                             float la) {
    float E[3][3];
    F[0][0] += 1.f;
    F[1][1] += 1.f;
    F[2][2] += 1.f;
    const float trE = green_strain(F, E);
    float ee = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) ee += E[a][b] * E[a][b];
    }
    return mu * ee + 0.5f * la * trE * trE;
}

// P = F M (first Piola-Kirchhoff stress)
__device__ __forceinline__ void force_stress(const float F[3][3],
                                             const float M[3][3],
                                             float P[3][3]) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
            P[r][c] = F[r][0] * M[0][c] + F[r][1] * M[1][c] + F[r][2] * M[2][c];
    }
}

// dP = dF M + F dM along dF (hvp_chain's arithmetic for one point)
__device__ __forceinline__ void hvp_stress(const float F[3][3],
                                           const float M[3][3],
                                           const float dF[3][3], float mu,
                                           float la, float dP[3][3]) {
    float dE[3][3], dM[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = a; b < 3; ++b) {
            float s = 0.f;
#pragma unroll
            for (int r = 0; r < 3; ++r)
                s += dF[r][a] * F[r][b] + F[r][a] * dF[r][b];
            dE[a][b] = 0.5f * s;
            dE[b][a] = dE[a][b];
        }
    }
    const float trdE = dE[0][0] + dE[1][1] + dE[2][2];
    stvk_stress(dE, trdE, mu, la, dM);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            float s = 0.f;
#pragma unroll
            for (int b = 0; b < 3; ++b)
                s += dF[r][b] * M[b][c] + F[r][b] * dM[b][c];
            dP[r][c] = s;
        }
    }
}

// out[r] = (P gq_i)[r]: one point's contribution to corner i
__device__ __forceinline__ void emit_corner(const float P[3][3],
                                            const float gq[3], float out[3]) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
        out[r] = P[r][0] * gq[0] + P[r][1] * gq[1] + P[r][2] * gq[2];
}

// One point's contribution to corner i's 6 diagonal channels: with a = g_iq
// and v = F a, delta_rs a^T M a + (mu+la) v_r v_s + mu |a|^2 (F F^T)_rs;
// Gm = F F^T in the symmetric channel order.
__device__ __forceinline__ void diag_corner(const float F[3][3],
                                            const float M[3][3],
                                            const float Gm[6],
                                            const float gq[3], float mu,
                                            float la, float out[6]) {
    const float a0 = gq[0], a1 = gq[1], a2 = gq[2];
    const float gg = a0 * a0 + a1 * a1 + a2 * a2;
    float v[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) v[r] = F[r][0] * a0 + F[r][1] * a1 + F[r][2] * a2;
    const float aMa = a0 * (M[0][0] * a0 + M[0][1] * a1 + M[0][2] * a2)
                    + a1 * (M[1][0] * a0 + M[1][1] * a1 + M[1][2] * a2)
                    + a2 * (M[2][0] * a0 + M[2][1] * a1 + M[2][2] * a2);
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) {
        const int r = diag_r(ch), s = diag_s(ch);
        float contrib = (mu + la) * v[r] * v[s] + (mu * gg) * Gm[ch];
        if (r == s) contrib += aMa;
        out[ch] = contrib;
    }
}

// Sum over the 8 lanes (points) of a cell, scattered: contrib(i, out) gives
// this lane's NCH contributions to corner i; on return lane i of the eight
// holds corner i's sums over the 8 points. Every lane of the warp must call
// it. The order of the sums is fixed.
template <int NCH, class Contrib>
__device__ __forceinline__ void sum_points_to_corners(Contrib contrib, int lane,
                                                      float out[NCH]) {
    const unsigned full = 0xffffffffu;
    const bool hi = lane & 4, mid = lane & 2, lo = lane & 1;
    float a4[4][NCH];  // corner 4*hi + i
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float c0[NCH], c1[NCH];
        contrib(i, c0);
        contrib(i + 4, c1);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
            const float keep = hi ? c1[ch] : c0[ch];
            const float send = hi ? c0[ch] : c1[ch];
            a4[i][ch] = keep + __shfl_xor_sync(full, send, 4);
        }
    }
    float a2[2][NCH];  // corner 4*hi + 2*mid + i
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
            const float keep = mid ? a4[i + 2][ch] : a4[i][ch];
            const float send = mid ? a4[i][ch] : a4[i + 2][ch];
            a2[i][ch] = keep + __shfl_xor_sync(full, send, 2);
        }
    }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
        const float keep = lo ? a2[1][ch] : a2[0][ch];
        const float send = lo ? a2[0][ch] : a2[1][ch];
        out[ch] = keep + __shfl_xor_sync(full, send, 1);
    }
}

// Vertex-diagonal Hessian chain of one cell, 6 symmetric channels per
// corner: acc[i][ch] = sum over the points of diag_corner's contribution,
// the points one at a time, corner i's displacement read as corner(i) at
// every point, so that registers hold the 48 sums and not the 24 corner
// values as well. The caller scales by det * cell mask. The points' order:
// * kPairs false: in sequence (lat_diag's order, that of its first
//   two-pass form);
// * kPairs true: ((c0 + c4) + (c2 + c6)) + ((c1 + c5) + (c3 + c7)), c_q
//   point q's contribution: the order in which the eight-lane kernels'
//   exchange (sum_points_to_corners) sums the points, so lat_diag_shift
//   keeps the bits of its first, eight-lane form. Partial sums wait in two
//   slots of 48 floats: stash(slot, acc) writes them, add_stash(slot, acc)
//   sets acc = slot + acc.
template <bool kPairs, class Corner, class Stash, class AddStash>
__device__ __forceinline__ void diag_chain(const GTab& G, float mu, float la,
                                           Corner corner, Stash stash,
                                           AddStash add_stash,
                                           float acc[8][6]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) acc[i][ch] = 0.f;
    }
#pragma unroll 1
    for (int s = 0; s < 8; ++s) {
        // kPairs: points 0 4 2 6 1 5 3 7, a pair's first one assigned
        const int q = kPairs ? ((s >> 1) & 1) * 2 + (s >> 2) + (s & 1) * 4
                             : s;
        const bool add = !kPairs || (s & 1);
        const QuadLane g = quad_lane(G, q);
        float F[3][3], M[3][3], Gm[6];
        zero3x3(F);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float3 a = corner(i);
            const float us[3] = {a.x, a.y, a.z};
            grad_add(us, g.gq[i], F);
        }
        deformation_stress(F, mu, la, M);
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) {
            const int r = diag_r(ch), c = diag_s(ch);
            Gm[ch] = F[r][0] * F[c][0] + F[r][1] * F[c][1] + F[r][2] * F[c][2];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float o[6];
            diag_corner(F, M, Gm, g.gq[i], mu, la, o);
#pragma unroll
            for (int ch = 0; ch < 6; ++ch)
                acc[i][ch] = add ? acc[i][ch] + o[ch] : o[ch];
        }
        if constexpr (kPairs) {
            if (s == 1) {           // c0 + c4
                stash(0, acc);
            } else if (s == 3) {    // (c0 + c4) + (c2 + c6)
                add_stash(0, acc);
                stash(0, acc);
            } else if (s == 5) {    // c1 + c5
                stash(1, acc);
            }
        }
    }
    if constexpr (kPairs) {
        add_stash(1, acc);          // (c1 + c5) + (c3 + c7)
        add_stash(0, acc);
    }
}
