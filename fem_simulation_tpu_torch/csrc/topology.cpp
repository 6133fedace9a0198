// Host-side topology builder of fem_simulation_tpu_torch: the hex-pair
// stencil's deduplication, the hex -> block-ELL slot map, the Galerkin
// triple-product plan's expansion and the voxelizer's ray-parity inside
// test. Each entry's output is bit-equal to the numpy path it replaces
// (hierarchy.py, mesh.py), which stays as its plain version. A plain C ABI
// for ctypes; built and loaded by native.py (g++ -O2 -shared -fPIC
// -ffp-contract=off, so no product is fused into an FMA on any host).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Count + fill the Galerkin plan A_c[I,J] += wI*wJ*A[i,j].
//
// Inputs:
//   fi, fj:  (E,) fine row/col of each real fine ELL entry
//   src_flat:(E,) flat fine ELL slot of the entry
//   p_idx:   (Nf*8,) coarse contributor ids per fine vertex (row-major)
//   p_w:     (Nf*8,) trilinear weights (0 = padding)
//   cnbr:    (Nc*Kc,) coarse neighbor table (row-major, real prefix ascending)
//   cdeg:    (Nc,) real row widths of the coarse table
// Outputs (caller allocates capacity cap; returns number written, or -1 if
// a destination slot is missing, or -(needed) - 2 if cap is too small):
//   g_src, g_dst (int32), g_w (float)
int64_t galerkin_plan(const int32_t* fi, const int32_t* fj,
                      const int32_t* src_flat, int64_t E,
                      const int32_t* p_idx, const float* p_w,
                      const int32_t* cnbr, const int32_t* cdeg,
                      int64_t Kc,
                      int32_t* g_src, int32_t* g_dst, float* g_w,
                      int64_t cap) {
  int64_t n = 0;
  for (int64_t e = 0; e < E; ++e) {
    const int32_t i = fi[e];
    const int32_t j = fj[e];
    const int32_t* Ii = p_idx + (int64_t)i * 8;
    const float* wi = p_w + (int64_t)i * 8;
    const int32_t* Jj = p_idx + (int64_t)j * 8;
    const float* wj = p_w + (int64_t)j * 8;
    for (int a = 0; a < 8; ++a) {
      const float wa = wi[a];
      if (wa == 0.0f) continue;
      const int32_t I = Ii[a];
      const int32_t* row = cnbr + (int64_t)I * Kc;
      const int32_t deg = cdeg[I];
      for (int b = 0; b < 8; ++b) {
        const float w = wa * wj[b];
        if (w == 0.0f) continue;
        const int32_t J = Jj[b];
        // binary search in the ascending real prefix of the coarse row
        const int32_t* lo = std::lower_bound(row, row + deg, J);
        if (lo == row + deg || *lo != J) return -1;
        if (n >= cap) return -(E * 64) - 2;
        g_src[n] = src_flat[e];
        g_dst[n] = (int32_t)((int64_t)I * Kc + (lo - row));
        g_w[n] = w;
        ++n;
      }
    }
  }
  return n;
}

// Deduplicate hex-pair couplings into sorted (r, c) pairs.
//
// Inputs: hexes (H*8,) int32 corner ids; n number of vertices.
// Output: pairs_out (cap, 2) int32 sorted lexicographically; returns count
// (or -needed-2 if cap too small — call again with a larger buffer).
int64_t hex_pairs_unique(const int32_t* hexes, int64_t H, int64_t cap,
                         int32_t* pairs_out) {
  std::vector<int64_t> keys;
  keys.reserve((size_t)H * 64);
  for (int64_t h = 0; h < H; ++h) {
    const int32_t* c = hexes + h * 8;
    for (int a = 0; a < 8; ++a)
      for (int b = 0; b < 8; ++b)
        keys.push_back(((int64_t)c[a] << 32) | (uint32_t)c[b]);
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  if ((int64_t)keys.size() > cap) return -(int64_t)keys.size() - 2;
  for (size_t k = 0; k < keys.size(); ++k) {
    pairs_out[2 * k] = (int32_t)(keys[k] >> 32);
    pairs_out[2 * k + 1] = (int32_t)(keys[k] & 0xffffffff);
  }
  return (int64_t)keys.size();
}

// Ray-parity inside test: the voxelizer core (the numpy path is
// mesh.py:_points_inside). Identical semantics to the numpy path — same slightly-off-axis ray, same epsilons — so both produce
// the same cell set; tests assert bit-equality. A yz uniform grid (64x64
// bins, vs numpy's 16x16) prefilters triangles per point.
//
// Inputs: points (P,3) float64 row-major, verts (V,3) float64,
//         tris (T,3) int32. Output: out (P,) uint8 (1 = inside).
// Returns P on success, -1 on degenerate input.
int64_t points_inside_parity(const double* points, int64_t P,
                             const double* verts,
                             const int32_t* tris, int64_t T,
                             uint8_t* out) {
  if (P <= 0) return 0;
  if (T <= 0) { std::memset(out, 0, (size_t)P); return P; }
  // Ray direction (matches mesh.py): slightly off +x to avoid grazing the
  // shared edges/diagonals of axis-aligned quad faces.
  double d[3] = {1.0, 5.7721566e-4, 3.1415927e-4};
  const double dn = std::sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  d[0] /= dn; d[1] /= dn; d[2] /= dn;

  struct Tri { double v0[3], e1[3], e2[3], pvec[3], inv_det; };
  std::vector<Tri> ts;
  ts.reserve((size_t)T);
  std::vector<double> lo_y(T), lo_z(T), hi_y(T), hi_z(T);
  std::vector<int32_t> keep;
  keep.reserve((size_t)T);
  double tri_lo[2] = {1e300, 1e300}, tri_hi[2] = {-1e300, -1e300};
  for (int64_t t = 0; t < T; ++t) {
    const double* a = verts + (int64_t)tris[3 * t] * 3;
    const double* b = verts + (int64_t)tris[3 * t + 1] * 3;
    const double* c = verts + (int64_t)tris[3 * t + 2] * 3;
    Tri tr;
    for (int k = 0; k < 3; ++k) {
      tr.v0[k] = a[k];
      tr.e1[k] = b[k] - a[k];
      tr.e2[k] = c[k] - a[k];
    }
    tr.pvec[0] = d[1] * tr.e2[2] - d[2] * tr.e2[1];
    tr.pvec[1] = d[2] * tr.e2[0] - d[0] * tr.e2[2];
    tr.pvec[2] = d[0] * tr.e2[1] - d[1] * tr.e2[0];
    const double det = tr.e1[0] * tr.pvec[0] + tr.e1[1] * tr.pvec[1]
                     + tr.e1[2] * tr.pvec[2];
    lo_y[keep.size()] = std::min(a[1], std::min(b[1], c[1]));
    hi_y[keep.size()] = std::max(a[1], std::max(b[1], c[1]));
    lo_z[keep.size()] = std::min(a[2], std::min(b[2], c[2]));
    hi_z[keep.size()] = std::max(a[2], std::max(b[2], c[2]));
    tri_lo[0] = std::min(tri_lo[0], lo_y[keep.size()]);
    tri_lo[1] = std::min(tri_lo[1], lo_z[keep.size()]);
    tri_hi[0] = std::max(tri_hi[0], hi_y[keep.size()]);
    tri_hi[1] = std::max(tri_hi[1], hi_z[keep.size()]);
    if (std::fabs(det) <= 1e-12) continue;  // numpy path: ok mask
    tr.inv_det = 1.0 / det;
    keep.push_back((int32_t)ts.size());
    ts.push_back(tr);
    // bbox arrays are indexed by ts position; the entry just written above
    // used keep.size() BEFORE push_back, i.e. exactly ts.size()-1. (A
    // skipped degenerate tri overwrites its slot on the next iteration.)
  }
  const int64_t TK = (int64_t)ts.size();
  // margin: same formula as numpy (1e-3 of the global tri yz span)
  const double margin_y = 1e-3 * (tri_hi[0] - tri_lo[0] + 1e-12);
  const double margin_z = 1e-3 * (tri_hi[1] - tri_lo[1] + 1e-12);

  // point-cloud yz extent defines the bin grid (numpy binning, finer)
  const int NB = 64;
  double plo[2] = {1e300, 1e300}, phi[2] = {-1e300, -1e300};
  for (int64_t p = 0; p < P; ++p) {
    plo[0] = std::min(plo[0], points[3 * p + 1]);
    plo[1] = std::min(plo[1], points[3 * p + 2]);
    phi[0] = std::max(phi[0], points[3 * p + 1]);
    phi[1] = std::max(phi[1], points[3 * p + 2]);
  }
  const double lo0 = plo[0] - margin_y, lo1 = plo[1] - margin_z;
  const double span0 = std::max(phi[0] + margin_y - lo0, 1e-12);
  const double span1 = std::max(phi[1] + margin_z - lo1, 1e-12);

  // assign each kept triangle to every bin its (margin-expanded) yz bbox
  // overlaps; a point only looks up its own bin, so no double counting
  std::vector<std::vector<int32_t>> bins((size_t)NB * NB);
  for (int64_t t = 0; t < TK; ++t) {
    int by0 = (int)std::floor((lo_y[t] - margin_y - lo0) / span0 * NB);
    int by1 = (int)std::floor((hi_y[t] + margin_y - lo0) / span0 * NB);
    int bz0 = (int)std::floor((lo_z[t] - margin_z - lo1) / span1 * NB);
    int bz1 = (int)std::floor((hi_z[t] + margin_z - lo1) / span1 * NB);
    by0 = std::max(by0, 0); bz0 = std::max(bz0, 0);
    by1 = std::min(by1, NB - 1); bz1 = std::min(bz1, NB - 1);
    for (int by = by0; by <= by1; ++by)
      for (int bz = bz0; bz <= bz1; ++bz)
        bins[(size_t)by * NB + bz].push_back((int32_t)t);
  }

  for (int64_t p = 0; p < P; ++p) {
    const double px = points[3 * p], py = points[3 * p + 1],
                 pz = points[3 * p + 2];
    int by = (int)((py - lo0) / span0 * NB);
    int bz = (int)((pz - lo1) / span1 * NB);
    by = std::min(std::max(by, 0), NB - 1);
    bz = std::min(std::max(bz, 0), NB - 1);
    int64_t hits = 0;
    for (const int32_t ti : bins[(size_t)by * NB + bz]) {
      const Tri& tr = ts[(size_t)ti];
      const double tv0 = px - tr.v0[0], tv1 = py - tr.v0[1],
                   tv2 = pz - tr.v0[2];
      const double u = (tv0 * tr.pvec[0] + tv1 * tr.pvec[1]
                        + tv2 * tr.pvec[2]) * tr.inv_det;
      if (u < 0.0) continue;
      // qvec = tvec x e1
      const double q0 = tv1 * tr.e1[2] - tv2 * tr.e1[1];
      const double q1 = tv2 * tr.e1[0] - tv0 * tr.e1[2];
      const double q2 = tv0 * tr.e1[1] - tv1 * tr.e1[0];
      const double v = (q0 * d[0] + q1 * d[1] + q2 * d[2]) * tr.inv_det;
      if (v < 0.0 || u + v > 1.0) continue;
      const double tt = (q0 * tr.e2[0] + q1 * tr.e2[1] + q2 * tr.e2[2])
                        * tr.inv_det;
      if (tt > 1e-10) ++hits;
    }
    out[p] = (uint8_t)(hits & 1);
  }
  return P;
}

// Map each (hex, a, b) coupling to its flat ELL slot row*K + slot.
// nbr rows' real prefixes are ascending; deg gives prefix widths.
int64_t hex_slot_map(const int32_t* hexes, int64_t H,
                     const int32_t* nbr, const int32_t* deg, int64_t K,
                     int32_t* out) {
  for (int64_t h = 0; h < H; ++h) {
    const int32_t* c = hexes + h * 8;
    for (int a = 0; a < 8; ++a) {
      const int32_t r = c[a];
      const int32_t* row = nbr + (int64_t)r * K;
      const int32_t d = deg[r];
      for (int b = 0; b < 8; ++b) {
        const int32_t* lo = std::lower_bound(row, row + d, c[b]);
        if (lo == row + d || *lo != c[b]) return -1;
        out[h * 64 + a * 8 + b] = (int32_t)((int64_t)r * K + (lo - row));
      }
    }
  }
  return H * 64;
}

}  // extern "C"
