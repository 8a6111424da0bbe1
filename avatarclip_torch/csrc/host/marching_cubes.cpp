// Host-side iso-surface extraction via marching tetrahedra (Kuhn 6-tet
// subdivision), replacing the reference's external PyMCubes dependency
// (reference: AvatarGen/AppearanceGen/models/renderer.py:31,
// requirements.txt:8). The SDF grid itself is evaluated on-device by XLA
// (export/marching_cubes.py); only the topology pass runs here.
//
// The Kuhn subdivision tiles space consistently (every cell uses the same
// 6 tetrahedra around the main diagonal), so shared faces between neighboring
// cells triangulate identically and the output surface is watertight up to
// grid boundaries. Vertices on shared grid edges are deduplicated through a
// hash map keyed by the (sorted) grid-point id pair.
//
// Build: g++ -O3 -shared -fPIC -o libmc.so marching_cubes.cpp
// API (ctypes): marching_tets(...) fills malloc'd arrays; free with mc_free.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Mesh {
  std::vector<float> verts;   // xyz triples
  std::vector<int32_t> tris;  // index triples
  std::unordered_map<uint64_t, int32_t> edge_vertex;
};

// Kuhn subdivision: 6 tets around the 0-7 main diagonal of the unit cube.
// Cube corner c in {0..7} has offset (c&1, (c>>1)&1, (c>>2)&1).
static const int TETS[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

inline int32_t edge_point(Mesh& m, uint64_t ia, uint64_t ib, const float* pa,
                          const float* pb, float va, float vb, float iso) {
  if (ia > ib) {
    std::swap(ia, ib);
    std::swap(pa, pb);
    std::swap(va, vb);
  }
  const uint64_t key = (ia << 32) | ib;
  auto it = m.edge_vertex.find(key);
  if (it != m.edge_vertex.end()) return it->second;
  float t = (iso - va) / (vb - va);
  if (t < 0.f) t = 0.f;
  if (t > 1.f) t = 1.f;
  const int32_t idx = static_cast<int32_t>(m.verts.size() / 3);
  m.verts.push_back(pa[0] + t * (pb[0] - pa[0]));
  m.verts.push_back(pa[1] + t * (pb[1] - pa[1]));
  m.verts.push_back(pa[2] + t * (pb[2] - pa[2]));
  m.edge_vertex.emplace(key, idx);
  return idx;
}

// Emit a triangle oriented so its normal points away from `inside` (the
// centroid of the tet corners above the iso value). The 6 Kuhn tets alternate
// parity, so a fixed per-case winding would flip orientation between tets;
// orienting against the inside point is parity-independent and yields a
// consistently outward-facing surface.
inline void emit_tri(Mesh& m, int32_t a, int32_t b, int32_t c,
                     const float inside[3]) {
  if (a == b || b == c || a == c) return;  // degenerate (iso hits a corner)
  const float* pa = &m.verts[3 * a];
  const float* pb = &m.verts[3 * b];
  const float* pc = &m.verts[3 * c];
  const float u[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
  const float v[3] = {pc[0] - pa[0], pc[1] - pa[1], pc[2] - pa[2]};
  const float n[3] = {u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                      u[0] * v[1] - u[1] * v[0]};
  const float cx = (pa[0] + pb[0] + pc[0]) / 3.f - inside[0];
  const float cy = (pa[1] + pb[1] + pc[1]) / 3.f - inside[1];
  const float cz = (pa[2] + pb[2] + pc[2]) / 3.f - inside[2];
  const bool flip = n[0] * cx + n[1] * cy + n[2] * cz < 0.f;
  m.tris.push_back(a);
  m.tris.push_back(flip ? c : b);
  m.tris.push_back(flip ? b : c);
}

// Triangulate one tetrahedron. Corner order matters for consistent winding:
// we orient triangles so their normal points toward the negative side
// (outside, for an SDF where inside is positive after the -sdf negation the
// caller applies — matching mcubes' convention of surface at value==iso).
void do_tet(Mesh& m, const uint64_t gid[4], const float* pos[4],
            const float val[4], float iso) {
  int mask = 0;
  for (int i = 0; i < 4; ++i)
    if (val[i] > iso) mask |= 1 << i;
  if (mask == 0 || mask == 15) return;

  float inside[3] = {0.f, 0.f, 0.f};
  int n_in = 0;
  for (int i = 0; i < 4; ++i) {
    if (val[i] > iso) {
      inside[0] += pos[i][0];
      inside[1] += pos[i][1];
      inside[2] += pos[i][2];
      ++n_in;
    }
  }
  inside[0] /= n_in;
  inside[1] /= n_in;
  inside[2] /= n_in;

  // helper: interpolated vertex on edge (i, j)
  auto ev = [&](int i, int j) {
    return edge_point(m, gid[i], gid[j], pos[i], pos[j], val[i], val[j], iso);
  };
  auto tri = [&](int32_t a, int32_t b, int32_t c) { emit_tri(m, a, b, c, inside); };

  switch (mask) {
    // one corner above / below: a single triangle around that corner
    case 1: case 14: tri(ev(0, 1), ev(0, 2), ev(0, 3)); break;
    case 2: case 13: tri(ev(1, 0), ev(1, 3), ev(1, 2)); break;
    case 4: case 11: tri(ev(2, 0), ev(2, 1), ev(2, 3)); break;
    case 8: case 7: tri(ev(3, 0), ev(3, 2), ev(3, 1)); break;
    // two-and-two: a quad, split into two triangles
    case 3: case 12:  // {0,1} vs {2,3}
      tri(ev(0, 2), ev(1, 2), ev(1, 3));
      tri(ev(0, 2), ev(1, 3), ev(0, 3));
      break;
    case 5: case 10:  // {0,2} vs {1,3}
      tri(ev(0, 1), ev(1, 2), ev(2, 3));
      tri(ev(0, 1), ev(2, 3), ev(0, 3));
      break;
    case 6: case 9:  // {1,2} vs {0,3}
      tri(ev(0, 1), ev(0, 2), ev(2, 3));
      tri(ev(0, 1), ev(2, 3), ev(1, 3));
      break;
  }
}

}  // namespace

extern "C" {

// grid: nx*ny*nz floats, C order (x-major: index = (x*ny + y)*nz + z to match
// the reference's extract_fields layout u[x, y, z]).
// Returns 0 on success.
int marching_tets(const float* grid, int nx, int ny, int nz, float iso,
                  float** out_verts, int32_t** out_tris, int64_t* n_verts,
                  int64_t* n_tris) {
  Mesh m;
  m.verts.reserve(1 << 16);
  m.tris.reserve(1 << 16);

  const auto gidx = [&](int x, int y, int z) -> uint64_t {
    return (static_cast<uint64_t>(x) * ny + y) * nz + z;
  };

  float corner_pos[8][3];
  float corner_val[8];
  uint64_t corner_gid[8];

  for (int x = 0; x + 1 < nx; ++x) {
    for (int y = 0; y + 1 < ny; ++y) {
      for (int z = 0; z + 1 < nz; ++z) {
        // gather cube corners; skip cells fully inside/outside fast
        bool any_above = false, any_below = false;
        for (int c = 0; c < 8; ++c) {
          const int cx = x + (c & 1);
          const int cy = y + ((c >> 1) & 1);
          const int cz = z + ((c >> 2) & 1);
          const uint64_t gi = gidx(cx, cy, cz);
          const float v = grid[gi];
          corner_pos[c][0] = static_cast<float>(cx);
          corner_pos[c][1] = static_cast<float>(cy);
          corner_pos[c][2] = static_cast<float>(cz);
          corner_val[c] = v;
          corner_gid[c] = gi;
          if (v > iso)
            any_above = true;
          else
            any_below = true;
        }
        if (!any_above || !any_below) continue;

        for (const auto& tet : TETS) {
          const uint64_t gid[4] = {corner_gid[tet[0]], corner_gid[tet[1]],
                                   corner_gid[tet[2]], corner_gid[tet[3]]};
          const float* pos[4] = {corner_pos[tet[0]], corner_pos[tet[1]],
                                 corner_pos[tet[2]], corner_pos[tet[3]]};
          const float val[4] = {corner_val[tet[0]], corner_val[tet[1]],
                                corner_val[tet[2]], corner_val[tet[3]]};
          do_tet(m, gid, pos, val, iso);
        }
      }
    }
  }

  *n_verts = static_cast<int64_t>(m.verts.size() / 3);
  *n_tris = static_cast<int64_t>(m.tris.size() / 3);
  *out_verts = static_cast<float*>(std::malloc(m.verts.size() * sizeof(float)));
  *out_tris =
      static_cast<int32_t*>(std::malloc(m.tris.size() * sizeof(int32_t)));
  if (!*out_verts || !*out_tris) return 1;
  std::memcpy(*out_verts, m.verts.data(), m.verts.size() * sizeof(float));
  std::memcpy(*out_tris, m.tris.data(), m.tris.size() * sizeof(int32_t));
  return 0;
}

void mc_free(void* p) { std::free(p); }

}  // extern "C"
