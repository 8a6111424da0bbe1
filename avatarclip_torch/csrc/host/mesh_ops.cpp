// Host-side mesh utilities replacing the reference's external Open3D (C++)
// dependency (reference: AvatarGen/AppearanceGen/drive.py:7,172-210;
// Avatar2FBX/utils/ply_utils.py:16-19):
//   - largest_component: keep the biggest connected island of a triangle
//     mesh (drive.py cleanup_mesh, BFS over the vertex adjacency)
//   - cluster_simplify: vertex-clustering decimation on a uniform grid
//     (ply_utils.py simplify_vertex_clustering with 1/256-bbox cells)
//   - nearest_neighbors: index of the nearest reference point for each query
//     (uniform-grid accelerated; the blend-weight transfer step,
//     drive.py:235-240)
//
// The port's own copy of the JAX package's native/mesh_ops.cpp, built with
// g++ at first use by avatarclip_torch/ops/_build.load_host and bound in
// avatarclip_torch/export/meshops.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct GridHash {
  float minx, miny, minz, cell;
  int64_t nx, ny, nz;
  inline int64_t cell_id(float x, float y, float z) const {
    int64_t cx = static_cast<int64_t>((x - minx) / cell);
    int64_t cy = static_cast<int64_t>((y - miny) / cell);
    int64_t cz = static_cast<int64_t>((z - minz) / cell);
    if (cx < 0) cx = 0;
    if (cy < 0) cy = 0;
    if (cz < 0) cz = 0;
    if (cx >= nx) cx = nx - 1;
    if (cy >= ny) cy = ny - 1;
    if (cz >= nz) cz = nz - 1;
    return (cx * ny + cy) * nz + cz;
  }
};

GridHash make_grid(const float* pts, int64_t n, float cell) {
  GridHash g;
  g.minx = g.miny = g.minz = 1e30f;
  float maxx = -1e30f, maxy = -1e30f, maxz = -1e30f;
  for (int64_t i = 0; i < n; ++i) {
    g.minx = std::fmin(g.minx, pts[3 * i]);
    g.miny = std::fmin(g.miny, pts[3 * i + 1]);
    g.minz = std::fmin(g.minz, pts[3 * i + 2]);
    maxx = std::fmax(maxx, pts[3 * i]);
    maxy = std::fmax(maxy, pts[3 * i + 1]);
    maxz = std::fmax(maxz, pts[3 * i + 2]);
  }
  g.cell = cell;
  g.nx = static_cast<int64_t>((maxx - g.minx) / cell) + 1;
  g.ny = static_cast<int64_t>((maxy - g.miny) / cell) + 1;
  g.nz = static_cast<int64_t>((maxz - g.minz) / cell) + 1;
  return g;
}

}  // namespace

extern "C" {

// Label connected components over triangle connectivity; writes the kept
// (largest component) flag per vertex into keep[n_verts].
// Returns the number of components.
int largest_component(const int32_t* tris, int64_t n_tris, int64_t n_verts,
                      uint8_t* keep) {
  std::vector<int32_t> parent(n_verts);
  for (int64_t i = 0; i < n_verts; ++i) parent[i] = static_cast<int32_t>(i);
  std::vector<int32_t>* pp = &parent;
  std::vector<int32_t>& par = *pp;

  // union-find
  std::vector<int32_t> rank_(n_verts, 0);
  auto find = [&](int32_t a) {
    while (par[a] != a) {
      par[a] = par[par[a]];
      a = par[a];
    }
    return a;
  };
  auto unite = [&](int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    par[b] = a;
    if (rank_[a] == rank_[b]) ++rank_[a];
  };

  for (int64_t t = 0; t < n_tris; ++t) {
    unite(tris[3 * t], tris[3 * t + 1]);
    unite(tris[3 * t], tris[3 * t + 2]);
  }

  std::unordered_map<int32_t, int64_t> counts;
  for (int64_t i = 0; i < n_verts; ++i) counts[find(static_cast<int32_t>(i))]++;
  int32_t best_root = -1;
  int64_t best_count = -1;
  for (auto& kv : counts) {
    if (kv.second > best_count) {
      best_count = kv.second;
      best_root = kv.first;
    }
  }
  for (int64_t i = 0; i < n_verts; ++i)
    keep[i] = find(static_cast<int32_t>(i)) == best_root ? 1 : 0;
  return static_cast<int>(counts.size());
}

// Vertex clustering: cluster cell = bbox_diag_fraction of the bbox max
// extent. Outputs: cluster id per input vertex (for attribute pooling) and
// the clustered vertex positions (centroid). Returns n_clusters.
int64_t cluster_simplify(const float* verts, int64_t n_verts,
                         float cell_size, int32_t* cluster_of,
                         float* out_verts /* capacity n_verts*3 */) {
  GridHash g = make_grid(verts, n_verts, cell_size);
  std::unordered_map<int64_t, int32_t> cell_to_cluster;
  std::vector<double> sum;
  std::vector<int64_t> cnt;
  for (int64_t i = 0; i < n_verts; ++i) {
    int64_t cid = g.cell_id(verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]);
    auto it = cell_to_cluster.find(cid);
    int32_t c;
    if (it == cell_to_cluster.end()) {
      c = static_cast<int32_t>(cnt.size());
      cell_to_cluster.emplace(cid, c);
      sum.resize(sum.size() + 3, 0.0);
      cnt.push_back(0);
    } else {
      c = it->second;
    }
    cluster_of[i] = c;
    sum[3 * c] += verts[3 * i];
    sum[3 * c + 1] += verts[3 * i + 1];
    sum[3 * c + 2] += verts[3 * i + 2];
    cnt[c]++;
  }
  const int64_t n_clusters = static_cast<int64_t>(cnt.size());
  for (int64_t c = 0; c < n_clusters; ++c) {
    out_verts[3 * c] = static_cast<float>(sum[3 * c] / cnt[c]);
    out_verts[3 * c + 1] = static_cast<float>(sum[3 * c + 1] / cnt[c]);
    out_verts[3 * c + 2] = static_cast<float>(sum[3 * c + 2] / cnt[c]);
  }
  return n_clusters;
}

// For each query point, the index of the nearest reference point.
// Grid-accelerated with expanding ring search.
void nearest_neighbors(const float* ref, int64_t n_ref, const float* query,
                       int64_t n_query, int32_t* out_idx) {
  // cell ~ average spacing
  float minv[3] = {1e30f, 1e30f, 1e30f}, maxv[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n_ref; ++i)
    for (int d = 0; d < 3; ++d) {
      minv[d] = std::fmin(minv[d], ref[3 * i + d]);
      maxv[d] = std::fmax(maxv[d], ref[3 * i + d]);
    }
  float extent = std::fmax(
      maxv[0] - minv[0], std::fmax(maxv[1] - minv[1], maxv[2] - minv[2]));
  float cell = std::fmax(extent / 64.0f, 1e-6f);
  GridHash g = make_grid(ref, n_ref, cell);

  std::unordered_map<int64_t, std::vector<int32_t>> buckets;
  buckets.reserve(n_ref);
  for (int64_t i = 0; i < n_ref; ++i)
    buckets[g.cell_id(ref[3 * i], ref[3 * i + 1], ref[3 * i + 2])].push_back(
        static_cast<int32_t>(i));

  for (int64_t q = 0; q < n_query; ++q) {
    const float qx = query[3 * q], qy = query[3 * q + 1], qz = query[3 * q + 2];
    int64_t cx = static_cast<int64_t>((qx - g.minx) / g.cell);
    int64_t cy = static_cast<int64_t>((qy - g.miny) / g.cell);
    int64_t cz = static_cast<int64_t>((qz - g.minz) / g.cell);
    float best_d = 1e30f;
    int32_t best_i = 0;
    for (int64_t ring = 0; ring < std::max({g.nx, g.ny, g.nz}) + 1; ++ring) {
      for (int64_t x = cx - ring; x <= cx + ring; ++x) {
        if (x < 0 || x >= g.nx) continue;
        for (int64_t y = cy - ring; y <= cy + ring; ++y) {
          if (y < 0 || y >= g.ny) continue;
          for (int64_t z = cz - ring; z <= cz + ring; ++z) {
            if (z < 0 || z >= g.nz) continue;
            // only the shell of the ring
            if (ring > 0 && std::llabs(x - cx) != ring &&
                std::llabs(y - cy) != ring && std::llabs(z - cz) != ring)
              continue;
            auto it = buckets.find((x * g.ny + y) * g.nz + z);
            if (it == buckets.end()) continue;
            for (int32_t i : it->second) {
              const float dx = ref[3 * i] - qx;
              const float dy = ref[3 * i + 1] - qy;
              const float dz = ref[3 * i + 2] - qz;
              const float d = dx * dx + dy * dy + dz * dz;
              if (d < best_d) {
                best_d = d;
                best_i = i;
              }
            }
          }
        }
      }
      // any cell at ring r+1 lies at Euclidean distance >= r*cell from the
      // query (which sits somewhere inside the center cell), so once the
      // current best beats that bound no farther ring can improve it
      const float bound = static_cast<float>(ring) * g.cell;
      if (best_d <= bound * bound) break;
    }
    out_idx[q] = best_i;
  }
}

}  // extern "C"
