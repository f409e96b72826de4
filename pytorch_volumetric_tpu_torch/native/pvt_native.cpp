// pvt_native: host-side triangle-mesh geometry runtime.
//
// The port's own copy of the JAX package's native runtime
// (pytorch_volumetric_tpu/native/pvt_native.cpp): a bounding-volume
// hierarchy over triangles with closest-point queries and a fast winding
// number (the counterpart of Open3D's RaycastingScene), the candidate-table
// build of the narrow-band SDF, and an OBJ parser.  It runs on the host; the
// card's work starts from the tables it builds.
//
// One change from the JAX package's copy: pvt_build_cell_table sorts each
// cell's candidate ids ascending after the parallel fill.  Threads claim
// slots with an atomic counter, so without the sort the order of a cell's
// candidates (and so which of two equidistant triangles wins a query's
// first-minimum) depends on thread timing whenever the mesh has 1024 faces
// or more.  Sorted, it is the order one thread would write.  (A cell with
// more than K candidates still keeps a subset that depends on timing; the
// narrow-band build demotes such cells to its far field.)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (native/__init__.py, at
// first use).  Exposed via ctypes: plain C ABI, no pybind11.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline Vec3 operator*(float s, Vec3 a) { return {s * a.x, s * a.y, s * a.z}; }
static inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float norm(Vec3 a) { return std::sqrt(dot(a, a)); }

// Closest point on a triangle (Ericson, Real-Time Collision Detection 5.1.5).
static Vec3 closest_point_triangle(Vec3 p, Vec3 a, Vec3 b, Vec3 c) {
  Vec3 ab = b - a, ac = c - a, ap = p - a;
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) return a;
  Vec3 bp = p - b;
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return b;
  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    float v = d1 / (d1 - d3);
    return a + v * ab;
  }
  Vec3 cp = p - c;
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return c;
  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    float w = d2 / (d2 - d6);
    return a + w * ac;
  }
  float va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    float w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    return b + w * (c - b);
  }
  float denom = 1.0f / (va + vb + vc);
  float v = vb * denom, w = vc * denom;
  return a + v * ab + w * ac;
}

struct AABB {
  Vec3 lo{1e30f, 1e30f, 1e30f};
  Vec3 hi{-1e30f, -1e30f, -1e30f};
  void grow(Vec3 p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
  }
  void grow(const AABB& o) { grow(o.lo); grow(o.hi); }
  float dist2(Vec3 p) const {
    float dx = std::max({lo.x - p.x, 0.0f, p.x - hi.x});
    float dy = std::max({lo.y - p.y, 0.0f, p.y - hi.y});
    float dz = std::max({lo.z - p.z, 0.0f, p.z - hi.z});
    return dx * dx + dy * dy + dz * dz;
  }
};

struct BVHNode {
  AABB box;
  int32_t left = -1;    // internal: child index; leaf: first tri index
  int32_t count = 0;    // leaf: number of tris (0 for internal)
  int32_t right = -1;
};

struct Scene {
  std::vector<Vec3> va, vb, vc;   // triangle corners, BVH order
  std::vector<int32_t> face_id;   // original face index per BVH-ordered tri
  std::vector<BVHNode> nodes;
  int32_t root = 0;

  // winding-number acceleration: per-node dipole approximation
  // (Barill et al. 2018 "Fast Winding Numbers"): area-weighted normal and
  // centroid; exact sum at leaves / when close.
  std::vector<Vec3> node_normal;   // sum of area-weighted face normals
  std::vector<Vec3> node_center;   // area-weighted centroid
  std::vector<float> node_radius;  // max dist from center to node box corner
};

static int build_bvh(Scene& s, std::vector<int>& order, std::vector<Vec3>& centroids,
                     int begin, int end, int leaf_size) {
  BVHNode node;
  for (int i = begin; i < end; ++i) {
    // grow by the full triangle
    int t = order[i];
    node.box.grow(s.va[t]); node.box.grow(s.vb[t]); node.box.grow(s.vc[t]);
  }
  int idx = (int)s.nodes.size();
  s.nodes.push_back(node);
  if (end - begin <= leaf_size) {
    s.nodes[idx].left = begin;
    s.nodes[idx].count = end - begin;
    return idx;
  }
  // split along the widest centroid axis at the median
  AABB cb;
  for (int i = begin; i < end; ++i) cb.grow(centroids[order[i]]);
  Vec3 ext = cb.hi - cb.lo;
  int axis = (ext.x > ext.y && ext.x > ext.z) ? 0 : (ext.y > ext.z ? 1 : 2);
  int mid = (begin + end) / 2;
  std::nth_element(order.begin() + begin, order.begin() + mid, order.begin() + end,
                   [&](int p, int q) {
                     const Vec3& cp = centroids[p];
                     const Vec3& cq = centroids[q];
                     return axis == 0 ? cp.x < cq.x : (axis == 1 ? cp.y < cq.y : cp.z < cq.z);
                   });
  int l = build_bvh(s, order, centroids, begin, mid, leaf_size);
  int r = build_bvh(s, order, centroids, mid, end, leaf_size);
  s.nodes[idx].left = l;
  s.nodes[idx].right = r;
  s.nodes[idx].count = 0;
  return idx;
}

static void build_winding_tree(Scene& s) {
  size_t n = s.nodes.size();
  s.node_normal.assign(n, {0, 0, 0});
  s.node_center.assign(n, {0, 0, 0});
  s.node_radius.assign(n, 0.0f);
  // process nodes in reverse creation order: children have larger indices
  // than their parent only for the right subtree... build order is parent
  // first, then left subtree, then right subtree -> children always have
  // larger indices, so a reverse sweep accumulates bottom-up.
  std::vector<float> area(n, 0.0f);
  for (int i = (int)n - 1; i >= 0; --i) {
    BVHNode& nd = s.nodes[i];
    Vec3 nsum{0, 0, 0}, csum{0, 0, 0};
    float asum = 0;
    if (nd.count > 0) {
      for (int k = nd.left; k < nd.left + nd.count; ++k) {
        Vec3 a = s.va[k], b = s.vb[k], c = s.vc[k];
        Vec3 fn = cross(b - a, c - a);            // 2*area-weighted normal
        float ar = 0.5f * norm(fn);
        Vec3 cen = (1.0f / 3.0f) * (a + b + c);
        nsum = nsum + 0.5f * fn;
        csum = csum + ar * cen;
        asum += ar;
      }
    } else {
      nsum = s.node_normal[nd.left] + s.node_normal[nd.right];
      csum = area[nd.left] * s.node_center[nd.left] +
             area[nd.right] * s.node_center[nd.right];
      asum = area[nd.left] + area[nd.right];
    }
    s.node_normal[i] = nsum;
    s.node_center[i] = asum > 0 ? (1.0f / asum) * csum : nsum;
    area[i] = asum;
    // radius: center to farthest box corner
    Vec3 c = s.node_center[i];
    float dx = std::max(std::abs(nd.box.lo.x - c.x), std::abs(nd.box.hi.x - c.x));
    float dy = std::max(std::abs(nd.box.lo.y - c.y), std::abs(nd.box.hi.y - c.y));
    float dz = std::max(std::abs(nd.box.lo.z - c.z), std::abs(nd.box.hi.z - c.z));
    s.node_radius[i] = std::sqrt(dx * dx + dy * dy + dz * dz);
  }
}

static inline float solid_angle(Vec3 p, Vec3 a, Vec3 b, Vec3 c) {
  Vec3 av = a - p, bv = b - p, cv = c - p;
  float la = norm(av), lb = norm(bv), lc = norm(cv);
  float num = dot(av, cross(bv, cv));
  float den = la * lb * lc + dot(av, bv) * lc + dot(bv, cv) * la + dot(cv, av) * lb;
  return 2.0f * std::atan2(num, den);
}

// Fast winding number: far nodes use the dipole approximation, near ones recurse.
static float winding_rec(const Scene& s, int node, Vec3 p, float beta) {
  const BVHNode& nd = s.nodes[node];
  Vec3 d = s.node_center[node] - p;  // from query point to the dipole center
  float r = norm(d);
  if (r > beta * s.node_radius[node]) {
    // dipole (Barill et al.): w ~ n . (c - q) / (4 pi r^3)
    float r3 = r * r * r;
    return dot(s.node_normal[node], d) / (12.566370614f * r3 + 1e-30f);
  }
  if (nd.count > 0) {
    float w = 0;
    for (int k = nd.left; k < nd.left + nd.count; ++k)
      w += solid_angle(p, s.va[k], s.vb[k], s.vc[k]);
    return w / 12.566370614f;
  }
  return winding_rec(s, nd.left, p, beta) + winding_rec(s, nd.right, p, beta);
}

static void closest_query_one(const Scene& s, Vec3 p, float* out_d2, Vec3* out_cp,
                              int32_t* out_fid) {
  float best = 1e30f;
  Vec3 best_cp{0, 0, 0};
  int32_t best_fid = 0;
  int stack[128];
  int sp = 0;
  stack[sp++] = s.root;
  while (sp) {
    int ni = stack[--sp];
    const BVHNode& nd = s.nodes[ni];
    if (nd.box.dist2(p) >= best) continue;
    if (nd.count > 0) {
      for (int k = nd.left; k < nd.left + nd.count; ++k) {
        Vec3 cp = closest_point_triangle(p, s.va[k], s.vb[k], s.vc[k]);
        Vec3 dv = cp - p;
        float d2 = dot(dv, dv);
        if (d2 < best) { best = d2; best_cp = cp; best_fid = s.face_id[k]; }
      }
    } else {
      // visit the nearer child first
      float dl = s.nodes[nd.left].box.dist2(p);
      float dr = s.nodes[nd.right].box.dist2(p);
      if (dl < dr) {
        if (dr < best) stack[sp++] = nd.right;
        if (dl < best) stack[sp++] = nd.left;
      } else {
        if (dl < best) stack[sp++] = nd.left;
        if (dr < best) stack[sp++] = nd.right;
      }
    }
  }
  *out_d2 = best;
  *out_cp = best_cp;
  *out_fid = best_fid;
}

static void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = std::max(1u, std::min(hw, 32u));
  if (n < 1024 || nthreads == 1) { fn(0, n); return; }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Build a scene: triangles [F, 3, 3] float32 (corner-major).
// Returns an opaque handle.
void* pvt_scene_create(const float* tris, int64_t num_faces) {
  // an empty scene would build a count==0 root that every consumer
  // misreads as an internal node (nodes[-1] out-of-bounds); refuse it
  if (num_faces <= 0) return nullptr;
  Scene* s = new Scene();
  std::vector<Vec3> a(num_faces), b(num_faces), c(num_faces), cent(num_faces);
  for (int64_t i = 0; i < num_faces; ++i) {
    a[i] = {tris[i * 9 + 0], tris[i * 9 + 1], tris[i * 9 + 2]};
    b[i] = {tris[i * 9 + 3], tris[i * 9 + 4], tris[i * 9 + 5]};
    c[i] = {tris[i * 9 + 6], tris[i * 9 + 7], tris[i * 9 + 8]};
    cent[i] = (1.0f / 3.0f) * (a[i] + b[i] + c[i]);
  }
  std::vector<int> order(num_faces);
  for (int64_t i = 0; i < num_faces; ++i) order[i] = (int)i;
  // temporarily store unordered so build_bvh can index by original id
  s->va = a; s->vb = b; s->vc = c;
  s->nodes.reserve(2 * num_faces);
  s->root = build_bvh(*s, order, cent, 0, (int)num_faces, 4);
  // reorder triangles into BVH leaf order for cache-friendly traversal
  std::vector<Vec3> ra(num_faces), rb(num_faces), rc(num_faces);
  s->face_id.resize(num_faces);
  for (int64_t i = 0; i < num_faces; ++i) {
    ra[i] = a[order[i]]; rb[i] = b[order[i]]; rc[i] = c[order[i]];
    s->face_id[i] = order[i];
  }
  s->va = std::move(ra); s->vb = std::move(rb); s->vc = std::move(rc);
  build_winding_tree(*s);
  return s;
}

void pvt_scene_destroy(void* handle) { delete static_cast<Scene*>(handle); }

// Closest point + signed distance + gradient + winding for N points.
// points: [N, 3] f32.  Outputs (caller-allocated): closest [N,3], dist [N]
// (unsigned), fid [N] i32, winding [N] f32.
void pvt_closest_query(void* handle, const float* points, int64_t n,
                       float* closest, float* dist, int32_t* fid,
                       float* winding, float winding_beta) {
  Scene* s = static_cast<Scene*>(handle);
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      Vec3 p{points[i * 3], points[i * 3 + 1], points[i * 3 + 2]};
      float d2; Vec3 cp; int32_t f;
      closest_query_one(*s, p, &d2, &cp, &f);
      closest[i * 3] = cp.x; closest[i * 3 + 1] = cp.y; closest[i * 3 + 2] = cp.z;
      dist[i] = std::sqrt(d2);
      fid[i] = f;
      winding[i] = winding_rec(*s, s->root, p, winding_beta);
    }
  });
}

// Candidate-table build for narrow-band SDF grids: for every grid cell c
// with radius[c] >= 0, collect the triangles whose AABB is within radius[c]
// of the cell's box.  Two-pass from Python: K == 0 counts only; K > 0 fills
// out_ids [C, K] (-1 padded, counts clamped to K).  Returns the max count.
// tris: [F, 3, 3] f32; lo/res: [3]; dims: [3]; radius: [C] (< 0 -> skip).
int64_t pvt_build_cell_table(const float* tris, int64_t F,
                             const float* lo, const float* res,
                             const int32_t* dims, const float* radius,
                             int32_t* out_ids, int64_t K,
                             int32_t* out_counts) {
  const int64_t nx = dims[0], ny = dims[1], nz = dims[2];
  const int64_t C = nx * ny * nz;
  std::memset(out_counts, 0, C * sizeof(int32_t));
  if (out_ids && K > 0)
    for (int64_t i = 0; i < C * K; ++i) out_ids[i] = -1;
  float rmax = 0.0f;
  for (int64_t c = 0; c < C; ++c) rmax = std::max(rmax, radius[c]);
  auto* counts = reinterpret_cast<std::atomic<int32_t>*>(out_counts);

  parallel_for(F, [&](int64_t t0, int64_t t1) {
    for (int64_t t = t0; t < t1; ++t) {
      float tlo[3], thi[3];
      for (int d = 0; d < 3; ++d) {
        float a = tris[t * 9 + d], b = tris[t * 9 + 3 + d], c = tris[t * 9 + 6 + d];
        tlo[d] = std::min(a, std::min(b, c));
        thi[d] = std::max(a, std::max(b, c));
      }
      int64_t ilo[3], ihi[3];
      for (int d = 0; d < 3; ++d) {
        ilo[d] = std::max<int64_t>(
            0, (int64_t)std::floor((tlo[d] - rmax - lo[d]) / res[d]));
        ihi[d] = std::min<int64_t>(
            dims[d] - 1, (int64_t)std::floor((thi[d] + rmax - lo[d]) / res[d]));
      }
      for (int64_t i = ilo[0]; i <= ihi[0]; ++i)
        for (int64_t j = ilo[1]; j <= ihi[1]; ++j)
          for (int64_t k = ilo[2]; k <= ihi[2]; ++k) {
            int64_t c = (i * ny + j) * nz + k;
            float r = radius[c];
            if (r < 0.0f) continue;
            float cl[3] = {lo[0] + i * res[0], lo[1] + j * res[1],
                           lo[2] + k * res[2]};
            float d2 = 0.0f;
            for (int d = 0; d < 3; ++d) {
              float ch = cl[d] + res[d];
              float gap = std::max(0.0f, std::max(cl[d] - thi[d], tlo[d] - ch));
              d2 += gap * gap;
            }
            if (d2 > r * r) continue;
            int32_t slot = counts[c].fetch_add(1, std::memory_order_relaxed);
            if (out_ids && K > 0 && slot < K) out_ids[c * K + slot] = (int32_t)t;
          }
    }
  });
  if (out_ids && K > 0) {
    // a deterministic order: ascending face id within each cell
    parallel_for(C, [&](int64_t c0, int64_t c1) {
      for (int64_t c = c0; c < c1; ++c) {
        const int64_t n = std::min<int64_t>(out_counts[c], K);
        if (n > 1) std::sort(out_ids + c * K, out_ids + c * K + n);
      }
    });
  }
  int64_t maxc = 0;
  for (int64_t c = 0; c < C; ++c)
    maxc = std::max<int64_t>(maxc, out_counts[c]);
  return maxc;
}

// Fast OBJ vertex/face counting + parsing (see native.py for usage).
// Returns 0 on success.  Two-pass: first call with null buffers to get counts.
int pvt_parse_obj(const char* path, float* vertices, int64_t* num_vertices,
                  int32_t* faces, int64_t* num_faces) {
  FILE* f = fopen(path, "r");
  if (!f) return 1;
  char line[4096];
  int64_t nv = 0, nf = 0;
  bool counting = (vertices == nullptr);
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      if (!counting) {
        float x = 0, y = 0, z = 0;
        // underparsed lines still fill their slot (the caller's buffer is
        // uninitialized np.empty; leaving it would poison the mesh)
        sscanf(line + 2, "%f %f %f", &x, &y, &z);
        vertices[nv * 3] = x; vertices[nv * 3 + 1] = y; vertices[nv * 3 + 2] = z;
      }
      nv++;
    } else if (line[0] == 'f' && line[1] == ' ') {
      // fan-triangulate arbitrary polygons (CAD caps can exceed 8 corners)
      std::vector<int64_t> idx;
      char* tok = strtok(line + 2, " \t\r\n");
      while (tok) {
        long v = strtol(tok, nullptr, 10);
        idx.push_back(v > 0 ? v - 1 : nv + v);
        tok = strtok(nullptr, " \t\r\n");
      }
      int cnt = (int)idx.size();
      for (int k = 1; k + 1 < cnt; ++k) {
        if (!counting) {
          faces[nf * 3] = (int32_t)idx[0];
          faces[nf * 3 + 1] = (int32_t)idx[k];
          faces[nf * 3 + 2] = (int32_t)idx[k + 1];
        }
        nf++;
      }
    }
  }
  fclose(f);
  *num_vertices = nv;
  *num_faces = nf;
  return 0;
}

}  // extern "C"
