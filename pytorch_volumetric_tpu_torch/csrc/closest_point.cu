// Fused point -> triangle-mesh closest-point + winding-number sweep (Hopper).
//
// Replaces the TPU kernel pytorch_volumetric_tpu/ops/pallas/closest_point.py
// :: _sweep_kernel (launched by pallas_closest_query_soa).  For every
// (point, triangle) pair it computes the Ericson closest point (Voronoi-region
// select cascade, safe division at 1e-30) and its squared distance, plus the
// van Oosterom-Strackee solid angle 2*atan2(num, den).  Per point it keeps
// the running min squared distance, the face id that reaches it (ascending
// face order with a strict '<', so the lowest id wins ties), the closest
// point, and the solid-angle sum (divided by 4*pi by the caller).
//
// What bounds it on an H100: instruction issue.  A pair costs about 110
// FP32 operations plus square roots, divisions and an atan2, while the bytes
// are tiny (a point is read once, a triangle once per block and from L2
// after the first); the SMs issue one warp-instruction per scheduler and
// cycle, and the brute-force loop needed ~381 of them per pair.  So the
// design cuts pairs and instructions per pair, never the per-pair rounding:
//
// 1. Select, then divide.  The six region flags come first; the quotient
//    each output needs is picked by the cascade's priority and divided once,
//    two IEEE divisions per pair instead of five.  Each kept quotient is the
//    same division of the same operands as in the plain version.  The
//    cascade lives in point_triangle.cuh, shared with narrow_band.cu.
// 2. Padding is skipped.  A triangle whose nine coordinates all equal
//    mesh.PAD_COORD is dropped when its tile is compacted into shared
//    memory; every padding triangle gives the same pair, so the first one
//    is evaluated once at the end and merged by (d2, face id).
// 3. Exterior winding.  For a mesh with no boundary the winding number is
//    exactly 0 outside its bounding box.  The caller passes that box (grown
//    by a margin) only for such meshes; a warp whose points all lie strictly
//    outside it sums no solid angle and writes 0.
// 4. Cluster culling.  Each run of kCluster consecutive real triangles gets
//    a bounding box, grown by kCullAbs of its largest coordinate.  A warp
//    skips a cluster's closest-point work when every point's squared
//    distance to the box, less kCullRel of itself, is >= its running best
//    (all skipped faces have higher ids, so none could replace it under the
//    strict '<') or > an upper bound on its final best (the distance to a
//    corner of a well-shaped triangle sampled every kCluster faces, plus the
//    same margins: such faces cannot reach the final minimum).  Clusters
//    holding a thin triangle (squared area below kThin of its longest
//    edge's fourth power), whose cascade can round far off the triangle,
//    are never culled and give no bound.  Faces keep their order.  kCull
//    switches it off at compile time, for scripts/sweep_variants_torch.py,
//    which times the levers and other compile-time choices side by side.
// 5. One point per thread.  Two or four would spread the 15 shared loads
//    and the loop's integer and control instructions over several points,
//    but on the H100 they were slower: wider warps cull less, and they took
//    80 and 96 registers.
//
// Every sum and product is written in the same order as the plain PyTorch
// version (ops/point_triangle.py), and the library is built with
// -fmad=false, so on the card the kernel reproduces the plain version's
// squared distances, closest points and face ids bit for bit; only the
// winding sum differs, by summation order (and by exactly 0 where the
// exterior shortcut replaces a sum that rounds to about 1e-7).  The culling
// margins hold that parity for points up to ~10^3 of the cluster's shortest
// edge from the surface; nearer, the rounding they must cover is far smaller.
//
// Design: 128 threads per block.  The block streams tiles of 128 triangles
// through shared memory (corners plus the two edge vectors, 15 floats each,
// compacted to the real triangles, with their face ids and the cluster
// boxes); every thread reads the same triangle at the same time, so
// shared-memory reads are broadcasts.  The running state stays in
// registers.  Ragged point counts are masked here.
//
// The body is a template on kWinding.  kWinding=true is the sweep above;
// kWinding=false is the same closest-point arithmetic without the solid
// angle (the no-winding variant of benchmarks/pallas_mxu_ab.py ::
// sweep_kernel, mode "nowind"), which the roofline probe times against it.
// The probe also builds this source with contraction on (-fmad=true) to
// measure what -fmad=false costs.

#include <cuda_runtime.h>

#include "point_triangle.cuh"  // Tri, closest_pair, solid_angle, is_thin

namespace {

constexpr int kThreads = 128;   // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kTriTile = 128;   // triangles per shared-memory tile
constexpr int kCluster = 8;     // triangles per culling cluster
constexpr bool kCull = true;    // cluster culling (lever 4)
constexpr int kClusters = kTriTile / kCluster;
constexpr float kPad = 1.0e7f;  // mesh.PAD_COORD
constexpr float kCullRel = 1e-3f;
constexpr float kCullAbs = 1e-5f;
constexpr float kThin = 1e-3f;
constexpr unsigned kFull = 0xffffffffu;

struct Box {
  float lo[3], hi[3];
};

struct Point {  // one thread's point and its running state
  float px, py, pz;
  float best;  // running min squared distance
  int fid;
  float qx, qy, qz;
  float wind;
};

// The tile's triangle at slot k (structure of arrays, 15 rows).
__device__ __forceinline__ Tri load_tri(const float* __restrict__ s, int k) {
  Tri t;
  t.ax = s[0 * kTriTile + k];  t.ay = s[1 * kTriTile + k];  t.az = s[2 * kTriTile + k];
  t.bx = s[3 * kTriTile + k];  t.by = s[4 * kTriTile + k];  t.bz = s[5 * kTriTile + k];
  t.cx = s[6 * kTriTile + k];  t.cy = s[7 * kTriTile + k];  t.cz = s[8 * kTriTile + k];
  t.abx = s[9 * kTriTile + k]; t.aby = s[10 * kTriTile + k]; t.abz = s[11 * kTriTile + k];
  t.acx = s[12 * kTriTile + k]; t.acy = s[13 * kTriTile + k]; t.acz = s[14 * kTriTile + k];
  return t;
}

// Slots [k0, k1) of the tile against this thread's point: the closest
// point, the solid angle, or both.
template <bool kClosest, bool kWind>
__device__ __forceinline__ void sweep_slots(const float* __restrict__ s,
                                            const int* __restrict__ s_id, int k0, int k1,
                                            Point& pt) {
  for (int k = k0; k < k1; ++k) {
    const Tri t = load_tri(s, k);
    if constexpr (kClosest) {
      float qx, qy, qz;
      const float d2 = closest_pair(t, pt.px, pt.py, pt.pz, qx, qy, qz);
      if (d2 < pt.best) {
        pt.best = d2;
        pt.fid = s_id[k];
        pt.qx = qx; pt.qy = qy; pt.qz = qz;
      }
    }
    if constexpr (kWind) pt.wind += solid_angle(t, pt.px, pt.py, pt.pz);
  }
}

template <bool kWinding>
__global__ void __launch_bounds__(kThreads)
closest_point_sweep_kernel(const float* __restrict__ pts, int num_points,
                           const float* __restrict__ tri, int num_tri,
                           float* __restrict__ out_d2,
                           float* __restrict__ out_closest,
                           int* __restrict__ out_fid,
                           float* __restrict__ out_wind,
                           Box ext, int has_ext,
                           unsigned long long* __restrict__ counters) {
  // compacted tile: a, b, c corners and ab = b - a, ac = c - a, the face
  // ids, each cluster's grown box (lo xyz, hi xyz) and the warps' ballots
  __shared__ float s[15 * kTriTile];
  __shared__ int s_id[kTriTile];
  __shared__ float s_box[6 * kClusters];
  __shared__ unsigned s_mask[2 * kWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < num_points;

  Point pt;
  pt.px = live ? pts[3 * i + 0] : 0.f;
  pt.py = live ? pts[3 * i + 1] : 0.f;
  pt.pz = live ? pts[3 * i + 2] : 0.f;
  pt.best = __int_as_float(0x7f800000);  // +inf
  pt.fid = 0;
  pt.qx = 0.f; pt.qy = 0.f; pt.qz = 0.f;
  pt.wind = 0.f;
  // a missing point counts as outside: it does not hold its warp back
  const bool outside = !live || pt.px < ext.lo[0] || pt.px > ext.hi[0] ||
                       pt.py < ext.lo[1] || pt.py > ext.hi[1] ||
                       pt.pz < ext.lo[2] || pt.pz > ext.hi[2];
  const bool wind_needed = kWinding && !(has_ext && __all_sync(kFull, outside));
  const unsigned warp_points = __popc(__ballot_sync(kFull, live));

  // an upper bound on the point's final best: its squared distance to the
  // first corner of every kCluster-th triangle (a well-shaped one, whose
  // computed distance cannot exceed it by more than the margins)
  float bound = __int_as_float(0x7f800000);
  if constexpr (kCull) {
    for (int f = 0; f < num_tri; f += kCluster) {
      float c[9], m = 0.f;
#pragma unroll
      for (int r = 0; r < 9; ++r) {
        c[r] = __ldg(tri + 9 * f + r);
        m = fmaxf(m, fabsf(c[r]));
      }
      const float ax = c[0], ay = c[1], az = c[2];
      if (is_thin(c[3] - ax, c[4] - ay, c[5] - az, c[6] - ax, c[7] - ay, c[8] - az, kThin))
        continue;
      const float eta = kCullAbs * m;
      const float slack = eta * eta * (1.f + 1.f / kCullRel);
      const float dx = ax - pt.px, dy = ay - pt.py, dz = az - pt.pz;
      const float u = (dx * dx + dy * dy + dz * dz) * (1.f + 2.f * kCullRel) + slack;
      bound = fminf(bound, u);
    }
  }

  int pad_id = -1;           // the first padding triangle's face id
  unsigned long long closest_tris = 0, wind_tris = 0;  // per warp, for counters

  for (int f0 = 0; f0 < num_tri; f0 += kTriTile) {
    // ---- load and compact the tile: real triangles in face order ----
    const int f = f0 + threadIdx.x;
    float c[9];
    bool is_pad = false;
    if (f < num_tri) {
      is_pad = true;
#pragma unroll
      for (int r = 0; r < 9; ++r) {
        c[r] = tri[9 * f + r];
        is_pad = is_pad && c[r] == kPad;
      }
    }
    const unsigned pad_mask = __ballot_sync(kFull, f < num_tri && is_pad);
    const unsigned real_mask = __ballot_sync(kFull, f < num_tri && !is_pad);
    __syncthreads();  // the previous tile is no longer read
    if (lane == 0) {
      s_mask[warp] = real_mask;
      s_mask[kWarps + warp] = pad_mask;
    }
    __syncthreads();
    int n = 0, slot = -1;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned m = s_mask[w];
      const unsigned pm = s_mask[kWarps + w];
      if (pad_id < 0 && pm) pad_id = f0 + 32 * w + __ffs(pm) - 1;
      if (w == warp && ((m >> lane) & 1u)) slot = n + __popc(m & ((1u << lane) - 1u));
      n += __popc(m);
    }
    if (slot >= 0) {
      s[0 * kTriTile + slot] = c[0]; s[1 * kTriTile + slot] = c[1]; s[2 * kTriTile + slot] = c[2];
      s[3 * kTriTile + slot] = c[3]; s[4 * kTriTile + slot] = c[4]; s[5 * kTriTile + slot] = c[5];
      s[6 * kTriTile + slot] = c[6]; s[7 * kTriTile + slot] = c[7]; s[8 * kTriTile + slot] = c[8];
      s[9 * kTriTile + slot] = c[3] - c[0];
      s[10 * kTriTile + slot] = c[4] - c[1];
      s[11 * kTriTile + slot] = c[5] - c[2];
      s[12 * kTriTile + slot] = c[6] - c[0];
      s[13 * kTriTile + slot] = c[7] - c[1];
      s[14 * kTriTile + slot] = c[8] - c[2];
      s_id[slot] = f;
    }
    if (n == 0) continue;  // block-uniform: a tile of padding only
    __syncthreads();

    // ---- cluster boxes: kCluster lanes per cluster, one slot each ----
    if constexpr (kCull) {
      const int k = threadIdx.x;
      float lo[3], hi[3], m = 0.f;
      bool thin = false;
#pragma unroll
      for (int d = 0; d < 3; ++d) { lo[d] = __int_as_float(0x7f800000); hi[d] = -lo[d]; }
      if (k < n) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float x = s[d * kTriTile + k], y = s[(3 + d) * kTriTile + k],
                      z = s[(6 + d) * kTriTile + k];
          lo[d] = fminf(fminf(x, y), z);
          hi[d] = fmaxf(fmaxf(x, y), z);
          m = fmaxf(m, fmaxf(-lo[d], hi[d]));
        }
        thin = is_thin(s[9 * kTriTile + k], s[10 * kTriTile + k], s[11 * kTriTile + k],
                       s[12 * kTriTile + k], s[13 * kTriTile + k], s[14 * kTriTile + k], kThin);
      }
#pragma unroll
      for (int off = 1; off < kCluster; off <<= 1) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          lo[d] = fminf(lo[d], __shfl_xor_sync(kFull, lo[d], off));
          hi[d] = fmaxf(hi[d], __shfl_xor_sync(kFull, hi[d], off));
        }
        m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
        thin = __shfl_xor_sync(kFull, (int)thin, off) || thin;
      }
      if (k % kCluster == 0) {
        const float eta = kCullAbs * m;
        const float inf = __int_as_float(0x7f800000);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          s_box[6 * (k / kCluster) + d] = thin ? -inf : lo[d] - eta;
          s_box[6 * (k / kCluster) + 3 + d] = thin ? inf : hi[d] + eta;
        }
      }
      __syncthreads();
    }

    // ---- sweep the tile cluster by cluster ----
    for (int k0 = 0; k0 < n; k0 += kCluster) {
      const int k1 = min(k0 + kCluster, n);
      bool skip = false;
      if constexpr (kCull) {
        const float* b = s_box + 6 * (k0 / kCluster);
        const float dx = fmaxf(fmaxf(b[0] - pt.px, pt.px - b[3]), 0.f);
        const float dy = fmaxf(fmaxf(b[1] - pt.py, pt.py - b[4]), 0.f);
        const float dz = fmaxf(fmaxf(b[2] - pt.pz, pt.pz - b[5]), 0.f);
        const float lb = (dx * dx + dy * dy + dz * dz) * (1.f - kCullRel);
        skip = __all_sync(kFull, !live || lb >= pt.best || lb > bound);
      }
      if (!skip) closest_tris += k1 - k0;
      if constexpr (kWinding) {
        if (wind_needed) {
          wind_tris += k1 - k0;
          if (skip) sweep_slots<false, true>(s, s_id, k0, k1, pt);
          else sweep_slots<true, true>(s, s_id, k0, k1, pt);
          continue;
        }
      }
      if (!skip) sweep_slots<true, false>(s, s_id, k0, k1, pt);
    }
  }

  // every padding triangle is the same degenerate triangle at PAD_COORD:
  // the first one stands for all, merged by (d2, face id)
  if (pad_id >= 0) {
    Tri t;
    t.ax = t.bx = t.cx = kPad; t.ay = t.by = t.cy = kPad; t.az = t.bz = t.cz = kPad;
    t.abx = t.aby = t.abz = t.acx = t.acy = t.acz = 0.f;
    float qx, qy, qz;
    const float d2 = closest_pair(t, pt.px, pt.py, pt.pz, qx, qy, qz);
    if (d2 < pt.best || (d2 == pt.best && pad_id < pt.fid)) {
      pt.best = d2;
      pt.fid = pad_id;
      pt.qx = qx; pt.qy = qy; pt.qz = qz;
    }
  }

  if (counters != nullptr && lane == 0 && warp_points > 0) {
    atomicAdd(counters + 0, closest_tris * warp_points);
    atomicAdd(counters + 1, wind_tris * warp_points);
  }
  if (!live) return;
  out_d2[i] = pt.best;
  out_closest[3 * i + 0] = pt.qx;
  out_closest[3 * i + 1] = pt.qy;
  out_closest[3 * i + 2] = pt.qz;
  out_fid[i] = pt.fid;
  if constexpr (kWinding) out_wind[i] = wind_needed ? pt.wind : 0.f;
}

template <bool kWinding>
int launch(const float* pts, int num_points, const float* tri, int num_tri, float* d2,
           float* closest, int* fid, float* wind, const float* exterior_box,
           unsigned long long* counters, void* stream) {
  if (num_points <= 0) return 0;
  Box ext{};
  const int has_ext = exterior_box != nullptr;
  for (int d = 0; d < 3 && has_ext; ++d) {
    ext.lo[d] = exterior_box[d];
    ext.hi[d] = exterior_box[3 + d];
  }
  const int blocks = (num_points + kThreads - 1) / kThreads;
  closest_point_sweep_kernel<kWinding><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, num_points, tri, num_tri, d2, closest, fid, wind, ext, has_ext, counters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  pts [P,3], tri [F,3,3] float32
// contiguous on the device; outputs d2 [P], closest [P,3], fid [P] int32,
// wind [P] (raw solid-angle sum).  exterior_box: null, or 6 host floats
// (lo xyz, hi xyz) that the caller gives only for a mesh with no boundary,
// grown by its margin.  counters: null, or 2 device uint64 to which the
// launch adds the (point, real triangle) pairs whose closest point, and
// whose solid angle, it evaluated.
// Launches on `stream` and returns the cudaGetLastError() code of the
// launch (0 on success).
extern "C" int pvt_closest_point_sweep(const float* pts, int num_points,
                                       const float* tri, int num_tri,
                                       float* d2, float* closest, int* fid,
                                       float* wind, const float* exterior_box,
                                       unsigned long long* counters, void* stream) {
  return launch<true>(pts, num_points, tri, num_tri, d2, closest, fid, wind, exterior_box,
                      counters, stream);
}

// The same sweep without the winding sum: d2, closest and fid only.
extern "C" int pvt_closest_point_sweep_nowind(const float* pts, int num_points,
                                              const float* tri, int num_tri,
                                              float* d2, float* closest, int* fid,
                                              unsigned long long* counters, void* stream) {
  return launch<false>(pts, num_points, tri, num_tri, d2, closest, fid, nullptr, nullptr,
                       counters, stream);
}

extern "C" const char* pvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
