// Narrow-band mesh SDF query (Hopper): a warp-cooperative cascade over
// each cell's real candidates.
//
// Replaces no Pallas kernel: the JAX package computes this query as plain
// XLA, fused under jit (pytorch_volumetric_tpu/ops/narrow_band.py ::
// _query_impl, with _candidate_query).  Its plain PyTorch version is
// ops/narrow_band.py :: _query_impl, which materialises a [P, K, 10] row
// gather and some fifty elementwise passes over [P, K].
//
// Per point (cell keys (p - lo) * f32(1 / res), the arithmetic of the JAX
// package's compiled query, where XLA folds the division by a constant):
//  1. the cell key (a NaN floor gives key 0 and the rest is clamped to
//     [-1, dims] before the conversion, XLA's saturating convert as far as
//     the grid test sees; utils/batching.py :: float_keys) and the cell's
//     meta row (value, gradient at the center, candidate slot; slot < 0:
//     far field);
//  2. far field: the center's value plus the gradient's first-order step;
//  3. in band: the closest-point cascade (point_triangle.cuh) over the
//     slot's candidate rows (9 corner floats and the face id as an int32
//     bit pattern), the winner chosen as torch.argmin chooses (the first
//     NaN, else the least d2, ties to the smaller row), then the winner's
//     pseudonormal (one 21-float row: face, 3 vertices, 3 edges) at its
//     closest feature for the sign, and the pseudonormal as the gradient
//     within surface_normal_eps of the surface;
//  4. outside the grid: the distance to the surface's bounding box.
//
// What bounds it on an H100: its bound counts the bytes of the real
// candidate rows (40 bytes each; at the bigmesh shape 307 real of K = 430
// per in-band point, 232 MB over the cells hit against a 50 MB L2); past
// them, the issue rate: the cascade is about 200 SASS instructions per
// (point, row) pair under -fmad=false, selects and two IEEE divisions,
// with no product for the tensor cores to take.  A one-thread-per-point
// kernel runs every padding row, and idles the lanes of a warp while a few
// of them run a cascade.  The design (lever A) removes both:
//   Each thread classifies its point; the block lists its in-band points in
//   shared memory and its warps take them in turn, all 32 lanes splitting
//   a point's rows (lane l takes rows k = l (mod 32)), so a round reads 32
//   consecutive rows (1,280 contiguous bytes) and no lane idles while
//   another runs a cascade.  Sharing the block's points among its 4 warps
//   (rather than each warp running its own lanes' points) keeps the warps
//   that hold few in-band lanes from idling beside one that holds many.
//   A cell's list is padded with PAD_COORD rows only at its tail (the
//   native builds fill slots 0..count-1), so the loop stops after the
//   first round that meets one: each point runs ceil(real / 32) rounds,
//   not K iterations.  Each lane keeps its first best row; a shuffle
//   reduction on (d2, k) picks the warp's winner and its lane broadcasts
//   the closest point, feature and face id.
// A cell's rows are still read again for every point in it.  Grouping the
// in-band points by cell and staging each cell's rows in shared memory once
// (lever B, timed on one H100 80GB HBM3 at 700 W; PERF.md, Findings) ran the bigmesh shape with max_k=1024 at
// most 7% faster and the robot arm's launches (3 M points, 0.9% in band)
// 50% slower: the cascade's issue rate, not its bytes, bounds both, so this
// kernel leaves it out.
//
// Every sum and product is written in the plain version's order, and the
// library is built with -fmad=false, so on the card the kernel reproduces
// the plain version's values, gradients and slots bit for bit.  Clamps that
// the plain version writes as torch.clamp keep NaN (clamp_min below), as
// torch.clamp does.
//
// One call of the C entry launches the kernel on the caller's stream, with
// no host synchronisation and no allocation.

#include <climits>

#include <cuda_runtime.h>

#include "point_triangle.cuh"  // Tri, closest_pair

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRow = 10;     // candidate row: a, b, c corners, face id bits
constexpr int kPseudo = 21;  // pseudonormal row: face, vertices A-C, edges AB, BC, CA
constexpr float kPadCoord = 1.0e7f;  // mesh.PAD_COORD: a padding row's corners

struct Grid {
  float lo[3], inv_res[3], res[3], bb_lo[3], bb_hi[3];
  int dims[3], strides[3];
  float eps;
};

// torch.clamp(x, min=lo): NaN stays NaN (fmaxf would return lo)
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// (d2, k) before (d2', k') in torch.argmin's order: the first NaN wins,
// else the least value, ties to the smaller row
__device__ __forceinline__ bool before(float a, int ka, float b, int kb) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ka < kb);
  return a < b || (a == b && ka < kb);
}

struct Best {
  float d2, qx, qy, qz;
  int k, feat, fid;
};

struct Out {
  float val, gx, gy, gz;
};

// Steps 1, 2 and 4: the point's slot (>= 0 in band, -1 far field, -2
// outside the grid) and, unless in band, its result.
__device__ __forceinline__ int classify(const float p[3], const Grid& g,
                                        const float* __restrict__ meta, Out& o) {
  int kc[3];
  bool in_grid = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float fl = floorf((p[d] - g.lo[d]) * g.inv_res[d]);
    // float_keys: NaN -> 0, then [-1, dims] before the int conversion
    const int k = isnan(fl) ? 0
                            : static_cast<int>(fminf(fmaxf(fl, -1.f),
                                                     static_cast<float>(g.dims[d])));
    in_grid = in_grid && k >= 0 && k < g.dims[d];
    kc[d] = min(max(k, 0), g.dims[d] - 1);
  }
  if (!in_grid) {
    float dt[3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      dt[d] = clamp_min(p[d] - g.bb_hi[d], 0.f) - clamp_min(g.bb_lo[d] - p[d], 0.f);
    o.val = sqrtf(dt[0] * dt[0] + dt[1] * dt[1] + dt[2] * dt[2]);
    const float den = clamp_min(o.val, 1e-12f);
    o.gx = dt[0] / den; o.gy = dt[1] / den; o.gz = dt[2] / den;
    return -2;
  }
  const float* m = meta + 5LL * (kc[0] * g.strides[0] + kc[1] * g.strides[1] +
                                 kc[2] * g.strides[2]);
  const int slot = static_cast<int>(__ldg(m + 4));
  if (slot < 0) {
    const float cx = g.lo[0] + (static_cast<float>(kc[0]) + 0.5f) * g.res[0];
    const float cy = g.lo[1] + (static_cast<float>(kc[1]) + 0.5f) * g.res[1];
    const float cz = g.lo[2] + (static_cast<float>(kc[2]) + 0.5f) * g.res[2];
    o.gx = __ldg(m + 1); o.gy = __ldg(m + 2); o.gz = __ldg(m + 3);
    o.val = __ldg(m + 0) + (o.gx * (p[0] - cx) + o.gy * (p[1] - cy) + o.gz * (p[2] - cz));
  }
  return slot;
}

// Step 3 for one point, split across the warp (every lane calls it with the
// same point): lane l evaluates rows k = l, l + 32, ... of the slot's K,
// read as five 8-byte loads, and the loop stops after the first round that
// meets a padding row.  Every lane returns the winner.
__device__ __forceinline__ Best warp_cascade(const float* __restrict__ rows, int K, float px,
                                             float py, float pz, int lane) {
  Best b{__int_as_float(0x7f800000), 0.f, 0.f, 0.f, INT_MAX, 0, 0};  // (+inf, no row)
  for (int base = 0; base < K; base += kWarp) {
    const int k = base + lane;
    float r[kRow] = {};
    if (k < K) {
      const float2* s = reinterpret_cast<const float2*>(rows + static_cast<long long>(k) * kRow);
#pragma unroll
      for (int j = 0; j < kRow / 2; ++j) {
        const float2 v = __ldg(s + j);
        r[2 * j] = v.x;
        r[2 * j + 1] = v.y;
      }
    }
    const bool pad = k < K && r[0] == kPadCoord;
    // padding is tail-only: every row after a round that meets one pads too
    const bool last = __any_sync(kFull, pad);
    if (k < K) {
      Tri t;
      t.ax = r[0]; t.ay = r[1]; t.az = r[2];
      t.bx = r[3]; t.by = r[4]; t.bz = r[5];
      t.cx = r[6]; t.cy = r[7]; t.cz = r[8];
      t.abx = t.bx - t.ax; t.aby = t.by - t.ay; t.abz = t.bz - t.az;
      t.acx = t.cx - t.ax; t.acy = t.cy - t.ay; t.acz = t.cz - t.az;
      float x, y, z;
      int f;
      const float d2 = closest_pair(t, px, py, pz, x, y, z, f);
      if (before(d2, k, b.d2, b.k)) {
        b.d2 = d2; b.k = k;
        b.qx = x; b.qy = y; b.qz = z;
        b.feat = f;
        b.fid = __float_as_int(r[9]);
      }
    }
    if (last) break;
  }
  float d2 = b.d2;
  int k = b.k;
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, d2, off);
    const int ok = __shfl_xor_sync(kFull, k, off);
    if (before(od, ok, d2, k)) { d2 = od; k = ok; }
  }
  // row k sits in lane k % 32, which kept it as its own best (K >= 1, so
  // lane 0 always has row 0 and the winner is a real row index)
  const int src = k & (kWarp - 1);
  Best w;
  w.d2 = d2; w.k = k;
  w.qx = __shfl_sync(kFull, b.qx, src);
  w.qy = __shfl_sync(kFull, b.qy, src);
  w.qz = __shfl_sync(kFull, b.qz, src);
  w.feat = __shfl_sync(kFull, b.feat, src);
  w.fid = __shfl_sync(kFull, b.fid, src);
  return w;
}

// Step 3's end: the sign from the winner's pseudonormal and the gradient.
__device__ __forceinline__ Out finish(const float p[3], const Best& b,
                                      const float* __restrict__ pseudo, float eps) {
  Out o;
  const float dist = sqrtf(b.d2);
  const float* pn = pseudo + static_cast<long long>(b.fid) * kPseudo + 3 * b.feat;
  const float nx = __ldg(pn + 0), ny = __ldg(pn + 1), nz = __ldg(pn + 2);
  const float tx = p[0] - b.qx, ty = p[1] - b.qy, tz = p[2] - b.qz;
  const float sgn = (tx * nx + ty * ny + tz * nz) < 0.f ? -1.f : 1.f;
  o.val = sgn * dist;
  if (dist < eps) {
    // at the surface the direction is degenerate: the pseudonormal
    const float den = clamp_min(sqrtf(nx * nx + ny * ny + nz * nz), 1e-12f);
    o.gx = nx / den; o.gy = ny / den; o.gz = nz / den;
  } else {
    const float den = clamp_min(dist, 1e-12f);
    o.gx = (sgn * tx) / den; o.gy = (sgn * ty) / den; o.gz = (sgn * tz) / den;
  }
  return o;
}

__device__ __forceinline__ void load_point(const float* __restrict__ pts, int i, float p[3]) {
  const long long b = 3LL * i;
  p[0] = pts[b + 0]; p[1] = pts[b + 1]; p[2] = pts[b + 2];
}

__device__ __forceinline__ void store(int i, const Out& o, float* __restrict__ val,
                                      float* __restrict__ grad) {
  const long long b = 3LL * i;
  val[i] = o.val;
  grad[b + 0] = o.gx;
  grad[b + 1] = o.gy;
  grad[b + 2] = o.gz;
}

// One thread classifies each point; the block's in-band points go to a list
// in shared memory that its warps take in turn.  All lanes run each
// cascade; the point's own thread finishes it.
__global__ void __launch_bounds__(kThreads)
query_kernel(const float* __restrict__ pts, int num_points, Grid g,
             const float* __restrict__ meta, const float* __restrict__ cand, int K,
             const float* __restrict__ pseudo, float* __restrict__ out_val,
             float* __restrict__ out_grad, int* __restrict__ out_slot) {
  __shared__ float share_p[3][kThreads];
  __shared__ int share_slot[kThreads], list[kThreads], count;
  __shared__ Best share_best[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & (kWarp - 1);
  const bool live = i < num_points;
  float p[3] = {0.f, 0.f, 0.f};
  if (live) load_point(pts, i, p);
  Out o{0.f, 0.f, 0.f, 0.f};
  const int slot = live ? classify(p, g, meta, o) : -2;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  if (live && slot >= 0) {
    list[atomicAdd(&count, 1)] = threadIdx.x;
    share_p[0][threadIdx.x] = p[0];
    share_p[1][threadIdx.x] = p[1];
    share_p[2][threadIdx.x] = p[2];
    share_slot[threadIdx.x] = slot;
  }
  __syncthreads();
  // the list's order comes from the atomics; no point's result depends on it
  for (int j = threadIdx.x / kWarp; j < count; j += kThreads / kWarp) {
    const int t = list[j];
    const Best b = warp_cascade(cand + static_cast<long long>(share_slot[t]) * K * kRow, K,
                                share_p[0][t], share_p[1][t], share_p[2][t], lane);
    if (lane == 0) share_best[t] = b;
  }
  __syncthreads();
  if (!live) return;
  if (slot >= 0) o = finish(p, share_best[threadIdx.x], pseudo, g.eps);
  store(i, o, out_val, out_grad);
  if (out_slot != nullptr) out_slot[i] = slot;
}

}  // namespace

// C interface, loaded with ctypes.  pts [P,3] float32, meta [C,5], cand
// [S,K,10] (8-byte aligned), pseudo [F,21], all contiguous on the device.
// grid_f: 16 host floats (lo xyz, 1/res xyz, res xyz, surface box lo xyz,
// hi xyz, the surface-normal eps); grid_i: 6 host ints (dims xyz, strides
// xyz).  Outputs val [P], grad [P,3] and, unless null, slot [P] int32 (the
// candidate slot, -1 far field, -2 outside the grid).  Launches on
// `stream` and returns the launch's CUDA error code (0 on success).
extern "C" int pvt_narrow_band_query(const float* pts, int num_points, const float* grid_f,
                                     const int* grid_i, const float* meta, const float* cand,
                                     int K, const float* pseudo, float* val, float* grad,
                                     int* slot, void* stream_ptr) {
  if (num_points <= 0) return 0;
  Grid g;
  for (int d = 0; d < 3; ++d) {
    g.lo[d] = grid_f[d];
    g.inv_res[d] = grid_f[3 + d];
    g.res[d] = grid_f[6 + d];
    g.bb_lo[d] = grid_f[9 + d];
    g.bb_hi[d] = grid_f[12 + d];
    g.dims[d] = grid_i[d];
    g.strides[d] = grid_i[3 + d];
  }
  g.eps = grid_f[15];
  const int blocks = (num_points + kThreads - 1) / kThreads;
  query_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      pts, num_points, g, meta, cand, K, pseudo, val, grad, slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
