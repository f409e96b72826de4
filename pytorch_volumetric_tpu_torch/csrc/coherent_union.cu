// The coherent per-tile nearest union (Hopper): keys, brick anchor, value
// cells, AABB fallback, first-min winner, tile candidates, residual rows and
// rotation, for every (configuration, tile) in one pass over the points.
//
// Replaces no Pallas kernel: the JAX package runs this union as one jitted
// XLA program with a custom VJP (pytorch_volumetric_tpu/sdf.py ::
// _coherent_union_lookup_tile, and _coherent_union_values for values only).
// Its plain PyTorch version is the port's eager chain in
// pytorch_volumetric_tpu_torch/sdf.py (_union_tile_eval, _union_values_eval:
// _nearest_keys, _nearest_anchor, _nearest_cells, _nearest_select,
// _first_min, _tile_candidate_ids, _finish_tile_union), about 260 launches a
// north-star chunk, each writing its [C, B, FS, seg] intermediates to
// device memory (~490 bytes a link-point).
//
// What bounds it on an H100: bytes.  Per point it must read its world point
// (12 bytes, once over every configuration and child), one value cell of
// each child's brick row, the winner's gradient (a gradient-brick cell, or
// its packed row in a middle tile) and its rotation, and write val, g_obj,
// win (int64) and g_link: 36 bytes a (configuration, point), plus the
// tables' cells, each counted once however many points, tiles and
// configurations read it (chip_smoke.union_bound counts each run's),
// against little arithmetic: each link-frame point is formed in registers
// from the world point and the child's obj_to_link row T[c, b] (12 loads
// that a warp broadcasts, 9 products, 9 sums) and never stored.  The
// design keeps every intermediate in registers:
//   One lane owns one point and loops over the children; the seg points of
//   a tile are seg consecutive lanes of one warp (floor(32 / seg) tiles a
//   warp), so each per-tile reduction (the brick anchor's min key, the
//   tile's distinct winners) is a redux.sync over the tile's lane mask.
//   For seg > 32 a warp owns a tile and its lanes loop over the tile's
//   points: the anchors go to shared memory first, then each point runs
//   the union, then each point is finished from its winner.
//   The children's tables are read in place through a device array of
//   pointers (no concatenation), their small fields staged once a block in
//   shared memory.
//   The residual lane's capacity needs a global rank of the middle tiles
//   (tiles with >= 4 distinct in-grid winners), in tile order.  The main
//   kernel writes every middle tile's exact residual rows and a per-tile
//   flag; a cumsum of the flags and the poison kernel below then put NaN in
//   the middle tiles beyond the capacity, at their in-grid points.
//
// Every sum and product is written in the plain version's order, and the
// library is built with -fmad=false, so on the card the kernel reproduces
// the plain version bit for bit:
//  - keys round((p - lo) * inv_res) half to even (rintf); NaN keys are 0 and
//    the rest is clamped to [-1, n] before the conversion (float_keys);
//  - the AABB distance sqrt((d0^2 + d2^2) + d1^2): the order of
//    torch.linalg.vector_norm's CUDA reduction over a last dimension of 3
//    (two threads per output: elements 0 and 2 in one, 1 in the other,
//    then combined);
//  - the winner as torch.argmin picks it (the first NaN, else the first
//    least value);
//  - values only as amin's CUDA reduction folds the children: four
//    accumulators (child c into c % 4), then folded in order, NaN kept;
//  - each link-frame point in transforms.transform_points' term order,
//    ((T00 x + T01 y) + T02 z) + T03 for row 0, likewise rows 1 and 2;
//  - the rotation in transforms.rotate_vectors' term order;
//  - torch.clamp keeps NaN, as clamp_nan below does.
//
// The union's backward (pvt_tile_union_backward, below) goes from the saved
// winners and link-frame gradients and the outputs' cotangents straight to
// the cotangents of the children's obj_to_link rows T and rotations Rb.  Its
// plain version is ops/coherent_union.py :: tile_union_cotangents_plain;
// the dense formula it replaces wrote a [C, B, N, 3] point cotangent and a
// [C, B, N, 3, 3] outer product, and reduced them through
// transforms.transform_points' backward.  Per (configuration b, point p)
// with winner c it adds 21 terms into (b, c):
//   dT[c, b][o, j] += (ct_val * g_link[o]) * points[p, j]   (j < 3)
//   dT[c, b][o, 3] += ct_val * g_link[o]
//   dRb[c, b][o, i] += ct_g[o] * g_link[i]
// What bounds it: bytes, 36 a (b, p) (win int64, g_link, ct_val, ct_g) and
// 12 a point, against 42 operations.  A block owns one b and 512 points,
// keeps them in registers, and for each child that wins one of them sums the
// terms in registers, then across the warp (a reduce-scatter of shuffles)
// and the block (shared memory), in a fixed order; a second pass sums the
// blocks' partials in a fixed order.  No float atomics: a call repeats its
// bits.  (Blocks of 64 to 256 threads and 2 to 4 points a thread time within
// ~20% of one another on the north-star chunk; 8 points a thread, at 156
// registers, is 40% slower.)
// The dense formula multiplied every child's terms by its 0/1 mask, so a
// non-finite ct_val * g_link[o], ct_g[o], g_link[i] or points[p, j] made the
// terms of every child other than the winner NaN (0 * inf): each point's
// 21-bit mask of such terms is OR-ed (integer atomics, exact) into every other
// child's mask, and a masked sum is NaN.
//
// One call of each C entry launches one kernel on the caller's stream (the
// backward's two), with no host synchronisation and no allocation.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSmallThreads = 256;  // seg <= 32: floor(32 / seg) tiles a warp
constexpr int kMultiThreads = 128;  // seg > 32: one tile a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCells = 64;          // a 4x4x4 brick row
constexpr int kNone = INT_MAX;      // no winner in a distinct-winner list
constexpr unsigned kInfBits = 0x7f800000u;  // +inf, amin's identity
constexpr int kNumPtrs = 9;         // per-child device pointers, in this order:
// lo [3] f32, inv_res [3] f32, n [3] i64, strides [3] i64, bstrides [3] i64,
// bb [3, 2] f32, bricks [NB, 64] f32, gbricks [NB, 3, 64] f32 (or null),
// vg [G, 4] f32

// One child's small fields, staged in shared memory.
struct Child {
  float lo[3], inv_res[3], bb_lo[3], bb_hi[3], n_f[3];
  int n[3];
  long long strides[3], bstrides[3];
  const float* bricks;
  const float* gbricks;
  const float* vg;
};

__device__ void stage_children(const long long* __restrict__ desc, int C, Child* sh) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long* d = desc + static_cast<long long>(c) * kNumPtrs;
    const float* lo = reinterpret_cast<const float*>(d[0]);
    const float* inv = reinterpret_cast<const float*>(d[1]);
    const long long* n = reinterpret_cast<const long long*>(d[2]);
    const long long* st = reinterpret_cast<const long long*>(d[3]);
    const long long* bst = reinterpret_cast<const long long*>(d[4]);
    const float* bb = reinterpret_cast<const float*>(d[5]);
    Child ch;
    for (int k = 0; k < 3; ++k) {
      ch.lo[k] = lo[k];
      ch.inv_res[k] = inv[k];
      ch.bb_lo[k] = bb[2 * k];
      ch.bb_hi[k] = bb[2 * k + 1];
      ch.n[k] = static_cast<int>(n[k]);
      ch.n_f[k] = static_cast<float>(n[k]);  // float_keys' n.to(float32)
      ch.strides[k] = st[k];
      ch.bstrides[k] = bst[k];
    }
    ch.bricks = reinterpret_cast<const float*>(d[6]);
    ch.gbricks = reinterpret_cast<const float*>(d[7]);
    ch.vg = reinterpret_cast<const float*>(d[8]);
    sh[c] = ch;
  }
}

// torch.clamp(x, lo, hi) and clamp(min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// A point's in-grid mask and clamped keys in one child's grid (_voxel_keys).
__device__ __forceinline__ bool voxel_keys(const float p[3], const Child& ch, int kc[3]) {
  bool valid = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float r = rintf(__fmul_rn(__fsub_rn(p[d], ch.lo[d]), ch.inv_res[d]));
    const int k = isnan(r) ? 0 : static_cast<int>(fminf(fmaxf(r, -1.f), ch.n_f[d]));
    valid = valid && k >= 0 && k < ch.n[d];
    kc[d] = min(max(k, 0), ch.n[d] - 1);
  }
  return valid;
}

// The AABB fallback's offset p - clamp(p, lo, hi) and its norm.
__device__ __forceinline__ float aabb_offset(const float p[3], const Child& ch, float dt[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) dt[d] = __fsub_rn(p[d], clamp_nan(p[d], ch.bb_lo[d], ch.bb_hi[d]));
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dt[0], dt[0]), __fmul_rn(dt[2], dt[2])),
                         __fmul_rn(dt[1], dt[1])));
}

// One child at one point, given the tile's anchor corner (min key / 2).
struct Eval {
  float v;
  bool valid;
  int cell;
  long long row, flat;
};

__device__ __forceinline__ Eval eval_child(const float p[3], const Child& ch, const int kc[3],
                                           bool valid, const int corner2[3]) {
  Eval e;
  e.valid = valid;
  e.row = 0;
  e.flat = 0;
  int off[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    e.row += static_cast<long long>(corner2[d]) * ch.bstrides[d];
    e.flat += static_cast<long long>(kc[d]) * ch.strides[d];
    off[d] = min(kc[d] - 2 * corner2[d], 3);
  }
  e.cell = off[0] * 16 + off[1] * 4 + off[2];
  if (valid) {
    e.v = __ldg(ch.bricks + e.row * kCells + e.cell);
  } else {
    float dt[3];
    e.v = aabb_offset(p, ch, dt);
  }
  return e;
}

// v before the running best b in torch.argmin's order (children in order)
__device__ __forceinline__ bool better(float v, float b) {
  return isnan(v) ? !isnan(b) : v < b;
}

// amin's CUDA combine: the first argument unless the second is less
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

__device__ __forceinline__ float fold4(const float acc[4]) {
  return min_nan(min_nan(min_nan(acc[0], acc[1]), acc[2]), acc[3]);
}

// A lane's distinct in-grid winners: the four smallest, ascending, kNone
// padded.  The tile's k-th smallest distinct winner (k <= 4) is in some
// lane's list.
struct Distinct4 {
  int w[4];
};

__device__ __forceinline__ void distinct_init(Distinct4& s) {
  s.w[0] = s.w[1] = s.w[2] = s.w[3] = kNone;
}

__device__ __forceinline__ void distinct_add(Distinct4& s, int w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (s.w[k] == w) return;
    if (w < s.w[k]) {
      const int t = s.w[k];
      s.w[k] = w;
      w = t;
    }
  }
}

// The least list entry above x (kNone if none)
__device__ __forceinline__ int distinct_above(const Distinct4& s, int x) {
  int r = kNone;
#pragma unroll
  for (int k = 3; k >= 0; --k)
    if (s.w[k] > x) r = s.w[k];
  return r;
}

// True iff the tile (the lanes of mask) has >= 4 distinct in-grid winners:
// a point whose winner is none of _tile_candidate_ids' three candidates
// (the least, the greatest and the least remaining winner).
__device__ __forceinline__ bool tile_is_middle(const Distinct4& s, unsigned mask) {
  int d = __reduce_min_sync(mask, s.w[0]);
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (d == kNone) return false;
    d = __reduce_min_sync(mask, distinct_above(s, d));
  }
  return d != kNone;
}

// A point's result from its winner w (row, cell and flat in w's tables)
// and its tile's middle flag; writes val, g_obj, win and g_link.
__device__ __forceinline__ void finish_point(long long i, int b, int B, const float p[3],
                                             const Child& ch, const Eval& e, int w,
                                             bool middle, const float* __restrict__ Rb,
                                             float* __restrict__ val, float* __restrict__ g_obj,
                                             long long* __restrict__ win,
                                             float* __restrict__ g_link) {
  float g[3];
  if (!e.valid) {
    // _aabb_distance_grad: dtotal / clamp(dist, min=1e-12)
    float dt[3];
    const float den = clamp_min_nan(aabb_offset(p, ch, dt), 1e-12f);
#pragma unroll
    for (int d = 0; d < 3; ++d) g[d] = __fdiv_rn(dt[d], den);
  } else if (middle) {
    // the residual lane: the winner's packed (value, grad) row
    const float* r = ch.vg + e.flat * 4;
    g[0] = __ldg(r + 1); g[1] = __ldg(r + 2); g[2] = __ldg(r + 3);
  } else {
    // a tile candidate: the winner's gradient-brick cell
    const float* r = ch.gbricks + e.row * (3 * kCells) + e.cell;
    g[0] = __ldg(r); g[1] = __ldg(r + kCells); g[2] = __ldg(r + 2 * kCells);
  }
  const float* R = Rb + (static_cast<long long>(w) * B + b) * 9;
  float o[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    o[r] = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(R + 3 * r), g[0]), __fmul_rn(__ldg(R + 3 * r + 1), g[1])),
                     __fmul_rn(__ldg(R + 3 * r + 2), g[2]));
  val[i] = e.v;
  win[i] = w;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    g_link[3 * i + d] = g[d];
    g_obj[3 * i + d] = o[d];
  }
}

struct Args {
  const float* points;  // [F, 3] world points, shared by every configuration
  const float* T;       // [C, B, 4, 4] obj_to_link rows
  const float* Rb;      // [C, B, 3, 3]
  const long long* desc;
  int C, B, FS, seg;
  long long F, NT, N;   // points a configuration FS * seg, tiles B * FS, points NT * seg
  float* val;         // [N]
  float* g_obj;       // [N, 3]
  long long* win;     // [N]
  float* g_link;      // [N, 3]
  int* middle;        // [NT] (C > 3)
  unsigned char* mask;  // [N]: in-grid points of middle tiles (C > 3)
};

// Point i (of [B, FS, seg]) of configuration b in child c's frame: its world
// point through T[c, b], as transforms.transform_points rounds it.
__device__ __forceinline__ void load_point(const Args& a, int c, int b, long long i, float p[3]) {
  const float* w = a.points + (i - static_cast<long long>(b) * a.F) * 3;
  const float x = __ldg(w), y = __ldg(w + 1), z = __ldg(w + 2);
  const float* m = a.T + (static_cast<long long>(c) * a.B + b) * 16;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    p[r] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(m + 4 * r), x),
                                         __fmul_rn(__ldg(m + 4 * r + 1), y)),
                               __fmul_rn(__ldg(m + 4 * r + 2), z)),
                     __ldg(m + 4 * r + 3));
}

// seg <= 32: floor(32 / seg) tiles a warp, one point a lane, the union
// child by child with the running winner in registers.
template <bool kValuesOnly>
__global__ void __launch_bounds__(kSmallThreads) union_small(Args a) {
  extern __shared__ Child sh[];
  stage_children(a.desc, a.C, sh);
  __syncthreads();
  const int lane = threadIdx.x & (kWarp - 1);
  const int per_warp = kWarp / a.seg;
  const int group = lane / a.seg;
  const long long warp = (static_cast<long long>(blockIdx.x) * kSmallThreads + threadIdx.x) / kWarp;
  const long long tile = warp * per_warp + group;
  if (group >= per_warp || tile >= a.NT) return;  // whole tiles leave together
  const unsigned mask = a.seg == kWarp ? kFull : ((1u << a.seg) - 1u) << (group * a.seg);
  const long long i = tile * a.seg + (lane - group * a.seg);
  const int b = static_cast<int>(tile / a.FS);

  const float inf = __int_as_float(kInfBits);
  float acc[4] = {inf, inf, inf, inf};  // values only
  Eval best;
  float bp[3];
  int bw = 0, bcorner[3] = {0, 0, 0};
  for (int c = 0; c < a.C; ++c) {
    const Child& ch = sh[c];
    float p[3];
    load_point(a, c, b, i, p);
    int kc[3], corner2[3];
    const bool valid = voxel_keys(p, ch, kc);
#pragma unroll
    for (int d = 0; d < 3; ++d) corner2[d] = __reduce_min_sync(mask, kc[d]) / 2;
    const Eval e = eval_child(p, ch, kc, valid, corner2);
    if (kValuesOnly) {
      acc[c & 3] = min_nan(acc[c & 3], e.v);
    } else if (c == 0 || better(e.v, best.v)) {
      best = e;
      bw = c;
#pragma unroll
      for (int d = 0; d < 3; ++d) { bp[d] = p[d]; bcorner[d] = corner2[d]; }
    }
  }
  if (kValuesOnly) {
    a.val[i] = fold4(acc);
    return;
  }
  bool middle = false;
  if (a.C > 3) {
    Distinct4 s;
    distinct_init(s);
    if (best.valid) distinct_add(s, bw);
    middle = tile_is_middle(s, mask);
    if (i == tile * a.seg) a.middle[tile] = middle;
    if (middle) a.mask[i] = best.valid;
  }
  finish_point(i, b, a.B, bp, sh[bw], best, bw, middle, a.Rb, a.val, a.g_obj, a.win, a.g_link);
}

// seg > 32: one tile a warp, each lane looping over the tile's points j =
// lane, lane + 32, ...: the children's anchors first (shared memory), then
// the union at each point (val and win written), then, once the tile's
// middle flag is known, each point finished from its winner.
template <bool kValuesOnly>
__global__ void __launch_bounds__(kMultiThreads) union_multi(Args a) {
  extern __shared__ Child sh[];
  int* corners = reinterpret_cast<int*>(sh + a.C) + (threadIdx.x / kWarp) * 3 * a.C;
  stage_children(a.desc, a.C, sh);
  __syncthreads();
  const int lane = threadIdx.x & (kWarp - 1);
  const long long tile = (static_cast<long long>(blockIdx.x) * kMultiThreads + threadIdx.x) / kWarp;
  if (tile >= a.NT) return;  // whole warps leave together
  const long long i0 = tile * a.seg;
  const int b = static_cast<int>(tile / a.FS);

  for (int c = 0; c < a.C; ++c) {
    int m[3] = {INT_MAX, INT_MAX, INT_MAX};
    for (int j = lane; j < a.seg; j += kWarp) {
      float p[3];
      int kc[3];
      load_point(a, c, b, i0 + j, p);
      voxel_keys(p, sh[c], kc);
#pragma unroll
      for (int d = 0; d < 3; ++d) m[d] = min(m[d], kc[d]);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int mk = __reduce_min_sync(kFull, m[d]);
      if (lane == 0) corners[3 * c + d] = mk / 2;
    }
  }
  __syncwarp();

  Distinct4 s;
  distinct_init(s);
  for (int j = lane; j < a.seg; j += kWarp) {
    const long long i = i0 + j;
    const float inf = __int_as_float(kInfBits);
    float acc[4] = {inf, inf, inf, inf};
    float best = 0.f;
    int bw = 0;
    bool bvalid = false;
    for (int c = 0; c < a.C; ++c) {
      float p[3];
      int kc[3];
      load_point(a, c, b, i, p);
      const bool valid = voxel_keys(p, sh[c], kc);
      const Eval e = eval_child(p, sh[c], kc, valid, corners + 3 * c);
      if (kValuesOnly) {
        acc[c & 3] = min_nan(acc[c & 3], e.v);
      } else if (c == 0 || better(e.v, best)) {
        best = e.v;
        bw = c;
        bvalid = valid;
      }
    }
    if (kValuesOnly) {
      a.val[i] = fold4(acc);
    } else {
      a.win[i] = bw;  // read back below by this lane
      if (bvalid) distinct_add(s, bw);
    }
  }
  if (kValuesOnly) return;
  const bool middle = a.C > 3 && tile_is_middle(s, kFull);
  if (a.C > 3 && lane == 0) a.middle[tile] = middle;
  for (int j = lane; j < a.seg; j += kWarp) {
    const long long i = i0 + j;
    const int w = static_cast<int>(a.win[i]);
    float p[3];
    int kc[3];
    load_point(a, w, b, i, p);
    const bool valid = voxel_keys(p, sh[w], kc);
    const Eval e = eval_child(p, sh[w], kc, valid, corners + 3 * w);
    if (middle) a.mask[i] = valid;
    finish_point(i, b, a.B, p, sh[w], e, w, middle, a.Rb, a.val, a.g_obj, a.win, a.g_link);
  }
}

// The residual lane's overflow: NaN in g_link and g_obj at the in-grid
// points of the middle tiles whose rank (the inclusive cumsum of the flags
// less one) is at or beyond the capacity.  g_link takes the NaN that
// torch.where writes from Python's float("nan"); g_obj the canonical NaN
// that the card's arithmetic gives for the rotation of a NaN vector.
__global__ void poison(const int* __restrict__ middle, const int* __restrict__ rank, int seg,
                       long long N, int cap, const unsigned char* __restrict__ mask,
                       float* __restrict__ g_obj, float* __restrict__ g_link) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long long t = i / seg;
  if (!middle[t] || rank[t] <= cap || !mask[i]) return;
  const float nan_where = __int_as_float(0x7fc00000);
  const float nan_card = __int_as_float(0x7fffffff);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    g_link[3 * i + d] = nan_where;
    g_obj[3 * i + d] = nan_card;
  }
}

constexpr int kBwdThreads = 128;
constexpr int kBwdPer = 4;  // points a thread
constexpr int kBwdPoints = kBwdThreads * kBwdPer;  // points a block
constexpr int kBwdTerms = 21;  // dT's 3 x 4, then dRb's 3 x 3
constexpr int kBwdGroups = 12;  // the second pass: 12 x 21 threads a (b, c)

struct BwdArgs {
  const long long* win;  // [B, N]
  const float* g_link;   // [B, N, 3]
  const float* ct_val;   // [B, N]
  const float* ct_g;     // [B, N, 3]
  const float* points;   // [N, 3]
  int C, B;
  long long N, X;        // points, blocks over them
  float* partial;        // [B, C, X, kBwdTerms]
  float* d_T;            // [C, B, 4, 4]
  float* d_Rb;           // [C, B, 3, 3]
};

// One step of a warp's reduce-scatter of v[0, 2S): a lane keeps the half
// of its values that its bit S selects, moved to v[0, S), and adds its
// partner's copy of that half.  (S a template argument, so v stays in
// registers.)
template <int S>
__device__ __forceinline__ void scatter_step(float (&v)[kWarp], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float send = upper ? v[k] : v[k + S];
    const float keep = upper ? v[k + S] : v[k];
    v[k] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, S));
  }
}

// One block: configuration b = blockIdx.x % B, points x * kBwdPoints on
// (x = blockIdx.x / B, so the B blocks that read one tile of points run
// together).  Writes partial[b, c, x, :] for every child c.
__global__ void __launch_bounds__(kBwdThreads) union_backward_partial(BwdArgs a) {
  extern __shared__ unsigned masks[];  // [C] NaN terms, then [C] present
  __shared__ float warp_sums[2][kBwdThreads / kWarp][kBwdTerms];
  unsigned* nan_terms = masks;
  unsigned* present = masks + a.C;
  const int b = static_cast<int>(blockIdx.x % a.B);
  const long long x = blockIdx.x / a.B;
  for (int c = threadIdx.x; c < 2 * a.C; c += blockDim.x) masks[c] = 0u;
  __syncthreads();

  int w[kBwdPer];
  float q[kBwdPer][3], g[kBwdPer][3], cg[kBwdPer][3], p[kBwdPer][3];
#pragma unroll
  for (int r = 0; r < kBwdPer; ++r) {
    const long long i = x * kBwdPoints + r * kBwdThreads + threadIdx.x;
    w[r] = -1;
    if (i >= a.N) continue;
    const long long bi = static_cast<long long>(b) * a.N + i;
    const long long wl = __ldg(a.win + bi);
    w[r] = (wl >= 0 && wl < a.C) ? static_cast<int>(wl) : a.C;  // a.C: no child's
    const float cv = __ldg(a.ct_val + bi);
    unsigned bad = 0u;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      g[r][d] = __ldg(a.g_link + 3 * bi + d);
      cg[r][d] = __ldg(a.ct_g + 3 * bi + d);
      p[r][d] = __ldg(a.points + 3 * i + d);
      q[r][d] = __fmul_rn(cv, g[r][d]);
    }
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      if (!isfinite(q[r][o])) bad |= 0xfu << (4 * o);
      if (!isfinite(cg[r][o])) bad |= 0x7u << (12 + 3 * o);
      if (!isfinite(p[r][o])) bad |= 0x111u << o;          // column o of dT
      if (!isfinite(g[r][o])) bad |= 0x49u << (12 + o);    // column o of dRb
    }
    if (bad) {
      for (int c = 0; c < a.C; ++c)
        if (c != w[r]) atomicOr(nan_terms + c, bad);
    }
    if (w[r] < a.C) present[w[r]] = 1u;
  }
  __syncthreads();

  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  int n_present = 0;
  for (int c = 0; c < a.C; ++c) {
    float* out = a.partial + ((static_cast<long long>(b) * a.C + c) * a.X + x) * kBwdTerms;
    const unsigned nan_c = nan_terms[c];
    if (!present[c]) {  // the same branch in every thread
      if (threadIdx.x < kBwdTerms)
        out[threadIdx.x] = (nan_c >> threadIdx.x) & 1u ? __int_as_float(0x7fffffff) : 0.f;
      continue;
    }
    // the terms, padded to a warp's 32 for the reduction below
    float v[kWarp];
#pragma unroll
    for (int k = 0; k < kWarp; ++k) v[k] = 0.f;
    bool mine = false;
#pragma unroll
    for (int r = 0; r < kBwdPer; ++r) {
      if (w[r] != c) continue;
      mine = true;
#pragma unroll
      for (int o = 0; o < 3; ++o) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          v[4 * o + j] = __fadd_rn(v[4 * o + j], __fmul_rn(q[r][o], p[r][j]));
          v[12 + 3 * o + j] = __fadd_rn(v[12 + 3 * o + j], __fmul_rn(cg[r][o], g[r][j]));
        }
        v[4 * o + 3] = __fadd_rn(v[4 * o + 3], q[r][o]);
      }
    }
    if (__any_sync(kFull, mine)) {
      // reduce-scatter across the warp: lane k ends with the warp's sum of
      // term k in v[0] (31 shuffles, not 21 x 5)
      scatter_step<16>(v, lane);
      scatter_step<8>(v, lane);
      scatter_step<4>(v, lane);
      scatter_step<2>(v, lane);
      scatter_step<1>(v, lane);
    }
    float* sums = warp_sums[n_present & 1][warp];
    if (lane < kBwdTerms) sums[lane] = v[0];
    __syncthreads();  // double-buffered: the next child writes the other buffer
    if (threadIdx.x < kBwdTerms) {
      float t = 0.f;
      for (int u = 0; u < kBwdThreads / kWarp; ++u)
        t = __fadd_rn(t, warp_sums[n_present & 1][u][threadIdx.x]);
      out[threadIdx.x] = (nan_c >> threadIdx.x) & 1u ? __int_as_float(0x7fffffff) : t;
    }
    ++n_present;
  }
}

// One block a (b, c) = blockIdx.x / C, % C: thread (group, k) sums the
// partials x = group, group + kBwdGroups, ... of term k (consecutive threads
// on consecutive floats), then thread k sums the groups in order and writes
// d_T[c, b] (its last row 0) and d_Rb[c, b].
__global__ void __launch_bounds__(kBwdGroups * kBwdTerms) union_backward_finish(BwdArgs a) {
  __shared__ float sums[kBwdGroups][kBwdTerms];
  const int b = static_cast<int>(blockIdx.x / a.C), c = static_cast<int>(blockIdx.x % a.C);
  const int group = threadIdx.x / kBwdTerms, k = threadIdx.x % kBwdTerms;
  const float* in = a.partial + (static_cast<long long>(b) * a.C + c) * a.X * kBwdTerms;
  float s = 0.f;
  for (long long x = group; x < a.X; x += kBwdGroups)
    s = __fadd_rn(s, __ldg(in + x * kBwdTerms + k));
  sums[group][k] = s;
  __syncthreads();
  const long long cb = static_cast<long long>(c) * a.B + b;
  if (threadIdx.x < kBwdTerms) {
    float t = 0.f;
    for (int v = 0; v < kBwdGroups; ++v) t = __fadd_rn(t, sums[v][threadIdx.x]);
    if (threadIdx.x < 12)
      a.d_T[cb * 16 + threadIdx.x] = t;  // rows 0-2 of [4, 4]
    else
      a.d_Rb[cb * 9 + threadIdx.x - 12] = t;
  } else if (threadIdx.x < kBwdTerms + 4) {
    a.d_T[cb * 16 + 12 + threadIdx.x - kBwdTerms] = 0.f;
  }
}

template <typename Kernel>
int launch(Kernel kernel, long long blocks, int threads, size_t smem, cudaStream_t stream,
           const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  points [FS * seg, 3], T [C, B, 4, 4]
// and Rb [C, B, 3, 3] float32, contiguous on the device (Rb unread with
// values_only); desc [C, 9] int64 on the device: each child's pointers in
// the order of kNumPtrs' note.  Outputs val [N] and, unless values_only,
// g_obj [N, 3], win [N] int64, g_link [N, 3] and, for C > 3, middle [B * FS]
// int32 and mask [N] uint8 (written in middle tiles only).  Launches on
// `stream` and returns the launch's CUDA error code (0 on success).
extern "C" int pvt_coherent_union_tile(const float* points, const float* T, const float* Rb,
                                       const long long* desc, int C, int B, int FS, int seg,
                                       int values_only, float* val, float* g_obj,
                                       long long* win, float* g_link, int* middle,
                                       unsigned char* mask, void* stream_ptr) {
  Args a{points, T, Rb, desc, C, B, FS, seg, static_cast<long long>(FS) * seg,
         static_cast<long long>(B) * FS, 0, val, g_obj, win, g_link, middle, mask};
  a.N = a.NT * seg;
  if (a.N <= 0 || C <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t staged = sizeof(Child) * C;
  if (seg <= kWarp) {
    const long long per_block = (kSmallThreads / kWarp) * (kWarp / seg);
    const long long blocks = (a.NT + per_block - 1) / per_block;
    return values_only ? launch(union_small<true>, blocks, kSmallThreads, staged, stream, a)
                       : launch(union_small<false>, blocks, kSmallThreads, staged, stream, a);
  }
  const long long per_block = kMultiThreads / kWarp;
  const long long blocks = (a.NT + per_block - 1) / per_block;
  const size_t smem = staged + sizeof(int) * 3 * C * per_block;
  return values_only ? launch(union_multi<true>, blocks, kMultiThreads, smem, stream, a)
                     : launch(union_multi<false>, blocks, kMultiThreads, smem, stream, a);
}

// middle [B * FS] int32 and rank [B * FS] int32 (its inclusive cumsum),
// mask [N] uint8, g_obj and g_link [N, 3] float32 (updated in place).
extern "C" int pvt_coherent_union_poison(const int* middle, const int* rank, int seg,
                                         long long N, int cap, const unsigned char* mask,
                                         float* g_obj, float* g_link, void* stream_ptr) {
  if (N <= 0) return 0;
  constexpr int kThreads = 256;
  const long long blocks = (N + kThreads - 1) / kThreads;
  poison<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      middle, rank, seg, N, cap, mask, g_obj, g_link);
  return static_cast<int>(cudaGetLastError());
}

// The floats of the backward's scratch buffer for C children, B
// configurations and N points a configuration.
extern "C" long long pvt_tile_union_backward_scratch(int C, int B, long long N) {
  return static_cast<long long>(C) * B * ((N + kBwdPoints - 1) / kBwdPoints) * kBwdTerms;
}

// win [B, N] int64, g_link [B, N, 3], ct_val [B, N], ct_g [B, N, 3] and
// points [N, 3] float32, contiguous on the device; scratch of
// pvt_tile_union_backward_scratch(C, B, N) floats.  Writes d_T [C, B, 4, 4]
// and d_Rb [C, B, 3, 3] (float32, every element).  Launches two kernels on
// `stream` and returns the first CUDA error code (0 on success).
extern "C" int pvt_tile_union_backward(const long long* win, const float* g_link,
                                       const float* ct_val, const float* ct_g,
                                       const float* points, int C, int B, long long N,
                                       float* scratch, float* d_T, float* d_Rb,
                                       void* stream_ptr) {
  if (C <= 0 || B <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  BwdArgs a{win, g_link, ct_val, ct_g, points, C, B, N, (N + kBwdPoints - 1) / kBwdPoints,
            scratch, d_T, d_Rb};
  if (a.X > 0) {
    union_backward_partial<<<static_cast<unsigned>(a.X * B), kBwdThreads,
                             2 * C * sizeof(unsigned), stream>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  union_backward_finish<<<static_cast<unsigned>(C * B), kBwdGroups * kBwdTerms, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
