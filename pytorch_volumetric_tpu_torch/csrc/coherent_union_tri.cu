// The coherent per-tile TRILINEAR union (Hopper), CU-T: trilinear cells,
// brick anchor, 8-corner value lerps, AABB fallback, first-min winner, the
// winner's gradient lerp (its gradient brick, or its exact 8 packed rows in
// a residual-lane tile) and rotation, for every (configuration, tile) in one
// pass over the points.
//
// Replaces no Pallas kernel: the JAX package runs this union as one jitted
// XLA program (pytorch_volumetric_tpu/sdf.py :: _coherent_union_lookup_tile_tri).
// Its plain PyTorch version is the port's eager chain in
// pytorch_volumetric_tpu_torch/sdf.py (_union_tile_tri_eval and, values only,
// _union_values_tri_eval: _trilinear_anchor, _lerp5 over each child's 5x5x5
// value bricks, _first_min, _tile_candidate_ids, the candidates' gradient
// lerps, the residual lane's 8-corner rows, _finish_tile_union) after
// _link_points, about 1,300 launches a north-star chunk, each writing its
// [C, B, FS, seg] intermediates to device memory.  The nearest union is
// coherent_union.cu (CU); the two are separate kernels by design, and this
// one calls CU's poison pass (pvt_coherent_union_poison) for the residual
// lane's overflow.
//
// What bounds it on an H100: its floor at the north-star chunk is 0.32 ms by
// bytes and 0.24 ms by operations (chip_smoke.union_tri_bound); it runs at
// ~10x that, held by each child's chain of dependent L1/L2 reads of brick
// rows and warp reductions, not by device memory.  Per (configuration,
// point) it forms each child's
// link-frame point in registers from the world point and the child's
// obj_to_link row (12 loads that a warp broadcasts, 9 products, 9 sums),
// its trilinear cell, the 8 weights (16 products) and the lerp of 8 cells
// of the child's 500-byte value brick row (8 products, 8 sums), then the
// winner's gradient lerp (24 reads) and rotation.  Every lane of a tile
// reads the same brick row, so the rows stay in L1; the bytes that must
// reach device memory are each world point once, the outputs (val, g_obj,
// win int64, g_link: 36 bytes a (configuration, point)) and the distinct
// brick cells.  The design keeps every intermediate in registers:
//   One lane owns one point and loops over the children, carrying only the
//   running winner's anchor row, cell, weights and value; the seg points of
//   a tile are seg consecutive lanes of one warp (floor(32 / seg) tiles a
//   warp, CU's union_small shape), so the brick anchor's per-tile minimum
//   lower corner and the tile's distinct winners are redux.sync reductions
//   over the tile's lane mask.  For seg > 32 a warp owns a tile and its
//   lanes loop over the tile's points (CU's union_multi shape).
//   The children's tables are read in place through a device array of
//   pointers (no concatenation), their small fields staged once a block in
//   shared memory; every brick and row load goes through the read-only path.
//   Middle tiles (>= 4 distinct in-grid winners) take the exact 8-corner lerp
//   of the winner's packed (value, grad) rows; the kernel writes a per-tile
//   flag and an in-grid mask, and CU's cumsum-and-poison pass puts NaN in
//   the middle tiles beyond the residual lane's capacity.
// Block shapes are CU's (256 threads for seg <= 32, 128 beyond).  At the
// north-star chunk (8 links x 25 configurations x 1,061,208 points, seg 27)
// on an H100 the forward takes 3.13-3.15 device ms at 256 threads (64
// registers), 3.12 at 128, 3.26 at 512, 2.97 with __launch_bounds__(256, 6)
// (40 registers, spilling) and 4.75 with (256, 8); values only 2.35-2.37 at
// 256 and within 0.1 ms of it in every other shape.
//
// Every sum and product is written in the plain version's order, and the
// library is built with -fmad=false, so on the card the kernel reproduces
// the plain version bit for bit:
//  - f = (p - lo) * inv_res; the in-grid mask from round(f) half to even
//    (rintf), NaN keys 0, clamped to [-1, n] (float_keys); the cell's lower
//    corner floor(min(max(f, 0), n - 1)) (NaN kept) clamped to [0, n - 2],
//    and its weights f - i0 (_trilinear_cell);
//  - each tile's anchor 2 * floor(min i0 / 2) per dimension over its points,
//    offsets clamped to 3 (_brick_anchor);
//  - each lerp in _CORNERS order (bit d of the corner number the offset in
//    dimension d), each weight the product x, y, z of w or 1 - w
//    (_corner_weight), the sum starting from 0 + the first term, as
//    zeros_like(term) + term does (so a -0.0 first term gives +0.0);
//  - the AABB distance sqrt((d0^2 + d2^2) + d1^2), as CU's note explains;
//  - the winner as torch.argmin picks it (the first NaN, else the first
//    least value); values only as amin's CUDA reduction folds the children
//    (four accumulators, child c into c % 4, then folded in order);
//  - each link-frame point in transforms.transform_points' term order, the
//    rotation in transforms.rotate_vectors'; torch.clamp and torch.minimum
//    keep NaN, as the explicit isnan tests below do.
//
// One call of the C entry launches one kernel on the caller's stream, with
// no host synchronisation and no allocation.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSmallThreads = 256;  // seg <= 32: floor(32 / seg) tiles a warp
constexpr int kMultiThreads = 128;  // seg > 32: one tile a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRow = 125;           // a 5x5x5 brick row
constexpr int kNone = INT_MAX;      // no winner in a distinct-winner list
constexpr unsigned kInfBits = 0x7f800000u;  // +inf, amin's identity
constexpr int kNumPtrs = 9;         // per-child device pointers, in this order:
// lo [3] f32, inv_res [3] f32, n [3] i64, strides [3] i64, bstrides [3] i64,
// bb [3, 2] f32, tbricks [NB, 125] f32, tgbricks [NB, 3, 125] f32 (or null),
// vg [G, 4] f32

// One child's small fields, staged in shared memory.
struct Child {
  float lo[3], inv_res[3], bb_lo[3], bb_hi[3], n_f[3], nm1_f[3];
  int n[3];
  long long strides[3], bstrides[3];
  const float* tbricks;
  const float* tgbricks;
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
      ch.n_f[k] = static_cast<float>(n[k]);        // float_keys' n.to(float32)
      ch.nm1_f[k] = static_cast<float>(n[k] - 1);  // _trilinear_cell's (n - 1).to(float32)
      ch.strides[k] = st[k];
      ch.bstrides[k] = bst[k];
    }
    ch.tbricks = reinterpret_cast<const float*>(d[6]);
    ch.tgbricks = reinterpret_cast<const float*>(d[7]);
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

// float_keys of a rounded or floored float clamped to [-1, n]: NaN is 0
__device__ __forceinline__ int float_key(float r, float n_f) {
  return isnan(r) ? 0 : static_cast<int>(fminf(fmaxf(r, -1.f), n_f));
}

// Python's x // 2
__device__ __forceinline__ int floor_half(int x) {
  return x >= 0 ? x / 2 : -((1 - x) / 2);
}

// A point's in-grid mask, its cell's lower corner i0 clamped into the grid
// and its weights in one child's grid (_trilinear_cell).
__device__ __forceinline__ bool trilinear_cell(const float p[3], const Child& ch, int i0[3],
                                               float w[3]) {
  bool valid = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float f = __fmul_rn(__fsub_rn(p[d], ch.lo[d]), ch.inv_res[d]);
    const int k = float_key(rintf(f), ch.n_f[d]);
    valid = valid && k >= 0 && k < ch.n[d];
    // torch.minimum(f.clamp(min=0), n - 1): NaN stays NaN
    const float fc = clamp_nan(f, 0.f, ch.nm1_f[d]);
    i0[d] = min(max(float_key(floorf(fc), ch.n_f[d]), 0), ch.n[d] - 2);
    w[d] = __fsub_rn(fc, static_cast<float>(i0[d]));
  }
  return valid;
}

// The 8 trilinear weights in _CORNERS order: corner k's offset in dimension
// d is bit d of k, its weight (wd0 * wd1) * wd2 with wd = w or 1 - w.
__device__ __forceinline__ void corner_weights(const float w[3], float wt[8]) {
  float lo[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) lo[d] = __fsub_rn(1.f, w[d]);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    wt[k] = __fmul_rn(__fmul_rn(k & 1 ? w[0] : lo[0], k & 2 ? w[1] : lo[1]),
                      k & 4 ? w[2] : lo[2]);
}

// The lerp of a 5x5x5 brick row's cells at the lower corner r: 0 + the first
// term, then each term in corner order.
__device__ __forceinline__ float lerp5(const float* __restrict__ r, const float wt[8]) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    acc = __fadd_rn(acc, __fmul_rn(wt[k], __ldg(r + (k & 1) * 25 + ((k >> 1) & 1) * 5 +
                                                ((k >> 2) & 1))));
  return acc;
}

// The AABB fallback's offset p - clamp(p, lo, hi) and its norm.
__device__ __forceinline__ float aabb_offset(const float p[3], const Child& ch, float dt[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) dt[d] = __fsub_rn(p[d], clamp_nan(p[d], ch.bb_lo[d], ch.bb_hi[d]));
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dt[0], dt[0]), __fmul_rn(dt[2], dt[2])),
                         __fmul_rn(dt[1], dt[1])));
}

// One child at one point, given the tile's anchor corner (min i0 // 2).
struct Eval {
  float v;
  bool valid;
  int base5;
  long long row, flat0;
  float w[3];
};

__device__ __forceinline__ Eval eval_child(const float p[3], const Child& ch, const int i0[3],
                                           const float w[3], bool valid,
                                           const int corner2[3]) {
  Eval e;
  e.valid = valid;
  e.row = 0;
  e.flat0 = 0;
  int off[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    e.row += static_cast<long long>(corner2[d]) * ch.bstrides[d];
    e.flat0 += static_cast<long long>(i0[d]) * ch.strides[d];
    off[d] = min(i0[d] - 2 * corner2[d], 3);
    e.w[d] = w[d];
  }
  e.base5 = off[0] * 25 + off[1] * 5 + off[2];
  if (valid) {
    float wt[8];
    corner_weights(w, wt);
    e.v = lerp5(ch.tbricks + e.row * kRow + e.base5, wt);
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
// a point whose winner is none of _tile_candidate_ids' three candidates.
__device__ __forceinline__ bool tile_is_middle(const Distinct4& s, unsigned mask) {
  int d = __reduce_min_sync(mask, s.w[0]);
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (d == kNone) return false;
    d = __reduce_min_sync(mask, distinct_above(s, d));
  }
  return d != kNone;
}

// A point's result from its winner w (its Eval in w's tables) and its
// tile's middle flag; writes val, g_obj, win and g_link.
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
  } else {
    float wt[8];
    corner_weights(e.w, wt);
    if (middle) {
      // the residual lane: the exact 8-corner lerp of the winner's packed
      // (value, grad) rows
#pragma unroll
      for (int d = 0; d < 3; ++d) g[d] = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long r = e.flat0 + (k & 1) * ch.strides[0] + ((k >> 1) & 1) * ch.strides[1] +
                            ((k >> 2) & 1) * ch.strides[2];
        const float* row = ch.vg + r * 4;
#pragma unroll
        for (int d = 0; d < 3; ++d) g[d] = __fadd_rn(g[d], __fmul_rn(wt[k], __ldg(row + 1 + d)));
      }
    } else {
      // a tile candidate: the lerp of the winner's gradient brick row
      const float* r = ch.tgbricks + e.row * (3 * kRow) + e.base5;
#pragma unroll
      for (int d = 0; d < 3; ++d) g[d] = lerp5(r + d * kRow, wt);
    }
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
__global__ void __launch_bounds__(kSmallThreads) union_tri_small(Args a) {
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
  int bw = 0;
  for (int c = 0; c < a.C; ++c) {
    const Child& ch = sh[c];
    float p[3], w[3];
    int i0[3], corner2[3];
    load_point(a, c, b, i, p);
    const bool valid = trilinear_cell(p, ch, i0, w);
#pragma unroll
    for (int d = 0; d < 3; ++d) corner2[d] = floor_half(__reduce_min_sync(mask, i0[d]));
    const Eval e = eval_child(p, ch, i0, w, valid, corner2);
    if (kValuesOnly) {
      acc[c & 3] = min_nan(acc[c & 3], e.v);
    } else if (c == 0 || better(e.v, best.v)) {
      best = e;
      bw = c;
#pragma unroll
      for (int d = 0; d < 3; ++d) bp[d] = p[d];
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
// the union at each point (win written; val too with values only), then,
// once the tile's middle flag is known, each point finished from its winner.
template <bool kValuesOnly>
__global__ void __launch_bounds__(kMultiThreads) union_tri_multi(Args a) {
  extern __shared__ Child sh[];
  int* corners = reinterpret_cast<int*>(sh + a.C) + (threadIdx.x / kWarp) * 3 * a.C;
  stage_children(a.desc, a.C, sh);
  __syncthreads();
  const int lane = threadIdx.x & (kWarp - 1);
  const long long tile = (static_cast<long long>(blockIdx.x) * kMultiThreads + threadIdx.x) / kWarp;
  if (tile >= a.NT) return;  // whole warps leave together
  const long long i0t = tile * a.seg;
  const int b = static_cast<int>(tile / a.FS);

  for (int c = 0; c < a.C; ++c) {
    int m[3] = {INT_MAX, INT_MAX, INT_MAX};
    for (int j = lane; j < a.seg; j += kWarp) {
      float p[3], w[3];
      int i0[3];
      load_point(a, c, b, i0t + j, p);
      trilinear_cell(p, sh[c], i0, w);
#pragma unroll
      for (int d = 0; d < 3; ++d) m[d] = min(m[d], i0[d]);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int mk = __reduce_min_sync(kFull, m[d]);
      if (lane == 0) corners[3 * c + d] = floor_half(mk);
    }
  }
  __syncwarp();

  Distinct4 s;
  distinct_init(s);
  for (int j = lane; j < a.seg; j += kWarp) {
    const long long i = i0t + j;
    const float inf = __int_as_float(kInfBits);
    float acc[4] = {inf, inf, inf, inf};
    float best = 0.f;
    int bw = 0;
    bool bvalid = false;
    for (int c = 0; c < a.C; ++c) {
      float p[3], w[3];
      int i0[3];
      load_point(a, c, b, i, p);
      const bool valid = trilinear_cell(p, sh[c], i0, w);
      const Eval e = eval_child(p, sh[c], i0, w, valid, corners + 3 * c);
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
    const long long i = i0t + j;
    const int w = static_cast<int>(a.win[i]);
    float p[3], wts[3];
    int i0[3];
    load_point(a, w, b, i, p);
    const bool valid = trilinear_cell(p, sh[w], i0, wts);
    const Eval e = eval_child(p, sh[w], i0, wts, valid, corners + 3 * w);
    if (middle) a.mask[i] = valid;
    finish_point(i, b, a.B, p, sh[w], e, w, middle, a.Rb, a.val, a.g_obj, a.win, a.g_link);
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
// int32 and mask [N] uint8 (written in middle tiles only), the inputs of
// CU's pvt_coherent_union_poison.  Launches on `stream` and returns the
// launch's CUDA error code (0 on success).
extern "C" int pvt_coherent_union_tile_tri(const float* points, const float* T, const float* Rb,
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
    return values_only ? launch(union_tri_small<true>, blocks, kSmallThreads, staged, stream, a)
                       : launch(union_tri_small<false>, blocks, kSmallThreads, staged, stream, a);
  }
  const long long per_block = kMultiThreads / kWarp;
  const long long blocks = (a.NT + per_block - 1) / per_block;
  const size_t smem = staged + sizeof(int) * 3 * C * per_block;
  return values_only ? launch(union_tri_multi<true>, blocks, kMultiThreads, smem, stream, a)
                     : launch(union_tri_multi<false>, blocks, kMultiThreads, smem, stream, a);
}

extern "C" const char* pvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
