// Point -> triangle-mesh closest point + winding sweep with the pairwise
// products on the tensor cores (Hopper: warp mma.sync, or warpgroup wgmma;
// TF32 split three ways for float32 accuracy).
//
// Replaces the TPU kernel benchmarks/pallas_mxu_ab.py :: sweep_kernel, mode
// "mxu": the same function as csrc/closest_point.cu (min squared distance,
// its face id and closest point, and the solid-angle sum per point), with
// each (point, triangle) pair's dot products taken from a matrix product
// instead of the FP32 lanes.  The plain version is ops/point_triangle.py ::
// mesh_closest_query_expanded.
//
// What bounds it on an H100: instruction issue, not the tensor cores and
// not memory.  An evaluated pair still costs the region cascade with two
// divisions, and a solid angle three square roots and an atan2; a step's
// products (48 columns of K = 16 for 64 points) are a few percent of its
// issue slots.  So the design does what csrc/closest_point.cu does to cut
// pairs, and moves into the products every per-pair operation it can.
// Measured (PERF.md, findings): the epilogue's issue rate is what is left;
// at these tiny K the products' latency costs more than the FP32 lanes
// they save, and wgmma ties the four warps together at every step.
//
// A. Pairs.  Padding rows are compacted out of each tile; the first one is
//    merged at the end by (d2, face id).  Each run of kCluster consecutive
//    real faces (a group: one frame, one box, one product step) is culled
//    per warp against its box with closest_point.cu's margins, thin rule and
//    seed bound.  A warp whose points all lie strictly outside the caller's
//    exterior box sums no solid angle.  The (point, real face) pairs whose
//    closest point, and whose solid angle, were evaluated are counted.
// B. Products.  Each warp owns 16 points (M of mma.sync m16n8k8; the
//    warpgroup of wgmma owns 64).  A step's B, [48 columns, K = 16], is
//    split into TF32 hi and lo once per block and tile, stored in shared
//    memory in wgmma's K-major layout without swizzle, from which the
//    mma.sync fragments load without bank conflicts; A, the points' rows,
//    lives in registers.  A warp issues the products of the column blocks
//    it needs: D1 and D2 for the closest point, the other four for the
//    solid angle, none for a culled step.  kProducts selects the route at
//    compile time: kMmaSync (shipped, the fastest on the H100), kWgmma (two
//    m64n48k8, m64n16k8 without solid angles, issued when any warp of the
//    warpgroup needs the step, each warp then culling its own epilogue),
//    and kFp32, the same sums on the FP32 lanes in the plain version's
//    order, for comparison (scripts/sweep_variants_torch.py times all
//    three).
// C. Folded constants.  The point's row is (qx, qy, qz, 1, |q|^2) in the
//    group's frame, and a face's six columns give finished quantities:
//    d1 = ab.(q - a), d2 = ac.(q - a), the solid angle's numerator
//    a.(b x c) - q.(ab x ac), and |a - q|^2, |b - q|^2, |c - q|^2.  Then
//    d3 = d1 - |ab|^2, d4 = d2 - ab.ac, d5 = d1 - ab.ac, d6 = d2 - |ac|^2,
//    and the cross terms (a-q).(b-q) = (|a-q|^2 + |b-q|^2 - |ab|^2) / 2.
//    The three unused slots of a K = 8 row hold the split's lo parts, so
//    3xTF32 (hi.hi + lo.hi + hi.lo) takes K = 16, two products, not three:
//      K 0..7:  A (qx, qy, qz)hi 1 |q|^2hi (qx, qy, qz)lo
//               B (vx, vy, vz)hi chi e      (vx, vy, vz)hi
//      K 8..15: A (qx, qy, qz)hi 1 |q|^2lo 0 0 0
//               B (vx, vy, vz)lo clo e      0 0 0
//    (v: the column's vector, c: its constant, e: 1 for the squared
//    distances).  The cascade is point_triangle.cuh's select-then-divide on
//    those d1..d6: two divisions a pair.
// D. Accuracy.  Each group's frame is centred on the first corner of its
//    first real face, so padding anywhere moves no frame.  The products
//    cancel in proportion to a point's distance from the frame; for a
//    point within kNear diagonals of a group's box (any point of the warp),
//    the solid angle comes from the direct forms in the frame
//    (point_triangle.cuh :: solid_angle), where the products would lose
//    the winding's accuracy near the surface.
//
// The squared distance is taken directly as |q' - q|^2, and the closest
// point in world coordinates as q' + origin, as in the plain version.
// Results differ from the plain version by the products' rounding only:
// the tensor cores sum in their own order, and 3xTF32 keeps ~21 bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "point_triangle.cuh"  // Tri, closest_from_d, closest_pair, solid_angle, is_thin

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;            // one warpgroup
constexpr int kRows = 16;                        // points per warp (M of mma.sync)
constexpr int kPointsPerBlock = kRows * kWarps;  // 64 (M of wgmma)
constexpr int kTriTile = 64;                     // input rows per tile
constexpr int kCluster = 8;                      // faces per group
constexpr int kClusters = kTriTile / kCluster;
constexpr int kCols = 6;                         // product columns per face
constexpr int kBWords = kCols * kCluster * 16;   // a step's B: 48 columns x K = 16
constexpr bool kCull = true;                     // cluster culling (lever A)
// how a step's products are issued: the warpgroup's wgmma, each warp's
// mma.sync, or (for comparison) the same sums on the FP32 lanes
enum Products { kFp32, kMmaSync, kWgmma };
constexpr Products kProducts = kMmaSync;
constexpr float kPad = 1.0e7f;                   // mesh.PAD_COORD
constexpr float kCullRel = 1e-3f;
constexpr float kCullAbs = 1e-5f;
constexpr float kThin = 1e-3f;
constexpr float kNear = 1.0f;                    // point_triangle.EXPANDED_NEAR
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kOne = 0x3f800000u;           // 1.0f, exact in TF32

static_assert(kTriTile <= kThreads, "one thread fills one face of a tile");
static_assert(kCluster == 8, "a group is the N = 8 of one column block");

// per-face fields of the compacted tile, in its group's frame
enum Field {
  AX, AY, AZ, BX, BY, BZ, CX, CY, CZ, ABX, ABY, ABZ, ACX, ACY, ACZ,
  AB2, AC2, ABAC, BC2,
  NX, NY, NZ, C_D1, C_D2, C_NUM, C_LA2, C_LB2, C_LC2,  // FP32 products' columns
  kFields
};

// column blocks of a step's product (each one column per face of the group)
enum Column { D1, D2, NUM, LA2, LB2, LC2 };

struct Box {
  float lo[3], hi[3];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// B element (column n = 8 * block + face, K index k) of a step: core
// matrices of 8 columns x 4 K (16 B a column), K-major without swizzle, the
// 6 column blocks of one K quarter next to each other
__device__ __forceinline__ int b_index(int block, int face, int k) {
  return ((k >> 2) * kCols + block) * 32 + face * 4 + (k & 3);
}

// one column of a face: vector v, constant c, |q|^2 coefficient e (0 or 1)
__device__ __forceinline__ void store_column(uint32_t* b, int block, int face, float vx,
                                             float vy, float vz, float c, bool e) {
  uint32_t xh, xl, yh, yl, zh, zl, ch, cl;
  split_tf32(vx, xh, xl);
  split_tf32(vy, yh, yl);
  split_tf32(vz, zh, zl);
  split_tf32(c, ch, cl);
  const uint32_t ee = e ? kOne : 0u;
  *reinterpret_cast<uint4*>(b + b_index(block, face, 0)) = make_uint4(xh, yh, zh, ch);
  *reinterpret_cast<uint4*>(b + b_index(block, face, 4)) = make_uint4(ee, xh, yh, zh);
  *reinterpret_cast<uint4*>(b + b_index(block, face, 8)) = make_uint4(xl, yl, zl, cl);
  *reinterpret_cast<uint4*>(b + b_index(block, face, 12)) = make_uint4(ee, 0u, 0u, 0u);
}

// ---- products: acc[4 * block + e] = (row g + 8 (e >> 1), column
// 8 * block + 2t + (e & 1)), the same fragment for wgmma and mma.sync ----

// wgmma descriptor of a K = 8 half of a step's B: no swizzle; the leading
// byte offset steps K by 4 (the next K quarter, 6 column blocks on), the
// stride byte offset steps N by 8 (the next column block)
__device__ __forceinline__ uint64_t b_desc(const uint32_t* b) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(b));
  constexpr uint64_t kLbo = kCols * 128, kSbo = 128;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | ((kLbo >> 4) << 16) |
         ((kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_n48(float (&d)[24], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n16(float (&d)[24], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the step's products as the warpgroup's wgmma: column blocks D1, D2, and
// the four of the solid angle when `wide`
__device__ __forceinline__ void products_wgmma(float (&acc)[24], const uint32_t (&a0)[4],
                                               const uint32_t (&a1)[4], const uint32_t* b,
                                               bool wide) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  if (wide) {
    wgmma_n48(acc, a0, b_desc(b), 0);
    wgmma_n48(acc, a1, b_desc(b + b_index(0, 0, 8)), 1);
  } else {
    wgmma_n16(acc, a0, b_desc(b), 0);
    wgmma_n16(acc, a1, b_desc(b + b_index(0, 0, 8)), 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 24; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// d = a * b (+ d when `accumulate`) for one m16n8k8 TF32 block
__device__ __forceinline__ void mma_k8(float& d0, float& d1, float& d2, float& d3,
                                       const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                                       bool accumulate) {
  const float c0 = accumulate ? d0 : 0.f, c1 = accumulate ? d1 : 0.f;
  const float c2 = accumulate ? d2 : 0.f, c3 = accumulate ? d3 : 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c0), "f"(c1),
        "f"(c2), "f"(c3));
}

// the step's products as this warp's mma.sync: column blocks [first, last)
__device__ __forceinline__ void products_mma(float (&acc)[24], const uint32_t (&a0)[4],
                                             const uint32_t (&a1)[4], const uint32_t* b,
                                             int first, int last, int g, int t) {
#pragma unroll
  for (int block = 0; block < kCols; ++block) {
    if (block < first || block >= last) continue;
    float& d0 = acc[4 * block];
    float& d1 = acc[4 * block + 1];
    float& d2 = acc[4 * block + 2];
    float& d3 = acc[4 * block + 3];
    mma_k8(d0, d1, d2, d3, a0, b[b_index(block, g, t)], b[b_index(block, g, t + 4)], false);
    mma_k8(d0, d1, d2, d3, a1, b[b_index(block, g, t + 8)], b[b_index(block, g, t + 12)],
           true);
  }
}

// the step's products on the FP32 lanes, as the plain version's _products
// sums them: q.v + c + |q|^2 e, for this thread's faces (slots k_lo, k_hi of
// the tile) and column blocks [first, last)
__device__ __forceinline__ void products_fp32(float (&acc)[24], const float (&q)[2][3],
                                              const float (&pp)[2], const float* s,
                                              int k_lo, int k_hi, int first, int last) {
#pragma unroll
  for (int block = 0; block < kCols; ++block) {
    if (block < first || block >= last) continue;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int k = cc ? k_hi : k_lo;
      float vx, vy, vz, c;
      bool e = false;
      switch (block) {
        case D1: vx = s[ABX * kTriTile + k]; vy = s[ABY * kTriTile + k];
                 vz = s[ABZ * kTriTile + k]; c = s[C_D1 * kTriTile + k]; break;
        case D2: vx = s[ACX * kTriTile + k]; vy = s[ACY * kTriTile + k];
                 vz = s[ACZ * kTriTile + k]; c = s[C_D2 * kTriTile + k]; break;
        case NUM: vx = -s[NX * kTriTile + k]; vy = -s[NY * kTriTile + k];
                  vz = -s[NZ * kTriTile + k]; c = s[C_NUM * kTriTile + k]; break;
        default: {
          const int f = block == LA2 ? AX : block == LB2 ? BX : CX;
          vx = -2.f * s[f * kTriTile + k]; vy = -2.f * s[(f + 1) * kTriTile + k];
          vz = -2.f * s[(f + 2) * kTriTile + k];
          c = s[(block == LA2 ? C_LA2 : block == LB2 ? C_LB2 : C_LC2) * kTriTile + k];
          e = true;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        acc[4 * block + 2 * r + cc] = q[r][0] * vx + q[r][1] * vy + q[r][2] * vz + c
                                      + (e ? pp[r] * 1.f : pp[r] * 0.f);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
closest_point_sweep_mma_kernel(const float* __restrict__ pts, int num_points,
                               const float* __restrict__ tri, int num_tri,
                               float* __restrict__ out_d2,
                               float* __restrict__ out_closest,
                               int* __restrict__ out_fid,
                               float* __restrict__ out_wind,
                               Box ext, int has_ext,
                               unsigned long long* __restrict__ counters) {
  __shared__ __align__(128) uint32_t s_b[kClusters * kBWords];  // the steps' B
  __shared__ float s[kFields * kTriTile];
  __shared__ float s_raw[9 * kTriTile];     // compacted corners, world frame
  __shared__ int s_id[kTriTile];
  __shared__ float s_box[8 * kClusters];    // grown box lo xyz, hi xyz, diagonal^2
  __shared__ float s_origin[3 * kClusters];
  __shared__ unsigned s_mask[2 * (kTriTile / 32)];
  __shared__ int s_need[2][kWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row group: points g and g + 8 of the warp
  const int t = lane & 3;   // thread in group: faces 2t, 2t + 1 of a step
  const int row0 = blockIdx.x * kPointsPerBlock + warp * kRows;
  const float inf = __int_as_float(0x7f800000);

  // this thread's two points (rows g and g + 8), zero past the end
  float p[2][3];
  bool live[2], outside = true;
  float best[2], bq[2][3], wind[2];
  int best_fid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    live[r] = i < num_points;
#pragma unroll
    for (int k = 0; k < 3; ++k) p[r][k] = live[r] ? pts[3 * i + k] : 0.f;
    // a missing point counts as outside: it does not hold its warp back
    outside = outside && (!live[r] || p[r][0] < ext.lo[0] || p[r][0] > ext.hi[0] ||
                          p[r][1] < ext.lo[1] || p[r][1] > ext.hi[1] ||
                          p[r][2] < ext.lo[2] || p[r][2] > ext.hi[2]);
    best[r] = inf;
    best_fid[r] = 0;
    bq[r][0] = bq[r][1] = bq[r][2] = 0.f;
    wind[r] = 0.f;
  }
  const bool wind_needed = !(has_ext && __all_sync(kFull, outside));
  const unsigned warp_points = __popc(__ballot_sync(kFull, live[0] && t == 0)) +
                               __popc(__ballot_sync(kFull, live[1] && t == 0));

  // an upper bound on each point's final best (closest_point.cu's): the
  // squared distance to the first corner of every kCluster-th well-shaped
  // triangle, with the margins; the quad's four threads share the work
  float bound[2] = {inf, inf};
  if constexpr (kCull) {
    for (int f = kCluster * t; f < num_tri; f += 4 * kCluster) {
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
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float dx = ax - p[r][0], dy = ay - p[r][1], dz = az - p[r][2];
        const float u = (dx * dx + dy * dy + dz * dz) * (1.f + 2.f * kCullRel) + slack;
        bound[r] = fminf(bound[r], u);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bound[r] = fminf(bound[r], __shfl_xor_sync(kFull, bound[r], 1));
      bound[r] = fminf(bound[r], __shfl_xor_sync(kFull, bound[r], 2));
    }
  }

  // the point this thread tests against each group's box (threads 2r and
  // 2r + 1 of a quad test its point r), its seed bound, and its running best
  // over the four threads that hold it
  const bool tr1 = t >> 1;
  const float tx = tr1 ? p[1][0] : p[0][0], ty = tr1 ? p[1][1] : p[0][1],
              tz = tr1 ? p[1][2] : p[0][2];
  const bool tlive = tr1 ? live[1] : live[0];
  const float tbound = tr1 ? bound[1] : bound[0];
  float run = inf;
  float acc[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) acc[i] = 0.f;
  int pad_id = -1;  // the first padding triangle's face id
  unsigned closest_tris = 0, wind_tris = 0;  // per warp, for counters

  for (int f0 = 0; f0 < num_tri; f0 += kTriTile) {
    // ---- load and compact the tile: real triangles in face order ----
    const int f = f0 + threadIdx.x;
    const bool in = threadIdx.x < kTriTile && f < num_tri;
    float c[9];
    bool is_pad = false;
    if (in) {
      is_pad = true;
#pragma unroll
      for (int r = 0; r < 9; ++r) {
        c[r] = tri[9 * f + r];
        is_pad = is_pad && c[r] == kPad;
      }
    }
    const unsigned pad_mask = __ballot_sync(kFull, in && is_pad);
    const unsigned real_mask = __ballot_sync(kFull, in && !is_pad);
    __syncthreads();  // the previous tile is no longer read
    if (lane == 0 && warp < kTriTile / 32) {
      s_mask[warp] = real_mask;
      s_mask[kTriTile / 32 + warp] = pad_mask;
    }
    __syncthreads();
    int n = 0, slot = -1;
#pragma unroll
    for (int w = 0; w < kTriTile / 32; ++w) {
      const unsigned m = s_mask[w];
      const unsigned pm = s_mask[kTriTile / 32 + w];
      if (pad_id < 0 && pm) pad_id = f0 + 32 * w + __ffs(pm) - 1;
      if (w == warp && ((m >> lane) & 1u)) slot = n + __popc(m & ((1u << lane) - 1u));
      n += __popc(m);
    }
    if (slot >= 0) {
#pragma unroll
      for (int r = 0; r < 9; ++r) s_raw[r * kTriTile + slot] = c[r];
      s_id[slot] = f;
    }
    if (n == 0) continue;  // block-uniform: a tile of padding only
    __syncthreads();

    // ---- each face in its group's frame, its B columns (split once), and
    // the group boxes: kCluster lanes per group, one face each ----
    {
      const int k = threadIdx.x;
      const int lead = k & ~(kCluster - 1);
      float lo[3], hi[3], m = 0.f;
      bool thin = false;
#pragma unroll
      for (int d = 0; d < 3; ++d) { lo[d] = inf; hi[d] = -inf; }
      if (k < n) {
        float w[9];
#pragma unroll
        for (int r = 0; r < 9; ++r) w[r] = s_raw[r * kTriTile + k];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          lo[d] = fminf(fminf(w[d], w[3 + d]), w[6 + d]);
          hi[d] = fmaxf(fmaxf(w[d], w[3 + d]), w[6 + d]);
          m = fmaxf(m, fmaxf(-lo[d], hi[d]));
        }
        thin = is_thin(w[3] - w[0], w[4] - w[1], w[5] - w[2], w[6] - w[0], w[7] - w[1],
                       w[8] - w[2], kThin);
        const float ox = s_raw[lead], oy = s_raw[kTriTile + lead],
                    oz = s_raw[2 * kTriTile + lead];
        if (k == lead) {
          s_origin[3 * (k / kCluster) + 0] = ox;
          s_origin[3 * (k / kCluster) + 1] = oy;
          s_origin[3 * (k / kCluster) + 2] = oz;
        }
        const float ax = w[0] - ox, ay = w[1] - oy, az = w[2] - oz;
        const float bx = w[3] - ox, by = w[4] - oy, bz = w[5] - oz;
        const float cx = w[6] - ox, cy = w[7] - oy, cz = w[8] - oz;
        const float abx = bx - ax, aby = by - ay, abz = bz - az;
        const float acx = cx - ax, acy = cy - ay, acz = cz - az;
        const float bcx = cx - bx, bcy = cy - by, bcz = cz - bz;
        s[AX * kTriTile + k] = ax; s[AY * kTriTile + k] = ay; s[AZ * kTriTile + k] = az;
        s[BX * kTriTile + k] = bx; s[BY * kTriTile + k] = by; s[BZ * kTriTile + k] = bz;
        s[CX * kTriTile + k] = cx; s[CY * kTriTile + k] = cy; s[CZ * kTriTile + k] = cz;
        s[ABX * kTriTile + k] = abx; s[ABY * kTriTile + k] = aby; s[ABZ * kTriTile + k] = abz;
        s[ACX * kTriTile + k] = acx; s[ACY * kTriTile + k] = acy; s[ACZ * kTriTile + k] = acz;
        s[AB2 * kTriTile + k] = abx * abx + aby * aby + abz * abz;
        s[AC2 * kTriTile + k] = acx * acx + acy * acy + acz * acz;
        s[ABAC * kTriTile + k] = abx * acx + aby * acy + abz * acz;
        s[BC2 * kTriTile + k] = bcx * bcx + bcy * bcy + bcz * bcz;
        // the columns of point_triangle.expanded_columns, each dot product
        // and cross product in its order
        const float nx = aby * acz - abz * acy;
        const float ny = abz * acx - abx * acz;
        const float nz = abx * acy - aby * acx;
        const float xx = by * cz - bz * cy, xy = bz * cx - bx * cz, xz = bx * cy - by * cx;
        uint32_t* b = s_b + (k / kCluster) * kBWords;
        const int face = k % kCluster;
        const float c_d1 = -(abx * ax + aby * ay + abz * az);
        const float c_d2 = -(acx * ax + acy * ay + acz * az);
        const float c_num = ax * xx + ay * xy + az * xz;
        const float c_la2 = ax * ax + ay * ay + az * az;
        const float c_lb2 = bx * bx + by * by + bz * bz;
        const float c_lc2 = cx * cx + cy * cy + cz * cz;
        if constexpr (kProducts == kFp32) {
          s[NX * kTriTile + k] = nx; s[NY * kTriTile + k] = ny; s[NZ * kTriTile + k] = nz;
          s[C_D1 * kTriTile + k] = c_d1; s[C_D2 * kTriTile + k] = c_d2;
          s[C_NUM * kTriTile + k] = c_num; s[C_LA2 * kTriTile + k] = c_la2;
          s[C_LB2 * kTriTile + k] = c_lb2; s[C_LC2 * kTriTile + k] = c_lc2;
        } else {
          store_column(b, D1, face, abx, aby, abz, c_d1, false);
          store_column(b, D2, face, acx, acy, acz, c_d2, false);
          store_column(b, NUM, face, -nx, -ny, -nz, c_num, false);
          store_column(b, LA2, face, -2.f * ax, -2.f * ay, -2.f * az, c_la2, true);
          store_column(b, LB2, face, -2.f * bx, -2.f * by, -2.f * bz, c_lb2, true);
          store_column(b, LC2, face, -2.f * cx, -2.f * cy, -2.f * cz, c_lc2, true);
        }
      } else if (k < kTriTile && lead < n) {
        // the ragged group's empty columns: zero products, never read
        uint32_t* b = s_b + (k / kCluster) * kBWords;
#pragma unroll
        for (int col = 0; col < kCols; ++col)
          store_column(b, col, k % kCluster, 0.f, 0.f, 0.f, 0.f, false);
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
      if (k < n && k == lead) {
        const float eta = kCullAbs * m;
        float* bx = s_box + 8 * (k / kCluster);
        float diag2 = 0.f;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          bx[d] = thin ? -inf : lo[d] - eta;
          bx[3 + d] = thin ? inf : hi[d] + eta;
          const float span = bx[3 + d] - bx[d];
          diag2 = diag2 + span * span;
        }
        bx[6] = diag2;
      }
    }
    if constexpr (kProducts == kWgmma)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // ---- sweep the tile group by group ----
    const int n_groups = (n + kCluster - 1) / kCluster;
    for (int j = 0; j < n_groups; ++j) {
      const int k0 = j * kCluster;
      const float* box = s_box + 8 * j;
      // the cull and near tests of this thread's tested point
      const float dx = fmaxf(fmaxf(box[0] - tx, tx - box[3]), 0.f);
      const float dy = fmaxf(fmaxf(box[1] - ty, ty - box[4]), 0.f);
      const float dz = fmaxf(fmaxf(box[2] - tz, tz - box[5]), 0.f);
      const float gap2 = dx * dx + dy * dy + dz * dz;
      bool skip = !tlive;
      if constexpr (kCull) {
        const float lb = gap2 * (1.f - kCullRel);
        skip = skip || lb >= run || lb > tbound;
      }
      const bool near = tlive && gap2 <= (kNear * kNear) * box[6];
      const bool closest = !__all_sync(kFull, skip);
      const bool direct = wind_needed && __any_sync(kFull, near);
      const bool expanded = wind_needed && !direct;
      int need = (closest ? 1 : 0) | (expanded ? 2 : 0);  // this warp's products
      if constexpr (kProducts == kWgmma) {  // the warpgroup issues what any warp needs
        if (lane == 0) s_need[j & 1][warp] = need;
        __syncthreads();
        need = s_need[j & 1][0] | s_need[j & 1][1] | s_need[j & 1][2] | s_need[j & 1][3];
      }
      if (!need && !wind_needed) continue;

      // this step's point rows in the group's frame, as the A fragments of
      // its two K = 8 halves: a[0], a[1] = column t of rows g, g + 8;
      // a[2], a[3] = column t + 4
      const float o[3] = {s_origin[3 * j], s_origin[3 * j + 1], s_origin[3 * j + 2]};
      float q[2][3], pp[2];
      uint32_t a0[4], a1[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        q[r][0] = p[r][0] - o[0];
        q[r][1] = p[r][1] - o[1];
        q[r][2] = p[r][2] - o[2];
        pp[r] = q[r][0] * q[r][0] + q[r][1] * q[r][1] + q[r][2] * q[r][2];
        const float x = t == 0 ? q[r][0] : t == 1 ? q[r][1] : q[r][2];
        a0[r] = a1[r] = t == 3 ? kOne : to_tf32(x);
        const float u = t == 0 ? pp[r] : t == 1 ? q[r][0] : t == 2 ? q[r][1] : q[r][2];
        uint32_t hi, lo;
        split_tf32(u, hi, lo);
        a0[2 + r] = t == 0 ? hi : lo;
        a1[2 + r] = t == 0 ? lo : 0u;
      }
      const uint32_t* b = s_b + j * kBWords;
      if constexpr (kProducts == kWgmma) {
        if (need) products_wgmma(acc, a0, a1, b, need & 2);
      } else if constexpr (kProducts == kMmaSync) {
        products_mma(acc, a0, a1, b, closest ? D1 : NUM, expanded ? kCols : NUM, g, t);
      } else {
        products_fp32(acc, q, pp, s, min(k0 + 2 * t, n - 1), min(k0 + 2 * t + 1, n - 1),
                      closest ? D1 : NUM, expanded ? kCols : NUM);
      }
      if (!closest && !wind_needed) continue;
      const int k1 = min(k0 + kCluster, n);
      if (closest) closest_tris += k1 - k0;
      if (wind_needed) wind_tris += k1 - k0;

      // ---- the epilogue: this thread's faces 2t, 2t + 1 for its two points
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int k = k0 + 2 * t + cc;
        const bool valid = k < k1;
        const int ks = valid ? k : k0;
        Tri tr;
        tr.ax = s[AX * kTriTile + ks]; tr.ay = s[AY * kTriTile + ks]; tr.az = s[AZ * kTriTile + ks];
        tr.abx = s[ABX * kTriTile + ks]; tr.aby = s[ABY * kTriTile + ks];
        tr.abz = s[ABZ * kTriTile + ks];
        tr.acx = s[ACX * kTriTile + ks]; tr.acy = s[ACY * kTriTile + ks];
        tr.acz = s[ACZ * kTriTile + ks];
        const float ab2 = s[AB2 * kTriTile + ks], ac2 = s[AC2 * kTriTile + ks];
        const float abac = s[ABAC * kTriTile + ks];
        if (wind_needed && direct) {
          tr.bx = s[BX * kTriTile + ks]; tr.by = s[BY * kTriTile + ks];
          tr.bz = s[BZ * kTriTile + ks];
          tr.cx = s[CX * kTriTile + ks]; tr.cy = s[CY * kTriTile + ks];
          tr.cz = s[CZ * kTriTile + ks];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + cc;  // the pair's accumulator element
          if (closest) {
            const float d1 = acc[4 * D1 + e], d2 = acc[4 * D2 + e];
            float qx, qy, qz;
            int feat;
            const float dist2 = closest_from_d(tr, d1, d2, d1 - ab2, d2 - abac, d1 - abac,
                                               d2 - ac2, q[r][0], q[r][1], q[r][2], qx, qy,
                                               qz, feat);
            if (valid && dist2 < best[r]) {
              best[r] = dist2;
              best_fid[r] = s_id[k];
              bq[r][0] = qx + o[0]; bq[r][1] = qy + o[1]; bq[r][2] = qz + o[2];
            }
          }
          if (!wind_needed || !valid) continue;
          if (direct) {
            wind[r] += solid_angle(tr, q[r][0], q[r][1], q[r][2]);
          } else {
            const float la2 = fmaxf(acc[4 * LA2 + e], 0.f);
            const float lb2 = fmaxf(acc[4 * LB2 + e], 0.f);
            const float lc2 = fmaxf(acc[4 * LC2 + e], 0.f);
            const float la = sqrtf(la2), lb = sqrtf(lb2), lc = sqrtf(lc2);
            const float bc2 = s[BC2 * kTriTile + ks];
            const float den = la * lb * lc + (la2 + lb2 - ab2) * 0.5f * lc
                              + (lb2 + lc2 - bc2) * 0.5f * la + (lc2 + la2 - ac2) * 0.5f * lb;
            wind[r] += 2.f * atan2f(acc[4 * NUM + e], den);
          }
        }
      }
      if (kCull && closest) {  // the tested point's running best over its quad
        const float mine = tr1 ? best[1] : best[0];
        const float pair = __shfl_xor_sync(kFull, tr1 ? best[0] : best[1], 2);
        run = fminf(fminf(mine, pair), fminf(__shfl_xor_sync(kFull, mine, 1),
                                             __shfl_xor_sync(kFull, pair, 1)));
      }
    }
  }

  // merge the quad's four partial results: min by (d2, face id), sum
  // winding; then every padding triangle (the same degenerate triangle at
  // PAD_COORD) through the first one, by (d2, face id)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      const float o_d2 = __shfl_xor_sync(kFull, best[r], m);
      const int o_fid = __shfl_xor_sync(kFull, best_fid[r], m);
      const float o_qx = __shfl_xor_sync(kFull, bq[r][0], m);
      const float o_qy = __shfl_xor_sync(kFull, bq[r][1], m);
      const float o_qz = __shfl_xor_sync(kFull, bq[r][2], m);
      wind[r] += __shfl_xor_sync(kFull, wind[r], m);
      if (o_d2 < best[r] || (o_d2 == best[r] && o_fid < best_fid[r])) {
        best[r] = o_d2;
        best_fid[r] = o_fid;
        bq[r][0] = o_qx; bq[r][1] = o_qy; bq[r][2] = o_qz;
      }
    }
    if (pad_id >= 0) {
      Tri tp;
      tp.ax = tp.bx = tp.cx = kPad; tp.ay = tp.by = tp.cy = kPad; tp.az = tp.bz = tp.cz = kPad;
      tp.abx = tp.aby = tp.abz = tp.acx = tp.acy = tp.acz = 0.f;
      float qx, qy, qz;
      const float d2 = closest_pair(tp, p[r][0], p[r][1], p[r][2], qx, qy, qz);
      if (d2 < best[r] || (d2 == best[r] && pad_id < best_fid[r])) {
        best[r] = d2;
        best_fid[r] = pad_id;
        bq[r][0] = qx; bq[r][1] = qy; bq[r][2] = qz;
      }
    }
    const int i = row0 + g + 8 * r;
    if (t == 0 && live[r]) {
      out_d2[i] = best[r];
      out_closest[3 * i + 0] = bq[r][0];
      out_closest[3 * i + 1] = bq[r][1];
      out_closest[3 * i + 2] = bq[r][2];
      out_fid[i] = best_fid[r];
      out_wind[i] = wind[r];
    }
  }
  if (counters != nullptr && lane == 0 && warp_points > 0) {
    atomicAdd(counters + 0, static_cast<unsigned long long>(closest_tris) * warp_points);
    atomicAdd(counters + 1, static_cast<unsigned long long>(wind_tris) * warp_points);
  }
}

}  // namespace

// C interface, loaded with ctypes; the contract of pvt_closest_point_sweep
// in closest_point.cu: pts [P,3], tri [F,3,3] float32 contiguous on the
// device (PAD_COORD rows anywhere); outputs d2 [P], closest [P,3], fid [P]
// int32, wind [P] (raw solid-angle sum).  exterior_box: null, or 6 host
// floats (lo xyz, hi xyz) given only for a mesh with no boundary.
// counters: null, or 2 device uint64 to which the launch adds the (point,
// real triangle) pairs whose closest point, and whose solid angle, it
// evaluated.  Launches on `stream` and returns the cudaGetLastError() code
// of the launch (0 on success).
extern "C" int pvt_closest_point_sweep_mma(const float* pts, int num_points,
                                           const float* tri, int num_tri,
                                           float* d2, float* closest, int* fid,
                                           float* wind, const float* exterior_box,
                                           unsigned long long* counters, void* stream) {
  if (num_points <= 0) return 0;
  Box ext{};
  const int has_ext = exterior_box != nullptr;
  for (int d = 0; d < 3 && has_ext; ++d) {
    ext.lo[d] = exterior_box[d];
    ext.hi[d] = exterior_box[3 + d];
  }
  const int blocks = (num_points + kPointsPerBlock - 1) / kPointsPerBlock;
  closest_point_sweep_mma_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, num_points, tri, num_tri, d2, closest, fid, wind, ext, has_ext, counters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
