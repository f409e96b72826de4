// Point -> triangle-mesh closest point + winding sweep with the pairwise dot
// products on the tensor cores (Hopper, warp-level mma.sync, TF32 split
// three ways for float32 accuracy).
//
// Replaces the TPU kernel benchmarks/pallas_mxu_ab.py :: sweep_kernel, mode
// "mxu": the same function as csrc/closest_point.cu (min squared distance,
// its face id and closest point, and the solid-angle sum per point), with
// the six point-vector dot products of every (point, triangle) pair,
// p.ab, p.ac, p.n, p.a, p.b, p.c, taken from matrix products instead of the
// FP32 lanes.  The rest is the expanded arithmetic of that kernel:
//   d1..d6     = p.ab - ab.a, p.ac - ac.a, p.ab - ab.b, ...  (per-triangle
//                constants ab.a, ... precomputed once per tile),
//   |a - p|^2  = |a|^2 - 2 p.a + |p|^2,
//   (a-p).(b-p) = a.b - p.a - p.b + |p|^2,
//   num        = a.(b x c) - p.n,  n = b x c + c x a + a x b,
// and then K1's region cascade, square roots and atan2 on the FP32 lanes.
//
// What bounds it: the FP32 and special-function work left per pair, not
// the tensor cores and not memory.  The products take over the dot and
// cross products, about 50 of the ~110 FP32 operations per pair by the TPU
// kernel's count; the cascade, 3 square roots, ~5 divisions and the atan2
// stay.  The probe (bench/sweep_roofline.py) measures whether that is a
// gain.
//
// Design (simple first):
// - One warp owns 16 points, the M rows of an m16n8k8 product: A is
//   [16 points, 8] with columns x, y, z and five zeros (K = 3 padded to 8,
//   as the TPU kernel pads it).  Each step takes 8 triangles, the N
//   columns, and issues one product per vector (ab, ac, n, a, b, c), whose B
//   is [8, 8 triangles] with rows x, y, z and five zeros.
// - Precision: plain TF32 keeps 11 bits and breaks the 1e-5 distance gate.
//   Each operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi),
//   and every product is lo*hi + hi*lo + hi*hi accumulated in float32
//   (3xTF32, about 21 bits); the lo*lo term is below float32's rounding.
// - Cancellation: the expanded forms subtract numbers of size |p|*|a| (or
//   |p|^2) to get results of size |p - a|^2, so their error grows with the
//   distance of the points and triangles from the origin, not with the
//   distance between them.  Near a vertex the solid angle amplifies it: with
//   the mesh's own origin, two float32 evaluations of the expanded winding
//   on the probe's torus differ by ~1e-2.  So each step of 8 triangles works
//   in its own frame, centred on the first corner of its first triangle: the
//   tile stores the shifted corners and constants, and the points are
//   shifted (and split again) once per step.  Near points then carry
//   magnitudes of the triangles' size, and the winding agrees with the plain
//   version to ~1e-6.  Far points (the capsule cache grid's ~1.1 m) keep
//   |p - a| ~ |p|, where nothing cancels.  The squared distance is taken
//   directly as |q - p|^2 in the step's frame.
// - The accumulator fragment gives each thread two points (rows g, g+8)
//   and two triangles (columns 2t, 2t+1) per step: four whole pairs with all
//   six dot products in its own registers.  Each thread keeps a running
//   (min d2, face id, closest point, winding) for its two points over its
//   share of the triangles, in ascending face order with a strict '<'; the
//   four threads of a quad then merge by (d2, face id), so the lowest face
//   id wins ties, as in the plain version.
// - Triangles stream through shared memory in tiles of 128 as 31 float
//   fields each (shifted corners, edges, normal sum and the per-triangle
//   constants of the expanded forms), computed once per block and tile.  A
//   tile's ragged tail is filled with far-away degenerate triangles, like
//   the caller's PAD_COORD padding: they never win and add exactly zero
//   solid angle.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;                        // points per warp (M)
constexpr int kPointsPerBlock = kRows * kWarps;  // 64
constexpr int kCols = 8;                         // triangles per step (N)
constexpr int kTriTile = 128;                    // triangles per tile
constexpr int kStride = kTriTile + 8;            // spreads B loads over banks
constexpr float kPad = 1.0e7f;                   // mesh.PAD_COORD

// shared-memory fields of a triangle
enum Field {
  AX, AY, AZ, BX, BY, BZ, CX, CY, CZ,
  ABX, ABY, ABZ, ACX, ACY, ACZ, NX, NY, NZ,
  AB_A, AC_A, AB_B, AC_B, AB_C, AC_C,
  AA, BB, CC, A_B, B_C, C_A, DET,
  kFields
};

static_assert(kThreads == kTriTile, "one thread fills one triangle of a tile");

// first field of vector v fed to the tensor cores, in product order
// ab, ac, n, a, b, c
__device__ __forceinline__ int vec_field(int v) {
  return v == 0 ? ABX : v == 1 ? ACX : v == 2 ? NX : v == 3 ? AX : v == 4 ? BX : CX;
}

__device__ __forceinline__ float safe_div(float num, float den) {
  return num / (fabsf(den) < 1e-30f ? 1e-30f : den);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += A * B for m16n8k8 TF32 with a2 = a3 = b1 = 0 (columns 4..7 of A and
// rows 4..7 of B are the zero padding of K)
__device__ __forceinline__ void mma_k3(float (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(0u), "r"(b0), "r"(0u));
}

__global__ void __launch_bounds__(kThreads)
closest_point_sweep_mma_kernel(const float* __restrict__ pts, int num_points,
                               const float* __restrict__ tri, int num_tri,
                               float* __restrict__ out_d2,
                               float* __restrict__ out_closest,
                               int* __restrict__ out_fid,
                               float* __restrict__ out_wind) {
  __shared__ float s[kFields][kStride];
  __shared__ float s_origin[3][kTriTile / kCols];  // each step's frame

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;   // fragment row group: points g and g + 8
  const int t = lane & 3;    // thread in group: columns 2t, 2t + 1
  const int row0 = blockIdx.x * kPointsPerBlock + warp * kRows;

  // this thread's two points (rows g and g + 8), zero past the end
  float p[2][3];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
#pragma unroll
    for (int k = 0; k < 3; ++k) p[r][k] = i < num_points ? pts[3 * i + k] : 0.f;
  }

  float best[2], bq[2][3], wind[2];
  int best_fid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    best[r] = __int_as_float(0x7f800000);  // +inf
    best_fid[r] = 0;
    bq[r][0] = bq[r][1] = bq[r][2] = 0.f;
    wind[r] = 0.f;
  }

  for (int f0 = 0; f0 < num_tri; f0 += kTriTile) {
    const int n = min(kTriTile, num_tri - f0);
    const int n_steps = (n + kCols - 1) / kCols;
    __syncthreads();  // the previous tile is no longer read
    {
      const int k = threadIdx.x;
      // the step's frame: the first corner of its first triangle
      const int lead = k & ~(kCols - 1);
      float ox = kPad, oy = kPad, oz = kPad;
      if (lead < n) {
        const float* tl = tri + 9 * (f0 + lead);
        ox = tl[0]; oy = tl[1]; oz = tl[2];
      }
      float ax = kPad, ay = kPad, az = kPad, bx = kPad, by = kPad, bz = kPad,
            cx = kPad, cy = kPad, cz = kPad;
      if (k < n) {
        const float* tp = tri + 9 * (f0 + k);
        ax = tp[0]; ay = tp[1]; az = tp[2];
        bx = tp[3]; by = tp[4]; bz = tp[5];
        cx = tp[6]; cy = tp[7]; cz = tp[8];
      }
      ax = ax - ox; ay = ay - oy; az = az - oz;
      bx = bx - ox; by = by - oy; bz = bz - oz;
      cx = cx - ox; cy = cy - oy; cz = cz - oz;
      if (k == lead) {
        s_origin[0][k / kCols] = ox;
        s_origin[1][k / kCols] = oy;
        s_origin[2][k / kCols] = oz;
      }
      const float abx = bx - ax, aby = by - ay, abz = bz - az;
      const float acx = cx - ax, acy = cy - ay, acz = cz - az;
      s[AX][k] = ax; s[AY][k] = ay; s[AZ][k] = az;
      s[BX][k] = bx; s[BY][k] = by; s[BZ][k] = bz;
      s[CX][k] = cx; s[CY][k] = cy; s[CZ][k] = cz;
      s[ABX][k] = abx; s[ABY][k] = aby; s[ABZ][k] = abz;
      s[ACX][k] = acx; s[ACY][k] = acy; s[ACZ][k] = acz;
      s[NX][k] = (by * cz - bz * cy) + (cy * az - cz * ay) + (ay * bz - az * by);
      s[NY][k] = (bz * cx - bx * cz) + (cz * ax - cx * az) + (az * bx - ax * bz);
      s[NZ][k] = (bx * cy - by * cx) + (cx * ay - cy * ax) + (ax * by - ay * bx);
      s[AB_A][k] = abx * ax + aby * ay + abz * az;
      s[AC_A][k] = acx * ax + acy * ay + acz * az;
      s[AB_B][k] = abx * bx + aby * by + abz * bz;
      s[AC_B][k] = acx * bx + acy * by + acz * bz;
      s[AB_C][k] = abx * cx + aby * cy + abz * cz;
      s[AC_C][k] = acx * cx + acy * cy + acz * cz;
      s[AA][k] = ax * ax + ay * ay + az * az;
      s[BB][k] = bx * bx + by * by + bz * bz;
      s[CC][k] = cx * cx + cy * cy + cz * cz;
      s[A_B][k] = ax * bx + ay * by + az * bz;
      s[B_C][k] = bx * cx + by * cy + bz * cz;
      s[C_A][k] = cx * ax + cy * ay + cz * az;
      s[DET][k] = ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz)
                  + az * (bx * cy - by * cx);
    }
    __syncthreads();

    for (int step = 0; step < n_steps; ++step) {
      const int base = step * kCols;
      const float o[3] = {s_origin[0][step], s_origin[1][step], s_origin[2][step]};
      // this thread's points in the step's frame, and the A fragment:
      // a0 = (row g, column t), a1 = (row g + 8, column t); column t is
      // coordinate t for t < 3 and padding for t = 3
      float q[2][3], pp[2];
      uint32_t a_hi[2], a_lo[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        q[r][0] = p[r][0] - o[0];
        q[r][1] = p[r][1] - o[1];
        q[r][2] = p[r][2] - o[2];
        pp[r] = q[r][0] * q[r][0] + q[r][1] * q[r][1] + q[r][2] * q[r][2];
        const float x = t == 0 ? q[r][0] : t == 1 ? q[r][1] : t == 2 ? q[r][2] : 0.f;
        split_tf32(x, a_hi[r], a_lo[r]);
      }
      // dots[v][e]: vector v, accumulator element e = (row g + 8 * (e >> 1),
      // column 2t + (e & 1))
      float dots[6][4];
#pragma unroll
      for (int v = 0; v < 6; ++v) {
        // B fragment: b0 = (row t, column g) = component t of vector v of
        // triangle base + g; row 3 is padding
        uint32_t b_hi, b_lo;
        split_tf32(t < 3 ? s[vec_field(v) + t][base + g] : 0.f, b_hi, b_lo);
        dots[v][0] = dots[v][1] = dots[v][2] = dots[v][3] = 0.f;
        mma_k3(dots[v], a_lo[0], a_lo[1], b_hi);
        mma_k3(dots[v], a_hi[0], a_hi[1], b_lo);
        mma_k3(dots[v], a_hi[0], a_hi[1], b_hi);
      }

#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = base + 2 * t + c;
        const float ax = s[AX][k], ay = s[AY][k], az = s[AZ][k];
        const float abx = s[ABX][k], aby = s[ABY][k], abz = s[ABZ][k];
        const float acx = s[ACX][k], acy = s[ACY][k], acz = s[ACZ][k];
        const float ab_a = s[AB_A][k], ac_a = s[AC_A][k];
        const float ab_b = s[AB_B][k], ac_b = s[AC_B][k];
        const float ab_c = s[AB_C][k], ac_c = s[AC_C][k];
        const float aa = s[AA][k], bb = s[BB][k], cc = s[CC][k];
        const float a_b = s[A_B][k], b_c = s[B_C][k], c_a = s[C_A][k];
        const float det = s[DET][k];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float pab = dots[0][e], pac = dots[1][e], pn = dots[2][e];
          const float pa = dots[3][e], pb = dots[4][e], pc = dots[5][e];

          // ---- closest point: K1's cascade on the expanded d1..d6 ----
          const float d1 = pab - ab_a;
          const float d2 = pac - ac_a;
          const float d3 = pab - ab_b;
          const float d4 = pac - ac_b;
          const float d5 = pab - ab_c;
          const float d6 = pac - ac_c;

          const float va = d3 * d6 - d5 * d4;
          const float vb = d5 * d2 - d1 * d6;
          const float vc = d1 * d4 - d3 * d2;

          const float denom = va + vb + vc;
          const float v_in = safe_div(vb, denom);
          const float w_in = safe_div(vc, denom);
          const float v_ab = safe_div(d1, d1 - d3);
          const float w_ac = safe_div(d2, d2 - d6);
          const float w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6));

          const bool in_a = (d1 <= 0.f) && (d2 <= 0.f);
          const bool in_b = (d3 >= 0.f) && (d4 <= d3);
          const bool in_c = (d6 >= 0.f) && (d5 <= d6);
          const bool on_ab = (vc <= 0.f) && (d1 >= 0.f) && (d3 <= 0.f);
          const bool on_ac = (vb <= 0.f) && (d2 >= 0.f) && (d6 <= 0.f);
          const bool on_bc = (va <= 0.f) && (d4 - d3 >= 0.f) && (d5 - d6 >= 0.f);

          float v = on_bc ? 1.f - w_bc : v_in;
          float w = on_bc ? w_bc : w_in;
          if (on_ac) { v = 0.f; w = w_ac; }
          if (on_ab) { v = v_ab; w = 0.f; }
          if (in_c) { v = 0.f; w = 1.f; }
          if (in_b) { v = 1.f; w = 0.f; }
          if (in_a) { v = 0.f; w = 0.f; }

          const float qx = ax + v * abx + w * acx;
          const float qy = ay + v * aby + w * acy;
          const float qz = az + v * abz + w * acz;
          const float dx = qx - q[r][0], dy = qy - q[r][1], dz = qz - q[r][2];
          const float dist2 = dx * dx + dy * dy + dz * dz;

          // ---- solid angle from the expanded forms ----
          const float la = sqrtf(fmaxf(aa - 2.f * pa + pp[r], 0.f));
          const float lb = sqrtf(fmaxf(bb - 2.f * pb + pp[r], 0.f));
          const float lc = sqrtf(fmaxf(cc - 2.f * pc + pp[r], 0.f));
          const float num = det - pn;
          const float den = la * lb * lc + (a_b - pa - pb + pp[r]) * lc
                            + (b_c - pb - pc + pp[r]) * la
                            + (c_a - pc - pa + pp[r]) * lb;
          wind[r] += 2.f * atan2f(num, den);

          if (dist2 < best[r]) {
            best[r] = dist2;
            best_fid[r] = f0 + k;
            bq[r][0] = qx + o[0]; bq[r][1] = qy + o[1]; bq[r][2] = qz + o[2];
          }
        }
      }
    }
  }

  // merge the quad's four partial results: min by (d2, face id), sum winding
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      const float o_d2 = __shfl_xor_sync(0xffffffffu, best[r], m);
      const int o_fid = __shfl_xor_sync(0xffffffffu, best_fid[r], m);
      const float o_qx = __shfl_xor_sync(0xffffffffu, bq[r][0], m);
      const float o_qy = __shfl_xor_sync(0xffffffffu, bq[r][1], m);
      const float o_qz = __shfl_xor_sync(0xffffffffu, bq[r][2], m);
      wind[r] += __shfl_xor_sync(0xffffffffu, wind[r], m);
      if (o_d2 < best[r] || (o_d2 == best[r] && o_fid < best_fid[r])) {
        best[r] = o_d2;
        best_fid[r] = o_fid;
        bq[r][0] = o_qx; bq[r][1] = o_qy; bq[r][2] = o_qz;
      }
    }
    const int i = row0 + g + 8 * r;
    if (t == 0 && i < num_points) {
      out_d2[i] = best[r];
      out_closest[3 * i + 0] = bq[r][0];
      out_closest[3 * i + 1] = bq[r][1];
      out_closest[3 * i + 2] = bq[r][2];
      out_fid[i] = best_fid[r];
      out_wind[i] = wind[r];
    }
  }
}

}  // namespace

// C interface, loaded with ctypes; the same contract as
// pvt_closest_point_sweep in closest_point.cu: pts [P,3], tri [F,3,3]
// float32 contiguous on the device; outputs d2 [P], closest [P,3], fid [P]
// int32, wind [P] (raw solid-angle sum).  Launches on `stream` and returns
// the cudaGetLastError() code of the launch (0 on success).
extern "C" int pvt_closest_point_sweep_mma(const float* pts, int num_points,
                                           const float* tri, int num_tri,
                                           float* d2, float* closest, int* fid,
                                           float* wind, void* stream) {
  if (num_points <= 0) return 0;
  const int blocks = (num_points + kPointsPerBlock - 1) / kPointsPerBlock;
  closest_point_sweep_mma_kernel<<<blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      pts, num_points, tri, num_tri, d2, closest, fid, wind);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
