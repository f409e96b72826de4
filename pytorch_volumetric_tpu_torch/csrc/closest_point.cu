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
// What bounds it on an H100: arithmetic, not memory.  Each pair costs about
// 110 FP32 operations plus 3 square roots, 5 divisions and one atan2, while
// the bytes are tiny: a point is read once, a triangle once per block of
// points and from L2 after the first block.  The square roots, divisions
// and atan2 lean on the special-function units, which may bind before the
// FP32 lanes do.
//
// Design (simple first): one thread per point, 128 points per block.  The
// block streams tiles of 128 triangles through shared memory (corners plus
// the two edge vectors, 15 floats each); every thread reads the same
// triangle at the same time, so shared-memory reads are broadcasts.  The
// running state stays in registers.  Ragged point counts are masked here;
// triangles may carry the caller's far-away padding, which never wins the
// min and gives exactly zero solid angle.
//
// Every sum and product is written in the same order as the plain PyTorch
// version (ops/point_triangle.py), and the library is built with
// -fmad=false, so on the card the kernel reproduces the plain version's
// squared distances, closest points and face ids bit for bit; only the
// winding sum differs, by summation order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // points per block, one per thread
constexpr int kTriTile = 128;   // triangles per shared-memory tile

__device__ __forceinline__ float safe_div(float num, float den) {
  return num / (fabsf(den) < 1e-30f ? 1e-30f : den);
}

__global__ void __launch_bounds__(kThreads)
closest_point_sweep_kernel(const float* __restrict__ pts, int num_points,
                           const float* __restrict__ tri, int num_tri,
                           float* __restrict__ out_d2,
                           float* __restrict__ out_closest,
                           int* __restrict__ out_fid,
                           float* __restrict__ out_wind) {
  // structure-of-arrays tile: a, b, c corners and ab = b - a, ac = c - a
  __shared__ float s[15][kTriTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < num_points;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (live) {
    px = pts[3 * i + 0];
    py = pts[3 * i + 1];
    pz = pts[3 * i + 2];
  }

  float best = __int_as_float(0x7f800000);  // +inf
  int best_fid = 0;
  float bqx = 0.f, bqy = 0.f, bqz = 0.f;
  float wind = 0.f;

  for (int f0 = 0; f0 < num_tri; f0 += kTriTile) {
    const int n = min(kTriTile, num_tri - f0);
    __syncthreads();  // the previous tile is no longer read
    if (threadIdx.x < n) {
      const float* t = tri + 9 * (f0 + threadIdx.x);
      const int k = threadIdx.x;
      const float ax = t[0], ay = t[1], az = t[2];
      const float bx = t[3], by = t[4], bz = t[5];
      const float cx = t[6], cy = t[7], cz = t[8];
      s[0][k] = ax; s[1][k] = ay; s[2][k] = az;
      s[3][k] = bx; s[4][k] = by; s[5][k] = bz;
      s[6][k] = cx; s[7][k] = cy; s[8][k] = cz;
      s[9][k] = bx - ax; s[10][k] = by - ay; s[11][k] = bz - az;
      s[12][k] = cx - ax; s[13][k] = cy - ay; s[14][k] = cz - az;
    }
    __syncthreads();

    for (int k = 0; k < n; ++k) {
      const float ax = s[0][k], ay = s[1][k], az = s[2][k];
      const float bx = s[3][k], by = s[4][k], bz = s[5][k];
      const float cx = s[6][k], cy = s[7][k], cz = s[8][k];
      const float abx = s[9][k], aby = s[10][k], abz = s[11][k];
      const float acx = s[12][k], acy = s[13][k], acz = s[14][k];

      // ---- closest point (Ericson RTCD 5.1.5) ----
      const float apx = px - ax, apy = py - ay, apz = pz - az;
      const float d1 = abx * apx + aby * apy + abz * apz;
      const float d2 = acx * apx + acy * apy + acz * apz;
      const float bpx = apx - abx, bpy = apy - aby, bpz = apz - abz;
      const float d3 = abx * bpx + aby * bpy + abz * bpz;
      const float d4 = acx * bpx + acy * bpy + acz * bpz;
      const float cpx = apx - acx, cpy = apy - acy, cpz = apz - acz;
      const float d5 = abx * cpx + aby * cpy + abz * cpz;
      const float d6 = acx * cpx + acy * cpy + acz * cpz;

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

      // priority cascade: interior < BC < AC < AB < C < B < A
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
      const float dx = qx - px, dy = qy - py, dz = qz - pz;
      const float dist2 = dx * dx + dy * dy + dz * dz;

      // ---- solid angle (van Oosterom & Strackee) ----
      const float a0 = ax - px, a1 = ay - py, a2 = az - pz;
      const float b0 = bx - px, b1 = by - py, b2 = bz - pz;
      const float c0 = cx - px, c1 = cy - py, c2 = cz - pz;
      const float la = sqrtf(a0 * a0 + a1 * a1 + a2 * a2);
      const float lb = sqrtf(b0 * b0 + b1 * b1 + b2 * b2);
      const float lc = sqrtf(c0 * c0 + c1 * c1 + c2 * c2);
      const float x0 = b1 * c2 - b2 * c1;
      const float x1 = b2 * c0 - b0 * c2;
      const float x2 = b0 * c1 - b1 * c0;
      const float num = a0 * x0 + a1 * x1 + a2 * x2;
      const float den = la * lb * lc + (a0 * b0 + a1 * b1 + a2 * b2) * lc
                        + (b0 * c0 + b1 * c1 + b2 * c2) * la
                        + (c0 * a0 + c1 * a1 + c2 * a2) * lb;
      wind += 2.f * atan2f(num, den);

      if (dist2 < best) {
        best = dist2;
        best_fid = f0 + k;
        bqx = qx; bqy = qy; bqz = qz;
      }
    }
  }

  if (live) {
    out_d2[i] = best;
    out_closest[3 * i + 0] = bqx;
    out_closest[3 * i + 1] = bqy;
    out_closest[3 * i + 2] = bqz;
    out_fid[i] = best_fid;
    out_wind[i] = wind;
  }
}

}  // namespace

// C interface, loaded with ctypes.  pts [P,3], tri [F,3,3] float32
// contiguous on the device; outputs d2 [P], closest [P,3], fid [P] int32,
// wind [P] (raw solid-angle sum).  Launches on `stream` and returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int pvt_closest_point_sweep(const float* pts, int num_points,
                                       const float* tri, int num_tri,
                                       float* d2, float* closest, int* fid,
                                       float* wind, void* stream) {
  if (num_points <= 0) return 0;
  const int blocks = (num_points + kThreads - 1) / kThreads;
  closest_point_sweep_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      pts, num_points, tri, num_tri, d2, closest, fid, wind);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
