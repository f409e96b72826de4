// Narrow-band mesh SDF query (Hopper): one thread per point.
//
// Replaces no Pallas kernel: the JAX package computes this query as plain
// XLA, fused under jit (pytorch_volumetric_tpu/ops/narrow_band.py ::
// _query_impl, with _candidate_query).  Its plain PyTorch version is
// ops/narrow_band.py :: _query_impl, which materialises a [P, K, 10] row
// gather and some fifty elementwise passes over [P, K]; this kernel reads
// each in-band point's candidate rows once and keeps everything else in
// registers.
//
// Per point (cell keys (p - lo) * f32(1 / res), the arithmetic of the JAX
// package's compiled query, where XLA folds the division by a constant):
//  1. the cell key, clamped into the grid, and the cell's meta row (value,
//     gradient at the center, candidate slot; slot < 0: far field);
//  2. far field: the center's value plus the gradient's first-order step;
//  3. in band: the closest-point cascade (point_triangle.cuh) over the
//     slot's K candidate rows (9 corner floats and the face id as an int32
//     bit pattern), keeping the first strict minimum as argmin does, then
//     the winner's pseudonormal (one 21-float row: face, 3 vertices, 3
//     edges) at its closest feature for the sign, and the pseudonormal as
//     the gradient within surface_normal_eps of the surface;
//  4. outside the grid: the distance to the surface's bounding box.
// Far and out-of-grid points skip the candidate loop (the JAX code
// computes a cascade for them and discards it).  Padding rows (PAD_COORD
// corners, face id 0) give squared distances near 1e14 and never win.
//
// What bounds it on an H100: memory.  An in-band point reads K rows of 40
// bytes (K = 430 at the bigmesh shape, 17 KB per point) against ~60 FP32
// operations per row; the arithmetic intensity (~1.5 operations per byte)
// is far below the card's ~20.  This first version reads the rows straight
// from global memory, one thread per point, with no sorting of points by
// cell and no shared-memory staging: neighbouring threads read unrelated
// cells, and a cell's rows are read again by every point in it, from L2 at
// best.  Sorting points by cell and staging a cell's rows in shared memory
// would read each row once per block.
//
// Every sum and product is written in the plain version's order, and the
// library is built with -fmad=false, so on the card the kernel reproduces
// the plain version's values, gradients and slots bit for bit.

#include <cuda_runtime.h>

#include "point_triangle.cuh"  // Tri, closest_pair

namespace {

constexpr int kThreads = 128;
constexpr int kRow = 10;    // candidate row: a, b, c corners, face id bits
constexpr int kPseudo = 21;  // pseudonormal row: face, vertices A-C, edges AB, BC, CA

struct Grid {
  float lo[3], inv_res[3], res[3], bb_lo[3], bb_hi[3];
  int dims[3], strides[3];
  float eps;
};

__global__ void __launch_bounds__(kThreads)
narrow_band_kernel(const float* __restrict__ pts, int num_points, Grid g,
                   const float* __restrict__ meta, const float* __restrict__ cand, int K,
                   const float* __restrict__ pseudo, float* __restrict__ out_val,
                   float* __restrict__ out_grad, int* __restrict__ out_slot) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= num_points) return;
  const float p[3] = {pts[3 * i + 0], pts[3 * i + 1], pts[3 * i + 2]};

  int kc[3];
  bool in_grid = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float f = (p[d] - g.lo[d]) * g.inv_res[d];
    // clamped to [-1, dims] before the conversion (NaN -> -1): the grid
    // test is unchanged and the int conversion stays in range
    const float fl = fminf(fmaxf(floorf(f), -1.f), static_cast<float>(g.dims[d]));
    const int k = static_cast<int>(fl);
    in_grid = in_grid && k >= 0 && k < g.dims[d];
    kc[d] = min(max(k, 0), g.dims[d] - 1);
  }

  float val, gx, gy, gz;
  int slot = -2;  // out of the grid
  if (in_grid) {
    const float* m = meta + 5LL * (kc[0] * g.strides[0] + kc[1] * g.strides[1] +
                                   kc[2] * g.strides[2]);
    slot = static_cast<int>(m[4]);
    if (slot >= 0) {
      const float* rows = cand + static_cast<long long>(slot) * K * kRow;
      float best = 0.f, qx = 0.f, qy = 0.f, qz = 0.f;
      int feat = 0, fid = 0;
      for (int k = 0; k < K; ++k) {
        const float* r = rows + static_cast<long long>(k) * kRow;
        Tri t;
        t.ax = __ldg(r + 0); t.ay = __ldg(r + 1); t.az = __ldg(r + 2);
        t.bx = __ldg(r + 3); t.by = __ldg(r + 4); t.bz = __ldg(r + 5);
        t.cx = __ldg(r + 6); t.cy = __ldg(r + 7); t.cz = __ldg(r + 8);
        t.abx = t.bx - t.ax; t.aby = t.by - t.ay; t.abz = t.bz - t.az;
        t.acx = t.cx - t.ax; t.acy = t.cy - t.ay; t.acz = t.cz - t.az;
        float x, y, z;
        int f;
        const float d2 = closest_pair(t, p[0], p[1], p[2], x, y, z, f);
        // the first candidate, then the first strict minimum (argmin)
        if (k == 0 || d2 < best) {
          best = d2;
          qx = x; qy = y; qz = z;
          feat = f;
          fid = __float_as_int(__ldg(r + 9));
        }
      }
      const float dist = sqrtf(best);
      const float* pn = pseudo + static_cast<long long>(fid) * kPseudo + 3 * feat;
      const float nx = __ldg(pn + 0), ny = __ldg(pn + 1), nz = __ldg(pn + 2);
      const float tx = p[0] - qx, ty = p[1] - qy, tz = p[2] - qz;
      const float sgn = (tx * nx + ty * ny + tz * nz) < 0.f ? -1.f : 1.f;
      val = sgn * dist;
      if (dist < g.eps) {
        // at the surface the direction is degenerate: the pseudonormal
        const float den = fmaxf(sqrtf(nx * nx + ny * ny + nz * nz), 1e-12f);
        gx = nx / den; gy = ny / den; gz = nz / den;
      } else {
        const float den = fmaxf(dist, 1e-12f);
        gx = (sgn * tx) / den; gy = (sgn * ty) / den; gz = (sgn * tz) / den;
      }
    } else {
      const float cx = g.lo[0] + (static_cast<float>(kc[0]) + 0.5f) * g.res[0];
      const float cy = g.lo[1] + (static_cast<float>(kc[1]) + 0.5f) * g.res[1];
      const float cz = g.lo[2] + (static_cast<float>(kc[2]) + 0.5f) * g.res[2];
      gx = m[1]; gy = m[2]; gz = m[3];
      val = m[0] + (gx * (p[0] - cx) + gy * (p[1] - cy) + gz * (p[2] - cz));
    }
  } else {
    float dt[3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      dt[d] = fmaxf(p[d] - g.bb_hi[d], 0.f) - fmaxf(g.bb_lo[d] - p[d], 0.f);
    val = sqrtf(dt[0] * dt[0] + dt[1] * dt[1] + dt[2] * dt[2]);
    const float den = fmaxf(val, 1e-12f);
    gx = dt[0] / den; gy = dt[1] / den; gz = dt[2] / den;
  }
  out_val[i] = val;
  out_grad[3 * i + 0] = gx;
  out_grad[3 * i + 1] = gy;
  out_grad[3 * i + 2] = gz;
  if (out_slot != nullptr) out_slot[i] = slot;
}

}  // namespace

// C interface, loaded with ctypes.  pts [P,3] float32, meta [C,5], cand
// [S,K,10], pseudo [F,21], all contiguous on the device.  grid_f: 16 host
// floats (lo xyz, 1/res xyz, res xyz, surface box lo xyz, hi xyz, the
// surface-normal eps); grid_i: 6 host ints (dims xyz, strides xyz).
// Outputs val [P], grad [P,3] and, unless null, slot [P] int32 (the
// candidate slot, -1 far field, -2 outside the grid).  Launches on `stream`
// and returns the cudaGetLastError() code of the launch (0 on success).
extern "C" int pvt_narrow_band_query(const float* pts, int num_points, const float* grid_f,
                                     const int* grid_i, const float* meta, const float* cand,
                                     int K, const float* pseudo, float* val, float* grad,
                                     int* slot, void* stream) {
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
  narrow_band_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, num_points, g, meta, cand, K, pseudo, val, grad, slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
