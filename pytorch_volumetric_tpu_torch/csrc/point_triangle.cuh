// Point -> triangle closest point (Ericson RTCD 5.1.5), shared by the sweep
// (closest_point.cu), its tensor-core variant (closest_point_mma.cu) and the
// narrow-band query (narrow_band.cu), and the solid angle and thin-triangle
// test of the sweeps.
//
// Operation for operation as the plain version's _closest_point_bary,
// _region_cascade and _winding_contrib (ops/point_triangle.py): every dot
// product summed x, y, z in order, and each kept quotient the same IEEE
// division of the same operands.  Built with -fmad=false, so the kernels
// reproduce the plain version bit for bit.

#pragma once

struct Tri {
  float ax, ay, az, bx, by, bz, cx, cy, cz, abx, aby, abz, acx, acy, acz;
};

__device__ __forceinline__ float safe_den(float den) {
  return fabsf(den) < 1e-30f ? 1e-30f : den;
}

// The cascade on given d1 = ab.(p - a), d2 = ac.(p - a), d3, d4 (from b)
// and d5, d6 (from c): the squared distance from p to its closest point q
// on t, and the closest feature: 0 face, 1..3 vertex A/B/C, 4 edge AB,
// 5 edge BC, 6 edge CA (the pseudonormal row layout of ops/narrow_band.py).
// Only t's a, ab and ac are read.
//
// Select, then divide: the six region flags come first; the quotient each
// output needs is picked by the cascade's priority and divided once, two
// divisions per pair instead of the plain version's five.
__device__ __forceinline__ float closest_from_d(const Tri& t, float d1, float d2, float d3,
                                                float d4, float d5, float d6, float px,
                                                float py, float pz, float& qx, float& qy,
                                                float& qz, int& feat) {
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;
  const float denom = va + vb + vc;
  const float e43 = d4 - d3, e56 = d5 - d6;

  const bool in_a = (d1 <= 0.f) && (d2 <= 0.f);
  const bool in_b = (d3 >= 0.f) && (d4 <= d3);
  const bool in_c = (d6 >= 0.f) && (d5 <= d6);
  const bool on_ab = (vc <= 0.f) && (d1 >= 0.f) && (d3 <= 0.f);
  const bool on_ac = (vb <= 0.f) && (d2 >= 0.f) && (d6 <= 0.f);
  const bool on_bc = (va <= 0.f) && (e43 >= 0.f) && (e56 >= 0.f);

  // priority: A > B > C > AB > AC > BC > interior.  The first quotient is
  // the one the winning edge needs (v_ab, w_ac or w_bc) or the interior's
  // v; the second is the interior's w.
  float num = vb, den = denom;
  if (on_bc) { num = e43; den = e43 + e56; }
  if (on_ac) { num = d2; den = d2 - d6; }
  if (on_ab) { num = d1; den = d1 - d3; }
  const float q1 = num / safe_den(den);
  const float q2 = vc / safe_den(denom);
  float v = q1, w = q2;
  int f = 0;
  if (on_bc) { v = 1.f - q1; w = q1; f = 5; }
  if (on_ac) { v = 0.f; w = q1; f = 6; }
  if (on_ab) { v = q1; w = 0.f; f = 4; }
  if (in_c) { v = 0.f; w = 1.f; f = 3; }
  if (in_b) { v = 1.f; w = 0.f; f = 2; }
  if (in_a) { v = 0.f; w = 0.f; f = 1; }
  feat = f;

  qx = t.ax + v * t.abx + w * t.acx;
  qy = t.ay + v * t.aby + w * t.acy;
  qz = t.az + v * t.abz + w * t.acz;
  const float dx = qx - px, dy = qy - py, dz = qz - pz;
  return dx * dx + dy * dy + dz * dz;
}

// The squared distance from p to its closest point q on t, and the closest
// feature (as closest_from_d), with d1..d6 from the corners.
__device__ __forceinline__ float closest_pair(const Tri& t, float px, float py, float pz,
                                              float& qx, float& qy, float& qz, int& feat) {
  const float apx = px - t.ax, apy = py - t.ay, apz = pz - t.az;
  const float d1 = t.abx * apx + t.aby * apy + t.abz * apz;
  const float d2 = t.acx * apx + t.acy * apy + t.acz * apz;
  const float bpx = apx - t.abx, bpy = apy - t.aby, bpz = apz - t.abz;
  const float d3 = t.abx * bpx + t.aby * bpy + t.abz * bpz;
  const float d4 = t.acx * bpx + t.acy * bpy + t.acz * bpz;
  const float cpx = apx - t.acx, cpy = apy - t.acy, cpz = apz - t.acz;
  const float d5 = t.abx * cpx + t.aby * cpy + t.abz * cpz;
  const float d6 = t.acx * cpx + t.acy * cpy + t.acz * cpz;
  return closest_from_d(t, d1, d2, d3, d4, d5, d6, px, py, pz, qx, qy, qz, feat);
}

// The same without the feature (the sweep's form; the compiler drops it).
__device__ __forceinline__ float closest_pair(const Tri& t, float px, float py, float pz,
                                              float& qx, float& qy, float& qz) {
  int feat;
  return closest_pair(t, px, py, pz, qx, qy, qz, feat);
}

// Solid angle of t seen from p (van Oosterom & Strackee), as the plain
// version's _winding_contrib.
__device__ __forceinline__ float solid_angle(const Tri& t, float px, float py, float pz) {
  const float a0 = t.ax - px, a1 = t.ay - py, a2 = t.az - pz;
  const float b0 = t.bx - px, b1 = t.by - py, b2 = t.bz - pz;
  const float c0 = t.cx - px, c1 = t.cy - py, c2 = t.cz - pz;
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
  return 2.f * atan2f(num, den);
}

// Whether a triangle with edges ab, ac is thin: squared area (of the
// parallelogram) below `thin` of its longer edge's fourth power.  NaN is
// thin.
__device__ __forceinline__ bool is_thin(float abx, float aby, float abz, float acx,
                                        float acy, float acz, float thin) {
  const float x0 = aby * acz - abz * acy;
  const float x1 = abz * acx - abx * acz;
  const float x2 = abx * acy - aby * acx;
  const float cross2 = x0 * x0 + x1 * x1 + x2 * x2;
  const float l2 = fmaxf(abx * abx + aby * aby + abz * abz, acx * acx + acy * acy + acz * acz);
  return !(cross2 >= thin * (l2 * l2));
}
