// Forward kinematics of a robot's SDF links (Hopper): the link-major
// transforms obj->link and link->obj of every configuration, and their d/dq.
//
// Replaces no Pallas kernel: the JAX package walks the kinematic tree in jnp
// (pytorch_volumetric_tpu/kinematics.py :: Chain.fk_matrices, then
// model_to_sdf.py :: RobotSDF._link_transforms), which XLA compiles into the
// query's program.  The port's plain PyTorch version is the same walk run
// eagerly (ops/fk.py :: link_transforms_plain, operation for operation
// kinematics.Chain.fk_matrices and RobotSDF._link_transforms): about 24
// operations a revolute joint and 12 a link, ~290 launches forward and ~420
// in autograd's backward for a 7-joint arm, each moving a few KB, so the
// host's launches, not the card, set its time.
//
// What bounds it on an H100: latency.  A call reads q [A, M] and writes two
// [L*A, 4, 4] matrices (~200 KB at A = 200, L = 8) against ~3 KFLOP a
// configuration; the time is the chain of dependent 4x4 products down the
// tree.  The design keeps that chain short and in registers:
//   Forward: one thread per configuration walks the frames in topological
//   order.  A frame's world matrix is kept in registers for the next frame
//   and stored to a scratch array [F, 16, A] (consecutive threads on
//   consecutive addresses); a frame whose parent is not the frame before it
//   (a branch) loads its parent from there.  At each frame the thread writes
//   the outputs of the SDF links that live there.
//   Backward (d/dq): forward mode, one thread per (configuration, actuated
//   joint) lane.  The lane walks the tree as the forward does, carrying each
//   frame's world matrix W and its tangent T = dW/dq_j (scratch [F, 32,
//   A*M]); a mimic joint's value moves with its master's times the
//   multiplier.  At each link it forms the tangents of both outputs through
//   invert_tf's linearisation, (dR^T, -(dR^T t + R^T dt)), and contracts
//   them with the outputs' cotangents.  No atomics, no autograd graph.
//
// Every product and sum is written in the plain version's order of terms
// (a 4x4 product as ((a0 b0 + a1 b1) + a2 b2) + a3 b3; Rodrigues as
// (c I + s K) + (1 - c) u u^T with u = axis / max(|axis|, 1e-12) and |axis|
// summed as torch.linalg.vector_norm's CUDA reduction, (a0^2 + a2^2) + a1^2;
// invert_tf's -((R00 t0 + R10 t1) + R20 t2)), and the library is built with
// -fmad=false.  cuBLAS's products in the plain version sum in an order of
// their own, so the two agree to float32 rounding, not bit for bit.
//
// One call of each C entry launches one kernel on the caller's stream, with
// no host synchronisation and no allocation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// a frame's kind, flags: as ops/fk.py's FIXED, REVOLUTE, PRISMATIC, MIMIC,
// JOINT_OFFSET, NO_JOINT.  Every frame, the root too, starts from its
// parent's world matrix (the identity at the root) and, unless it has no
// joint, applies its origin and motion.
constexpr int kRevolute = 1, kPrismatic = 2;
constexpr int kMimic = 1, kJointOffset = 2, kNoJoint = 4;

struct Mat {
  float v[16];  // row-major 4x4
};

struct Desc {
  const int* frames;          // [F, 4]: parent, kind, q index, flags
  const float* origins;       // [F, 16]
  const float* axes;          // [F, 3]
  const float* joint_offsets; // [F, 2, 16]
  const double* mimic;        // [F, 2]: multiplier, offset
  const int* link_frames;     // [L]
  const float* offset_inv;    // [L, 16]
  int F, L;
};

__device__ __forceinline__ Mat load(const float* p) {
  Mat m;
#pragma unroll
  for (int k = 0; k < 16; ++k) m.v[k] = __ldg(p + k);
  return m;
}

__device__ __forceinline__ Mat identity() {
  Mat m;
#pragma unroll
  for (int k = 0; k < 16; ++k) m.v[k] = (k % 5 == 0) ? 1.0f : 0.0f;
  return m;
}

__device__ __forceinline__ Mat zero() {
  Mat m;
#pragma unroll
  for (int k = 0; k < 16; ++k) m.v[k] = 0.0f;
  return m;
}

// a @ b, each entry ((a0 b0 + a1 b1) + a2 b2) + a3 b3
__device__ __forceinline__ Mat mm(const Mat& a, const Mat& b) {
  Mat c;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c.v[4 * r + k] = ((a.v[4 * r] * b.v[k] + a.v[4 * r + 1] * b.v[4 + k]) +
                        a.v[4 * r + 2] * b.v[8 + k]) + a.v[4 * r + 3] * b.v[12 + k];
    }
  }
  return c;
}

__device__ __forceinline__ Mat add(const Mat& a, const Mat& b) {
  Mat c;
#pragma unroll
  for (int k = 0; k < 16; ++k) c.v[k] = a.v[k] + b.v[k];
  return c;
}

// transforms.invert_tf: (R^T, -R^T t), bottom row (0, 0, 0, 1)
__device__ __forceinline__ Mat invert_tf(const Mat& m) {
  Mat o;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) o.v[4 * i + k] = m.v[4 * k + i];
    o.v[4 * i + 3] = -((m.v[i] * m.v[3] + m.v[4 + i] * m.v[7]) + m.v[8 + i] * m.v[11]);
  }
  o.v[12] = o.v[13] = o.v[14] = 0.0f;
  o.v[15] = 1.0f;
  return o;
}

// invert_tf's derivative at m along dm: (dR^T, -(dR^T t + R^T dt)), bottom row 0
__device__ __forceinline__ Mat invert_tf_tangent(const Mat& m, const Mat& dm) {
  Mat o;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) o.v[4 * i + k] = dm.v[4 * k + i];
    o.v[4 * i + 3] = -(((dm.v[i] * m.v[3] + dm.v[4 + i] * m.v[7]) + dm.v[8 + i] * m.v[11]) +
                       ((m.v[i] * dm.v[3] + m.v[4 + i] * dm.v[7]) + m.v[8 + i] * dm.v[11]));
  }
  o.v[12] = o.v[13] = o.v[14] = o.v[15] = 0.0f;
  return o;
}

// the joint's value: q[src], or a mimic joint's multiplier * q[master] + offset
// (each rounded to float32 first, as a Python scalar times a float32 tensor is)
__device__ __forceinline__ float joint_value(const Desc& d, int f, int flags, float qs) {
  if (!(flags & kMimic)) return qs;
  return static_cast<float>(d.mimic[2 * f]) * qs + static_cast<float>(d.mimic[2 * f + 1]);
}

// the joint's motion at value x (make_tf of Rodrigues' rotation, or of the
// translation axis * x) and, with tangent, its derivative times dx
template <bool kTangent>
__device__ __forceinline__ void motion(const Desc& d, int f, int kind, float x, float dx,
                                       Mat& mot, Mat& dmot) {
  const float a0 = __ldg(d.axes + 3 * f), a1 = __ldg(d.axes + 3 * f + 1),
              a2 = __ldg(d.axes + 3 * f + 2);
  mot = identity();
  if (kTangent) dmot = zero();
  if (kind == kPrismatic) {
    mot.v[3] = a0 * x;
    mot.v[7] = a1 * x;
    mot.v[11] = a2 * x;
    if (kTangent) {
      dmot.v[3] = a0 * dx;
      dmot.v[7] = a1 * dx;
      dmot.v[11] = a2 * dx;
    }
    return;
  }
  float n = sqrtf((a0 * a0 + a2 * a2) + a1 * a1);
  n = n < 1e-12f ? 1e-12f : n;  // torch.clamp(min=1e-12), NaN kept
  const float u[3] = {a0 / n, a1 / n, a2 / n};
  const float c = cosf(x), s = sinf(x), omc = 1.0f - c;
  // K = [[0, -uz, uy], [uz, 0, -ux], [-uy, ux, 0]]
  const float K[9] = {0.0f, -u[2], u[1], u[2], 0.0f, -u[0], -u[1], u[0], 0.0f};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float e = r == k ? 1.0f : 0.0f, uu = u[r] * u[k];
      mot.v[4 * r + k] = (c * e + s * K[3 * r + k]) + omc * uu;
      // d/dx of (c I + s K + (1 - c) u u^T) = -s I + c K + s u u^T
      if (kTangent) dmot.v[4 * r + k] = ((-s * e + c * K[3 * r + k]) + s * uu) * dx;
    }
  }
}

__device__ __forceinline__ void store_strided(float* base, long long stride, const Mat& m) {
#pragma unroll
  for (int k = 0; k < 16; ++k) base[k * stride] = m.v[k];
}

__device__ __forceinline__ Mat load_strided(const float* base, long long stride) {
  Mat m;
#pragma unroll
  for (int k = 0; k < 16; ++k) m.v[k] = base[k * stride];
  return m;
}

__device__ __forceinline__ void store_row_major(float* out, const Mat& m) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    o[r] = make_float4(m.v[4 * r], m.v[4 * r + 1], m.v[4 * r + 2], m.v[4 * r + 3]);
}

// the sum over the 16 entries of a * b, in row-major order
__device__ __forceinline__ float contract(const Mat& a, const Mat& b) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) acc += a.v[k] * b.v[k];
  return acc;
}

// world [F, 16, A]; m, m_inv [L*A, 16]
__global__ void __launch_bounds__(kThreads)
fk_forward(const float* __restrict__ q, int A, int M, Desc d, float* __restrict__ world,
           float* __restrict__ m_out, float* __restrict__ minv_out) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A) return;
  Mat w = identity();
  for (int f = 0; f < d.F; ++f) {
    const int parent = __ldg(d.frames + 4 * f), kind = __ldg(d.frames + 4 * f + 1),
              src = __ldg(d.frames + 4 * f + 2), flags = __ldg(d.frames + 4 * f + 3);
    if (parent < 0) {
      w = identity();
    } else if (parent != f - 1) {
      w = load_strided(world + static_cast<long long>(parent) * 16 * A + a, A);
    }
    if (!(flags & kNoJoint)) {
      w = mm(w, load(d.origins + 16 * f));
      if (kind == kRevolute || kind == kPrismatic) {
        const float x = joint_value(d, f, flags, __ldg(q + static_cast<long long>(a) * M + src));
        Mat mot, unused;
        motion<false>(d, f, kind, x, 0.0f, mot, unused);
        if (flags & kJointOffset) {
          mot = mm(mm(load(d.joint_offsets + 32 * f), mot), load(d.joint_offsets + 32 * f + 16));
        }
        w = mm(w, mot);
      }
    }
    store_strided(world + static_cast<long long>(f) * 16 * A + a, A, w);
    for (int i = 0; i < d.L; ++i) {
      if (__ldg(d.link_frames + i) != f) continue;
      const Mat ol = mm(load(d.offset_inv + 16 * i), invert_tf(w));
      const long long row = (static_cast<long long>(i) * A + a) * 16;
      store_row_major(m_out + row, ol);
      store_row_major(minv_out + row, invert_tf(ol));
    }
  }
}

// scratch [F, 32, A*M] (W, then its tangent); g_m, g_minv [L*A, 16]; dq [A, M]
__global__ void __launch_bounds__(kThreads)
fk_backward(const float* __restrict__ q, int A, int M, Desc d, const float* __restrict__ g_m,
            const float* __restrict__ g_minv, float* __restrict__ scratch,
            float* __restrict__ dq) {
  const long long lanes = static_cast<long long>(A) * M;
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int a = static_cast<int>(lane / M), j = static_cast<int>(lane % M);
  Mat w = identity(), t = zero();
  float acc = 0.0f;
  for (int f = 0; f < d.F; ++f) {
    const int parent = __ldg(d.frames + 4 * f), kind = __ldg(d.frames + 4 * f + 1),
              src = __ldg(d.frames + 4 * f + 2), flags = __ldg(d.frames + 4 * f + 3);
    if (parent < 0) {
      w = identity();
      t = zero();
    } else if (parent != f - 1) {
      const float* p = scratch + static_cast<long long>(parent) * 32 * lanes + lane;
      w = load_strided(p, lanes);
      t = load_strided(p + 16 * lanes, lanes);
    }
    if (!(flags & kNoJoint)) {
      const Mat o = load(d.origins + 16 * f);
      w = mm(w, o);
      t = mm(t, o);
      if (kind == kRevolute || kind == kPrismatic) {
        const float x = joint_value(d, f, flags, __ldg(q + static_cast<long long>(a) * M + src));
        // dx/dq_j: 1 for the joint's own value, the multiplier for a mimic of q_j
        const float dx = src != j ? 0.0f
                         : (flags & kMimic) ? static_cast<float>(d.mimic[2 * f]) : 1.0f;
        Mat mot, dmot;
        motion<true>(d, f, kind, x, dx, mot, dmot);
        if (flags & kJointOffset) {
          const Mat j0 = load(d.joint_offsets + 32 * f), j1 = load(d.joint_offsets + 32 * f + 16);
          mot = mm(mm(j0, mot), j1);
          dmot = mm(mm(j0, dmot), j1);
        }
        t = add(mm(t, mot), mm(w, dmot));
        w = mm(w, mot);
      }
    }
    float* p = scratch + static_cast<long long>(f) * 32 * lanes + lane;
    store_strided(p, lanes, w);
    store_strided(p + 16 * lanes, lanes, t);
    for (int i = 0; i < d.L; ++i) {
      if (__ldg(d.link_frames + i) != f) continue;
      const Mat oi = load(d.offset_inv + 16 * i);
      const Mat ol = mm(oi, invert_tf(w)), dol = mm(oi, invert_tf_tangent(w, t));
      const long long row = (static_cast<long long>(i) * A + a) * 16;
      acc += contract(load(g_m + row), dol) + contract(load(g_minv + row), invert_tf_tangent(ol, dol));
    }
  }
  dq[lane] = acc;
}

Desc make_desc(const int* frames, int F, const float* origins, const float* axes,
               const float* joint_offsets, const double* mimic, const int* link_frames, int L,
               const float* offset_inv) {
  return Desc{frames, origins, axes, joint_offsets, mimic, link_frames, offset_inv, F, L};
}

}  // namespace

// q [A, M] f32; frames [F, 4] i32; origins [F, 4, 4] f32; axes [F, 3] f32;
// joint_offsets [F, 2, 4, 4] f32; mimic [F, 2] f64; link_frames [L] i32;
// offset_inv [L, 4, 4] f32; world [F, 16, A] f32 scratch; m, m_inv [L*A, 4, 4] f32.
extern "C" int pvt_fk_forward(const float* q, int A, int M, const int* frames, int F,
                              const float* origins, const float* axes,
                              const float* joint_offsets, const double* mimic,
                              const int* link_frames, int L, const float* offset_inv,
                              float* world, float* m, float* m_inv, void* stream_ptr) {
  if (A <= 0 || F <= 0 || L <= 0) return 0;
  const Desc d = make_desc(frames, F, origins, axes, joint_offsets, mimic, link_frames, L,
                           offset_inv);
  const unsigned blocks = static_cast<unsigned>((A + kThreads - 1) / kThreads);
  fk_forward<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(q, A, M, d, world,
                                                                            m, m_inv);
  return static_cast<int>(cudaGetLastError());
}

// as pvt_fk_forward's, then g_m, g_minv [L*A, 4, 4] f32 (the outputs'
// cotangents), scratch [F, 32, A*M] f32 and dq [A, M] f32.
extern "C" int pvt_fk_backward(const float* q, int A, int M, const int* frames, int F,
                               const float* origins, const float* axes,
                               const float* joint_offsets, const double* mimic,
                               const int* link_frames, int L, const float* offset_inv,
                               const float* g_m, const float* g_minv, float* scratch,
                               float* dq, void* stream_ptr) {
  const long long lanes = static_cast<long long>(A) * M;
  if (lanes <= 0 || F <= 0) return 0;
  const Desc d = make_desc(frames, F, origins, axes, joint_offsets, mimic, link_frames, L,
                           offset_inv);
  const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
  fk_backward<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      q, A, M, d, g_m, g_minv, scratch, dq);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
