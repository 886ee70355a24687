// The swing-leg computed-torque law for Hopper (sm_90a): a thread per leg,
// one launch for every leg of every scenario.
//
// Replaces no TPU kernel: the JAX package's swing law
// (quadruped_locomotion_tpu/control/swing.py::swing_torques) is plain XLA.
// Its plain PyTorch version, control/swing.py::swing_torques_plain, takes
// J-dot q-dot by a jvp of the leg Jacobians and the inverse dynamics from the
// Christoffel symbols of M(q), itself a jacfwd of the links' centres of mass
// (model/dynamics.py): ~1,800 launches a call, most of them batched 3x3
// products. This kernel computes the same law (the semantics of
// swing_torques_plain, term for term) for leg i of scenario b:
//
//   g      = the base-frame gravity, quat_inv_rotate(quat, (0, 0, -gravity))
//   p, J   = the foot and its Jacobian from the leg's chain in its hip frame
//            (model/kinematics.py), turned into the base frame by the hip
//   F      = kp (p_des - p) + kd (v_des - J qd)          (base frame)
//   Jd qd  = the foot's acceleration at qdd = 0, from a forward pass of the
//            links' angular velocities and accelerations
//   qdd    = J' (J J' + damping I)^-1 (a_des - Jd qd), the 3x3 solve by
//            ops/linalg3.solve3's cofactors and its sign-preserving epsilon
//   tau    = J' F + ID(q, qd, feedforward qdd, g)
//
// ID is recursive Newton-Euler over the 3-link chain in the hip frame: the
// links' angular velocities and accelerations outward, each link's force
// m (a_c - g) and moment I alpha + w x I w, then the joint torques inward as
// the joint axes' components of the moments about each joint. It is
// M(q) qdd + C(q, qd) qd + G(q) with no derivative of M: the quantity
// model/dynamics.py builds from the Christoffel symbols. Every frame
// change goes through the hip's rotation H (base <- hip): the law's J J' is
// H (J_h J_h') H', so the solve runs in the hip frame on H' (a_des - Jd qd);
// the gains act on the base frame's axes, as the plain law's do.
//
// float32 with fused multiply-adds; no tensor cores, no reduced precision;
// "/" is IEEE (build without --use_fast_math).
//
// What bounds it on an H100: a leg is ~1,000 flop against 64 bytes in and
// 12 out (swing_flops / swing_bytes in control/swing.py), so at B = 32768
// scenarios the bound is ~3.0 us of memory traffic (3.35 TB/s) against
// ~2.0 us of float32 work (67 TFLOP/s): the launch and the chain's latency
// set its time.
//
// What the design does about it: legs are independent, so a thread takes one
// (32 scenarios, 128 legs, a block) and keeps its whole working set in
// registers: no shared memory, no synchronisation, no reduction. Thread t of
// the grid reads its leg's 15 floats at stride 3 and its scenario's
// quaternion (four neighbouring threads read the same 16 bytes), and writes
// its 3 torques once. The model's 120 floats are read in place through the
// read-only cache: every thread of a warp reads the same link constants, and
// four hip poses.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>

namespace {

constexpr int LEGS = 4;
constexpr int THREADS = 128;                 // a thread per leg
constexpr int SCENARIOS = THREADS / LEGS;    // scenarios per block
constexpr float DET_FLOOR = 1e-30f;          // ops/linalg3.solve3's epsilon

// RobotModel's tensors as utils/cuda_build.pack_model packs them, in this
// order (the plant's kernel reads the same layout).
struct Model {
  float hip_pos[4][3];
  float hip_rot[4][3][3];  // base <- hip
  float d, l1, l2;
  float link_mass[3];
  float link_com[3][3];
  float link_inertia[3][3][3];
  float base_mass;
  float leg_mass[4];
  float base_inertia[3][3];
  float hip_offset[4][3];
  float com_in_base[3];
  float joint_damping;
};
static_assert(sizeof(Model) / sizeof(float) == 120,
              "the wrapper packs 120 floats");

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// o = A b and o = A' b, A row-major 3x3.
__device__ __forceinline__ void mv(const float* A, const float b[3],
                                   float o[3]) {
  for (int r = 0; r < 3; ++r)
    o[r] = A[3 * r] * b[0] + A[3 * r + 1] * b[1] + A[3 * r + 2] * b[2];
}

__device__ __forceinline__ void mtv(const float* A, const float b[3],
                                    float o[3]) {
  for (int r = 0; r < 3; ++r)
    o[r] = A[r] * b[0] + A[3 + r] * b[1] + A[6 + r] * b[2];
}

// x (x w r): the centripetal part of a point's acceleration.
__device__ __forceinline__ void centripetal(const float w[3], const float r[3],
                                            float o[3]) {
  float t[3];
  cross(w, r, t);
  cross(w, t, o);
}

// A leg's chain in its hip frame (model/kinematics.py): the link frames
// R1 = Rz(q1), R2 = Rz(q1) Rx(-pi/2) Rz(q2), R3 = R2 Rz(q3); the joint axes
// a1 = z and a2 = a3 = R2 z (R2's third column), both through the hip's
// origin for joints 1 and 2; the knee's origin o3 = R2 (l1, 0, d); the
// foot p = o3 + l2 R3 x; and the links' centres of mass.
struct Chain {
  float R1[9], R2[9], R3[9];
  float a2[3], o3[3], p[3];
  float com[3][3];
};

__device__ __forceinline__ void leg_chain(const Model& m, const float q[3],
                                          Chain& c) {
  float s1, c1, s2, c2, s3, c3;
  sincosf(q[0], &s1, &c1);
  sincosf(q[1], &s2, &c2);
  sincosf(q[2], &s3, &c3);
  const float R1[9] = {c1, -s1, 0.f, s1, c1, 0.f, 0.f, 0.f, 1.f};
  // Rz(q1) Rx(-pi/2) Rz(q2), column by column
  const float R2[9] = {c1 * c2, -c1 * s2, -s1,
                       s1 * c2, -s1 * s2, c1,
                       -s2, -c2, 0.f};
  for (int e = 0; e < 9; ++e) c.R1[e] = R1[e], c.R2[e] = R2[e];
  for (int r = 0; r < 3; ++r) {
    c.R3[3 * r] = R2[3 * r] * c3 + R2[3 * r + 1] * s3;
    c.R3[3 * r + 1] = R2[3 * r + 1] * c3 - R2[3 * r] * s3;
    c.R3[3 * r + 2] = R2[3 * r + 2];
    c.a2[r] = R2[3 * r + 2];
    c.o3[r] = m.l1 * R2[3 * r] + m.d * R2[3 * r + 2];
    c.p[r] = c.o3[r] + m.l2 * c.R3[3 * r];
  }
  mv(c.R1, m.link_com[0], c.com[0]);
  mv(c.R2, m.link_com[1], c.com[1]);
  float t[3];
  mv(c.R3, m.link_com[2], t);
  for (int r = 0; r < 3; ++r) c.com[2][r] = c.o3[r] + t[r];
}

// The links' angular velocities w_k = sum_{j<=k} a_j qd_j and their
// accelerations at qdd = 0: alpha_1 = 0, alpha_k = alpha_{k-1} +
// w_{k-1} x a_k qd_k (a joint's axis turns with the link that carries it).
struct Motion {
  float w[3][3], alpha[3][3];
};

__device__ __forceinline__ void leg_motion(const Chain& c, const float qd[3],
                                           Motion& v) {
  const float a1[3] = {0.f, 0.f, 1.f};
  float t[3];
  for (int r = 0; r < 3; ++r) {
    v.w[0][r] = a1[r] * qd[0];
    v.w[1][r] = v.w[0][r] + c.a2[r] * qd[1];
    v.w[2][r] = v.w[1][r] + c.a2[r] * qd[2];
    v.alpha[0][r] = 0.f;
  }
  const float u2[3] = {c.a2[0] * qd[1], c.a2[1] * qd[1], c.a2[2] * qd[1]};
  cross(v.w[0], u2, v.alpha[1]);
  const float u3[3] = {c.a2[0] * qd[2], c.a2[1] * qd[2], c.a2[2] * qd[2]};
  cross(v.w[1], u3, t);
  for (int r = 0; r < 3; ++r) v.alpha[2][r] = v.alpha[1][r] + t[r];
}

// Acceleration of a point r of a link that turns about the hip's origin
// (links 1 and 2) at angular velocity w and acceleration alpha.
__device__ __forceinline__ void turning_acc(const float w[3],
                                            const float alpha[3],
                                            const float r[3], float o[3]) {
  float t[3], u[3];
  cross(alpha, r, t);
  centripetal(w, r, u);
  for (int e = 0; e < 3; ++e) o[e] = t[e] + u[e];
}

// Acceleration of a point r of link 3, which turns about the knee o3, a
// point of link 2.
__device__ __forceinline__ void shank_acc(const Chain& c, const Motion& v,
                                          const float r[3], float o[3]) {
  float ao3[3], rel[3], t[3];
  turning_acc(v.w[1], v.alpha[1], c.o3, ao3);
  for (int e = 0; e < 3; ++e) rel[e] = r[e] - c.o3[e];
  turning_acc(v.w[2], v.alpha[2], rel, t);
  for (int e = 0; e < 3; ++e) o[e] = ao3[e] + t[e];
}

// Recursive Newton-Euler: tau = M(q) qdd + C(q, qd) qd + G(q) of the leg whose
// chain is c, at joint velocities qd (their motion v at qdd = 0) and
// accelerations qdd, gravity g (hip frame, an acceleration).
__device__ __forceinline__ void rnea(const Model& m, const Chain& c,
                                     const Motion& v0, const float qdd[3],
                                     const float g[3], float tau[3]) {
  // alpha_k = alpha_k(qdd = 0) + sum_{j<=k} a_j qdd_j
  Motion v = v0;
  for (int r = 0; r < 3; ++r) {
    const float a1qdd = r == 2 ? qdd[0] : 0.f;
    v.alpha[0][r] += a1qdd;
    v.alpha[1][r] += a1qdd + c.a2[r] * qdd[1];
    v.alpha[2][r] += a1qdd + c.a2[r] * (qdd[1] + qdd[2]);
  }
  const float* Rk[3] = {c.R1, c.R2, c.R3};
  float moment[3][3];  // each link's moment about the hip's origin
  float knee[3];       // link 3's about the knee
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float acc[3], f[3], wl[3], al[3], Iw[3], Ia[3], gyro[3], nl[3], n[3],
        arm[3];
    if (k < 2)
      turning_acc(v.w[k], v.alpha[k], c.com[k], acc);
    else
      shank_acc(c, v, c.com[k], acc);
    for (int e = 0; e < 3; ++e) f[e] = m.link_mass[k] * (acc[e] - g[e]);
    // I alpha + w x I w, in the link's frame
    mtv(Rk[k], v.w[k], wl);
    mtv(Rk[k], v.alpha[k], al);
    mv(&m.link_inertia[k][0][0], wl, Iw);
    mv(&m.link_inertia[k][0][0], al, Ia);
    cross(wl, Iw, gyro);
    for (int e = 0; e < 3; ++e) nl[e] = Ia[e] + gyro[e];
    mv(Rk[k], nl, n);
    cross(c.com[k], f, arm);
    for (int e = 0; e < 3; ++e) moment[k][e] = n[e] + arm[e];
    if (k == 2) {
      float rel[3];
      for (int e = 0; e < 3; ++e) rel[e] = c.com[2][e] - c.o3[e];
      cross(rel, f, arm);
      for (int e = 0; e < 3; ++e) knee[e] = n[e] + arm[e];
    }
  }
  float n2[3];
  for (int e = 0; e < 3; ++e) n2[e] = moment[1][e] + moment[2][e];
  tau[0] = moment[0][2] + n2[2];  // a1 = z
  tau[1] = dot(c.a2, n2);
  tau[2] = dot(c.a2, knee);
}

// Leg i's swing torques (see the head of the file). Inputs in the base
// frame; gains (kp, kd) per base axis.
__device__ __forceinline__ void leg_torques(
    const Model& m, const float* kp, const float* kd, int i,
    const float quat[4], const float q[3], const float qd[3],
    const float p_des[3], const float v_des[3], const float a_des[3],
    float gravity, float damping, float feedforward, float tau[3]) {
  const float* H = &m.hip_rot[i][0][0];
  // gravity in the base, then the hip frame: the rotation by the conjugate
  // quaternion, as utils/rotations.quat_inv_rotate
  const float u[3] = {-quat[1], -quat[2], -quat[3]};
  const float gv[3] = {0.f, 0.f, -gravity};
  float uv[3], uuv[3], g_base[3], g[3];
  cross(u, gv, uv);
  cross(u, uv, uuv);
  for (int e = 0; e < 3; ++e)
    g_base[e] = gv[e] + 2.f * (quat[0] * uv[e] + uuv[e]);
  mtv(H, g_base, g);

  Chain c;
  leg_chain(m, q, c);
  Motion v;
  leg_motion(c, qd, v);

  // the Jacobian's columns z x p, a2 x p, a2 x (p - o3), and J qd
  const float a1[3] = {0.f, 0.f, 1.f};
  float J[3][3], rel[3], Jqd[3];
  for (int e = 0; e < 3; ++e) rel[e] = c.p[e] - c.o3[e];
  cross(a1, c.p, J[0]);
  cross(c.a2, c.p, J[1]);
  cross(c.a2, rel, J[2]);
  for (int e = 0; e < 3; ++e)
    Jqd[e] = J[0][e] * qd[0] + J[1][e] * qd[1] + J[2][e] * qd[2];

  // the PD force on the base frame's axes
  float p_b[3], v_b[3], force_b[3], force[3];
  mv(H, c.p, p_b);
  mv(H, Jqd, v_b);
  for (int e = 0; e < 3; ++e)
    force_b[e] = kp[e] * (p_des[e] - (m.hip_pos[i][e] + p_b[e])) +
                 kd[e] * (v_des[e] - v_b[e]);
  mtv(H, force_b, force);

  // Jd qd, the foot's acceleration at qdd = 0; the damped solve
  float jdqd[3], a_h[3], rhs[3];
  shank_acc(c, v, c.p, jdqd);
  mtv(H, a_des, a_h);
  for (int e = 0; e < 3; ++e) rhs[e] = a_h[e] - jdqd[e];
  float A[3][3];
  for (int r = 0; r < 3; ++r)
    for (int s = 0; s < 3; ++s)
      A[r][s] = J[0][r] * J[0][s] + J[1][r] * J[1][s] + J[2][r] * J[2][s] +
                (r == s ? damping : 0.f);
  const float c00 = A[1][1] * A[2][2] - A[1][2] * A[2][1];
  const float c01 = A[1][2] * A[2][0] - A[1][0] * A[2][2];
  const float c02 = A[1][0] * A[2][1] - A[1][1] * A[2][0];
  const float c10 = A[0][2] * A[2][1] - A[0][1] * A[2][2];
  const float c11 = A[0][0] * A[2][2] - A[0][2] * A[2][0];
  const float c12 = A[0][1] * A[2][0] - A[0][0] * A[2][1];
  const float c20 = A[0][1] * A[1][2] - A[0][2] * A[1][1];
  const float c21 = A[0][2] * A[1][0] - A[0][0] * A[1][2];
  const float c22 = A[0][0] * A[1][1] - A[0][1] * A[1][0];
  const float det = A[0][0] * c00 + A[0][1] * c01 + A[0][2] * c02;
  const float det_safe =
      fabsf(det) < DET_FLOOR ? (det < 0.f ? -DET_FLOOR : DET_FLOOR) : det;
  const float inv_det = 1.f / det_safe;
  const float y[3] = {(c00 * rhs[0] + c10 * rhs[1] + c20 * rhs[2]) * inv_det,
                      (c01 * rhs[0] + c11 * rhs[1] + c21 * rhs[2]) * inv_det,
                      (c02 * rhs[0] + c12 * rhs[1] + c22 * rhs[2]) * inv_det};
  float qdd[3];
  for (int k = 0; k < 3; ++k) qdd[k] = feedforward * dot(J[k], y);

  float id[3];
  rnea(m, c, v, qdd, g, id);
  for (int k = 0; k < 3; ++k) tau[k] = dot(J[k], force) + id[k];
}

// Thread t: leg t % 4 of scenario t / 4. Inputs and outputs are contiguous
// row-major (B, ...) tensors of the wrapper (control/swing.py).
__global__ void __launch_bounds__(THREADS)
    swing_torques_kernel(const float* __restrict__ model,
                         const float* __restrict__ kp,
                         const float* __restrict__ kd,
                         const float* __restrict__ quat,
                         const float* __restrict__ q,
                         const float* __restrict__ qd,
                         const float* __restrict__ p_des,
                         const float* __restrict__ v_des,
                         const float* __restrict__ a_des,
                         float* __restrict__ tau, int B, float gravity,
                         float damping, float feedforward) {
  const long t = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= static_cast<long>(B) * LEGS) return;
  const long b = t / LEGS;
  const int i = static_cast<int>(t % LEGS);
  const Model& m = *reinterpret_cast<const Model*>(model);
  float qt[4], ql[3], qdl[3], pl[3], vl[3], al[3], out[3];
  for (int e = 0; e < 4; ++e) qt[e] = quat[4 * b + e];
  for (int e = 0; e < 3; ++e) {
    ql[e] = q[3 * t + e];
    qdl[e] = qd[3 * t + e];
    pl[e] = p_des[3 * t + e];
    vl[e] = v_des[3 * t + e];
    al[e] = a_des[3 * t + e];
  }
  leg_torques(m, kp, kd, i, qt, ql, qdl, pl, vl, al, gravity, damping,
              feedforward, out);
  for (int e = 0; e < 3; ++e) tau[3 * t + e] = out[e];
}

}  // namespace

#ifdef __CUDACC__

// One launch for the 4 legs of B scenarios on `stream`. Returns
// cudaGetLastError() after the launch.
extern "C" int swing_torques(const float* model, const float* kp,
                             const float* kd, const float* quat,
                             const float* q, const float* qd,
                             const float* p_des, const float* v_des,
                             const float* a_des, float* tau, int B,
                             float gravity, float damping, float feedforward,
                             void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + SCENARIOS - 1) / SCENARIOS;
  swing_torques_kernel<<<blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      model, kp, kd, quat, q, qd, p_des, v_des, a_des, tau, B, gravity,
      damping, feedforward);
  return static_cast<int>(cudaGetLastError());
}

// Launch geometry, for reports: threads and scenarios (four legs, a thread
// each) per block, and the blocks an SM holds at once (a CUDA error code,
// negated, if the query fails).
extern "C" int swing_torques_threads_per_block() { return THREADS; }

extern "C" int swing_torques_instances_per_block() { return SCENARIOS; }

extern "C" int swing_torques_resident_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, swing_torques_kernel, THREADS, 0);
  return rc == cudaSuccess ? blocks : -static_cast<int>(rc);
}

extern "C" const char* swing_torques_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // __CUDACC__
