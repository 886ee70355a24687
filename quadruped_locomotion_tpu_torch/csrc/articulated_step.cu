// The articulated 18-DoF floating-base plant's step for Hopper (sm_90a):
// one warp per scenario, one launch for the whole step.
//
// Replaces no TPU kernel: the JAX package's plant
// (quadruped_locomotion_tpu/rollout/articulated.py::step) is plain XLA. Its
// plain PyTorch version, rollout/articulated.py::step_plain, builds the same
// step from forward-mode autodiff through a chart of the base and batched
// LU solves of a masked 30x30 KKT system: ~5,000 launches of small batched
// products a step. This kernel computes the same step (the semantics of
// step_plain, rule for rule) for every scenario b:
//
//   `substeps` times: the 13 bodies' kinematics; their Jacobians and bias
//   accelerations in closed form from each leg's chain; M (18x18) and h;
//   the contact gating (commanded support, pinned or touching, within
//   `reach_share` of the reach); new pins anchored on the surface; the
//   Baumgarte right-hand side; the stick solve, the release of feet that
//   pull, the re-solve; with friction (template parameter) the Coulomb
//   cone check and a third solve with kinetic friction on sliding feet;
//   semi-implicit Euler and the quaternion update. Then the closing FK of
//   the swing feet.
//
// The generalised velocity is u = (v world, w body, qdot). A point x of a
// body moved by the base and by joints j <= k of its leg moves with
//   v + w_w x (x - p) + sum_j U_j qdot_j x (x - O_j),
// U_j the joint's world axis and O_j its origin, w_w = R w; these partial
// velocities are the Jacobian's columns (the base's angular columns
// R e_c x (x - p)), a link's angular-velocity columns R e_c and U_j. With
// udot = 0 its acceleration is the bias
//   w_w x (v_x - v) + sum_j [(W_{j-1} x U_j qdot_j) x (x - O_j)
//                            + U_j qdot_j x (v_x - v_{O_j})],
// W_{j-1} the angular velocity of the body that carries joint j, and the
// link's bias angular acceleration is sum_j W_{j-1} x U_j qdot_j. These are
// the derivatives step_plain takes by autodiff at the chart's centre. Then
//   M = sum_b m_b Jv_b' Jv_b + Jw_b' I_b Jw_b,
//   h = sum_b Jv_b' m_b (a_b - g) + Jw_b' (I_b alpha_b + w_b x I_b w_b).
//
// The contact system  M udot - A' lam = tau - h,  A udot + eps lam = b  (A
// the active rows of the feet's Jacobian J_c) is solved through the
// Cholesky factor of M, which is symmetric positive definite: M = L L',
// Y = L^-1 J_c' and z = L^-1 (tau - h) once a substep; the Schur matrix
// S = A M^-1 A' + diag(eps on active rows, 1 on inactive ones) is Y'Y
// masked, so each solve (stick, re-solve, friction) factors only the 12x12
// S; lam = S^-1 (b - Y'z) on active rows and 0 elsewhere, and
// udot = L^-T (z + Y (lam + f_ext)), f_ext the kinetic friction of sliding
// feet. This is the masked KKT system's unique solution in another order of
// arithmetic. float32 with fused multiply-adds throughout; no tensor cores,
// no reduced precision; "/" and sqrtf are IEEE (build without
// --use_fast_math).
//
// What bounds it on an H100: a scenario's substep is ~36 kflop (a count of
// the arithmetic below) against ~470 bytes of state in and out a step, so
// at B = 32768 and 2 substeps the bound is ~35 us of float32 FMA work
// (67 TFLOP/s) against ~5 us of memory traffic (3.35 TB/s). The work of
// one scenario is a chain of small, dependent steps (kinematics, assembly,
// two factorizations, triangular solves), so what limits a simple kernel
// is the chain's latency.
//
// What the design does about it: a warp per scenario (4 warps, 4 scenarios,
// a 128-thread block), the generalised coordinates as the parallel axis.
// Lanes 0-16 each take one point (the trunk, the 12 links, the 4 feet) and
// compute its leg's chain, its position, velocity and bias acceleration;
// lanes take M's 171 lower entries in turn (an entry sums only the bodies
// that move both its coordinates: all 13 for two base coordinates, the
// three links of one leg otherwise, none across legs), lane c < 18 h's row
// c and J_c's column c; the factorizations are right-looking, a lane per
// row; 13 lanes solve L Y = (J_c', tau - h) at once, a column each; the
// lanes take the Gram matrix's entries in turn. Each warp keeps its
// scenario's working set (~5.5 KB) in its own slice of static shared
// memory, with 18- and 13-row panels at an odd stride of 19 floats, so
// that a lane per row hits distinct banks; __syncwarp() orders the phases,
// and the only __syncthreads() follows the block's copy of the model.
// Control flow is warp-uniform at every __syncwarp(); an out-of-range warp
// (the batch's tail block) returns before the first one.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>

namespace {

constexpr int NV = 18;            // generalised velocities
constexpr int NC = 12;            // contact rows: 4 feet x 3
constexpr int NB = 13;            // bodies: the trunk, 4 legs x 3 links
constexpr int NP = NB + 4;        // points: the bodies' centres of mass, the feet
constexpr int NM = NV * (NV + 1) / 2;  // M's lower entries
constexpr int NG = NC * (NC + 1) / 2;  // the Gram matrix's lower entries
constexpr int RS = 19;            // padded row stride of M and the 13-row panel
constexpr int SS = 13;            // row stride of S and G: 12 + a right-hand side
constexpr int WARPS = 4;          // warps (scenarios) per block
constexpr int THREADS = 32 * WARPS;
constexpr float PIVOT_FLOOR = 1e-30f;

// RobotModel's tensors as rollout/articulated.py packs them, in this order.
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
constexpr int MODEL_FLOATS = sizeof(Model) / sizeof(float);
static_assert(MODEL_FLOATS == 120, "the wrapper packs 120 floats");

}  // namespace

// The plant's constants and the step's numbers, by value.
struct PlantConsts {
  float h;              // internal substep, dt / substeps
  int substeps;
  float gravity;        // m/s^2, along -z
  float contact_tol;    // a foot touches within this of the surface
  float kd, kp;         // Baumgarte gains 2/tau, 1/tau^2
  float compliance;     // eps on active contact rows
  float release_force;  // a pinned foot below this normal force is released
  float reach_share;    // a foot beyond this share of the reach is not pinned
  float mu;             // Coulomb coefficient (friction kernel only)
};

namespace {

// One scenario's working set.
struct Work {
  float p[3], quat[4], u[NV], q[12], anchors[12], gz[4], tau[12];
  int pinned[4], support[4], mask[4], keep[4], slip[4];
  float R[9];      // base -> world, row-major
  float r[NP][3];  // points relative to p (world): 0 trunk, 1 + 3i + k link
                   // k of leg i, 13 + i foot i
  float mass[NB], iw[NB][6];   // world inertia: xx yy zz xy xz yz
  float force[NB][3], torque[NB][3];  // m (a - g), I alpha + w x I w
  float axis[4][3][3], origin[4][3][3];  // world joint axes; origins - p
  float hip[4][3];                       // kinematic hips - p
  float foot_vel[NC], foot_acc[NC];      // world velocity, bias acceleration
  float bc[NC];                          // Baumgarte right-hand side
  float fext[NC];                        // kinetic friction of sliding feet
  float M[NV][RS];  // M, then its factor (lower, reciprocal diagonal)
  float P[NC + 1][RS];  // rows: J_c's, tau - h; then L^-1 of each (Y', z)
  float G[NC][SS];  // Y'Y, and Y'z in column 12
  float S[NC][SS];  // the masked Schur matrix, then its factor; column 12
                    // the right-hand side, then lam
  float vdot[NV];
};

// Per block: the model and what the step derives from it.
struct Shared {
  Model m;
  float m_base, i_base[3][3], reach;
};

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float o[3]) {
  o[0] = fmaf(a[1], b[2], -a[2] * b[1]);
  o[1] = fmaf(a[2], b[0], -a[0] * b[2]);
  o[2] = fmaf(a[0], b[1], -a[1] * b[0]);
}

__device__ __forceinline__ float dot(const float a[3], const float b[3]) {
  return fmaf(a[0], b[0], fmaf(a[1], b[1], a[2] * b[2]));
}

// o = A b, A row-major 3x3.
__device__ __forceinline__ void mv(const float* A, const float b[3],
                                   float o[3]) {
  for (int i = 0; i < 3; ++i)
    o[i] = fmaf(A[3 * i], b[0], fmaf(A[3 * i + 1], b[1], A[3 * i + 2] * b[2]));
}

// O = A B, row-major 3x3.
__device__ __forceinline__ void mm(const float* A, const float* B, float* O) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      O[3 * i + j] = fmaf(A[3 * i], B[j],
                          fmaf(A[3 * i + 1], B[3 + j], A[3 * i + 2] * B[6 + j]));
}

__device__ __forceinline__ void add(const float a[3], const float b[3],
                                    float o[3]) {
  for (int i = 0; i < 3; ++i) o[i] = a[i] + b[i];
}

__device__ __forceinline__ void sub(const float a[3], const float b[3],
                                    float o[3]) {
  for (int i = 0; i < 3; ++i) o[i] = a[i] - b[i];
}

// I (xx yy zz xy xz yz) times v.
__device__ __forceinline__ void sym_mv(const float* I, const float v[3],
                                       float o[3]) {
  o[0] = fmaf(I[0], v[0], fmaf(I[3], v[1], I[4] * v[2]));
  o[1] = fmaf(I[3], v[0], fmaf(I[1], v[1], I[5] * v[2]));
  o[2] = fmaf(I[4], v[0], fmaf(I[5], v[1], I[2] * v[2]));
}

// Q I Q' of a body inertia I (row-major 3x3) turned by Q, as xx yy zz xy xz yz.
__device__ __forceinline__ void rotate_inertia(const float* Q, const float* I,
                                               float o[6]) {
  float T[9];
  mm(Q, I, T);
  const int a[6] = {0, 1, 2, 0, 0, 1}, b[6] = {0, 1, 2, 1, 2, 2};
  for (int e = 0; e < 6; ++e)
    o[e] = fmaf(T[3 * a[e]], Q[3 * b[e]],
                fmaf(T[3 * a[e] + 1], Q[3 * b[e] + 1],
                     T[3 * a[e] + 2] * Q[3 * b[e] + 2]));
}

// Rotation matrix of the quaternion (w, x, y, z), as
// utils/rotations.matrix_from_quat.
__device__ __forceinline__ void quat_matrix(const float* qt, float* R) {
  const float w = qt[0], x = qt[1], y = qt[2], z = qt[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  R[0] = 1.f - 2.f * (yy + zz); R[1] = 2.f * (xy - wz); R[2] = 2.f * (xz + wy);
  R[3] = 2.f * (xy + wz); R[4] = 1.f - 2.f * (xx + zz); R[5] = 2.f * (yz - wx);
  R[6] = 2.f * (xz - wy); R[7] = 2.f * (yz + wx); R[8] = 1.f - 2.f * (xx + yy);
}

// A leg's chain in its hip frame (model/kinematics.py): link frames
// R1 = Rz(q1), R2 = R1 Rx(-pi/2) Rz(q2), R3 = R2 Rz(q3), and o3 = R2 (l1,0,d).
struct Chain {
  float R1[9], R2[9], R3[9], o3[3];
};

__device__ __forceinline__ void leg_chain(const Model& m, const float* q,
                                          Chain& c) {
  float s1, c1, s2, c2, s3, c3;
  sincosf(q[0], &s1, &c1);
  sincosf(q[1], &s2, &c2);
  sincosf(q[2], &s3, &c3);
  const float Rz1[9] = {c1, -s1, 0.f, s1, c1, 0.f, 0.f, 0.f, 1.f};
  // Rx(-pi/2) Rz(q2)
  const float A2[9] = {c2, -s2, 0.f, 0.f, 0.f, 1.f, -s2, -c2, 0.f};
  const float Rz3[9] = {c3, -s3, 0.f, s3, c3, 0.f, 0.f, 0.f, 1.f};
  for (int e = 0; e < 9; ++e) c.R1[e] = Rz1[e];
  mm(c.R1, A2, c.R2);
  mm(c.R2, Rz3, c.R3);
  const float l1d[3] = {m.l1, 0.f, m.d};
  mv(c.R2, l1d, c.o3);
}

// Column c of point pt's Jacobian: the linear part jv and the angular part
// jw (used for bodies). Returns false where the column is zero.
__device__ __forceinline__ bool column(const Work& W, int pt, int c,
                                       float jv[3], float jw[3]) {
  if (c < 3) {
    for (int a = 0; a < 3; ++a) jv[a] = jw[a] = 0.f;
    jv[c] = 1.f;
    return true;
  }
  if (c < 6) {
    const float e[3] = {W.R[c - 3], W.R[3 + c - 3], W.R[6 + c - 3]};
    cross(e, W.r[pt], jv);
    for (int a = 0; a < 3; ++a) jw[a] = e[a];
    return true;
  }
  const int leg = (c - 6) / 3, j = (c - 6) % 3;
  if (pt == 0) return false;
  const int pleg = pt <= 12 ? (pt - 1) / 3 : pt - 13;
  const int upto = pt <= 12 ? (pt - 1) % 3 + 1 : 3;  // joints that move it
  if (pleg != leg || j >= upto) return false;
  float d[3];
  sub(W.r[pt], W.origin[leg][j], d);
  cross(W.axis[leg][j], d, jv);
  for (int a = 0; a < 3; ++a) jw[a] = W.axis[leg][j][a];
  return true;
}

// The bodies that move generalised coordinate c: all 13 for a base
// coordinate, the links of its leg for a joint. [first, first + count).
__device__ __forceinline__ void bodies_of(int c, int& first, int& count) {
  if (c < 6) {
    first = 0;
    count = NB;
  } else {
    first = 1 + 3 * ((c - 6) / 3);
    count = 3;
  }
}

// Cholesky factor of the n x n matrix A (row stride rs) in place, lower,
// right-looking: a lane per row; the diagonal holds the pivots' reciprocal
// square roots. All lanes call it.
__device__ void cholesky(float* A, int n, int rs, int lane) {
  for (int j = 0; j < n; ++j) {
    const float rd = rsqrtf(fmaxf(A[j * rs + j], PIVOT_FLOOR));
    __syncwarp();
    if (lane == j)
      A[j * rs + j] = rd;
    else if (lane > j && lane < n)
      A[lane * rs + j] *= rd;
    __syncwarp();
    if (lane > j && lane < n) {
      const float lij = A[lane * rs + j];
      for (int k = j + 1; k <= lane; ++k)
        A[lane * rs + k] = fmaf(-lij, A[k * rs + j], A[lane * rs + k]);
    }
    __syncwarp();
  }
}

// x <- L^-1 x (x with element stride xs), L from cholesky(). One lane.
__device__ __forceinline__ void forward(const float* L, int n, int rs,
                                        float* x, int xs) {
  for (int i = 0; i < n; ++i) {
    float acc = x[i * xs];
    for (int k = 0; k < i; ++k) acc = fmaf(-L[i * rs + k], x[k * xs], acc);
    x[i * xs] = acc * L[i * rs + i];
  }
}

// x <- L^-T x. One lane.
__device__ __forceinline__ void backward(const float* L, int n, int rs,
                                         float* x, int xs) {
  for (int i = n - 1; i >= 0; --i) {
    float acc = x[i * xs];
    for (int k = i + 1; k < n; ++k) acc = fmaf(-L[k * rs + i], x[k * xs], acc);
    x[i * xs] = acc * L[i * rs + i];
  }
}

// The masked contact solve: S from Y'Y on the rows `act` (foot a / 3 of row
// a active, minus the tangential rows of sliding feet where `slide`), the
// right-hand side b - Y'(z + Y f_ext) on them; lam (in S's column 12) = 0
// on the others. All lanes call it.
__device__ void contact_solve(Work& W, const PlantConsts& k, const int* act,
                              bool slide, int lane) {
  for (int e = lane; e < NC * SS; e += 32) {
    const int a = e / SS, b = e % SS;
    const bool on_a = act[a / 3] && !(slide && W.slip[a / 3] && a % 3 < 2);
    float val;
    if (b < NC) {
      const bool on_b = act[b / 3] && !(slide && W.slip[b / 3] && b % 3 < 2);
      val = (on_a && on_b) ? W.G[a][b] : 0.f;
      if (a == b) val = on_a ? W.G[a][a] + k.compliance : 1.f;
    } else {
      float g = W.G[a][NC];
      if (slide)
        for (int c = 0; c < NC; ++c) g = fmaf(W.G[a][c], W.fext[c], g);
      val = on_a ? W.bc[a] - g : 0.f;
    }
    W.S[a][b] = val;
  }
  __syncwarp();
  cholesky(&W.S[0][0], NC, SS, lane);
  if (lane == 0) {
    forward(&W.S[0][0], NC, SS, &W.S[0][NC], SS);
    backward(&W.S[0][0], NC, SS, &W.S[0][NC], SS);
  }
  __syncwarp();
}

template <bool kFriction>
__global__ void __launch_bounds__(THREADS)
articulated_step_kernel(
    const float* __restrict__ model, const float* __restrict__ pos,
    const float* __restrict__ quat, const float* __restrict__ vel,
    const float* __restrict__ omega_b, const float* __restrict__ q,
    const float* __restrict__ qd, const unsigned char* __restrict__ pinned,
    const float* __restrict__ anchors, const float* __restrict__ tau,
    const unsigned char* __restrict__ support, const float* __restrict__ gz,
    float* __restrict__ pos_out, float* __restrict__ quat_out,
    float* __restrict__ vel_out, float* __restrict__ omega_out,
    float* __restrict__ q_out, float* __restrict__ qd_out,
    unsigned char* __restrict__ pinned_out, float* __restrict__ feet_out,
    int B, PlantConsts k) {
  __shared__ Shared sh;
  __shared__ Work work[WARPS];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);

  float* flat = reinterpret_cast<float*>(&sh.m);
  for (int e = threadIdx.x; e < MODEL_FLOATS; e += THREADS) flat[e] = model[e];
  __syncthreads();
  const Model& m = sh.m;
  if (threadIdx.x == 0) {
    // The trunk alone (articulated.base_dynamic_params): the controller's
    // total mass less the links, its inertia less the lumped legs'
    // parallel-axis terms at the virtual hips.
    float legs = 0.f, links = 0.f;
    for (int i = 0; i < 4; ++i) legs += m.leg_mass[i];
    for (int j = 0; j < 3; ++j) links += m.link_mass[j];
    sh.m_base = (m.base_mass + legs) - 4.f * links;
    for (int e = 0; e < 9; ++e) sh.i_base[e / 3][e % 3] = m.base_inertia[e / 3][e % 3];
    for (int i = 0; i < 4; ++i) {
      const float* r = m.hip_offset[i];
      const float rr = dot(r, r);
      for (int e = 0; e < 9; ++e) {
        const int a = e / 3, c = e % 3;
        sh.i_base[a][c] -= m.leg_mass[i] * ((a == c ? rr : 0.f) - r[a] * r[c]);
      }
    }
    const float l12 = m.l1 + m.l2;
    sh.reach = sqrtf(fmaf(m.d, m.d, l12 * l12));
  }
  __syncthreads();
  if (b >= B) return;  // the whole warp: b is uniform over it
  Work& W = work[threadIdx.x >> 5];

  // the scenario's state
  for (int e = lane; e < 3; e += 32) {
    W.p[e] = pos[3 * b + e];
    W.u[e] = vel[3 * b + e];
    W.u[3 + e] = omega_b[3 * b + e];
  }
  for (int e = lane; e < 4; e += 32) {
    W.quat[e] = quat[4 * b + e];
    W.gz[e] = gz[4 * b + e];
    W.pinned[e] = pinned[4 * b + e] != 0;
    W.support[e] = support[4 * b + e] != 0;
  }
  for (int e = lane; e < 12; e += 32) {
    W.q[e] = q[12 * b + e];
    W.u[6 + e] = qd[12 * b + e];
    W.anchors[e] = anchors[12 * b + e];
    W.tau[e] = tau[12 * b + e];
  }
  __syncwarp();

  const float g[3] = {0.f, 0.f, -k.gravity};
  for (int step = 0; step < k.substeps; ++step) {
    // --- kinematics: lane pt < 17 takes point pt ------------------------
    float R[9];
    quat_matrix(W.quat, R);
    const float v[3] = {W.u[0], W.u[1], W.u[2]};
    float w[3];
    mv(R, &W.u[3], w);  // the base's world angular velocity
    if (lane < 9) W.R[lane] = R[lane];
    if (lane == 0) {
      // the trunk: its centre of mass on the base, no joint
      float r[3], wr[3], a[3], I[6], Iw_[3], wIw[3];
      mv(R, m.com_in_base, r);
      cross(w, r, wr);
      cross(w, wr, a);
      rotate_inertia(R, &sh.i_base[0][0], I);
      sym_mv(I, w, Iw_);
      cross(w, Iw_, wIw);
      for (int c = 0; c < 3; ++c) {
        W.r[0][c] = r[c];
        W.force[0][c] = sh.m_base * (a[c] - g[c]);
        W.torque[0][c] = wIw[c];
      }
      for (int e = 0; e < 6; ++e) W.iw[0][e] = I[e];
      W.mass[0] = sh.m_base;
    } else if (lane < NP) {
      const int i = lane <= 12 ? (lane - 1) / 3 : lane - 13;
      const int kk = lane <= 12 ? (lane - 1) % 3 : 3;  // 3: the foot
      Chain ch;
      leg_chain(m, &W.q[3 * i], ch);
      float RH[9], hip[3], U[3][3], O3[3], tmp[3];
      mm(R, &m.hip_rot[i][0][0], RH);
      mv(R, m.hip_pos[i], hip);
      const float ez[3] = {0.f, 0.f, 1.f};
      const float a2[3] = {ch.R2[2], ch.R2[5], ch.R2[8]};
      const float a3[3] = {ch.R3[2], ch.R3[5], ch.R3[8]};
      mv(RH, ez, U[0]);
      mv(RH, a2, U[1]);
      mv(RH, a3, U[2]);
      mv(RH, ch.o3, tmp);
      add(hip, tmp, O3);
      // the point in the hip frame
      float loc[3];
      if (kk == 0) {
        mv(ch.R1, m.link_com[0], loc);
      } else if (kk == 1) {
        mv(ch.R2, m.link_com[1], loc);
      } else {
        const float foot[3] = {m.l2, 0.f, 0.f};
        mv(ch.R3, kk == 2 ? m.link_com[2] : foot, tmp);
        add(ch.o3, tmp, loc);
      }
      float x[3];
      mv(RH, loc, tmp);
      add(hip, tmp, x);
      const int upto = kk < 3 ? kk + 1 : 3;
      // joint rates along their axes, the carrying bodies' angular
      // velocities W_0 = w, W_j = W_{j-1} + qa_j, the joint origins'
      // velocities
      float qa[3][3], Wj[4][3], vO[3][3];
      for (int j = 0; j < 3; ++j)
        for (int c = 0; c < 3; ++c) qa[j][c] = U[j][c] * W.u[6 + 3 * i + j];
      for (int c = 0; c < 3; ++c) Wj[0][c] = w[c];
      for (int j = 0; j < 3; ++j) add(Wj[j], qa[j], Wj[j + 1]);
      cross(w, hip, tmp);
      add(v, tmp, vO[0]);
      for (int c = 0; c < 3; ++c) vO[1][c] = vO[0][c];
      {
        float d[3], t2[3];
        cross(w, O3, tmp);
        add(v, tmp, vO[2]);
        sub(O3, hip, d);
        cross(qa[0], d, t2);
        add(vO[2], t2, vO[2]);
        cross(qa[1], d, t2);
        add(vO[2], t2, vO[2]);
      }
      // the point's velocity and bias acceleration (joints j < upto move
      // it; O_1 = O_2 = the hip)
      float vx[3], acc[3];
      cross(w, x, tmp);
      add(v, tmp, vx);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j >= upto) break;
        float d[3];
        sub(x, j == 2 ? O3 : hip, d);
        cross(qa[j], d, tmp);
        add(vx, tmp, vx);
      }
      {
        float dv[3];
        sub(vx, v, dv);
        cross(w, dv, acc);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j >= upto) break;
        float wq[3], d[3], t2[3];
        cross(Wj[j], qa[j], wq);
        sub(x, j == 2 ? O3 : hip, d);
        cross(wq, d, t2);
        add(acc, t2, acc);
        sub(vx, vO[j], d);
        cross(qa[j], d, t2);
        add(acc, t2, acc);
      }
      for (int c = 0; c < 3; ++c) W.r[lane][c] = x[c];
      if (kk == 3) {
        for (int c = 0; c < 3; ++c) {
          W.foot_vel[3 * i + c] = vx[c];
          W.foot_acc[3 * i + c] = acc[c];
          W.hip[i][c] = hip[c];
          W.origin[i][0][c] = W.origin[i][1][c] = hip[c];
          W.origin[i][2][c] = O3[c];
          for (int j = 0; j < 3; ++j) W.axis[i][j][c] = U[j][c];
        }
      } else {
        // a link: angular velocity W_upto, bias angular acceleration
        // sum_j W_{j-1} x qa_j, world inertia of R RH R_k
        float alpha[3] = {0.f, 0.f, 0.f}, wk[3], Rk[9], I[6], Iw_[3], Ia[3],
              wIw[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          if (j >= upto) break;
          cross(Wj[j], qa[j], tmp);
          add(alpha, tmp, alpha);
        }
        for (int c = 0; c < 3; ++c)
          wk[c] = kk == 0 ? Wj[1][c] : (kk == 1 ? Wj[2][c] : Wj[3][c]);
        mm(RH, kk == 0 ? ch.R1 : (kk == 1 ? ch.R2 : ch.R3), Rk);
        rotate_inertia(Rk, &m.link_inertia[kk][0][0], I);
        sym_mv(I, wk, Iw_);
        cross(wk, Iw_, wIw);
        sym_mv(I, alpha, Ia);
        const float mk = m.link_mass[kk];
        for (int c = 0; c < 3; ++c) {
          W.force[lane][c] = mk * (acc[c] - g[c]);
          W.torque[lane][c] = Ia[c] + wIw[c];
        }
        for (int e = 0; e < 6; ++e) W.iw[lane][e] = I[e];
        W.mass[lane] = mk;
      }
    }
    __syncwarp();

    // --- M, h, J_c; the gating and the Baumgarte right-hand side --------
    for (int e = lane; e < NM; e += 32) {
      int r = static_cast<int>((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
      const int c = e - r * (r + 1) / 2;
      float acc = 0.f;
      const bool other_legs = r >= 6 && c >= 6 && (r - 6) / 3 != (c - 6) / 3;
      if (!other_legs) {
        int first, count;
        bodies_of(r >= 6 ? r : c, first, count);
        for (int bb = first; bb < first + count; ++bb) {
          float jvr[3], jwr[3], jvc[3], jwc[3], Ij[3];
          if (!column(W, bb, r, jvr, jwr) || !column(W, bb, c, jvc, jwc))
            continue;
          sym_mv(W.iw[bb], jwc, Ij);
          acc = fmaf(W.mass[bb], dot(jvr, jvc), acc) + dot(jwr, Ij);
        }
      }
      W.M[r][c] = acc;
    }
    if (lane < NV) {
      const int c = lane;
      int first, count;
      bodies_of(c, first, count);
      float hc = 0.f;
      for (int bb = first; bb < first + count; ++bb) {
        float jv[3], jw[3];
        if (column(W, bb, c, jv, jw))
          hc += dot(jv, W.force[bb]) + dot(jw, W.torque[bb]);
      }
      const float tau_gen =
          c < 6 ? 0.f : fmaf(-m.joint_damping, W.u[c], W.tau[c - 6]);
      W.P[NC][c] = tau_gen - hc;
      for (int i = 0; i < 4; ++i) {
        float jv[3], jw[3];
        const bool nz = column(W, 13 + i, c, jv, jw);
        for (int a = 0; a < 3; ++a) W.P[3 * i + a][c] = nz ? jv[a] : 0.f;
      }
    }
    if (lane < 4) {
      const int i = lane;
      float F[3], d[3];
      add(W.p, W.r[13 + i], F);
      sub(W.r[13 + i], W.hip[i], d);
      const bool touching = F[2] <= W.gz[i] + k.contact_tol;
      const float extension = sqrtf(dot(d, d));
      const bool mask = W.support[i] && (W.pinned[i] || touching) &&
                        extension < k.reach_share * sh.reach;
      if (mask && !W.pinned[i]) {  // a new pin anchors on the surface
        W.anchors[3 * i] = F[0];
        W.anchors[3 * i + 1] = F[1];
        W.anchors[3 * i + 2] = W.gz[i];
      }
      W.mask[i] = mask;
      for (int a = 0; a < 3; ++a) {
        const int row = 3 * i + a;
        W.bc[row] = -W.foot_acc[row] - k.kd * W.foot_vel[row] -
                    k.kp * (F[a] - W.anchors[row]);
        W.fext[row] = 0.f;
      }
    }
    __syncwarp();

    // --- M = L L'; Y' = (L^-1 J_c')', z = L^-1 (tau - h) ------------------
    cholesky(&W.M[0][0], NV, RS, lane);
    if (lane <= NC) forward(&W.M[0][0], NV, RS, &W.P[lane][0], 1);
    __syncwarp();
    for (int e = lane; e < NG + NC; e += 32) {
      int a, c;
      if (e < NG) {
        a = static_cast<int>((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
        c = e - a * (a + 1) / 2;
      } else {
        a = e - NG;
        c = NC;  // Y'z
      }
      float acc = 0.f;
      for (int t = 0; t < NV; ++t) acc = fmaf(W.P[a][t], W.P[c][t], acc);
      W.G[a][c] = acc;
      if (c < NC) W.G[c][a] = acc;
    }
    __syncwarp();

    // --- stick, release of pulling feet, re-solve --------------------------
    contact_solve(W, k, W.mask, false, lane);
    if (lane < 4)
      W.keep[lane] = W.mask[lane] && W.S[3 * lane + 2][NC] >= k.release_force;
    __syncwarp();
    contact_solve(W, k, W.keep, false, lane);
    if (kFriction) {
      // the Coulomb cone on the stick solution: feet beyond it slide under
      // kinetic friction against their slip velocity (at stick-break onset
      // in the direction stick was applying), only their normal row kept
      if (lane < 4) {
        const int i = lane;
        const float* lam = &W.S[3 * i][0];
        const float lx = W.keep[i] ? lam[NC] : 0.f;
        const float ly = W.keep[i] ? lam[SS + NC] : 0.f;
        const float lz = W.keep[i] ? lam[2 * SS + NC] : 0.f;
        const float lam_t = sqrtf(fmaf(lx, lx, ly * ly));
        const float lam_n = fmaxf(lz, 0.f);
        const bool slip = W.keep[i] && lam_t > k.mu * lam_n + 1e-9f;
        const float vx = W.foot_vel[3 * i], vy = W.foot_vel[3 * i + 1];
        const float vt_n = sqrtf(fmaf(vx, vx, vy * vy));
        float dx, dy;
        if (vt_n > 1e-3f) {
          dx = -vx / fmaxf(vt_n, 1e-9f);
          dy = -vy / fmaxf(vt_n, 1e-9f);
        } else {
          dx = lx / fmaxf(lam_t, 1e-9f);
          dy = ly / fmaxf(lam_t, 1e-9f);
        }
        W.slip[i] = slip;
        W.fext[3 * i] = slip ? k.mu * lam_n * dx : 0.f;
        W.fext[3 * i + 1] = slip ? k.mu * lam_n * dy : 0.f;
        if (slip) {  // a sliding foot's anchor follows it
          W.anchors[3 * i] = W.p[0] + W.r[13 + i][0];
          W.anchors[3 * i + 1] = W.p[1] + W.r[13 + i][1];
          W.anchors[3 * i + 2] = W.gz[i];
        }
      }
      __syncwarp();
      contact_solve(W, k, W.keep, true, lane);
    }

    // --- udot = L^-T (z + Y (lam + f_ext)); semi-implicit Euler -----------
    if (lane < NV) {
      float acc = W.P[NC][lane];
      for (int a = 0; a < NC; ++a) {
        const float lam = W.keep[a / 3] ? W.S[a][NC] : 0.f;
        acc = fmaf(W.P[a][lane], lam + W.fext[a], acc);
      }
      W.vdot[lane] = acc;
    }
    __syncwarp();
    if (lane == 0) backward(&W.M[0][0], NV, RS, W.vdot, 1);
    __syncwarp();
    if (lane < NV) W.u[lane] = fmaf(k.h, W.vdot[lane], W.u[lane]);
    __syncwarp();
    if (lane < 3) {
      W.p[lane] = fmaf(k.h, W.u[lane], W.p[lane]);
    } else if (lane < 4) {
      // quat <- normalize(quat * exp(h w)), as utils/rotations
      const float phi[3] = {k.h * W.u[3], k.h * W.u[4], k.h * W.u[5]};
      const float angle = sqrtf(dot(phi, phi));
      float s, c;
      sincosf(0.5f * angle, &s, &c);
      const float kq = angle < 1e-8f ? 0.5f - angle * angle / 48.f : s / angle;
      const float e[4] = {c, kq * phi[0], kq * phi[1], kq * phi[2]};
      const float* a = W.quat;
      float o[4] = {a[0] * e[0] - a[1] * e[1] - a[2] * e[2] - a[3] * e[3],
                    a[0] * e[1] + a[1] * e[0] + a[2] * e[3] - a[3] * e[2],
                    a[0] * e[2] - a[1] * e[3] + a[2] * e[0] + a[3] * e[1],
                    a[0] * e[3] + a[1] * e[2] - a[2] * e[1] + a[3] * e[0]};
      const float n = fmaxf(sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] +
                                  o[3] * o[3]), 1e-12f);
      for (int t = 0; t < 4; ++t) W.quat[t] = o[t] / n;
    } else if (lane < 8) {
      W.pinned[lane - 4] = W.keep[lane - 4];
    } else if (lane >= 20) {
      W.q[lane - 20] = fmaf(k.h, W.u[6 + lane - 20], W.q[lane - 20]);
    }
    __syncwarp();
  }

  // --- the closing FK: pinned feet at their anchors, swing feet where the
  // legs put them; the state out ------------------------------------------
  if (lane < 4) {
    const int i = lane;
    float out[3];
    if (W.pinned[i]) {
      for (int c = 0; c < 3; ++c) out[c] = W.anchors[3 * i + c];
    } else {
      float R[9], s1, c1, s2, c2, s3, c3, x[3], y[3], t[3];
      quat_matrix(W.quat, R);
      sincosf(W.q[3 * i], &s1, &c1);
      sincosf(W.q[3 * i + 1], &s2, &c2);
      sincosf(W.q[3 * i + 2], &s3, &c3);
      // Rz(q1) Rx(-pi/2) Rz(q2) (l1 + l2 cos q3, l2 sin q3, d)
      const float knee[3] = {fmaf(m.l2, c3, m.l1), m.l2 * s3, m.d};
      x[0] = c2 * knee[0] - s2 * knee[1];
      x[1] = s2 * knee[0] + c2 * knee[1];
      x[2] = knee[2];
      y[0] = x[0];  // Rx(-pi/2): (x, y, z) -> (x, z, -y)
      y[1] = x[2];
      y[2] = -x[1];
      x[0] = c1 * y[0] - s1 * y[1];
      x[1] = s1 * y[0] + c1 * y[1];
      x[2] = y[2];
      mv(&m.hip_rot[i][0][0], x, t);
      add(m.hip_pos[i], t, y);
      mv(R, y, t);
      add(W.p, t, out);
    }
    for (int c = 0; c < 3; ++c) feet_out[12 * b + 3 * i + c] = out[c];
    pinned_out[4 * b + i] = W.pinned[i] ? 1 : 0;
    quat_out[4 * b + i] = W.quat[i];
  }
  for (int e = lane; e < 3; e += 32) {
    pos_out[3 * b + e] = W.p[e];
    vel_out[3 * b + e] = W.u[e];
    omega_out[3 * b + e] = W.u[3 + e];
  }
  for (int e = lane; e < 12; e += 32) {
    q_out[12 * b + e] = W.q[e];
    qd_out[12 * b + e] = W.u[6 + e];
  }
}

}  // namespace

#ifdef __CUDACC__

// One launch for B scenarios on `stream`: inputs and outputs are contiguous
// row-major (B, ...) tensors of the wrapper (rollout/articulated.py), flags
// one byte each. Returns cudaGetLastError() after the launch.
extern "C" int articulated_step(
    const float* model, const float* pos, const float* quat, const float* vel,
    const float* omega, const float* q, const float* qd,
    const unsigned char* pinned, const float* anchors, const float* tau,
    const unsigned char* support, const float* gz, float* pos_out,
    float* quat_out, float* vel_out, float* omega_out, float* q_out,
    float* qd_out, unsigned char* pinned_out, float* feet_out, int B,
    PlantConsts consts, int friction, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + WARPS - 1) / WARPS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (friction)
    articulated_step_kernel<true><<<blocks, THREADS, 0, s>>>(
        model, pos, quat, vel, omega, q, qd, pinned, anchors, tau, support, gz,
        pos_out, quat_out, vel_out, omega_out, q_out, qd_out, pinned_out,
        feet_out, B, consts);
  else
    articulated_step_kernel<false><<<blocks, THREADS, 0, s>>>(
        model, pos, quat, vel, omega, q, qd, pinned, anchors, tau, support, gz,
        pos_out, quat_out, vel_out, omega_out, q_out, qd_out, pinned_out,
        feet_out, B, consts);
  return static_cast<int>(cudaGetLastError());
}

// Launch geometry, for reports: threads and scenarios (one a warp) per
// block, and the blocks an SM holds at once (of the kernel without
// friction; a CUDA error code, negated, if the query fails).
extern "C" int articulated_step_threads_per_block() { return THREADS; }

extern "C" int articulated_step_instances_per_block() { return WARPS; }

extern "C" int articulated_step_resident_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, articulated_step_kernel<false>, THREADS, 0);
  return rc == cudaSuccess ? blocks : -static_cast<int>(rc);
}

extern "C" const char* articulated_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // __CUDACC__
