// Batched force-distribution QP for Hopper (sm_90a): one warp per instance.
//
// Replaces quadruped_locomotion_tpu/ops/qp_pallas.py::_ipm_kernel (launched
// there by solve_fd_qp through pl.pallas_call). For every instance b it
// solves
//
//     min 1/2 x'Gx + g'x   s.t.   Dx >= d,      n = 12, mi = 20, float32
//
// with the same algorithm, step for step: a start point from the Cholesky
// factor of G + 1e-6 I; `iters` Mehrotra predictor-corrector steps on the
// Schur matrix M = G + 1e-6 I + D' diag(z/s) D, factored by a
// Jacobi-equilibrated Cholesky that stores reciprocal diagonals; reciprocals
// of s and z once per step; fraction-to-boundary 0.995 with one division;
// best-iterate tracking and a freeze on KKT < 1e-6 or a non-finite step; the
// honest point-KKT endgame; and the active-set polish (4 refinement sweeps)
// kept only where it lowers the KKT residual. rsqrtf mirrors
// jax.lax.rsqrt, "/" is IEEE division (build without --use_fast_math), and
// max/min propagate NaN as jnp.maximum/jnp.minimum do, so that a non-finite
// candidate loses every comparison exactly as in the reference.
//
// What bounds it on an H100: float32 FMA work. An instance needs ~1.7e5 flop
// (fd_qp_kernel.fd_qp_flops) against 1,876 bytes of input and output, so at
// B = 4096 the bound is ~10 us at the H100 SXM's 67 TFLOP/s against ~2 us of
// memory traffic at 3.35 TB/s. The work of one instance is a serial chain of
// small factorizations and triangular solves, so what limits a simple kernel
// is latency: the chain, and the memory the working set (~1,300 floats: G,
// D, D diag(z/s), the Schur factor, the start factor L0, Ew and the 20x20
// polish matrix K) is kept in.
//
// What the design does about it: the matrix as well as the batch is the
// parallel axis. One warp solves one instance (4 warps per 128-thread block,
// so B = 4096 gives 1,024 blocks over the 132 SMs) and warps never wait for
// each other: __syncwarp() orders a warp's steps, there is no
// __syncthreads(). Each warp keeps its working set in its own slice of static
// shared memory (5.4 KB, 21 KB per block), with G and D rows padded to an odd
// stride of 13 floats so that a lane per row and a lane per column both hit
// 32 distinct banks; registers hold only each lane's entries of the vectors,
// so nothing is indexed at run time in local memory and nothing spills. Lane
// k < 20 owns slack row k (r_p, ds, dz, the step-length terms, w, lambda),
// lane i < 12 owns primal row i (r_d, dx, the stationarity row); row products
// read their vector through __shfl_sync and keep the reference's term order.
// D diag(z/s) is formed once per iteration, Ew = diag(w) D and G^-1 Ew' once
// for the polish (one right-hand side per lane); the Schur matrix and K are
// formed by lanes over packed lower-triangle entries. Cholesky factors column
// by column (a lane per row, the diagonal broadcast by shuffle); triangular
// solves broadcast each solved entry with __shfl_sync. Sums and maxima reduce
// across lanes with a __shfl_xor_sync butterfly, NaN-propagating at every
// step; a butterfly leaves the same bits in every lane, so control flow stays
// warp-uniform. A __syncwarp() before each triangular-solve step, and the
// packed-entry rounds kept as loops, stop the compiler from loading whole
// factors into registers ahead of use: ptxas then needs 128 registers, so an
// SM holds 4 blocks (16 warps). An instance's arithmetic does not depend on B
// or on its position in the batch. Inputs and outputs are the callers'
// (B, E) row-major tensors: one instance's G and D are contiguous, so a
// warp's loads coalesce.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N = 12;                    // primal variables
constexpr int MI = 20;                   // inequality rows
constexpr int NT = N * (N + 1) / 2;      // packed lower triangle, 12x12
constexpr int MT = MI * (MI + 1) / 2;    // packed lower triangle, 20x20
constexpr int RS = 13;                   // padded row stride of G, D in smem
constexpr float DELTA = 1e-6f;           // Tikhonov regularization
constexpr float S_FLOOR = 1e-9f;
constexpr float TOL = 1e-6f;
constexpr float INV_MI = 1.0f / MI;
constexpr int WARPS = 4;                 // instances (warps) per block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Row of packed entry p (p = tri(i, j), j <= i). sqrtf is correctly rounded,
// and 8p + 1 is a perfect square exactly at the start of a row.
__device__ __forceinline__ int tri_row(int p) {
  return static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
}

// NaN-propagating max/min (jnp.maximum / jnp.minimum semantics).
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float bcast(float v, int src) {
  return __shfl_sync(FULL, v, src);
}

// Butterfly reductions over the warp; every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// One warp's working set.
struct WarpSmem {
  float G[N * RS];    // G, row-major, padded rows
  float D[MI * RS];   // D, row-major, padded rows
  float DZ[MI * RS];  // D diag(z/s) in the IPM; rows of G^-1 Ew' in the polish
  float E[MI * RS];   // Ew = diag(w) D, the polish's active rows
  float L0[NT];       // Cholesky factor of G + dI
  float L[NT];        // equilibrated factor of the Schur matrix
  float K[MT];        // equilibrated factor of the polish matrix
  float sc[MI];       // Jacobi scalings, for the lanes that scale entries
  float w[MI];        // active set of the polish
};

// In place: the packed lower triangle of a symmetric M x M matrix becomes its
// Cholesky factor, with the RECIPROCAL of each diagonal entry stored. Column
// by column, lane i computing row i; each entry keeps the reference's
// running-sum order.
template <int M>
__device__ __forceinline__ void cholesky(float* L, int lane) {
  const int r = lane < M ? lane : M - 1;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float acc = L[tri(r, j)];  // unused where r < j (still inside L)
#pragma unroll
    for (int k = 0; k < j; ++k) acc -= L[tri(r, k)] * L[tri(j, k)];
    const float rdiag = rsqrtf(nmax(bcast(acc, j), 1e-30f));
    if (lane == j) {
      L[tri(j, j)] = rdiag;
    } else if (lane > j && lane < M) {
      L[tri(lane, j)] = acc * rdiag;
    }
    __syncwarp();
  }
}

// v <- A^{-1} v through the factor of `cholesky`, for the vector held one
// entry per lane (lane i < M holds v_i; other lanes are left alone). Each
// step starts with __syncwarp(), which keeps the compiler from loading the
// whole factor into registers ahead of the solve (the shuffle chain, not
// the loads, sets the pace).
template <int M>
__device__ __forceinline__ float chol_solve(const float* L, float v, int lane) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    __syncwarp();
    const float vi = bcast(v, i) * L[tri(i, i)];
    const bool below = lane > i && lane < M;
    const float l = L[below ? tri(lane, i) : 0];
    v = lane == i ? vi : (below ? v - l * vi : v);
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    __syncwarp();
    const float vi = bcast(v, i) * L[tri(i, i)];
    const bool above = lane < i;
    const float l = L[above ? tri(i, lane) : 0];
    v = lane == i ? vi : (above ? v - l * vi : v);
  }
  return v;
}

// v <- A^{-1} v for a vector held whole by one lane (the same factor in
// every lane, so its entries are broadcast reads; __syncwarp() per row as
// in chol_solve).
template <int M>
__device__ __forceinline__ void chol_solve_lane(const float* L, float* v) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    __syncwarp();
    float acc = v[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc -= L[tri(i, k)] * v[k];
    v[i] = acc * L[tri(i, i)];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    __syncwarp();
    float acc = v[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) acc -= L[tri(k, i)] * v[k];
    v[i] = acc * L[tri(i, i)];
  }
}

// Jacobi-equilibrated Cholesky: factor diag(s) A diag(s), s = 1/sqrt(diag A).
// Returns s_i to lane i.
template <int M>
__device__ __forceinline__ float scaled_cholesky(float* L, float* sc,
                                                 int lane) {
  const int r = lane < M ? lane : M - 1;
  const float dsc = rsqrtf(nmax(L[tri(r, r)], 1e-30f));
  if (lane < M) sc[lane] = dsc;
  __syncwarp();
  constexpr int T = M * (M + 1) / 2;
#pragma unroll 1
  for (int p0 = 0; p0 < T; p0 += 32) {
    const int p = p0 + lane;
    if (p < T) {
      const int i = tri_row(p), j = p - tri(i, 0);
      L[p] = L[p] * sc[i] * sc[j];
    }
  }
  __syncwarp();
  cholesky<M>(L, lane);
  return dsc;
}

template <int M>
__device__ __forceinline__ float scaled_solve(const float* L, float dsc,
                                              float v, int lane) {
  return chol_solve<M>(L, v * dsc, lane) * dsc;
}

// Fraction-to-boundary through reciprocals rv = 1/v (lane k < MI holds
// entry k): min(1, 0.995 / max_k(-dv_k rv_k | dv_k < 0)), 1 when no dv_k < 0.
__device__ __forceinline__ float step_len_recip(float rv, float dv, int lane) {
  const float m = warp_max(lane < MI && dv < 0.f ? -dv * rv : 0.f);
  const float alpha = 0.995f / nmax(m, 1e-30f);
  return m > 0.f ? nmin(1.f, alpha) : 1.f;
}

// Point KKT residual of (x, z) (lane i holds x_i, lane k holds z_k):
// stationarity, primal violation, mean complementarity, dual sign (twin of
// qp_pallas._honest_kkt_tiles).
__device__ __forceinline__ float honest_kkt(const WarpSmem& S, int lane,
                                            float g, float d, float x, float z,
                                            float scale_g, float scale_d) {
  const int ri = lane < N ? lane : N - 1;
  const int rk = lane < MI ? lane : MI - 1;
  float xv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) xv[j] = bcast(x, j);
  float st = g;
#pragma unroll
  for (int j = 0; j < N; ++j) st += S.G[ri * RS + j] * xv[j];
#pragma unroll
  for (int k = 0; k < MI; ++k) st -= S.D[k * RS + ri] * bcast(z, k);
  float slack = -d;
#pragma unroll
  for (int j = 0; j < N; ++j) slack += S.D[rk * RS + j] * xv[j];
  const bool row = lane < MI;
  const float stat = warp_max(lane < N ? fabsf(st) : 0.f);
  const float viol = warp_max(row ? nmax(-slack, 0.f) : 0.f);
  const float zmax = warp_max(row ? fabsf(z) : 0.f);
  const float zneg = warp_max(row ? nmax(-z, 0.f) : 0.f);
  const float c0 = lane == 0 ? slack * 0.f : 0.f;  // NaN/inf as the reference
  const float comp = warp_sum(row ? c0 + z * fabsf(slack) : 0.f) * INV_MI;
  const float dual = zneg / (1.f + zmax);
  return nmax(nmax(stat / scale_g, dual), nmax(viol / scale_d, comp / scale_g));
}

// One Newton step of the IPM for a complementarity right-hand side r_c
// (lane i: r_d, dx; lane k: r_p, z, rs, r_c, ds, dz).
__device__ __forceinline__ void kkt_step(const WarpSmem& S, int lane,
                                         float dsc, float r_d, float r_p,
                                         float z, float rs, float r_c,
                                         float& dx, float& ds, float& dz) {
  const int ri = lane < N ? lane : N - 1;
  const int rk = lane < MI ? lane : MI - 1;
  const float t = (r_c + z * r_p) * rs;
  float acc = -r_d;
#pragma unroll
  for (int k = 0; k < MI; ++k) acc -= S.D[k * RS + ri] * bcast(t, k);
  dx = scaled_solve<N>(S.L, dsc, acc, lane);
  float a2 = r_p;
#pragma unroll
  for (int j = 0; j < N; ++j) a2 += S.D[rk * RS + j] * bcast(dx, j);
  ds = a2;
  dz = -(r_c + z * a2) * rs;
}

__global__ void __launch_bounds__(THREADS, 1)
fd_qp_ipm_kernel(const float* __restrict__ Gp, const float* __restrict__ gp,
                 const float* __restrict__ Dp, const float* __restrict__ dp,
                 float* __restrict__ x_out, float* __restrict__ s_out,
                 float* __restrict__ z_out, float* __restrict__ kkt_out, int B,
                 int iters) {
  __shared__ WarpSmem smem[WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // the whole warp: b is warp-uniform
  WarpSmem& S = smem[warp];
  const int ri = lane < N ? lane : N - 1;
  const int rk = lane < MI ? lane : MI - 1;

  // ---- loads: G and D whole (coalesced), g_i and d_k to their lanes -------
  {
    const float* Gb = Gp + static_cast<size_t>(b) * (N * N);
    const float* Db = Dp + static_cast<size_t>(b) * (MI * N);
#pragma unroll
    for (int e0 = 0; e0 < N * N; e0 += 32) {
      const int e = e0 + lane;
      if (e < N * N) S.G[(e / N) * RS + e % N] = __ldg(Gb + e);
    }
#pragma unroll
    for (int e0 = 0; e0 < MI * N; e0 += 32) {
      const int e = e0 + lane;
      if (e < MI * N) S.D[(e / N) * RS + e % N] = __ldg(Db + e);
    }
  }
  const float g = lane < N ? __ldg(gp + static_cast<size_t>(b) * N + lane) : 0.f;
  const float d =
      lane < MI ? __ldg(dp + static_cast<size_t>(b) * MI + lane) : 0.f;
  const float scale_g = 1.f + warp_max(lane < N ? fabsf(g) : 0.f);
  const float scale_d = 1.f + warp_max(lane < MI ? fabsf(d) : 0.f);
  __syncwarp();

  // ---- start point: x = -(G + dI)^{-1} g, s = max(Dx - d, 1), z = 1 ------
#pragma unroll 1
  for (int p0 = 0; p0 < NT; p0 += 32) {
    const int p = p0 + lane;
    if (p < NT) {
      const int i = tri_row(p), j = p - tri(i, 0);
      S.L0[p] = S.G[i * RS + j] + (i == j ? DELTA : 0.f);
    }
  }
  __syncwarp();
  cholesky<N>(S.L0, lane);
  float x = chol_solve<N>(S.L0, -g, lane);
  float s, z = 1.f;
  {
    float acc = -d;
#pragma unroll
    for (int j = 0; j < N; ++j) acc += S.D[rk * RS + j] * bcast(x, j);
    s = nmax(acc, 1.f);
  }
  float xb = x, zb = z;
  float kb = INFINITY;
  bool done = false;

#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // residuals at the current iterate
    float r_d = g, r_p = -d - s;
    {
      float xv[N];
#pragma unroll
      for (int j = 0; j < N; ++j) xv[j] = bcast(x, j);
#pragma unroll
      for (int j = 0; j < N; ++j) r_d += S.G[ri * RS + j] * xv[j];
#pragma unroll
      for (int k = 0; k < MI; ++k) r_d -= S.D[k * RS + ri] * bcast(z, k);
#pragma unroll
      for (int j = 0; j < N; ++j) r_p += S.D[rk * RS + j] * xv[j];
    }
    const float mu = warp_sum(lane < MI ? s * z : 0.f) * INV_MI;

    const float rs = 1.f / nmax(s, S_FLOOR);
    const float rz = 1.f / nmax(z, S_FLOOR);
    const float zs = z * rs;

    // D diag(z/s) once, then the Schur matrix (lower half) by packed entries,
    // 32 at a time (rounds stay a loop so that their operands are not all
    // loaded into registers at once; the same for K below)
    if (lane < MI) {
#pragma unroll
      for (int j = 0; j < N; ++j) S.DZ[lane * RS + j] = S.D[lane * RS + j] * zs;
    }
    __syncwarp();
#pragma unroll 1
    for (int p0 = 0; p0 < NT; p0 += 32) {
      const int p = p0 + lane;
      if (p < NT) {
        const int i = tri_row(p), j = p - tri(i, 0);
        float acc = S.G[i * RS + j] + (i == j ? DELTA : 0.f);
#pragma unroll
        for (int k = 0; k < MI; ++k) acc += S.DZ[k * RS + i] * S.D[k * RS + j];
        S.L[p] = acc;
      }
    }
    __syncwarp();
    const float dsc = scaled_cholesky<N>(S.L, S.sc, lane);

    // predictor
    float dx, ds, dz;
    kkt_step(S, lane, dsc, r_d, r_p, z, rs, s * z, dx, ds, dz);
    const float alpha_p = step_len_recip(rs, ds, lane);
    const float alpha_d = step_len_recip(rz, dz, lane);
    const float mu_aff =
        warp_sum(lane < MI ? (s + alpha_p * ds) * (z + alpha_d * dz) : 0.f) *
        INV_MI;
    const float ratio = mu_aff / nmax(mu, 1e-30f);
    const float sigma = nmin(nmax(ratio * ratio * ratio, 0.f), 1.f);

    // corrector
    const float r_c = s * z + ds * dz - sigma * mu;
    kkt_step(S, lane, dsc, r_d, r_p, z, rs, r_c, dx, ds, dz);
    const float alpha = nmin(step_len_recip(rs, ds, lane),
                             step_len_recip(rz, dz, lane));

    // KKT of the CURRENT iterate -> best-so-far
    const float rmax_d = warp_max(lane < N ? fabsf(r_d) : 0.f);
    const float rmax_p = warp_max(lane < MI ? fabsf(r_p) : 0.f);
    const float kkt_new =
        nmax(rmax_d / scale_g, nmax(rmax_p / scale_d, mu / scale_g));
    if (kkt_new < kb) {
      xb = x;
      zb = z;
      kb = kkt_new;
    }

    // step; freeze on convergence or a non-finite update
    const float xn = x + alpha * dx;
    const float sn = s + alpha * ds;
    const float zn = z + alpha * dz;
    const float total = warp_sum((lane < N ? xn : 0.f) +
                                 (lane < MI ? sn + zn : 0.f));
    const bool bad = !isfinite(total);
    if (!done && !bad) {
      x = xn;
      s = sn;
      z = zn;
    }
    done = done || kkt_new < TOL || bad;
  }

  // ---- endgame: honest residuals, best-of -----------------------------
  const float k_last = honest_kkt(S, lane, g, d, x, z, scale_g, scale_d);
  const float k_best = honest_kkt(S, lane, g, d, xb, zb, scale_g, scale_d);
  const bool take_last = k_last <= k_best;
  if (!take_last) {
    x = xb;
    z = zb;
  }
  float kkt = take_last ? k_last : k_best;

  // ---- active-set polish: w = (z > slack) -------------------------------
  float w;
  {
    float slack = -d;
#pragma unroll
    for (int j = 0; j < N; ++j) slack += S.D[rk * RS + j] * bcast(x, j);
    w = z > slack ? 1.f : 0.f;
  }
  // Ew = diag(w) D once, and the rows of G^{-1} Ew': lane q solves for row q
  {
    float t[N];
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] = S.D[rk * RS + j] * w;
    if (lane < MI) {
      S.w[lane] = w;
#pragma unroll
      for (int j = 0; j < N; ++j) S.E[lane * RS + j] = t[j];
    }
    chol_solve_lane<N>(S.L0, t);
    if (lane < MI) {
#pragma unroll
      for (int j = 0; j < N; ++j) S.DZ[lane * RS + j] = t[j];
    }
  }
  __syncwarp();
  // K = Ew G^{-1} Ew' + diag(1 - w) + dI (lower half) by packed entries
#pragma unroll 1
  for (int p0 = 0; p0 < MT; p0 += 32) {
    const int p = p0 + lane;
    if (p < MT) {
      const int a = tri_row(p), q = p - tri(a, 0);
      const float wa = S.w[a];
      float acc = a == q ? (1.f - wa) + DELTA : 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) acc += S.E[a * RS + j] * S.DZ[q * RS + j];
      S.K[p] = acc;
    }
  }
  __syncwarp();
  const float dscK = scaled_cholesky<MI>(S.K, S.sc, lane);

  // xp = -G^{-1} g, lam = 0, then refinement sweeps on the KKT system
  float xp = chol_solve<N>(S.L0, -g, lane);
  float lam = 0.f;
#pragma unroll 1
  for (int sweep = 0; sweep < 4; ++sweep) {
    float xpv[N];
#pragma unroll
    for (int j = 0; j < N; ++j) xpv[j] = bcast(xp, j);
    float r1 = -g;
#pragma unroll
    for (int k = 0; k < MI; ++k) r1 += S.E[k * RS + ri] * bcast(lam, k);
#pragma unroll
    for (int j = 0; j < N; ++j) r1 -= S.G[ri * RS + j] * xpv[j];
    const float t = chol_solve<N>(S.L0, r1, lane);
    float r2 = d;
#pragma unroll
    for (int j = 0; j < N; ++j) r2 -= S.D[rk * RS + j] * xpv[j];
    float rhs2 = r2 * w;
#pragma unroll
    for (int j = 0; j < N; ++j) rhs2 -= S.E[rk * RS + j] * bcast(t, j);
    const float dlam = scaled_solve<MI>(S.K, dscK, rhs2, lane);
    float acc = r1;
#pragma unroll
    for (int k = 0; k < MI; ++k) acc += S.E[k * RS + ri] * bcast(dlam, k);
    xp = xp + chol_solve<N>(S.L0, acc, lane);
    lam = lam + dlam;
  }
  lam = lam * w;
  const float k_pol = honest_kkt(S, lane, g, d, xp, lam, scale_g, scale_d);
  if (k_pol < kkt) {  // false on a non-finite k_pol
    x = xp;
    z = lam;
    kkt = k_pol;
  }

  // ---- outputs: x, slack of x floored at 0, z, kkt -----------------------
  float slack = -d;
#pragma unroll
  for (int j = 0; j < N; ++j) slack += S.D[rk * RS + j] * bcast(x, j);
  if (lane < N) x_out[static_cast<size_t>(b) * N + lane] = x;
  if (lane < MI) {
    s_out[static_cast<size_t>(b) * MI + lane] = nmax(slack, 0.f);
    z_out[static_cast<size_t>(b) * MI + lane] = z;
  }
  if (lane == 0) kkt_out[b] = kkt;
}

}  // namespace

// Plain C entry point (bound with ctypes). All arrays are contiguous float32
// device pointers in the callers' (B, E) row-major layout: G (B, 12, 12),
// g (B, 12), D (B, 20, 12), d (B, 20) in; x (B, 12), s (B, 20), z (B, 20),
// kkt (B) out. Launches on `stream` and returns cudaGetLastError() of the
// launch (0 = success).
extern "C" int fd_qp_ipm(const float* G, const float* g, const float* D,
                         const float* d, float* x, float* s, float* z,
                         float* kkt, int B, int iters, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + WARPS - 1) / WARPS;
  fd_qp_ipm_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      G, g, D, d, x, s, z, kkt, B, iters);
  return static_cast<int>(cudaGetLastError());
}

// Launch geometry, for reports: threads per block (one warp per instance).
extern "C" int fd_qp_ipm_threads_per_block() { return THREADS; }

extern "C" const char* fd_qp_ipm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
