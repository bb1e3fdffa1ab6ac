// Kernel K1: the fused MPPI solve, hand-written for Hopper (sm_90a).
//
// Replaces tpunav/ops/pallas_mppi.py:_mppi_kernel (the Pallas TPU kernel
// launched by _solve_update). One solve is two launches:
//
//   A. mppi_rollout_partials — one 512-thread block per R = 32 rollouts,
//      ceil(K/32) blocks. The block works in stages over its R·N
//      (rollout, step) pairs, T steps of the horizon at a time (a chunk),
//      with a barrier between stages:
//        1. noise, in parallel: one Philox4x32-10 + Box-Muller draw per
//           pair (or a coalesced read of the injected (N, K, 2) tensor),
//           kept for the whole horizon; and each pair's heading increment
//           dθ, which depends on the held controls only;
//        2. θ, serial: one lane per rollout adds dθ down the chunk;
//        3. trigonometry, in parallel: the RK4 step's six cos/sin and the
//           x/y increments of every pair;
//        4. x and y, serial: one lane per rollout each (two warps);
//        5. the loss, in parallel: the LQR loss with the terminal row
//           overwritten and, with obstacles (BASELINE config 2), the
//           analytic obstacle cost of the TPU kernel's obstacle mode
//           (pallas_mppi.py:149-175), whose segment loop now runs across
//           pairs, not down one thread's chain;
//      then, over the whole horizon:
//        6. the reverse cost-to-go, serial: acc = J[t] + acc per rollout;
//        7. the softmax partials, in parallel over t: a warp takes a step
//           and its lanes the block's 32 rollouts, with no barrier between
//           steps, into (blocks, N, 6) rows [m_l, Σe, Σe·z0, Σe·z1, Σz0,
//           Σz1] with e = exp((m_l − J)/λ) (the partial_out layout of the
//           TPU kernel).
//      The noise and the cost-to-go of the horizon stay in shared memory
//      (3·R·N floats) for N ≤ 256 and in an L2-resident (3, N, K) global
//      scratch beyond; θ, x and y carry across chunks in the serial lanes'
//      registers. The Philox stream is counter-based (key (seed, 0),
//      counter (k, t, 0, 0)) and is drawn once: stage 7 reads the kept z.
//   B. mppi_combine — one 128-thread block per step t. It takes the global
//      min m_g over the blocks, rescales each block by exp((m_g − m_l)/λ)
//      and sums, then either writes the combined (N, 6) partials or
//      applies the +1e-8 weight floor, adds du to u and clamps to
//      ±max_wheel_vel, writing u_new (N, 2).
//
// Problems: one launch solves P independent problems (tpunav's vmap of the
// solve over a batch of seeds), each with its own u, pose, xd and seed:
// blockIdx.y is the problem in both kernels, so kernel A runs ceil(K/32)·P
// blocks and B runs N·P. Each problem's Philox stream is keyed by its own
// seed exactly as a launch of that problem alone keys it, and no block
// reads another problem's data, so every problem gets its single launch's
// bits. P = 1 is the single solve.
//
// What bounds it on this card: latency, not bytes. The solve reads only u,
// pose, xd, the seed and the obstacle table. Its real recurrences are θ,
// x, y and the reverse sum, a few adds per step each; everything else (the
// ~100 integer operations of a Philox draw, Box-Muller, six cos/sin, the
// loss and O segment distances per pair) is independent across steps. One
// rollout per thread would put all of it on one serial chain, in 32 blocks
// at K=4,096, and would replay Philox in the reduction. This design takes
// the independent work off the chains and spreads it over (rollout, step)
// pairs: 128 blocks of 16 warps at K=4,096, 1,536 at K=49,152. What is
// left serial is four chains of N adds, one lane per rollout. The
// obstacle table sits in shared memory ((6·O + 4)·4 bytes) and
// O is a runtime loop bound, so a new obstacle set needs no new build.
//
// Rounding: at λ=0.01 the softmax is close to a hard argmin over K, so
// every operation of the rollout, the loss and the obstacle term is an
// explicit round-to-nearest intrinsic in the TPU kernel's expression order
// (pallas_mppi.py:_mppi_kernel): nvcc contracts none of them into a fused
// multiply-add, and the plain version (ops/fused_mppi.py) rounds each
// operation alike. Splitting a rollout step over stages recomputes w and
// dθ from the same inputs, which gives the same bits. Built with -O3 and
// without --use_fast_math: cosf/sinf/expf/logf/sqrtf are the accurate
// library functions. No allocation and no synchronisation here: the caller
// allocates the scratch and outputs, and every entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kRollouts = 32;                 // R: rollouts per block (lanes)
constexpr int kThreads = 512;                 // threads per block of kernel A
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 128;
constexpr int kCombineWarps = kCombineThreads / 32;

// Mirrors tpunav_torch/ops/fused_mppi.py:_KernelParams (ctypes.Structure).
// Products of configuration constants (dt/6, r/b, r/2, ...) are formed on
// the host in double and rounded once to float, as the TPU kernel's
// trace-time Python constants are.
struct MppiParams {
  int rollouts;      // K
  int steps;         // N
  int partial_out;   // 1: write combined (N, 6) partials instead of u_new
  int n_obs;         // O: segment rows of the obstacle table (0: none)
  float dt;
  float half_dt;     // 0.5·dt
  float dt6;         // dt/6
  float w_scale;     // wheel_radius / wheel_base
  float fwd_scale;   // 0.5 · wheel_radius
  float sig0;        // sqrt(ul_var)
  float sig1;        // sqrt(ur_var)
  float q0, q1, q2;
  float r0, r1;
  float p0, p1, p2;
  float inv_lambda;  // 1/λ
  float floor_k;     // 1e-8 · K
  float max_wheel_vel;
  int chunk;         // T: steps per chunk of the horizon
  int horizon_smem;  // 1: z and J in shared memory; 0: in the global scratch
  int problems;      // P: independent problems of the launch (blockIdx.y)
};

namespace {

// Philox4x32-10 (Random123's philox4x32_R(10, ...)).
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// Uniform in (0, 1] from the top 24 bits: exact in float32.
__device__ __forceinline__ float uniform01(uint32_t w) {
  return (float)((w >> 8) + 1u) * 5.9604644775390625e-08f;  // 2^-24
}

// The perturbation of rollout k at step t (see ops/philox.py:mppi_noise).
__device__ __forceinline__ void noise_at(const MppiParams& p,
                                         const float* __restrict__ noise,
                                         uint32_t seed, int k, int t,
                                         float& z0, float& z1) {
  if (noise != nullptr) {
    const size_t i = ((size_t)t * p.rollouts + k) * 2;
    z0 = noise[i];
    z1 = noise[i + 1];
    return;
  }
  uint32_t c[4] = {(uint32_t)k, (uint32_t)t, 0u, 0u};
  philox4x32_10(c, seed, 0u);
  const float u1 = uniform01(c[0]);
  const float u2 = uniform01(c[1]);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float ang = __fmul_rn(6.28318530717958647692f, u2);
  z0 = __fmul_rn(__fmul_rn(r, cosf(ang)), p.sig0);
  z1 = __fmul_rn(__fmul_rn(r, sinf(ang)), p.sig1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The held wheel speeds of a pair: u_t + z.
struct Wheels {
  float ul, ur;
};

__device__ __forceinline__ Wheels wheels(const float* __restrict__ u, int t,
                                         float z0, float z1) {
  return {__fadd_rn(u[2 * t], z0), __fadd_rn(u[2 * t + 1], z1)};
}

// θ-dot of the held controls, w = (r/b)·(ur − ul).
__device__ __forceinline__ float omega(const MppiParams& p, Wheels c) {
  return __fmul_rn(p.w_scale, __fsub_rn(c.ur, c.ul));
}

// The RK4 step's increment s·(k1 + 2·(k2 + k2) + k4) (k3 = k2: θ-dot
// depends only on the held controls). For θ every stage is w.
__device__ __forceinline__ float rk4_increment(float s, float k1, float k2,
                                               float k4) {
  return __fmul_rn(
      s, __fadd_rn(__fadd_rn(k1, __fmul_rn(2.0f, __fadd_rn(k2, k2))), k4));
}

// Shared-memory layout of the obstacle table: per segment o, kSegFloats
// floats [ax, ay, abx, aby, r, inv] at 6·o, then the weights row
// [r_safe, w_hit, w_field, 1/σ] at 6·O.
constexpr int kSegFloats = 6;

// The block's copy of the packed (O+1, 5) table (pack_obstacles): each
// segment's b − a and inv = 1/max(|ab|², 1e-12) are formed once here, with
// the TPU kernel's float32 operations, instead of at every rollout step.
__device__ void load_obstacles(const float* __restrict__ table, int n_obs,
                               float* sh) {
  for (int o = threadIdx.x; o < n_obs; o += kThreads) {
    const float* row = table + 5 * o;
    const float ax = row[0], ay = row[1];
    const float abx = __fsub_rn(row[2], ax);
    const float aby = __fsub_rn(row[3], ay);
    const float n2 = __fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby));
    float* s = sh + kSegFloats * o;
    s[0] = ax;
    s[1] = ay;
    s[2] = abx;
    s[3] = aby;
    s[4] = row[4];
    s[5] = __fdiv_rn(1.0f, fmaxf(n2, 1e-12f));
  }
  if (threadIdx.x < 4) {
    sh[kSegFloats * n_obs + threadIdx.x] = table[5 * n_obs + threadIdx.x];
  }
}

// The obstacle term of one rollout position, added to its step loss l as
// the TPU kernel adds it: (l + w_hit·[d ≤ r_safe]) + w_field·exp(−(d −
// r_safe)·inv_σ), where d = min over o of (‖p − proj_o(p)‖ − r_o), taken in
// the order of pallas_mppi.py:157-168. sqrtf and expf are the accurate
// library functions.
__device__ __forceinline__ float obstacle_cost(const float* sh, int n_obs,
                                               float x, float y, float l) {
  float d = INFINITY;
  for (int o = 0; o < n_obs; ++o) {
    const float* s = sh + kSegFloats * o;
    float tp = __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(x, s[0]), s[2]),
                                   __fmul_rn(__fsub_rn(y, s[1]), s[3])),
                         s[5]);
    tp = fminf(fmaxf(tp, 0.0f), 1.0f);
    const float px = __fsub_rn(x, __fadd_rn(s[0], __fmul_rn(tp, s[2])));
    const float py = __fsub_rn(y, __fadd_rn(s[1], __fmul_rn(tp, s[3])));
    const float dist =
        sqrtf(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)));
    d = fminf(d, __fsub_rn(dist, s[4]));
  }
  const float* w = sh + kSegFloats * n_obs;
  const float hit = d <= w[0] ? 1.0f : 0.0f;
  const float e = expf(__fmul_rn(-__fsub_rn(d, w[0]), w[3]));
  return __fadd_rn(__fadd_rn(l, __fmul_rn(w[1], hit)), __fmul_rn(w[2], e));
}

// c·e·e, the loss's quadratic term, as the TPU kernel's q0 * ex * ex.
__device__ __forceinline__ float quad(float c, float e) {
  return __fmul_rn(__fmul_rn(c, e), e);
}

// The step loss of a pair at its new position: the running LQR loss, or
// on the last step the terminal loss that replaces it.
__device__ __forceinline__ float step_loss(const MppiParams& p,
                                           const float* __restrict__ xd,
                                           bool terminal, float x, float y,
                                           float th, Wheels c) {
  const float ex = __fsub_rn(x, xd[0]);
  const float ey = __fsub_rn(y, xd[1]);
  const float et = __fsub_rn(th, xd[2]);
  if (terminal) {
    return __fadd_rn(__fadd_rn(quad(p.p0, ex), quad(p.p1, ey)),
                     quad(p.p2, et));
  }
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(quad(p.q0, ex), quad(p.q1, ey)),
                          quad(p.q2, et)),
                quad(p.r0, c.ul)),
      quad(p.r1, c.ur));
}

__global__ void __launch_bounds__(kThreads)
mppi_rollout_partials(MppiParams p, const float* __restrict__ u,
                      const float* __restrict__ pose,
                      const float* __restrict__ xd,
                      const int* __restrict__ seed_ptr,
                      const float* __restrict__ noise,
                      const float* __restrict__ obstacles,
                      const unsigned char* __restrict__ hold,
                      float* __restrict__ scratch, float* __restrict__ parts) {
  // A held tick (a device flag): the caller discards the solve.
  if (hold != nullptr && *hold) return;
  // Dynamic shared memory, in floats: the obstacle table (6·O + 4), the
  // chunk planes TH, X, Y (T·R each), then, with horizon_smem, the
  // horizon planes Z0, Z1, J (N·R each). A plane is [step][rollout], so a
  // warp's 32 lanes touch 32 consecutive words.
  extern __shared__ float smem[];
  const int K = p.rollouts, N = p.steps, T = p.chunk, R = kRollouts;
  const int n_obs = p.n_obs;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * R;
  // This block's problem: its inputs, noise, scratch and partials.
  const size_t prob = blockIdx.y;
  u += prob * N * 2;
  pose += prob * 3;
  xd += prob * 3;
  if (noise != nullptr) noise += prob * N * K * 2;
  if (scratch != nullptr) scratch += prob * 3 * N * K;
  parts += prob * gridDim.x * N * 6;
  const uint32_t seed = noise == nullptr ? (uint32_t)seed_ptr[prob] : 0u;

  float* sh_obs = smem;
  float* th_c = smem + (n_obs > 0 ? kSegFloats * n_obs + 4 : 0);
  float* x_c = th_c + T * R;
  float* y_c = x_c + T * R;
  // Plane rows t of this block's rollouts: plane[t·hs + r].
  float *z0h, *z1h, *jh;
  size_t hs;
  if (p.horizon_smem) {
    z0h = y_c + T * R;
    z1h = z0h + N * R;
    jh = z1h + N * R;
    hs = R;
  } else {
    const size_t nk = (size_t)N * K;
    z0h = scratch + k0;
    z1h = scratch + nk + k0;
    jh = scratch + 2 * nk + k0;
    hs = K;
  }
  if (n_obs > 0) load_obstacles(obstacles, n_obs, sh_obs);

  // The serial lanes' state, carried across chunks (lane = rollout).
  const bool lane_valid = k0 + lane < K;
  float th = pose[2], x = pose[0], y = pose[1];

  for (int t0 = 0; t0 < N; t0 += T) {
    const int pairs = min(T, N - t0) * R;
    // Pair i of the chunk is step t0 + i/R of rollout k0 + i%R.
    // 1. Noise and dθ.
    for (int i = threadIdx.x; i < pairs; i += kThreads) {
      const int r = i & (kRollouts - 1), t = t0 + i / kRollouts;
      if (k0 + r >= K) continue;
      float z0, z1;
      noise_at(p, noise, seed, k0 + r, t, z0, z1);
      z0h[t * hs + r] = z0;
      z1h[t * hs + r] = z1;
      const float w = omega(p, wheels(u, t, z0, z1));
      th_c[i] = rk4_increment(p.dt6, w, w, w);
    }
    __syncthreads();
    // 2. θ at the start of each step, in place of dθ.
    if (warp == 0 && lane_valid) {
      const int steps = pairs / kRollouts;
#pragma unroll 8
      for (int s = 0; s < steps; ++s) {
        const float d = th_c[s * R + lane];
        th_c[s * R + lane] = th;
        th = __fadd_rn(th, d);
      }
    }
    __syncthreads();
    // 3. Trigonometry and the x/y increments.
    for (int i = threadIdx.x; i < pairs; i += kThreads) {
      const int r = i & (kRollouts - 1), t = t0 + i / kRollouts;
      if (k0 + r >= K) continue;
      const Wheels c = wheels(u, t, z0h[t * hs + r], z1h[t * hs + r]);
      const float w = omega(p, c);
      const float fwd = __fmul_rn(p.fwd_scale, __fadd_rn(c.ul, c.ur));
      const float th1 = th_c[i];
      const float th2 = __fadd_rn(th1, __fmul_rn(p.half_dt, w));
      const float th4 = __fadd_rn(th1, __fmul_rn(p.dt, w));
      x_c[i] = rk4_increment(p.dt6, __fmul_rn(fwd, cosf(th1)),
                             __fmul_rn(fwd, cosf(th2)),
                             __fmul_rn(fwd, cosf(th4)));
      y_c[i] = rk4_increment(p.dt6, __fmul_rn(fwd, sinf(th1)),
                             __fmul_rn(fwd, sinf(th2)),
                             __fmul_rn(fwd, sinf(th4)));
    }
    __syncthreads();
    // 4. x (warp 0) and y (warp 1) after each step, in place of the
    // increments.
    if (warp < 2 && lane_valid) {
      float* plane = warp == 0 ? x_c : y_c;
      float v = warp == 0 ? x : y;
      const int steps = pairs / kRollouts;
#pragma unroll 8
      for (int s = 0; s < steps; ++s) {
        v = __fadd_rn(v, plane[s * R + lane]);
        plane[s * R + lane] = v;
      }
      if (warp == 0) {
        x = v;
      } else {
        y = v;
      }
    }
    __syncthreads();
    // 5. The step loss at the new pose (θ after the step is θ + dθ again).
    for (int i = threadIdx.x; i < pairs; i += kThreads) {
      const int r = i & (kRollouts - 1), t = t0 + i / kRollouts;
      if (k0 + r >= K) continue;
      const Wheels c = wheels(u, t, z0h[t * hs + r], z1h[t * hs + r]);
      const float w = omega(p, c);
      const float th_new = __fadd_rn(th_c[i], rk4_increment(p.dt6, w, w, w));
      float l = step_loss(p, xd, t == N - 1, x_c[i], y_c[i], th_new, c);
      if (n_obs > 0) l = obstacle_cost(sh_obs, n_obs, x_c[i], y_c[i], l);
      jh[t * hs + r] = l;
    }
    __syncthreads();
  }

  // 6. The reverse cumulative sum: cost-to-go, in place of the loss.
  if (warp == 0 && lane_valid) {
    float acc = jh[(N - 1) * hs + lane];
#pragma unroll 8
    for (int t = N - 2; t >= 0; --t) {
      acc = __fadd_rn(jh[t * hs + lane], acc);
      jh[t * hs + lane] = acc;
    }
  }
  __syncthreads();

  // 7. Per-step softmax partials over the block's rollouts: warp per step.
  // Invalid lanes contribute +inf to the min and 0 to every sum.
  for (int t = warp; t < N; t += kWarps) {
    float jt = INFINITY, z0 = 0.0f, z1 = 0.0f;
    if (lane_valid) {
      jt = jh[t * hs + lane];
      z0 = z0h[t * hs + lane];
      z1 = z1h[t * hs + lane];
    }
    const float m = warp_min(jt);
    const float e =
        lane_valid ? expf(__fmul_rn(__fsub_rn(m, jt), p.inv_lambda)) : 0.0f;
    float v[5] = {e, __fmul_rn(e, z0), __fmul_rn(e, z1), z0, z1};
#pragma unroll
    for (int c = 0; c < 5; ++c) v[c] = warp_sum(v[c]);
    float out = m;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      if (lane == c + 1) out = v[c];
    }
    if (lane < 6) parts[((size_t)blockIdx.x * N + t) * 6 + lane] = out;
  }
}

__global__ void __launch_bounds__(kCombineThreads)
mppi_combine(MppiParams p, const float* __restrict__ u,
             const float* __restrict__ parts, int blocks,
             const unsigned char* __restrict__ hold,
             float* __restrict__ out) {
  if (hold != nullptr && *hold) return;
  __shared__ float sh_min[kCombineWarps];
  __shared__ float sh_sum[kCombineWarps][5];

  const int N = p.steps;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // This block's problem.
  const size_t prob = blockIdx.y;
  u += prob * N * 2;
  parts += prob * blocks * N * 6;
  out += prob * N * (p.partial_out ? 6 : 2);

  float m = INFINITY;
  for (int b = threadIdx.x; b < blocks; b += kCombineThreads)
    m = fminf(m, parts[((size_t)b * N + t) * 6]);
  m = warp_min(m);
  if (lane == 0) sh_min[warp] = m;
  __syncthreads();
  m = sh_min[0];
#pragma unroll
  for (int i = 1; i < kCombineWarps; ++i) m = fminf(m, sh_min[i]);

  float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int b = threadIdx.x; b < blocks; b += kCombineThreads) {
    const float* row = parts + ((size_t)b * N + t) * 6;
    const float s = expf((m - row[0]) * p.inv_lambda);
    v[0] += s * row[1];
    v[1] += s * row[2];
    v[2] += s * row[3];
    v[3] += row[4];
    v[4] += row[5];
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) v[c] = warp_sum(v[c]);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 5; ++c) sh_sum[warp][c] = v[c];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  float red[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    red[c] = sh_sum[0][c];
#pragma unroll
    for (int i = 1; i < kCombineWarps; ++i) red[c] += sh_sum[i][c];
  }
  if (p.partial_out) {
    float* row = out + (size_t)t * 6;
    row[0] = m;
#pragma unroll
    for (int c = 0; c < 5; ++c) row[1 + c] = red[c];
    return;
  }
  // w = e + 1e-8 over all K rollouts: Σw = Σe + 1e-8·K and
  // Σw·z = Σe·z + 1e-8·Σz.
  const float denom = red[0] + p.floor_k;
  const float du0 = (red[1] + 1e-8f * red[3]) / denom;
  const float du1 = (red[2] + 1e-8f * red[4]) / denom;
  const float lim = p.max_wheel_vel;
  out[2 * t] = fminf(fmaxf(u[2 * t] + du0, -lim), lim);
  out[2 * t + 1] = fminf(fmaxf(u[2 * t + 1] + du1, -lim), lim);
}

}  // namespace

extern "C" {

// P = params->problems fused MPPI solves on `stream`. Pointers are device
// pointers to P problems each: u (P, N, 2), pose and xd (P, 3), seed (P,);
// `noise` may be null (in-kernel Philox), else (P, N, K, 2); `obstacles` is
// the packed (O+1, 5) table with O = params->n_obs, shared by the
// problems, or null when n_obs is 0. `hold` is a device bool or null: where
// it is set, every block of both kernels returns at once and `out` is left
// as it was (a held tick, whose solve the caller discards). `scratch` holds
// the (P, 3, N, K) horizon planes when params->horizon_smem is 0, else it
// may be null; `parts` holds P·ceil(K/32)·N·6 floats, `out` P·N·2 floats
// (P·N·6 with partial_out). Returns cudaGetLastError() after both
// launches.
int tpunav_mppi_solve(const MppiParams* params, const float* u,
                      const float* pose, const float* xd, const int* seed,
                      const float* noise, const float* obstacles,
                      const unsigned char* hold, float* scratch,
                      float* parts, float* out, void* stream) {
  const MppiParams p = *params;
  const int blocks = (p.rollouts + kRollouts - 1) / kRollouts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Keep in step with fused_mppi.py:_shared_bytes.
  size_t floats = 3 * static_cast<size_t>(kRollouts) * p.chunk;
  if (p.horizon_smem) floats += 3 * static_cast<size_t>(kRollouts) * p.steps;
  if (p.n_obs > 0) floats += static_cast<size_t>(kSegFloats) * p.n_obs + 4;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mppi_rollout_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mppi_rollout_partials<<<dim3(blocks, p.problems), kThreads, smem, s>>>(
      p, u, pose, xd, seed, noise, obstacles, hold, scratch, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mppi_combine<<<dim3(p.steps, p.problems), kCombineThreads, 0, s>>>(
      p, u, parts, blocks, hold, out);
  return static_cast<int>(cudaGetLastError());
}

const char* tpunav_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
