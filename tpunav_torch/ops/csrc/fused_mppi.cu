// Kernel K1: the fused MPPI solve, hand-written for Hopper (sm_90a).
//
// Replaces tpunav/ops/pallas_mppi.py:_mppi_kernel (the Pallas TPU kernel
// launched by _solve_update). One solve is two launches:
//
//   A. mppi_rollout_partials — one thread per rollout, 128-thread blocks,
//      ceil(K/128) blocks. Each thread draws its perturbations (in-kernel
//      Philox4x32-10 + Box-Muller, or an injected (N, K, 2) tensor),
//      integrates its RK4 diff-drive rollout over N steps, writes its LQR
//      loss column into an (N, K) scratch (terminal row overwritten), and
//      takes the reverse cost-to-go down its own column. Then, for each
//      step t, the block reduces its 128 rows to the six softmax partials
//      [m_l, Σe, Σe·z0, Σe·z1, Σz0, Σz1] with e = exp((m_l − J)/λ)
//      (the partial_out layout of the TPU kernel), into (blocks, N, 6).
//      The Philox stream is counter-based (key (seed, 0), counter
//      (k, t, 0, 0)), so the reduction phase regenerates z instead of
//      storing it, as the TPU kernel re-seeds and replays its PRNG.
//      With obstacles (BASELINE config 2), each step's loss also pays the
//      analytic obstacle cost of the TPU kernel's obstacle mode
//      (pallas_mppi.py:149-175), after the terminal-row overwrite: see
//      obstacle_cost below.
//   B. mppi_combine — one 128-thread block per step t. It takes the global
//      min m_g over the blocks, rescales each block by exp((m_g − m_l)/λ)
//      and sums, then either writes the combined (N, 6) partials or
//      applies the +1e-8 weight floor, adds du to u and clamps to
//      ±max_wheel_vel, writing u_new (N, 2).
//
// What bounds it on this card: latency, not bytes. Each thread runs N
// dependent RK4 steps with trigonometry, and the solve reads only u, pose,
// xd and the seed. The (N, K) f32 scratch is 0.8 MB at K=4,096 and 9.8 MB
// at K=49,152 (N=50), so it stays in the 50 MB L2. The design keeps one
// rollout per thread so the recurrence never leaves registers, and makes
// the cross-block softmax exact by the rescaled-exponential algebra of
// combine_softmax_partials instead of atomics. The obstacle mode adds O
// segment distances to each step: the block keeps the table in shared
// memory ((6·O + 4)·4 bytes: 112 B for a 4-segment wall, 1 KB for the
// reference world's 41 edges), and O is a runtime loop bound, so a new
// obstacle set needs no new build (the TPU kernel unrolled it statically).
//
// Build with -O3 and without --use_fast_math: cosf/sinf/expf/logf are the
// accurate library functions. At λ=0.01 the softmax is close to a hard
// argmin over K, so the RK4 and loss keep the TPU kernel's expression
// order. No allocation and no synchronisation here: the caller allocates
// the scratch and outputs, and every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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
  const float r = sqrtf(-2.0f * logf(u1));
  const float ang = 6.28318530717958647692f * u2;
  z0 = (r * cosf(ang)) * p.sig0;
  z1 = (r * sinf(ang)) * p.sig1;
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
// the order of pallas_mppi.py:157-168. Every product and sum is an explicit
// round-to-nearest intrinsic, so nvcc contracts none into a fused
// multiply-add: at λ=0.01 the softmax turns last-ulp cost differences into
// weight ratios of e^(100Δ). sqrtf and expf are the accurate library
// functions (no --use_fast_math).
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

__global__ void __launch_bounds__(kThreads)
mppi_rollout_partials(MppiParams p, const float* __restrict__ u,
                      const float* __restrict__ pose,
                      const float* __restrict__ xd,
                      const int* __restrict__ seed_ptr,
                      const float* __restrict__ noise,
                      const float* __restrict__ obstacles,
                      float* __restrict__ J, float* __restrict__ parts) {
  __shared__ float sh_min[kWarps];
  __shared__ float sh_sum[kWarps][5];
  extern __shared__ float sh_obs[];  // kSegFloats·O + 4 floats

  const int K = p.rollouts;
  const int N = p.steps;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = k < K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t seed = noise == nullptr ? (uint32_t)seed_ptr[0] : 0u;
  const float xd0 = xd[0], xd1 = xd[1], xd2 = xd[2];
  const int n_obs = p.n_obs;
  if (n_obs > 0) {
    load_obstacles(obstacles, n_obs, sh_obs);
    __syncthreads();
  }

  if (valid) {
    // ── Rollout over the horizon; loss column in the (N, K) scratch ──
    float x = pose[0], y = pose[1], th = pose[2];
    const float dt = p.dt;
    for (int t = 0; t < N; ++t) {
      float z0, z1;
      noise_at(p, noise, seed, k, t, z0, z1);
      const float ul = u[2 * t] + z0;
      const float ur = u[2 * t + 1] + z1;
      // Classical RK4 with zero-order-hold control. theta-dot depends
      // only on the held controls, so the k2 and k3 stages are identical
      // and k3 reuses k2 (same expressions as the TPU kernel).
      const float w = p.w_scale * (ur - ul);
      const float fwd = p.fwd_scale * (ul + ur);
      const float k1x = fwd * cosf(th);
      const float k1y = fwd * sinf(th);
      const float th2 = th + p.half_dt * w;
      const float k2x = fwd * cosf(th2);
      const float k2y = fwd * sinf(th2);
      const float th4 = th + dt * w;
      const float k4x = fwd * cosf(th4);
      const float k4y = fwd * sinf(th4);
      const float s = p.dt6;
      x = x + s * (k1x + 2.0f * (k2x + k2x) + k4x);
      y = y + s * (k1y + 2.0f * (k2y + k2y) + k4y);
      th = th + s * (w + 2.0f * (w + w) + w);

      const float ex = x - xd0;
      const float ey = y - xd1;
      const float et = th - xd2;
      float l;
      if (t == N - 1) {  // the terminal loss replaces the running loss
        l = p.p0 * ex * ex + p.p1 * ey * ey + p.p2 * et * et;
      } else {
        l = p.q0 * ex * ex + p.q1 * ey * ey + p.q2 * et * et +
            p.r0 * ul * ul + p.r1 * ur * ur;
      }
      if (n_obs > 0) l = obstacle_cost(sh_obs, n_obs, x, y, l);
      J[(size_t)t * K + k] = l;
    }
    // ── Reverse cumulative sum → cost-to-go, down this thread's column ──
    float acc = J[(size_t)(N - 1) * K + k];
    for (int t = N - 2; t >= 0; --t) {
      acc = J[(size_t)t * K + k] + acc;
      J[(size_t)t * K + k] = acc;
    }
  }

  // ── Per-step softmax partials over this block's rollouts ──
  // Masked threads contribute +inf to the min and 0 to every sum.
  for (int t = 0; t < N; ++t) {
    float jt = INFINITY, z0 = 0.0f, z1 = 0.0f;
    if (valid) {
      jt = J[(size_t)t * K + k];
      noise_at(p, noise, seed, k, t, z0, z1);
    }
    float m = warp_min(jt);
    if (lane == 0) sh_min[warp] = m;
    __syncthreads();
    m = sh_min[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) m = fminf(m, sh_min[i]);

    const float e = valid ? expf((m - jt) * p.inv_lambda) : 0.0f;
    float v[5] = {e, e * z0, e * z1, z0, z1};
#pragma unroll
    for (int c = 0; c < 5; ++c) v[c] = warp_sum(v[c]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 5; ++c) sh_sum[warp][c] = v[c];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float* out = parts + ((size_t)blockIdx.x * N + t) * 6;
      out[0] = m;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        float acc = sh_sum[0][c];
#pragma unroll
        for (int i = 1; i < kWarps; ++i) acc += sh_sum[i][c];
        out[1 + c] = acc;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mppi_combine(MppiParams p, const float* __restrict__ u,
             const float* __restrict__ parts, int blocks,
             float* __restrict__ out) {
  __shared__ float sh_min[kWarps];
  __shared__ float sh_sum[kWarps][5];

  const int N = p.steps;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float m = INFINITY;
  for (int b = threadIdx.x; b < blocks; b += kThreads)
    m = fminf(m, parts[((size_t)b * N + t) * 6]);
  m = warp_min(m);
  if (lane == 0) sh_min[warp] = m;
  __syncthreads();
  m = sh_min[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = fminf(m, sh_min[i]);

  float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
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
    for (int i = 1; i < kWarps; ++i) red[c] += sh_sum[i][c];
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

// One fused MPPI solve on `stream`. Pointers are device pointers; `noise`
// may be null (in-kernel Philox); `obstacles` is the packed (O+1, 5) table
// with O = params->n_obs, or null when n_obs is 0. `scratch` holds N·K
// floats, `parts` ceil(K/128)·N·6 floats, `out` N·2 floats (N·6 with
// partial_out). Returns cudaGetLastError() after both launches.
int tpunav_mppi_solve(const MppiParams* params, const float* u,
                      const float* pose, const float* xd, const int* seed,
                      const float* noise, const float* obstacles,
                      float* scratch, float* parts, float* out,
                      void* stream) {
  const MppiParams p = *params;
  const int blocks = (p.rollouts + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      p.n_obs > 0 ? (static_cast<size_t>(kSegFloats) * p.n_obs + 4) *
                        sizeof(float)
                  : 0;
  cudaError_t err = cudaFuncSetAttribute(
      mppi_rollout_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mppi_rollout_partials<<<blocks, kThreads, smem, s>>>(
      p, u, pose, xd, seed, noise, obstacles, scratch, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mppi_combine<<<p.steps, kThreads, 0, s>>>(p, u, parts, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

const char* tpunav_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
