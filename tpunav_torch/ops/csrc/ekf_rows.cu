// The EKF SLAM filter step, one launch per step for a batch of states,
// hand-written for Hopper (sm_90a).
//
// No Pallas kernel of tpunav computes it: tpunav leaves the EKF to XLA
// (tpunav/estimation/ekf/filter.py, jitted array code, the row chain a
// lax.fori_loop). The port ran the chain as PyTorch operations, ~100 small
// kernels per measurement row, ~3,200 per sensing tick of config 4 (32
// rows over a (20, 103, 103) batch of covariances), each a few µs of
// launch and almost no work (PERF.md §5). This kernel runs one whole
// filter step of a state in one thread block, and a batch of B states as
// B blocks of one launch, with the semantics of
// tpunav_torch/ops/ekf_rows.py:_step_reference:
//
//   the motion update and the sparse uncertainty update G Σ Gᵀ + Q on the
//   covariance the caller repaired; each measurement row's validity and
//   (range, bearing); then every row in order, an invalid one an exact
//   no-op: the symmetrisation ½(σ̄ + σ̄ᵀ); with unknown data association
//   the Mahalanobis gate against every slot (+inf for an inactive slot, a
//   non-finite or clearly negative d²), the nearest slot updated at
//   d* <= dmin, a landmark added at d* >= dmax while capacity is left, the
//   N = 0 sentinel 1e12; with known association slot j = row i, a new
//   landmark where the slot was inactive, no gate; and the Kalman update
//   at the slot in the factored Joseph form (I−KH)σ̄(I−KH)ᵀ + KRKᵀ.
//
// What bounds it on this card. Not bytes (a state's covariance is read
// once and written once: 42.4 KB at S = 103 in float32) nor operations
// (~150k multiply-adds a row): latency. The rows of a state are a serial
// chain, each row a few short parallel phases joined by block barriers.
// The design keeps the chain on one SM with everything on chip: the
// covariance lives in shared memory for the whole step (S·S values; past
// the opt-in limit it stays in the output tensor in device memory, which
// the block updates in place), with the state, the row cache and the rows.
// A row is three barriers:
//   1. the gate: a thread per slot computes its d² from the slot's 5×5
//      block of σ̄ (a warp minimum, ties to the lower slot, into a buffer
//      by row parity); after the barrier every thread combines the warps'
//      minima and takes the same decision, so no thread broadcasts it;
//   2. every thread computes the row's 2×5 block of H, Ψ = Hσ̄Hᵀ + R and
//      its inverse from the 5×5 block of σ̄ at the slot's columns; then a
//      thread per index i caches σ̄'s five rows at H's columns (5 × S),
//      and computes K's row i, I−KH's row i (five values) and the left
//      factor's five columns at H's columns, Lᵢ = (I−KH)ᵢσ̄[:, h], which σ̄'s
//      symmetry lets it take from the cached rows alone;
//   3. one in-place pass over σ̄, a warp per row i and its lanes over j ≥ i,
//      computes each pair (i, j), (j, i) of (I−KH)σ̄(I−KH)ᵀ + KRKᵀ from its
//      own two entries and the cached values, and writes the pair
//      symmetrised where a later row will symmetrise it anyway.
// An ignored row (a gate between dmin and dmax) is one barrier.
//
// Rounding. Every sum, product and quotient is rounded on its own in the
// plain version's order (__fmul_rn, __fadd_rn and their double forms: no
// contracted multiply-add), so the kernel is the plain version's
// arithmetic but for sin, cos, atan2 and hypot, whose last bits the
// library rounds otherwise than the CPU. float32 and float64 are one
// template.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

// Mirrors tpunav_torch/ops/ekf_rows.py:_EkfParams (ctypes.Structure).
struct EkfParams {
  int batch;          // states, one block each
  int n;              // landmark slots; S = 3 + 2n
  int m;              // measurement rows
  int known;          // 1: row i is slot i; 0: the Mahalanobis gate
  int global_layout;  // 1: σ̄ stays in cov_out in device memory
  int f64;            // 1: double, 0: float
  int smem;           // dynamic shared memory bytes (ekf_rows.py:plan)
  double dmin, dmax;  // the update and new-landmark gates
  double q0, q1, q2;  // motion noise, Q's diagonal in the pose
  double r0, r1;      // measurement noise, R's diagonal
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr double kPi = 3.141592653589793;
constexpr double kTwoPi = 2.0 * 3.141592653589793;

// Explicitly rounded arithmetic: no multiply-add is contracted.
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float fsin(float a) { return sinf(a); }
__device__ __forceinline__ double fsin(double a) { return sin(a); }
__device__ __forceinline__ float fcos(float a) { return cosf(a); }
__device__ __forceinline__ double fcos(double a) { return cos(a); }
__device__ __forceinline__ float fatan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double fatan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float fhypot(float x, float y) { return hypotf(x, y); }
__device__ __forceinline__ double fhypot(double x, double y) { return hypot(x, y); }
__device__ __forceinline__ float ffloor(float a) { return floorf(a); }
__device__ __forceinline__ double ffloor(double a) { return floor(a); }
__device__ __forceinline__ float fmag(float a) { return fabsf(a); }
__device__ __forceinline__ double fmag(double a) { return fabs(a); }
// Neither infinite nor NaN: the exponent bits not all set.
__device__ __forceinline__ bool finite(float a) {
  return (__float_as_uint(a) & 0x7f800000u) != 0x7f800000u;
}
__device__ __forceinline__ bool finite(double a) {
  return (static_cast<unsigned long long>(__double_as_longlong(a)) &
          0x7ff0000000000000ull) != 0x7ff0000000000000ull;
}

// core/angles.py:normalize_angle_pi: [-π, π), the reference's formula.
template <typename T>
__device__ __forceinline__ T wrap(T rad) {
  const T pi = static_cast<T>(kPi), two_pi = static_cast<T>(kTwoPi);
  const T shifted = add(rad, pi);
  T r = sub(shifted, mul(ffloor(quo(shifted, two_pi)), two_pi));
  if (r < T(0)) r = add(r, two_pi);
  return sub(r, pi);
}

// ((((t0 + t1) + t2) + t3) + t4) of t_c = a[c]·b[c·stride]: the plain
// version's five-term sums, in its order.
template <typename T>
__device__ __forceinline__ T dot5(const T* a, const T* b, int stride) {
  T acc = mul(a[0], b[0]);
#pragma unroll
  for (int c = 1; c < 5; ++c) acc = add(acc, mul(a[c], b[c * stride]));
  return acc;
}

// H's nonzero (2, 5) block over columns [0, 1, 2, jx, jy] for the slot at
// (d0, d1) from the pose: [[0, -ex, -ey, ex, ey], [-1, fy, -fx, -fy, fx]],
// (ex, ey) = d/√q, (fx, fy) = d/q.
template <typename T>
struct Slot {
  T d0, d1, q, sq;
  T bl[2][5];
};

template <typename T>
__device__ __forceinline__ Slot<T> slot_terms(T lx, T ly, T px, T py) {
  Slot<T> s;
  s.d0 = sub(lx, px);
  s.d1 = sub(ly, py);
  s.q = add(mul(s.d0, s.d0), mul(s.d1, s.d1));
  s.sq = root(s.q);
  const T ex = quo(s.d0, s.sq), ey = quo(s.d1, s.sq);
  const T fx = quo(s.d0, s.q), fy = quo(s.d1, s.q);
  s.bl[0][0] = T(0); s.bl[0][1] = -ex; s.bl[0][2] = -ey;
  s.bl[0][3] = ex;   s.bl[0][4] = ey;
  s.bl[1][0] = T(-1); s.bl[1][1] = fy; s.bl[1][2] = -fx;
  s.bl[1][3] = -fy;   s.bl[1][4] = fx;
  return s;
}

// The 5×5 block of σ̄ at h = [0, 1, 2, jx, jy], and Ψ = B σ̄₅ Bᵀ as
// (B σ̄₅) Bᵀ, each entry a five-term sum (R not added).
template <typename T>
__device__ __forceinline__ void block5(const T* P, int S, int jx, T p5[5][5]) {
  const int h[5] = {0, 1, 2, jx, jx + 1};
#pragma unroll
  for (int c = 0; c < 5; ++c)
#pragma unroll
    for (int e = 0; e < 5; ++e) p5[c][e] = P[h[c] * S + h[e]];
}

template <typename T>
__device__ __forceinline__ void psi_of(const Slot<T>& s, const T p5[5][5],
                                       T psi[2][2]) {
  T t[2][5];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 5; ++e) t[m][e] = dot5(s.bl[m], &p5[0][e], 5);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int k = 0; k < 2; ++k) psi[m][k] = dot5(t[m], s.bl[k], 1);
}

// ẑ's innovation: (r − (√q + v_r), wrap(b_norm − wrap(wrap(atan2 − heading)))).
template <typename T>
__device__ __forceinline__ void innovation(const Slot<T>& s, T r, T b_norm,
                                           T v_r, T heading, T& dz0, T& dz1) {
  const T b_hat = wrap(sub(fatan2(s.d1, s.d0), heading));
  dz0 = sub(r, add(s.sq, v_r));
  dz1 = wrap(sub(b_norm, wrap(b_hat)));
}

// Shared memory, in T units then ints then bytes; keep in step with
// ekf_rows.py:shared_bytes.
template <typename T>
struct Smem {
  T* P;      // S × S covariance (shared layout) — else cov_out's slice
  T* x;      // S state
  T* xn;     // S state after the row's update
  T* pr;     // 5 × S cached rows of σ̄ at H's columns (row 0 and column 0
             // of Σ in the prediction)
  T* k;      // 2 × S gain
  T* ikh;    // 5 × S, I−KH at H's columns
  T* lf;     // 5 × S, the left factor at H's columns
  T* rr;     // M ranges
  T* rb;     // M bearings
  T* rbn;    // M bearings wrapped
  T* v0;     // M range noise
  T* v1;     // M bearing noise
  T* wmin;   // 2 × kWarps warp minima of d² (two buffers by row parity)
  int* widx; // 2 × kWarps their slots
  unsigned char* act;    // n active flags
  unsigned char* valid;  // M row flags
};

template <typename T, bool kGlobal>
__device__ __forceinline__ Smem<T> carve(unsigned char* raw, T* cov_slice,
                                         int S, int M, int n) {
  Smem<T> s;
  T* t = reinterpret_cast<T*>(raw);
  if (kGlobal) {
    s.P = cov_slice;
  } else {
    s.P = t;
    t += static_cast<size_t>(S) * S;
  }
  s.x = t;     t += S;
  s.xn = t;    t += S;
  s.pr = t;    t += 5 * S;
  s.k = t;     t += 2 * S;
  s.ikh = t;   t += 5 * S;
  s.lf = t;    t += 5 * S;
  s.rr = t;    t += M;
  s.rb = t;    t += M;
  s.rbn = t;   t += M;
  s.v0 = t;    t += M;
  s.v1 = t;    t += M;
  s.wmin = t;  t += 2 * kWarps;
  s.widx = reinterpret_cast<int*>(t);
  s.act = reinterpret_cast<unsigned char*>(s.widx + 2 * kWarps);
  s.valid = s.act + n;
  return s;
}

// d² of the row to slot s (ekf_rows.py:_gate_reference).
template <typename T>
__device__ T gate(const Smem<T>& m, int S, int s, T r, T b_norm, T v_r,
                  T heading, T r0, T r1) {
  if (!m.act[s]) return static_cast<T>(INFINITY);
  const int jx = 3 + 2 * s;
  const Slot<T> sl = slot_terms(m.x[jx], m.x[jx + 1], m.x[1], m.x[2]);
  T p5[5][5], psi[2][2];
  block5(m.P, S, jx, p5);
  psi_of(sl, p5, psi);
  const T p00 = add(psi[0][0], r0), p01 = psi[0][1], p11 = add(psi[1][1], r1);
  T dz0, dz1;
  innovation(sl, r, b_norm, v_r, heading, dz0, dz1);
  const T det = sub(mul(p00, p11), mul(p01, p01));
  const T num = add(sub(mul(mul(p11, dz0), dz0),
                        mul(mul(mul(T(2), p01), dz0), dz1)),
                    mul(mul(p00, dz1), dz1));
  const T d2 = quo(num, det);
  if (!finite(d2) || d2 < static_cast<T>(-1e-6))
    return static_cast<T>(INFINITY);
  return d2 < T(0) ? T(0) : d2;
}

__device__ __forceinline__ bool before(double a, int ia, double b, int ib) {
  return a < b || (a == b && ia < ib);
}

template <typename T, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 1)
ekf_step_kernel(EkfParams p, const T* __restrict__ state_in,
                const T* __restrict__ cov_in,
                const unsigned char* __restrict__ active_in,
                const int* __restrict__ count_in,
                const T* __restrict__ meas, const T* __restrict__ u,
                const T* __restrict__ w, const T* __restrict__ v,
                T* state_out, T* cov_out, unsigned char* active_out,
                int* count_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = p.n, S = 3 + 2 * n, M = p.m;
  const size_t SS = static_cast<size_t>(S) * S;
  T* const cov_slice = cov_out + b * SS;
  const Smem<T> m = carve<T, kGlobal>(smem_raw, cov_slice, S, M, n);
  T* const P = m.P;
  const T* const st = state_in + static_cast<size_t>(b) * S;
  const T* const cv = cov_in + b * SS;
  const T r0 = static_cast<T>(p.r0), r1 = static_cast<T>(p.r1);

  // ── Load: the state, row 0 and column 0 of Σ, the rows, the flags. ──
  for (int i = tid; i < S; i += kThreads) {
    if (i >= 3) m.x[i] = st[i];
    m.pr[i] = cv[i];                            // row 0
    m.pr[S + i] = cv[static_cast<size_t>(i) * S];  // column 0
  }
  for (int i = tid; i < n; i += kThreads)
    m.act[i] = active_in[static_cast<size_t>(b) * n + i];
  for (int k = tid; k < M; k += kThreads) {
    const size_t at = (static_cast<size_t>(b) * M + k) * 2;
    const T mx = meas[at], my = meas[at + 1];
    const bool ok = finite(mx) && finite(my);
    const T sx = ok ? mx : T(0), sy = ok ? my : T(0);
    m.valid[k] = ok;
    m.rr[k] = fhypot(sx, sy);
    m.rb[k] = fatan2(sy, sx);
    m.rbn[k] = wrap(m.rb[k]);
    m.v0[k] = v[at];
    m.v1[k] = v[at + 1];
  }
  // The motion update (thread 0) and G's column g = (0, g10, g20, 0, …),
  // from the prior heading (every thread).
  const T om = u[2 * b], vx = u[2 * b + 1], th = st[0];
  const bool small = fmag(om) < static_cast<T>(1e-12);
  const T om_safe = small ? T(1) : om;
  const T kk = quo(vx, om_safe), nv = quo(-vx, om_safe);
  const T g10 = small ? mul(-vx, fsin(th))
                      : add(mul(nv, fcos(th)), mul(kk, fcos(add(th, om))));
  const T g20 = small ? mul(vx, fcos(th))
                      : add(mul(nv, fsin(th)), mul(kk, fsin(add(th, om))));
  if (tid == 0) {
    const T* wb = w + 3 * b;
    const T th_new = wrap(add(add(th, small ? T(0) : om), wb[0]));
    const T s_new = fsin(th_new), c_new = fcos(th_new);
    const T dx = add(mul(nv, s_new), mul(kk, fsin(add(th_new, om))));
    const T dy = sub(mul(kk, c_new), mul(kk, fcos(add(th_new, om))));
    m.x[0] = th_new;
    m.x[1] = add(st[1], add(small ? mul(vx, c_new) : dx, wb[1]));
    m.x[2] = add(st[2], add(small ? mul(vx, s_new) : dy, wb[2]));
  }
  __syncthreads();
  int last_valid = -1;
  for (int k = 0; k < M; ++k)
    if (m.valid[k]) last_valid = k;

  // ── σ̄ = G Σ Gᵀ + Q, symmetrised where a row follows. ──
  {
    const T q[3] = {static_cast<T>(p.q0), static_cast<T>(p.q1),
                    static_cast<T>(p.q2)};
    const T c00 = m.pr[0];
    auto g_of = [&](int i) { return i == 1 ? g10 : i == 2 ? g20 : T(0); };
    auto pred = [&](int i, int j) {
      const T gi = g_of(i);
      const T gs = add(cv[static_cast<size_t>(i) * S + j], mul(gi, m.pr[j]));
      const T gs0 = add(m.pr[S + i], mul(gi, c00));
      const T qd = (i == j && i < 3) ? q[i] : T(0);
      return add(add(gs, mul(gs0, g_of(j))), qd);
    };
    const bool sym = last_valid >= 0;
    for (int i = warp; i < S; i += kWarps)
      for (int j = i + lane; j < S; j += 32) {
        T a = pred(i, j), c = pred(j, i);
        if (sym) a = c = mul(T(0.5), add(a, c));
        P[static_cast<size_t>(i) * S + j] = a;
        P[static_cast<size_t>(j) * S + i] = c;
      }
  }
  __syncthreads();

  // ── The rows. ──
  int count = count_in[b];
  int parity = 0;
  for (int row = 0; row < M; ++row) {
    if (!m.valid[row]) continue;
    const T r = m.rr[row], bear = m.rb[row], b_norm = m.rbn[row];
    const T v_r = m.v0[row];
    const T heading = wrap(add(m.x[0], m.v1[row]));
    int j;
    bool add_lm;
    if (p.known) {
      j = row;
      add_lm = !m.act[j];
    } else {
      double best = INFINITY;
      int bi = INT_MAX;
      for (int s = tid; s < n; s += kThreads) {
        const double d2 = gate(m, S, s, r, b_norm, v_r, heading, r0, r1);
        if (before(d2, s, best, bi)) { best = d2; bi = s; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const double ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (before(ob, oi, best, bi)) { best = ob; bi = oi; }
      }
      if (lane == 0) {
        m.wmin[parity * kWarps + warp] = static_cast<T>(best);
        m.widx[parity * kWarps + warp] = bi;
      }
      __syncthreads();
      T dmin_all = m.wmin[parity * kWarps];
      int jstar = m.widx[parity * kWarps];
      for (int k = 1; k < kWarps; ++k) {
        const T dk = m.wmin[parity * kWarps + k];
        const int ik = m.widx[parity * kWarps + k];
        if (dk < dmin_all || (dk == dmin_all && ik < jstar)) {
          dmin_all = dk;
          jstar = ik;
        }
      }
      parity ^= 1;
      const T dstar = count == 0 ? static_cast<T>(1e12) : dmin_all;
      const bool do_update = dstar <= static_cast<T>(p.dmin);
      const bool do_add = dstar >= static_cast<T>(p.dmax) && count < n;
      j = do_add ? count : jstar;
      const bool active_j = j < n && (m.act[j] || do_add);
      if (!((do_update || do_add) && active_j)) continue;
      add_lm = do_add;
      count += do_add;
    }

    // Every thread: the slot (a new landmark initialised), H's block, Ψ,
    // Ψ⁻¹ and the innovation.
    const int jx = 3 + 2 * j, jy = jx + 1;
    T lx = m.x[jx], ly = m.x[jy];
    if (add_lm) {
      const T a = add(bear, m.x[0]);
      lx = add(m.x[1], mul(r, fcos(a)));
      ly = add(m.x[2], mul(r, fsin(a)));
    }
    const Slot<T> sl = slot_terms(lx, ly, m.x[1], m.x[2]);
    T p5[5][5], psi[2][2];
    block5(P, S, jx, p5);
    psi_of(sl, p5, psi);
    psi[0][0] = add(psi[0][0], r0);
    psi[1][1] = add(psi[1][1], r1);
    const T det = sub(mul(psi[0][0], psi[1][1]), mul(psi[0][1], psi[1][0]));
    const T inv[2][2] = {{quo(psi[1][1], det), quo(-psi[0][1], det)},
                         {quo(-psi[1][0], det), quo(psi[0][0], det)}};
    T dz0, dz1;
    innovation(sl, r, b_norm, v_r, heading, dz0, dz1);

    // A thread per index i: σ̄'s rows at H's columns, K, I−KH, the left
    // factor at H's columns, the new state.
    const int h[5] = {0, 1, 2, jx, jy};
    for (int i = tid; i < S; i += kThreads) {
      T pr[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) pr[c] = P[static_cast<size_t>(h[c]) * S + i];
      const T hc0 = dot5(sl.bl[0], pr, 1), hc1 = dot5(sl.bl[1], pr, 1);
      const T k0 = add(mul(hc0, inv[0][0]), mul(hc1, inv[1][0]));
      const T k1 = add(mul(hc0, inv[0][1]), mul(hc1, inv[1][1]));
      const T xi = i == jx ? lx : i == jy ? ly : m.x[i];
      m.xn[i] = add(xi, add(mul(k0, dz0), mul(k1, dz1)));
      T ikh[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const T e = i == h[c] ? T(1) : T(0);
        ikh[c] = sub(e, add(mul(k0, sl.bl[0][c]), mul(k1, sl.bl[1][c])));
      }
      const T off = (i < 3 || i == jx || i == jy) ? T(0) : T(1);
#pragma unroll
      for (int e = 0; e < 5; ++e) {
        m.pr[e * S + i] = pr[e];
        m.ikh[e * S + i] = ikh[e];
        m.lf[e * S + i] = add(dot5(ikh, &p5[0][e], 5), mul(off, pr[e]));
      }
      m.k[i] = k0;
      m.k[S + i] = k1;
    }
    __syncthreads();
    if (tid == 0) m.act[j] = 1;
    for (int i = tid; i < S; i += kThreads) m.x[i] = m.xn[i];

    // The pass: a warp per row i, its lanes over j >= i.
    const bool sym = row < last_valid;
    for (int i = warp; i < S; i += kWarps) {
      T ikh_i[5], lf_i[5], pr_i[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        ikh_i[c] = m.ikh[c * S + i];
        lf_i[c] = m.lf[c * S + i];
        pr_i[c] = m.pr[c * S + i];
      }
      const T k0i = m.k[i], k1i = m.k[S + i];
      const T k0ir = mul(k0i, r0), k1ir = mul(k1i, r1);
      const T off_i = (i < 3 || i == jx || i == jy) ? T(0) : T(1);
      for (int jj = i + lane; jj < S; jj += 32) {
        T ikh_j[5], lf_j[5], pr_j[5];
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          ikh_j[c] = m.ikh[c * S + jj];
          lf_j[c] = m.lf[c * S + jj];
          pr_j[c] = m.pr[c * S + jj];
        }
        const T k0j = m.k[jj], k1j = m.k[S + jj];
        const T off_j = (jj < 3 || jj == jx || jj == jy) ? T(0) : T(1);
        T* const pij = P + static_cast<size_t>(i) * S + jj;
        T* const pji = P + static_cast<size_t>(jj) * S + i;
        const T left_ij = add(dot5(ikh_i, pr_j, 1), mul(off_i, *pij));
        const T left_ji = add(dot5(ikh_j, pr_i, 1), mul(off_j, *pji));
        const T krk_ij = add(mul(k0ir, k0j), mul(k1ir, k1j));
        const T krk_ji = add(mul(mul(k0j, r0), k0i), mul(mul(k1j, r1), k1i));
        T a = add(add(dot5(lf_i, ikh_j, 1), mul(left_ij, off_j)), krk_ij);
        T c = add(add(dot5(lf_j, ikh_i, 1), mul(left_ji, off_i)), krk_ji);
        if (sym) a = c = mul(T(0.5), add(a, c));
        *pij = a;
        *pji = c;
      }
    }
    __syncthreads();
  }
  __syncthreads();

  // ── Out. ──
  T* const so = state_out + static_cast<size_t>(b) * S;
  for (int i = tid; i < S; i += kThreads) so[i] = m.x[i];
  if (!kGlobal)
    for (size_t e = tid; e < SS; e += kThreads) cov_slice[e] = P[e];
  for (int i = tid; i < n; i += kThreads)
    active_out[static_cast<size_t>(b) * n + i] = m.act[i];
  if (tid == 0) {
    if (p.known) {
      count = 0;
      for (int i = 0; i < n; ++i) count += m.act[i];
    }
    count_out[b] = count;
  }
}

template <typename T, bool kGlobal>
int launch(const EkfParams& p, const void* state, const void* cov,
           const unsigned char* active, const int* count, const void* meas,
           const void* u, const void* w, const void* v, void* state_out,
           void* cov_out, unsigned char* active_out, int* count_out,
           size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      ekf_step_kernel<T, kGlobal>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ekf_step_kernel<T, kGlobal><<<p.batch, kThreads, smem, s>>>(
      p, static_cast<const T*>(state), static_cast<const T*>(cov), active,
      count, static_cast<const T*>(meas), static_cast<const T*>(u),
      static_cast<const T*>(w), static_cast<const T*>(v),
      static_cast<T*>(state_out), static_cast<T*>(cov_out), active_out,
      count_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One filter step for params->batch states on `stream`, one block each.
// state (B, S), cov (B, S, S) (repaired by the caller), meas (B, M, 2),
// u (B, 2), w (B, 3), v (B, M, 2): float (f64 = 0) or double; active
// (B, n) bool, count (B,) int32. The outputs have the inputs' shapes.
// Returns cudaGetLastError() after the launch.
int tpunav_ekf_step(const EkfParams* params, const void* state,
                    const void* cov, const unsigned char* active,
                    const int* count, const void* meas, const void* u,
                    const void* w, const void* v, void* state_out,
                    void* cov_out, unsigned char* active_out, int* count_out,
                    void* stream) {
  const EkfParams p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(p.smem);
  if (p.f64)
    return p.global_layout
               ? launch<double, true>(p, state, cov, active, count, meas, u,
                                      w, v, state_out, cov_out, active_out,
                                      count_out, bytes, s)
               : launch<double, false>(p, state, cov, active, count, meas, u,
                                       w, v, state_out, cov_out, active_out,
                                       count_out, bytes, s);
  return p.global_layout
             ? launch<float, true>(p, state, cov, active, count, meas, u, w,
                                   v, state_out, cov_out, active_out,
                                   count_out, bytes, s)
             : launch<float, false>(p, state, cov, active, count, meas, u, w,
                                    v, state_out, cov_out, active_out,
                                    count_out, bytes, s);
}

}  // extern "C"
