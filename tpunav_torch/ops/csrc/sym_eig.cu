// The batched symmetric eigensolver, hand-written for Hopper (sm_90a).
//
// No Pallas kernel of tpunav computes it: it replaces XLA's
// jnp.linalg.eigh at tpunav/estimation/landmarks.py:130,146 (the circle
// fit's two batched 4x4 calls) and tpunav/estimation/ekf/spd.py:36 (the
// (S, S) SPD repair, S = 3 + 2·capacity). torch.linalg.eigh on the card
// reads its error code on the host, which a CUDA graph capture refuses;
// these kernels read nothing on the host and run their convergence test on
// the device.
//
// Both run the cyclic two-sided Jacobi method in parallel (round-robin)
// order that tpunav_torch/ops/sym_eig.py describes, with its rotations,
// their order and the rounding of every operation: each product, sum and
// quotient is an explicit round-to-nearest intrinsic (no contraction into
// a fused multiply-add), so each kernel gives its plain version's bits but
// for the order of the norms' sums, which decides when a matrix stops.
//
// sym_eig_small<N> — S = N ≤ 8 (the detector's 4x4 batches): A and U = Vᵀ
//   in registers (the rounds' pairs are compile-time constants), no shared
//   memory and no barrier. A matrix has one lane per pair a round rotates
//   (two at S = 4): lane j takes the j-th rotation, the lanes swap them with
//   __shfl_sync, and each applies all of them; each matrix stops on its own
//   test. Bound by the latency of a round's rotation: two divisions and
//   two square roots in a chain (~480 cycles on an H100).
//
// S > 8 (the SPD repair): two launches.
// sym_eig_kernel<layout> — the A phase, one block of 512 threads per
//   matrix. A's upper triangle lies packed (S(S+1)/2 doubles, row by row)
//   in shared memory, or in a device scratch past what shared memory
//   holds. A round's work is the upper triangle's 2x2 blocks
//   at pair indices i ≤ j, P(P+1)/2 items; thread t takes a run of them, the
//   same every round. Each entry is computed once, in the one order the
//   plain version keeps it (rows of its row's pair, then columns of its
//   column's pair). The thread that writes the entry (p', q') of the next
//   round's pair also takes that pair's rotation: a_p'p' and a_q'q' after
//   this round are this round's a_pp − t·a_pq or a_qq + t·a_pq, kept with
//   its rotation; a thread holds these back until its items are done, so a
//   warp's lanes take them together. So a round ends on one barrier. Each
//   round's (c, s) goes to a log in the scratch; U is never needed by A's
//   rounds. At the end, w ranked ascending (ties by index, NaN last), and
//   the rounds run and the ranking for the V phase.
// sym_eig_vectors — the V phase: U built from the log, one block per eight
//   of U's columns (so over many SMs: columns are independent), a thread
//   per pair and column quad, one barrier per round; the log comes into
//   shared memory two rounds ahead (cp.async). Then V's rows, written whole,
//   in the ranked order.
// What bounds it on this card (measured, PERF.md §6): the A phase's
// per-round latency (the rotation chain after an item's entries, ~1,000
// cycles, and each thread's run of items) and, at large S, the
// instructions of its items on one SM; the bound of the function itself
// is 10/3·S³ FP64 operations. No allocation and no synchronisation here:
// the caller allocates the outputs and the scratch, and the entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// Outside the unnamed namespace: the extern "C" entry point takes it.
// Mirrors tpunav_torch/ops/sym_eig.py:_KernelParams (ctypes.Structure).
struct SymEigParams {
  int batch;       // matrices
  int n;           // S
  int layout;      // 0 registers, 1 packed in shared memory, 2 packed in
                   // the scratch (sym_eig.py:LAYOUTS)
  int region;      // bytes of shared memory that hold A
  int max_sweeps;
  double tol2;     // stop when Σ_{p<q} a_pq² <= tol2 · ‖A‖²_F
  double big_theta;
};

namespace {

constexpr int kMaxWarps = 32;
constexpr int kThreads = 512;   // threads per block of the A phase
constexpr int kVectorQuads = 2;  // U's columns per block of the V phase / 4
constexpr int kFound = 4;  // next-round pairs a thread holds back per round

// x·c − y·s (lo) and x·s + y·c (hi), each operation rounded on its own;
// x·c − y·s is x·c + (−s)·y to the bit, so both are one form.
__device__ __forceinline__ double rot(bool hi, double c, double s, double x,
                                      double y) {
  return __dadd_rn(__dmul_rn(hi ? s : c, x), __dmul_rn(hi ? c : -s, y));
}
__device__ __forceinline__ double rot_lo(double c, double s, double x,
                                         double y) {
  return __dsub_rn(__dmul_rn(c, x), __dmul_rn(s, y));
}
__device__ __forceinline__ double rot_hi(double c, double s, double x,
                                         double y) {
  return __dadd_rn(__dmul_rn(s, x), __dmul_rn(c, y));
}

// A pair's rotation (c, s) and its diagonal after the round:
// a_pp − t·a_pq and a_qq + t·a_pq.
struct Rot {
  double c, s, dpp, dqq;
};

// Rutishauser's rotation of (a_pp, a_qq, a_pq); a_pq = 0 rotates nothing.
__device__ __forceinline__ Rot rotation(double app, double aqq, double apq,
                                        double big_theta) {
  double c = 1.0, s = 0.0, t = 0.0;
  if (apq != 0.0) {
    const double theta = __ddiv_rn(__dsub_rn(aqq, app), __dmul_rn(2.0, apq));
    const double mag = fabs(theta);
    if (mag > big_theta) {
      t = __ddiv_rn(0.5, theta);
    } else {
      t = __ddiv_rn(1.0, __dadd_rn(mag, __dsqrt_rn(__dadd_rn(
                                            __dmul_rn(theta, theta), 1.0))));
      if (theta < 0.0) t = -t;
    }
    c = __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(__dmul_rn(t, t), 1.0)));
    s = __dmul_rn(t, c);
  }
  Rot out;
  out.c = c;
  out.s = s;
  out.dpp = __dsub_rn(app, __dmul_rn(t, apq));
  out.dqq = __dadd_rn(aqq, __dmul_rn(t, apq));
  return out;
}

// Pair i of round r among m (even) indices, the circle method: (m-1, r),
// then ((r + i) mod (m-1), (r - i) mod (m-1)); p < q. q == n marks the
// padding index of an odd n. r < m - 1 and i < m / 2, so one correction
// each takes the place of a division.
__host__ __device__ constexpr int wrap(int x, int k) {
  return x < 0 ? x + k : (x >= k ? x - k : x);
}
__host__ __device__ constexpr int pair_lo(int r, int i, int m) {
  return i == 0 ? r : (wrap(r + i, m - 1) < wrap(r - i, m - 1)
                           ? wrap(r + i, m - 1) : wrap(r - i, m - 1));
}
__host__ __device__ constexpr int pair_hi(int r, int i, int m) {
  return i == 0 ? m - 1 : (wrap(r + i, m - 1) < wrap(r - i, m - 1)
                               ? wrap(r - i, m - 1) : wrap(r + i, m - 1));
}
// Index x's partner in round r (m - 1 for the index the circle fixes).
__host__ __device__ constexpr int partner(int x, int r, int m) {
  return x == m - 1 ? r
                    : (wrap(2 * r - x, m - 1) == x ? m - 1
                                                   : wrap(2 * r - x, m - 1));
}
// The pair of round r that holds index x, which is not m - 1 and is not
// fixed by the circle (partner(x, r, m) < m - 1).
__host__ __device__ constexpr int pair_index(int x, int r, int m) {
  return wrap(x - r, m - 1) > m / 2 - 1 ? m - 1 - wrap(x - r, m - 1)
                                        : wrap(x - r, m - 1);
}

// ── S ≤ 8: one thread per matrix, in registers ──

// A symmetric entry from the upper triangle (unrolled: constant indices).
template <int N>
__device__ __forceinline__ double sym(const double (&a)[N][N], int i, int j) {
  return i <= j ? a[i][j] : a[j][i];
}

// Lanes per matrix: one for each pair a round rotates (the pairs without
// the padding index of an odd S), rounded up to a power of two.
__host__ __device__ constexpr int small_lanes(int n) {
  return n <= 3 ? 1 : (n <= 5 ? 2 : 4);
}

// One round on a matrix held whole by each of its L lanes: lane j takes the
// rotation of the round's j-th pair, the lanes swap them (__shfl_sync
// within the matrix's lanes), and each lane updates all of A and U.
template <int N, int L>
__device__ __forceinline__ void small_round(int r, double (&a)[N][N],
                                            double (&u)[N][N],
                                            double big_theta, int lane,
                                            unsigned lanes) {
  constexpr int M = N + (N & 1), P = M / 2, first = N & 1;
  double app = 0.0, aqq = 0.0, apq = 0.0;
#pragma unroll
  for (int i = first; i < P; ++i) {
    if (lane == i - first) {
      const int p = pair_lo(r, i, M), q = pair_hi(r, i, M);
      app = a[p][p];
      aqq = a[q][q];
      apq = a[p][q];
    }
  }
  const Rot mine = rotation(app, aqq, apq, big_theta);
  // Each index's rotation: (c, s) and its new diagonal value.
  double c[N], s[N], d[N];
#pragma unroll
  for (int x = 0; x < N; ++x) {
    if (partner(x, r, M) >= N) {
      c[x] = 1.0;
      s[x] = 0.0;
      d[x] = a[x][x];
    }
  }
#pragma unroll
  for (int i = first; i < P; ++i) {
    const int p = pair_lo(r, i, M), q = pair_hi(r, i, M);
    Rot rt = mine;
    if (L > 1) {
      rt.c = __shfl_sync(lanes, mine.c, i - first, L);
      rt.s = __shfl_sync(lanes, mine.s, i - first, L);
      rt.dpp = __shfl_sync(lanes, mine.dpp, i - first, L);
      rt.dqq = __shfl_sync(lanes, mine.dqq, i - first, L);
    }
    c[p] = c[q] = rt.c;
    s[p] = s[q] = rt.s;
    d[p] = rt.dpp;
    d[q] = rt.dqq;
  }
  // Every entry of the upper triangle once: rows of its row's pair, then
  // columns of its column's pair.
  double b[N][N];
#pragma unroll
  for (int x = 0; x < N; ++x) {
    b[x][x] = d[x];
#pragma unroll
    for (int z = x + 1; z < N; ++z) {
      const int px = partner(x, r, M), pz = partner(z, r, M);
      if (px == z) {
        b[x][z] = 0.0;
        continue;
      }
      const int xl = px < x ? px : x, xh = px < x ? x : px;   // x's pair
      const int zl = pz < z ? pz : z, zh = pz < z ? z : pz;
      double g[2];
      const int cols[2] = {zl, zh};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (cols[k] >= N) {
          g[k] = 0.0;
        } else if (px < N) {
          g[k] = rot(x == xh, c[x], s[x], sym(a, xl, cols[k]),
                     sym(a, xh, cols[k]));
        } else {
          g[k] = sym(a, x, cols[k]);
        }
      }
      b[x][z] = pz < N ? rot(z == zh, c[z], s[z], g[0], g[1])
                       : g[z == zh ? 1 : 0];
    }
  }
#pragma unroll
  for (int x = 0; x < N; ++x) {
#pragma unroll
    for (int z = x; z < N; ++z) a[x][z] = b[x][z];
  }
  // U's row pairs.
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int y = partner(x, r, M);
    if (y < N && x < y) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const double up = u[x][k], uq = u[y][k];
        u[x][k] = rot_lo(c[x], s[x], up, uq);
        u[y][k] = rot_hi(c[x], s[x], up, uq);
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(128)
sym_eig_small(SymEigParams prm, const unsigned char* __restrict__ skip,
              const double* __restrict__ a_in, double* __restrict__ w_out,
              double* __restrict__ v_out) {
  constexpr int M = N + (N & 1), L = small_lanes(N);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = t / L, lane = t % L;
  // A matrix's lanes leave together, so the others' shuffles stay whole.
  if (b >= prm.batch) return;
  const unsigned lanes = L == 1 ? 1u : ((1u << L) - 1)
                                           << ((threadIdx.x & 31) & ~(L - 1));
  const double* src = a_in + static_cast<size_t>(b) * N * N;
  double a[N][N], u[N][N];
  double norm2 = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const double x = src[i >= j ? i * N + j : j * N + i];
      if (i <= j) a[i][j] = x;
      u[i][j] = i == j ? 1.0 : 0.0;
      norm2 = __dadd_rn(norm2, __dmul_rn(x, x));
    }
  }
  const bool skipping = skip != nullptr && *skip != 0;
  for (int sweep = 0; sweep < prm.max_sweeps && !skipping; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = i + 1; j < N; ++j)
        off = __dadd_rn(off, __dmul_rn(a[i][j], a[i][j]));
    }
    if (off <= prm.tol2 * norm2) break;
#pragma unroll
    for (int r = 0; r < M - 1; ++r)
      small_round<N, L>(r, a, u, prm.big_theta, lane, lanes);
  }
  // Rank ascending, ties by index, NaN last; w and V's columns in order,
  // lane j writing the eigenvalues i ≡ j (mod L).
  double* vb = v_out + static_cast<size_t>(b) * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i % L != lane) continue;
    const double ki = isnan(a[i][i]) ? INFINITY : a[i][i];
    int rank = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const double kj = isnan(a[j][j]) ? INFINITY : a[j][j];
      rank += (kj < ki) || (kj == ki && j < i);
    }
    w_out[static_cast<size_t>(b) * N + rank] = a[i][i];
#pragma unroll
    for (int k = 0; k < N; ++k) vb[k * N + rank] = u[i][k];
  }
}

// ── S > 8: one block per matrix ──

enum Layout { kShared = 1, kGlobal = 2 };

// Where A's upper-triangle entry (a, c), a ≤ c, lies: packed row by row.
__device__ __forceinline__ int at(int a, int c, int n) {
  return ((a * (2 * n + 1 - a)) >> 1) - a + c;
}

// Sum over the block; every thread returns the same value (each adds the
// warps' partials in the same order), so a branch on it is uniform.
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) total += red[w];
  return total;
}

// A 16-byte copy from device to shared memory that does not hold the
// thread (cp.async), and the wait for this thread's copies.
__device__ __forceinline__ void copy_async(double2* dst, const double2* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
#endif
}

template <int kLayout>
__global__ void __launch_bounds__(kThreads, 1)
sym_eig_kernel(SymEigParams prm, const unsigned char* __restrict__ skip,
               const double* __restrict__ a_in, double* __restrict__ w_out,
               double2* __restrict__ rot_log, int* __restrict__ meta,
               double* __restrict__ a_scratch) {
  extern __shared__ double smem[];
  const int n = prm.n;
  const int P = (n + (n & 1)) / 2;  // pairs per round
  const int m = 2 * P;
  const int per_sweep = m - 1;      // rounds per sweep
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = nt >> 5;
  const size_t b = blockIdx.x;

  Rot* rots = reinterpret_cast<Rot*>(smem);       // two rounds' rotations
  double* red = smem + 8 * P;                      // kMaxWarps partials
  int2* pairs = reinterpret_cast<int2*>(red + kMaxWarps);  // two rounds' (p, q)
  double* region = red + kMaxWarps + 2 * P;        // A
  double* dg = region + prm.region / 8;            // the eigenvalues
  double* A = kLayout == kGlobal
                  ? a_scratch + b * (static_cast<size_t>(n) * (n + 1) / 2)
                  : region;
  const int max_rounds = prm.max_sweeps * per_sweep;
  double2* lg = rot_log + b * static_cast<size_t>(max_rounds) * P;

  // 0. A's upper triangle from the input's lower one; its squared norm.
  const double* src = a_in + b * n * n;
  double norm2 = 0.0;
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx - i * n;
    const double x = i >= j ? src[i * n + j] : src[j * n + i];
    if (i <= j) A[at(i, j, n)] = x;
    norm2 = __dadd_rn(norm2, __dmul_rn(x, x));
  }
  norm2 = block_sum(norm2, red);
  const bool skipping = skip != nullptr && *skip != 0;

  // Round 0's pairs and rotations.
  if (!skipping) {
    for (int i = tid; i < P; i += nt) {
      const int p = pair_lo(0, i, m), q = pair_hi(0, i, m);
      pairs[i] = make_int2(p, q);
      if (q < n) {
        const Rot rt = rotation(A[at(p, p, n)], A[at(q, q, n)],
                                A[at(p, q, n)], prm.big_theta);
        rots[i] = rt;
        lg[i] = make_double2(rt.c, rt.s);
      }
    }
  }

  // 1. The A phase. Thread t takes a run of consecutive items (i-major:
  // (i, i), (i, i + 1), …, (i, P − 1), (i + 1, i + 1), …), the same run
  // every round, so a pair's data is read once for its row of blocks.
  const int items = P * (P + 1) / 2;
  const int per = (items + nt - 1) / nt;
  const int e0 = min(tid * per, items), e1 = min(e0 + per, items);
  int i0 = 0;                                           // row of item e0
  while (i0 + 1 < P && (i0 + 1) * P - (i0 + 1) * i0 / 2 <= e0) ++i0;
  const int j0 = i0 + e0 - (i0 * P - i0 * (i0 - 1) / 2);
  int sweeps = 0, rho = 0;  // sweeps run; rounds run
  for (; sweeps < prm.max_sweeps && !skipping; ++sweeps) {
    double off = 0.0;
    for (int i = warp; i < n; i += warps) {
      for (int j = i + 1 + lane; j < n; j += 32) {
        const double x = A[at(i, j, n)];
        off = __dadd_rn(off, __dmul_rn(x, x));
      }
    }
    off = block_sum(off, red);
    if (off <= prm.tol2 * norm2) break;

    for (int r = 0; r < per_sweep; ++r, ++rho) {
      const Rot* cur = rots + (rho & 1) * P;
      Rot* nxt = rots + ((rho + 1) & 1) * P;
      const int2* tab = pairs + (rho & 1) * P;
      const int r1 = r + 1 == per_sweep ? 0 : r + 1;  // the next round
      const int sum1 = wrap(2 * r1, per_sweep);
      const bool log_next = rho + 1 < max_rounds;
      // The next round's pairs, from the last threads (past the items).
      for (int i = nt - 1 - tid; i < P; i += nt)
        pairs[((rho + 1) & 1) * P + i] =
            make_int2(pair_lo(r1, i, m), pair_hi(r1, i, m));
      // The next round's pairs this thread's entries hold: their inputs
      // (a_p'p', a_q'q', a_p'q') wait in nxt[k] until the thread's items
      // are done, so the lanes of a warp take their rotations together.
      int found[kFound], nfound = 0;
      // Block (i, j), i < j. kPad: a pair may hold the padding index (pair
      // 0 of an odd S); else both are whole, and their tests fold away.
      auto block = [&](auto pad, int i, int j, int pi, int qi, int pj,
                       int qj) {
        constexpr bool kPad = decltype(pad)::value;
        bool vi = !kPad || qi < n, vj = !kPad || qj < n;
        int ii = i, jj = j;
        if (pj < pi) {  // the pair of the smaller p first
          ii = j;
          jj = i;
          int t = pi;
          pi = pj;
          pj = t;
          t = qi;
          qi = qj;
          qj = t;
          const bool tv = vi;
          vi = vj;
          vj = tv;
        }
        const Rot ri = cur[ii], rj = cur[jj];  // unread for a padding pair
        // The block: rows pi, qi; columns pj, qj; pi < pj < qj.
        const double x00 = A[at(pi, pj, n)];
        const double x01 = vj ? A[at(pi, qj, n)] : 0.0;
        const double x10 =
            vi ? A[at(min(qi, pj), max(qi, pj), n)] : 0.0;
        const double x11 =
            vi && vj ? A[at(min(qi, qj), max(qi, qj), n)] : 0.0;
        // Row pi lies above both columns: rows by pair i, then columns.
        const double r00 = vi ? rot_lo(ri.c, ri.s, x00, x10) : x00;
        const double r01 = vi ? rot_lo(ri.c, ri.s, x01, x11) : x01;
        const double e00 = vj ? rot_lo(rj.c, rj.s, r00, r01) : r00;
        const double e01 = rot_hi(rj.c, rj.s, r00, r01);
        // Row qi: (qi, pj) and (qi, qj) rows first where qi is the smaller
        // index; else kept at (pj, qi) or (qj, qi), rows of pair j first.
        const double r10 = rot_hi(ri.c, ri.s, x00, x10);
        const double r11 = rot_hi(ri.c, ri.s, x01, x11);
        const double w0 = vj ? rot_lo(rj.c, rj.s, x00, x01) : x00;
        const double w1 = vj ? rot_lo(rj.c, rj.s, x10, x11) : x10;
        const double z0 = rot_hi(rj.c, rj.s, x00, x01);
        const double z1 = rot_hi(rj.c, rj.s, x10, x11);
        const bool f10 = qi < pj, f11 = qi < qj;
        const double e10 =
            f10 && !vj ? r10
                       : rot(!f10, f10 ? rj.c : ri.c, f10 ? rj.s : ri.s,
                             f10 ? r10 : w0, f10 ? r11 : w1);
        const double e11 = rot(true, f11 ? rj.c : ri.c, f11 ? rj.s : ri.s,
                               f11 ? r10 : z0, f11 ? r11 : z1);
        A[at(pi, pj, n)] = e00;
        if (vj) A[at(pi, qj, n)] = e01;
        if (vi) A[at(min(qi, pj), max(qi, pj), n)] = e10;
        if (vi && vj) A[at(min(qi, qj), max(qi, qj), n)] = e11;
        // Only these blocks hold an entry of a next round's pair: at pair
        // indices i < j, (0, 1), (0, 2), (i, i + 2) and (i, 2P − 3 − i),
        // whatever the round (the entries' index sums are 2r ± i ± j).
        if (!((i == 0 && j <= 2) || j - i == 2 || i + j == 2 * P - 3))
          return;
        // The new diagonal of each index after this round.
        const double dpi = vi ? ri.dpp : A[at(pi, pi, n)];
        const double dpj = vj ? rj.dpp : A[at(pj, pj, n)];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ra = q < 2 ? pi : qi, ca = (q & 1) ? qj : pj;
          if ((q >= 2 && !vi) || ((q & 1) && !vj)) continue;
          const double val = q == 0 ? e00 : q == 1 ? e01 : q == 2 ? e10 : e11;
          const int lo = min(ra, ca), hi = max(ra, ca);
          // Is (lo, hi) a pair of the next round? Then its rotation's
          // inputs wait in nxt[k]: the two new diagonals, and val.
          int k = -1;
          if (hi == m - 1) {
            if (lo == r1) k = 0;
          } else if (wrap(lo + hi, per_sweep) == sum1) {
            k = pair_index(lo, r1, m);
          }
          if (k < 0) continue;
          const double da = q < 2 ? dpi : ri.dqq;
          const double dc = (q & 1) ? rj.dqq : dpj;
          const double dlo = ra < ca ? da : dc, dhi = ra < ca ? dc : da;
          if (nfound < kFound) {
            nxt[k] = Rot{dlo, dhi, val, 0.0};
            found[nfound++] = k;
          } else {
            nxt[k] = rotation(dlo, dhi, val, prm.big_theta);
            if (log_next)
              lg[static_cast<size_t>(rho + 1) * P + k] =
                  make_double2(nxt[k].c, nxt[k].s);
          }
        }
      };
      int i = i0, j = j0 - 1;
      int2 ti = tab[i];
      for (int e = e0; e < e1; ++e) {
        if (++j == P) {
          ++i;
          j = i;
          ti = tab[i];
        }
        if (i == j) {
          if (ti.y < n) {
            A[at(ti.x, ti.x, n)] = cur[i].dpp;
            A[at(ti.y, ti.y, n)] = cur[i].dqq;
            A[at(ti.x, ti.y, n)] = 0.0;
          }
          continue;
        }
        const int2 tj = tab[j];
        if (i == 0 && (n & 1))
          block(std::true_type{}, i, j, ti.x, ti.y, tj.x, tj.y);
        else
          block(std::false_type{}, i, j, ti.x, ti.y, tj.x, tj.y);
      }
      for (int h = 0; h < nfound; ++h) {
        const int k = found[h];
        const Rot in = nxt[k];
        const Rot rt = rotation(in.c, in.s, in.dpp, prm.big_theta);
        nxt[k] = rt;
        if (log_next)
          lg[static_cast<size_t>(rho + 1) * P + k] = make_double2(rt.c, rt.s);
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // 2. Rank the eigenvalues (A's diagonal); w in that order. The V phase
  // reads the rounds run and the ranking (rank → index) from meta.
  int* mb = meta + b * (n + 1);
  for (int i = tid; i < n; i += nt) dg[i] = A[at(i, i, n)];
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    const double wi = dg[i];
    const double ki = isnan(wi) ? INFINITY : wi;
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const double kj = isnan(dg[j]) ? INFINITY : dg[j];
      rank += (kj < ki) || (kj == ki && j < i);
    }
    w_out[b * n + rank] = wi;
    mb[1 + rank] = i;
  }
  if (tid == 0) mb[0] = sweeps * per_sweep;
}

// 3. The V phase of S > 8: U = Vᵀ built from the rotation log, one block per
// 4·kVectorQuads of U's columns (blocks over all SMs: columns are
// independent). Thread t rotates column quad t mod kVectorQuads of its pairs
// g, g + G, … (g = t / kVectorQuads); one barrier per round. The log comes
// into shared memory two rounds at a time, the next two in flight (cp.async)
// while these are applied. Then V's rows of the block's columns, written
// whole, in the ranked order.
__global__ void __launch_bounds__(1024)
sym_eig_vectors(SymEigParams prm, const double2* __restrict__ rot_log,
                const int* __restrict__ meta, double* __restrict__ v_out) {
  extern __shared__ double smem[];
  constexpr int cs = 4 * kVectorQuads;  // row stride of U's block
  const int n = prm.n;
  const int P = (n + (n & 1)) / 2, m = 2 * P, per_sweep = m - 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int blocks = (n + cs - 1) / cs;
  const size_t b = blockIdx.x / blocks;
  const int k0 = (blockIdx.x - b * blocks) * cs, cw = min(cs, n - k0);
  const int* mb = meta + b * (n + 1);
  const int rounds = mb[0];
  const double2* lg =
      rot_log + b * static_cast<size_t>(prm.max_sweeps) * per_sweep * P;
  double2* stage = reinterpret_cast<double2*>(smem);  // 2 × 2 rounds
  double* U = smem + 8 * P;
  for (int idx = tid; idx < n * cs; idx += nt) {
    const int row = idx / cs, col = idx - row * cs;
    U[idx] = row == k0 + col ? 1.0 : 0.0;
  }
  const int groups = nt / kVectorQuads;
  const int quad = tid % kVectorQuads, g = tid / kVectorQuads;
  for (int idx = tid; idx < min(2, rounds) * P; idx += nt)
    copy_async(stage + idx, lg + idx);
  int r = 0;
  for (int q0 = 0; q0 < rounds; q0 += 2) {
    copy_wait();
    __syncthreads();
    const double2* cs2 = stage + ((q0 >> 1) & 1) * 2 * P;
    if (q0 + 2 < rounds) {
      double2* next = stage + (((q0 >> 1) + 1) & 1) * 2 * P;
      const double2* src = lg + static_cast<size_t>(q0 + 2) * P;
      for (int idx = tid; idx < min(2, rounds - q0 - 2) * P; idx += nt)
        copy_async(next + idx, src + idx);
    }
    for (int q = q0; q < min(q0 + 2, rounds); ++q, cs2 += P) {
      for (int i = g; i < P; i += groups) {
        const int pp = pair_lo(r, i, m), qq = pair_hi(r, i, m);
        if (qq >= n) continue;
        const double2 t = cs2[i];
        double2* up = reinterpret_cast<double2*>(U + pp * cs) + 2 * quad;
        double2* uq = reinterpret_cast<double2*>(U + qq * cs) + 2 * quad;
        const double2 p0 = up[0], p1 = up[1], r0 = uq[0], r1 = uq[1];
        up[0] = make_double2(rot_lo(t.x, t.y, p0.x, r0.x),
                             rot_lo(t.x, t.y, p0.y, r0.y));
        up[1] = make_double2(rot_lo(t.x, t.y, p1.x, r1.x),
                             rot_lo(t.x, t.y, p1.y, r1.y));
        uq[0] = make_double2(rot_hi(t.x, t.y, p0.x, r0.x),
                             rot_hi(t.x, t.y, p0.y, r0.y));
        uq[1] = make_double2(rot_hi(t.x, t.y, p1.x, r1.x),
                             rot_hi(t.x, t.y, p1.y, r1.y));
      }
      r = r + 1 == per_sweep ? 0 : r + 1;
      __syncthreads();
    }
  }
  __syncthreads();  // U = I where no round ran
  // V[k][rank] = U[perm[rank]][k], each row of V's block written whole.
  double* vb = v_out + b * n * n + static_cast<size_t>(k0) * n;
  for (int idx = tid; idx < n * cw; idx += nt) {
    const int k = idx / n, rank = idx - k * n;
    vb[idx] = U[mb[1 + rank] * cs + k];
  }
}

template <int kLayout>
int launch_large(const SymEigParams& p, const unsigned char* skip,
                 const double* a, double* w, double* v, double2* rot_log,
                 int* meta, double* a_scratch, cudaStream_t stream) {
  const int pairs = (p.n + (p.n & 1)) / 2;
  // Keep in step with sym_eig.py:layout and :vector_blocks.
  const size_t bytes = (sizeof(Rot) + sizeof(int2)) * 2 * pairs +
                       sizeof(double) * (kMaxWarps + p.n) + p.region;
  auto kernel = sym_eig_kernel<kLayout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.batch, kThreads, bytes, stream>>>(p, skip, a, w, rot_log, meta,
                                                 a_scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cs = 4 * kVectorQuads;
  const size_t vbytes = sizeof(double2) * 4 * pairs +
                        sizeof(double) * static_cast<size_t>(p.n) * cs;
  err = cudaFuncSetAttribute(sym_eig_vectors,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(vbytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vthreads = min(1024, (pairs * kVectorQuads + 31) / 32 * 32);
  sym_eig_vectors<<<p.batch * ((p.n + cs - 1) / cs), vthreads, vbytes,
                    stream>>>(p, rot_log, meta, v);
  return static_cast<int>(cudaGetLastError());
}

int launch_layout(const SymEigParams& p, const unsigned char* skip,
                  const double* a, double* w, double* v, double2* rot_log,
                  int* meta, double* a_scratch, cudaStream_t stream) {
  switch (p.layout) {
    case kShared:
      return launch_large<kShared>(p, skip, a, w, v, rot_log, meta,
                                   a_scratch, stream);
    case kGlobal:
      return launch_large<kGlobal>(p, skip, a, w, v, rot_log, meta,
                                   a_scratch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int N>
int launch_small(const SymEigParams& p, const unsigned char* skip,
                 const double* a, double* w, double* v,
                 cudaStream_t stream) {
  const int all = p.batch * small_lanes(N);
  const int threads = all < 128 ? (all + 31) / 32 * 32 : 128;
  sym_eig_small<N><<<(all + threads - 1) / threads, threads, 0, stream>>>(
      p, skip, a, w, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The eigendecomposition of params->batch symmetric float64 (n, n)
// matrices at `a` (their lower triangles) on `stream`: w (batch, n)
// ascending and V (batch, n, n). `skip` is a device bool or null. For
// n > 8 (two launches: the A phase, then the V phase), `scratch` holds the
// rotation log (batch · max_sweeps · (m − 1) · m/2 pairs of doubles, m = n
// rounded up to even), then each matrix's rounds run and ranking (batch ·
// (n + 1) ints, padded to whole doubles), then, for layout 3, A's packed
// planes (batch · n(n+1)/2 doubles); for n ≤ 8 it may be null. Returns
// cudaGetLastError() after the last launch.
int tpunav_sym_eig(const SymEigParams* params, const double* a,
                   const unsigned char* skip, double* w, double* v,
                   double* scratch, void* stream) {
  const SymEigParams p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.n) {
    case 1: return launch_small<1>(p, skip, a, w, v, s);
    case 2: return launch_small<2>(p, skip, a, w, v, s);
    case 3: return launch_small<3>(p, skip, a, w, v, s);
    case 4: return launch_small<4>(p, skip, a, w, v, s);
    case 5: return launch_small<5>(p, skip, a, w, v, s);
    case 6: return launch_small<6>(p, skip, a, w, v, s);
    case 7: return launch_small<7>(p, skip, a, w, v, s);
    case 8: return launch_small<8>(p, skip, a, w, v, s);
    default: break;
  }
  const int pairs = (p.n + (p.n & 1)) / 2;
  const size_t log = 2 * static_cast<size_t>(p.batch) * p.max_sweeps *
                     (2 * pairs - 1) * pairs;           // doubles
  double2* rot_log = reinterpret_cast<double2*>(scratch);
  int* meta = reinterpret_cast<int*>(scratch + log);
  double* a_scratch =
      scratch + log + (static_cast<size_t>(p.batch) * (p.n + 1) + 1) / 2;
  return launch_layout(p, skip, a, w, v, rot_log, meta, a_scratch, s);
}

}  // extern "C"
