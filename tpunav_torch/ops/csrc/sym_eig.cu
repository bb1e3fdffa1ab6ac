// The batched symmetric eigensolver, hand-written for Hopper (sm_90a).
//
// No Pallas kernel of tpunav computes it: it replaces XLA's
// jnp.linalg.eigh at tpunav/estimation/landmarks.py:130,146 (the circle
// fit's two batched 4x4 calls) and tpunav/estimation/ekf/spd.py:36 (the
// (S, S) SPD repair). torch.linalg.eigh on the card reads its error code on
// the host, which a CUDA graph capture refuses; this kernel reads nothing
// on the host and runs its convergence test on the device.
//
// sym_eig_kernel — one block per matrix of the batch (32 threads for the
// detector's 4x4 matrices, 128 or 256 for the SPD repair's S = 53 … 203).
// Cyclic two-sided Jacobi in parallel (round-robin) order, as
// tpunav_torch/ops/sym_eig.py describes it:
//   0. A (the input's lower triangle, mirrored) and U = Vᵀ = I; the
//      input's squared Frobenius norm;
//   then, per sweep, until the squared off-diagonal norm is at most
//   tol2 × that norm or max_sweeps have run (no sweep where *skip):
//   1. per round, one thread per pair: its indices and Rutishauser's
//      rotation (c, s, t), kept in shared memory;
//   2. per round, a warp per pair i: every 2x2 block of A at pairs i ≤ j,
//      rows rotated by i's rotation, then columns by j's, and written to
//      both triangles from whichever side holds the upper triangle (the
//      plain version's rows-then-columns order), the diagonal blocks set
//      to a_pp − t·a_pq, a_qq + t·a_pq and 0, its lanes over j; and the
//      pair's rows of U, its lanes over the columns;
//   3. the eigenvalues (A's diagonal) ranked ascending (ties by index,
//      NaN last), V's columns written in that order.
// Every product, sum and quotient of the rotations is an explicit
// round-to-nearest intrinsic (no contraction into a fused multiply-add),
// in the plain version's order, so the two agree but for the order of the
// norm's sums, which decides when a matrix stops.
//
// What bounds it on this card: operations and latency, not bytes. A sweep
// of an S×S matrix does about 3·S³ double operations over S − 1 rounds,
// each round a barrier; the input and outputs are 3·S² doubles. A and V
// stay in shared memory (2·S²·8 bytes: 170 KB at S = 103) where they fit
// the card's opt-in limit, then A alone (V in a device scratch), then
// neither (S = 203), so the kernel takes every S; shared rows have an odd
// stride in doubles, so a column's entries fall in distinct banks. No
// allocation and no synchronisation here: the caller allocates the outputs
// and the scratch, and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Outside the unnamed namespace: the extern "C" entry point takes it.
// Mirrors tpunav_torch/ops/sym_eig.py:_KernelParams (ctypes.Structure).
struct SymEigParams {
  int batch;       // matrices
  int n;           // S
  int ld;          // row stride of the working planes, in doubles
  int threads;     // threads per block
  int a_shared;    // A in shared memory (else in the scratch)
  int v_shared;    // U = Vᵀ in shared memory (else in the scratch)
  int max_sweeps;
  double tol2;     // stop when Σ_{p<q} a_pq² <= tol2 · ‖A‖²_F
  double big_theta;
};

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = 32;

// Pair i of round r among m (even) indices, the circle method: (m-1, r),
// then ((r + i) mod (m-1), (r - i) mod (m-1)); p < q. q == n marks the
// padding index of an odd n.
__device__ __forceinline__ void pair_of(int r, int i, int m, int* p, int* q) {
  int a, b;
  if (i == 0) {
    a = m - 1;
    b = r;
  } else {
    a = (r + i) % (m - 1);
    b = (r - i + (m - 1)) % (m - 1);
  }
  *p = min(a, b);
  *q = max(a, b);
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

// x·c − y·s and x·s + y·c, each operation rounded on its own.
__device__ __forceinline__ double rot_lo(double c, double s, double x,
                                         double y) {
  return __dsub_rn(__dmul_rn(c, x), __dmul_rn(s, y));
}
__device__ __forceinline__ double rot_hi(double c, double s, double x,
                                         double y) {
  return __dadd_rn(__dmul_rn(s, x), __dmul_rn(c, y));
}

// A 2x2 block X (rows of pair i, columns of pair j) with rows rotated by
// (ci, si) where ri, then columns by (cj, sj) where rj.
__device__ __forceinline__ void rotate_block(const double x[2][2], bool ri,
                                             double ci, double si, bool rj,
                                             double cj, double sj,
                                             double y[2][2]) {
  double r[2][2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    r[0][k] = ri ? rot_lo(ci, si, x[0][k], x[1][k]) : x[0][k];
    r[1][k] = ri ? rot_hi(ci, si, x[0][k], x[1][k]) : x[1][k];
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    y[k][0] = rj ? rot_lo(cj, sj, r[k][0], r[k][1]) : r[k][0];
    y[k][1] = rj ? rot_hi(cj, sj, r[k][0], r[k][1]) : r[k][1];
  }
}

__global__ void __launch_bounds__(kMaxThreads)
sym_eig_kernel(SymEigParams prm, const double* __restrict__ a_in,
               const unsigned char* __restrict__ skip,
               double* __restrict__ w_out, double* __restrict__ v_out,
               double* __restrict__ scratch) {
  extern __shared__ double smem[];
  const int n = prm.n, ld = prm.ld;
  const int P = (n + (n & 1)) / 2;  // pairs per round
  const int m = 2 * P;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = nt >> 5;
  const size_t b = blockIdx.x;

  double* rc = smem;         // c, s, t, a_pp, a_qq, a_pq of each pair
  double* rs = rc + P;
  double* rt = rs + P;
  double* rpp = rt + P;
  double* rqq = rpp + P;
  double* rpq = rqq + P;
  double* red = rpq + P;     // kMaxWarps partial sums
  int* rp = reinterpret_cast<int*>(red + kMaxWarps);  // each pair's p, q
  int* rq = rp + P;
  double* planes = reinterpret_cast<double*>(rq + P) + 2;
  const size_t plane = static_cast<size_t>(n) * ld;
  const int global_planes = !prm.a_shared + !prm.v_shared;
  double* gl = scratch ? scratch + b * global_planes * plane : nullptr;
  double* A = prm.a_shared ? planes : gl;
  double* U = prm.v_shared ? planes + plane : gl + (prm.a_shared ? 0 : plane);

  // 0. Load the lower triangle into both triangles; U = I.
  const double* src = a_in + b * n * n;
  double norm2 = 0.0;
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx - (idx / n) * n;
    const double x = i >= j ? src[i * n + j] : src[j * n + i];
    A[i * ld + j] = x;
    U[i * ld + j] = i == j ? 1.0 : 0.0;
    norm2 += x * x;
  }
  norm2 = block_sum(norm2, red);
  const bool skipping = skip != nullptr && *skip != 0;

  for (int sweep = 0; sweep < prm.max_sweeps && !skipping; ++sweep) {
    double off = 0.0;
    for (int i = warp; i < n; i += warps) {
      for (int j = i + 1 + lane; j < n; j += 32)
        off += A[i * ld + j] * A[i * ld + j];
    }
    off = block_sum(off, red);
    if (off <= prm.tol2 * norm2) break;

    for (int r = 0; r < m - 1; ++r) {
      // 1. The round's rotations.
      for (int i = tid; i < P; i += nt) {
        int p, q;
        pair_of(r, i, m, &p, &q);
        double c = 1.0, s = 0.0, t = 0.0, app = 0.0, aqq = 0.0, apq = 0.0;
        if (q < n) {
          app = A[p * ld + p];
          aqq = A[q * ld + q];
          apq = A[p * ld + q];
          if (apq != 0.0) {
            const double theta =
                __ddiv_rn(__dsub_rn(aqq, app), __dmul_rn(2.0, apq));
            const double mag = fabs(theta);
            if (mag > prm.big_theta) {
              t = __ddiv_rn(0.5, theta);
            } else {
              t = __ddiv_rn(1.0, __dadd_rn(mag, __dsqrt_rn(__dadd_rn(
                                                    __dmul_rn(theta, theta),
                                                    1.0))));
              if (theta < 0.0) t = -t;
            }
            c = __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(__dmul_rn(t, t), 1.0)));
            s = __dmul_rn(t, c);
          }
        }
        rp[i] = p;
        rq[i] = q;
        rc[i] = c;
        rs[i] = s;
        rt[i] = t;
        rpp[i] = app;
        rqq[i] = aqq;
        rpq[i] = apq;
      }
      __syncthreads();

      // 2a. A's 2x2 blocks at pairs i <= j: a warp per i, its lanes over j.
      for (int i = warp; i < P; i += warps) {
        const int pi = rp[i], qi = rq[i];
        const bool vi = qi < n;
        for (int j = i + lane; j < P; j += 32) {
          const int pj = rp[j], qj = rq[j];
          const bool vj = qj < n;
          if (i == j) {
            if (!vi) continue;
            A[pi * ld + pi] = __dsub_rn(rpp[i], __dmul_rn(rt[i], rpq[i]));
            A[qi * ld + qi] = __dadd_rn(rqq[i], __dmul_rn(rt[i], rpq[i]));
            A[pi * ld + qi] = 0.0;
            A[qi * ld + pi] = 0.0;
            continue;
          }
          const int ri[2] = {pi, qi}, rj[2] = {pj, qj};
          double x[2][2], xt[2][2], y[2][2], z[2][2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const bool live = (u == 0 || vi) && (v == 0 || vj);
              x[u][v] = live ? A[ri[u] * ld + rj[v]] : 0.0;
              xt[v][u] = x[u][v];
            }
          }
          // y: rows i then columns j; z: rows j then columns i (of Xᵀ).
          rotate_block(x, vi, rc[i], rs[i], vj, rc[j], rs[j], y);
          rotate_block(xt, vj, rc[j], rs[j], vi, rc[i], rs[i], z);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              if ((u == 1 && !vi) || (v == 1 && !vj)) continue;
              const int a = ri[u], c = rj[v];
              const double val = a < c ? y[u][v] : z[v][u];
              A[a * ld + c] = val;
              A[c * ld + a] = val;
            }
          }
        }
      }
      // 2b. U's row pairs (V's column pairs): a warp per pair, its lanes
      // over the columns.
      for (int i = warp; i < P; i += warps) {
        const int p = rp[i], q = rq[i];
        if (q >= n) continue;
        for (int col = lane; col < n; col += 32) {
          const double xp = U[p * ld + col], xq = U[q * ld + col];
          U[p * ld + col] = rot_lo(rc[i], rs[i], xp, xq);
          U[q * ld + col] = rot_hi(rc[i], rs[i], xp, xq);
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // 3. Rank the eigenvalues; write w and V's columns in that order.
  for (int i = tid; i < n; i += nt) {
    const double wi = A[i * ld + i];
    const double ki = isnan(wi) ? INFINITY : wi;
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const double wj = A[j * ld + j];
      const double kj = isnan(wj) ? INFINITY : wj;
      rank += (kj < ki) || (kj == ki && j < i);
    }
    w_out[b * n + rank] = wi;
    double* vb = v_out + b * n * n;
    for (int k = 0; k < n; ++k) vb[k * n + rank] = U[i * ld + k];
  }
}

}  // namespace

extern "C" {

// The eigendecomposition of params->batch symmetric float64 (n, n)
// matrices at `a` (their lower triangles) on `stream`: w (batch, n)
// ascending and V (batch, n, n). `skip` is a device bool or null; `scratch`
// holds the planes that params->a_shared / v_shared leave in device memory
// (batch · planes · n · ld doubles), else it may be null. Returns
// cudaGetLastError() after the launch.
int tpunav_sym_eig(const SymEigParams* params, const double* a,
                   const unsigned char* skip, double* w, double* v,
                   double* scratch, void* stream) {
  const SymEigParams p = *params;
  const int pairs = (p.n + (p.n & 1)) / 2;
  // Keep in step with sym_eig.py:layout.
  size_t bytes = sizeof(double) * (7 * static_cast<size_t>(pairs) +
                                   kMaxWarps) + 16;
  const size_t plane = sizeof(double) * static_cast<size_t>(p.n) * p.ld;
  bytes += (p.a_shared + p.v_shared) * plane;
  cudaError_t err = cudaFuncSetAttribute(
      sym_eig_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  sym_eig_kernel<<<p.batch, p.threads, bytes,
                   static_cast<cudaStream_t>(stream)>>>(p, a, skip, w, v,
                                                        scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
