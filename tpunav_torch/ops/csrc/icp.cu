// ICP scan matching, one launch per match, hand-written for Hopper (sm_90a).
//
// No Pallas kernel of tpunav computes it: tpunav leaves ICP to XLA
// (tpunav/estimation/rbpf/icp.py, a lax.scan over max_iter Gauss-Newton
// iterations of dense array code). The port ran the same iterations as
// ~100 PyTorch operations each: ~3,000 launches per match, most of a SLAM
// update's device time for a few MFLOP of work (PERF.md §5). This kernel
// runs a whole match — both scans to points, every iteration, the
// convergence test and the angle wrap — in one launch, with the semantics
// of tpunav_torch/ops/icp.py:_icp_reference:
//
//   per iteration, from T: moved = T·src; each valid source point's nearest
//   destination point (masked targets at d² = 1e9, the first minimum);
//   the gate nn_d <= max_corr_dist; the residual gate at
//   max(outlier_thresh, outlier_scale·s[(2·cnt)//5]), s the gated residuals
//   sorted; each inlier's point-to-line row (the line through its match's
//   scan neighbours, else the point-to-point direction); the 3x3 normal
//   equations (+1e-9·I) solved, T ← compose(x, T); rmse, |x|, the inlier
//   fraction and the normal spectrum's least eigenvalue of the last step.
//
// What bounds it on this card. Not bytes (two 360-float scans) nor
// operations (a match at N=360 and 30 iterations is ~30·7·N² ≈ 27 MFLOP:
// 0.4 µs at 67 TFLOP/s): latency. The iterations are dependent, and each
// is a chain of short parallel phases joined by barriers, with a serial
// step (the 3x3 solve and the compose on one thread) at its end; a plain
// design runs ~6 block barriers an iteration, 30 times over. This one
// keeps everything on chip between iterations (the clouds, the rows' terms
// and T in shared memory), spreads the N² search over a thread-block
// cluster of up to 8 blocks (icp.py:plan; each block takes a slice of the
// source rows), and cuts the barriers: each block pushes its rows' terms
// into every block's shared memory (distributed shared memory, two buffers
// by iteration parity), so no block waits on a remote read, and the
// residual gate's quantile is taken only where it can move the gate: an
// iteration is one cluster barrier and two block barriers. Every block
// then sums all rows in the same order and solves the same system, so T
// needs no broadcast. Measured (PERF.md §6): 169 µs a match at N=360 and
// 30 iterations on 8 blocks, ~5.6 µs an iteration.
//
// Phases of an iteration (block b, its source rows [b·rows, b·rows+rows)):
//   1. nearest neighbours: a group of g lanes per source row (g a power of
//      two, as many as the block's 1024 threads allow), lane l scanning the
//      compacted valid targets in pairs l, l+g, … (16-byte loads, no
//      branch); a shuffle min on (d², index), ties to the lower index,
//      keeps torch.argmin's first minimum. The masked targets are one
//      candidate (1e9, the first masked index). The row's lane 0 then
//      computes a gated row's terms (a0, nx, ny, b) and pushes them, with
//      its residual (1e9 where ungated), to every block.
//   2. the normal equations in the order the plain version's cuBLAS calls
//      take on this card (tests/test_torch_icp.py holds the bits): AᵀWA
//      (and the normal matrix, its lower-right block) as fused
//      multiply-add chains over runs of `chunk` rows, the runs' sums added
//      in row order (cuBLAS's split-K GEMM); AᵀWb as 32 chains over rows
//      l, l+32, … and a halving tree (its GEMV); a row off the residual
//      gate enters as a zero term, as aw = a·w does. They are taken with
//      the gate at outlier_thresh while one warp checks that it sits there:
//      the gate is max(outlier_thresh, outlier_scale·s[k]), s the gated
//      residuals sorted, k = (2·cnt)//5, and outlier_scale·v <=
//      outlier_thresh is monotone in v, so it does exactly when more than k
//      gated residuals meet it (the usual case once a match is close). Else
//      the quantile without a sort: s[k] is the largest gated v with
//      #{u < v} <= k, each block's gated rows counting the residuals below
//      them and the cluster taking the largest (one more cluster barrier),
//      and the sums are taken again at that gate.
//   3. warp 0 adds the runs; one thread solves by LU with partial pivoting
//      in cuSOLVER's order (the pivot's reciprocal, fused updates, division
//      in the back substitution), composes, and takes cos and sin of the
//      new heading.
//
// Rounding. Elementwise, the kernel keeps the plain version's expression
// order with explicit round-to-nearest intrinsics (no fused multiply-add
// where torch has none): se2.apply, dx² + dy², the square root, the gates,
// the scan-to-points conversion, the normals and the compose. So where
// icp.py:gemm_chunk knows cuBLAS's run length (the beam counts the port
// runs), T, the inlier fraction and the least normal eigenvalue are the
// plain version's bits, and so every correspondence of every iteration;
// rmse and |x| are reductions of another order (within float32 rounding).
// Those run lengths and the GEMV's order are cuBLAS's heuristics, learned
// with CUDA 12.8's cuBLAS on an H100 (icp.py:MEASURED_ON); another toolkit
// may choose others without notice, and then the kernel is still a correct
// float32 match in its own fixed order, within 1e-5 of the plain version
// but no longer its bits (icp.py:bit_exact says where the bits hold).
//
// Where the clouds lie: the per-point arrays (cloud_bytes) in dynamic
// shared memory when they fit, else in a device scratch that the wrapper
// allocates, with a cluster of one block. No allocation and no
// synchronisation with the host here; the entry point returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

// Outside the unnamed namespace: the extern "C" entry point takes it.
// Mirrors tpunav_torch/ops/icp.py:_IcpParams (ctypes.Structure).
struct IcpParams {
  int n;              // points per cloud (beams)
  int max_iter;       // Gauss-Newton iterations, >= 1
  int from_ranges;    // 1: src/dst are (n,) ranges; 0: (n, 2) points + masks
  int cluster;        // blocks per match, 1..8
  int rows;           // source rows per block, ceil(n / cluster)
  int group;          // lanes per source row in phases 1 and 2
  int global_layout;  // 1: the per-point arrays lie in the scratch
  int chunk;          // rows per run of AᵀWA's chains (phase 3)
  float range_min, range_max, beam_min, beam_delta;
  float max_corr_dist, converged_rmse, outlier_thresh, outlier_scale;
  float transform_eps, min_inlier_frac, min_normal_eig;
};

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxRuns = 64;     // runs of AᵀWA's chains (icp.py:MAX_RUNS)
constexpr int kPairs = 6;        // AᵀWA's upper triangle
constexpr float kBig = 1e9f;     // a masked target's d², an ungated residual
constexpr float kTiny = 1e-9f;

// The per-point arrays; keep in step with icp.py:cloud_bytes. Each block
// holds every row's terms and residual, in two buffers by iteration
// parity: a block may push iteration t+1's rows while a slower one still
// sums iteration t's.
struct Cloud {
  float2* vpts;         // the valid destination points in index order,
                        // then (inf, inf) to an even count
  float* resid0;        // every row's gated residual, kBig where ungated,
  float* resid1;        //   then kBig to a multiple of 4
  float4* terms0;       // every gated row's (a0, nx, ny, b), zeros
  float4* terms1;       //   where ungated
  float2* dst;          // destination points (n)
  float2* src;          // source points (n)
  int* vidx;            // vpts' indices into dst
  unsigned char* dok;   // dst validity (n)
  unsigned char* sok;   // src validity (n)
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ inline size_t cloud_bytes(int n) {
  const size_t b = 8 * static_cast<size_t>(round_up(n, 2)) +
                   8 * static_cast<size_t>(round_up(n, 4)) +
                   54 * static_cast<size_t>(n);
  return (b + 15) / 16 * 16;
}

__device__ __forceinline__ Cloud carve(unsigned char* base, int n) {
  Cloud c;
  c.vpts = reinterpret_cast<float2*>(base);
  c.resid0 = reinterpret_cast<float*>(c.vpts + round_up(n, 2));
  c.resid1 = c.resid0 + round_up(n, 4);
  c.terms0 = reinterpret_cast<float4*>(c.resid1 + round_up(n, 4));
  c.terms1 = c.terms0 + n;
  c.dst = reinterpret_cast<float2*>(c.terms1 + n);
  c.src = c.dst + n;
  c.vidx = reinterpret_cast<int*>(c.src + n);
  c.dok = reinterpret_cast<unsigned char*>(c.vidx + n);
  c.sok = c.dok + n;
  return c;
}

// se2.apply: (x + c·px − s·py, y + s·px + c·py), each operation rounded.
__device__ __forceinline__ void apply(float c, float s, float x, float y,
                                      float2 p, float& mx, float& my) {
  mx = __fsub_rn(__fadd_rn(x, __fmul_rn(c, p.x)), __fmul_rn(s, p.y));
  my = __fadd_rn(__fadd_rn(y, __fmul_rn(s, p.x)), __fmul_rn(c, p.y));
}

__device__ __forceinline__ float sq_sum(float x, float y) {
  return __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
}

// torch.clamp(v, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// scan_to_points for beam j of a scan.
__device__ __forceinline__ void beam_point(const IcpParams& p, float r, int j,
                                           float2& pt, unsigned char& ok) {
  const bool valid = r >= p.range_min && r < p.range_max;
  const float rr = valid ? r : p.range_min;
  const float ang =
      __fadd_rn(p.beam_min, __fmul_rn(p.beam_delta, static_cast<float>(j)));
  pt = make_float2(__fmul_rn(rr, cosf(ang)), __fmul_rn(rr, sinf(ang)));
  ok = valid;
}

// x = A⁻¹b for the 3x3 A as torch.linalg.solve_ex's cuSOLVER getrf and
// getrs run it here: the first largest pivot (LAPACK's isamax), the
// multipliers by the pivot's reciprocal, fused updates, the forward
// substitution fused, the back substitution fused and divided.
__device__ __forceinline__ void solve3(float a[3][3], float b[3], float x[3]) {
  int piv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int p = k;
    float best = fabsf(a[k][k]);
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      if (fabsf(a[i][k]) > best) {
        best = fabsf(a[i][k]);
        p = i;
      }
    }
    piv[k] = p;
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float t = a[k][j];
          a[k][j] = a[i][j];
          a[i][j] = t;
        }
      }
    }
    const float inv = __fdiv_rn(1.0f, a[k][k]);
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      a[i][k] = __fmul_rn(a[i][k], inv);
#pragma unroll
      for (int j = k + 1; j < 3; ++j)
        a[i][j] = __fmaf_rn(-a[i][k], a[k][j], a[i][j]);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      if (i == piv[k]) {
        const float t = b[k];
        b[k] = b[i];
        b[i] = t;
      }
    }
  }
#pragma unroll
  for (int i = 1; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) b[i] = __fmaf_rn(-a[i][j], b[j], b[i]);
  }
#pragma unroll
  for (int i = 2; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int j = 2; j > i; --j) s = __fmaf_rn(-a[i][j], x[j], s);
    x[i] = __fdiv_rn(s, a[i][i]);
  }
}

__device__ __forceinline__ void sync_cluster(int cluster) {
  if (cluster > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

template <typename T>
__device__ __forceinline__ T* at_rank(T* local, int rank, int cluster) {
  return cluster > 1 ? cg::this_cluster().map_shared_rank(local, rank)
                     : local;
}

// One candidate of the nearest-neighbour scan, in index order: the first
// minimum stays (strict <), without a branch.
__device__ __forceinline__ void nn_step(float mx, float my, float tx, float ty,
                                        int idx, float& best, int& at) {
  const float d = sq_sum(__fsub_rn(mx, tx), __fsub_rn(my, ty));
  const bool lt = d < best;
  best = lt ? d : best;
  at = lt ? idx : at;
}

// A row's terms (a0, nx, ny, b) from its match j and moved point (mx, my),
// in the plain version's expression order: the line through j's scan
// neighbours, else the point-to-point direction.
__device__ __forceinline__ float4 row_terms(const Cloud& cl, int n, int j,
                                            float mx, float my) {
  const int prv = max(j - 1, 0), nxt = min(j + 1, n - 1);
  const float2 q = cl.dst[j], qp = cl.dst[prv], qn = cl.dst[nxt];
  const bool both = cl.dok[prv] && cl.dok[nxt];
  const float ux = both ? __fsub_rn(qn.x, qp.x) : 0.0f;
  const float uy = both ? __fsub_rn(qn.y, qp.y) : 0.0f;
  const float tn = __fsqrt_rn(sq_sum(ux, uy));
  const float ex = __fsub_rn(q.x, mx), ey = __fsub_rn(q.y, my);
  float nx, ny;
  if (tn > kTiny) {
    nx = -__fdiv_rn(uy, tn);
    ny = __fdiv_rn(ux, tn);
  } else {
    const float dn = clamp_min(__fsqrt_rn(sq_sum(ex, ey)), kTiny);
    nx = __fdiv_rn(ex, dn);
    ny = __fdiv_rn(ey, dn);
  }
  return make_float4(__fadd_rn(__fmul_rn(nx, -my), __fmul_rn(ny, mx)), nx,
                     ny, __fadd_rn(__fmul_rn(nx, ex), __fmul_rn(ny, ey)));
}

// Component i of a row's terms (a0, nx, ny, b), without a branch.
__device__ __forceinline__ float term(const float4& t, int i) {
  const float lo = i == 0 ? t.x : t.y, hi = i == 2 ? t.z : t.w;
  return i < 2 ? lo : hi;
}

// kGlobal: the per-point arrays lie in the scratch (one block), else in
// dynamic shared memory, where the compiler then addresses them as such.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads, 1)
    icp_kernel(IcpParams p, const float* __restrict__ src_in,
               const unsigned char* __restrict__ sok_in,
               const float* __restrict__ dst_in,
               const unsigned char* __restrict__ dok_in,
               const float* __restrict__ t_init, float* __restrict__ out,
               unsigned char* __restrict__ converged,
               unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float runs[kMaxRuns][kPairs];   // AᵀWA's runs
  __shared__ float rhs[3], wsum_s[2];        // AᵀWb; Σw, Σw·nn_d
  __shared__ float part_cand[kWarps];
  __shared__ float cand[2][kMaxCluster];     // by parity, by source block
  __shared__ float pose[5];   // θ, x, y, cos θ, sin θ of the current T
  __shared__ int warp_count[kWarps];
  __shared__ int first_masked, src_count, quantile_k;

  const int n = p.n, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x;   // the grid is one cluster
  const int row0 = rank * p.rows;
  const int my_rows = max(0, min(p.rows, n - row0));
  const Cloud cl = carve(kGlobal ? scratch : smem, n);

  if (tid == 0) {
    first_masked = n;
    src_count = 0;
    const float th = t_init[0];
    pose[0] = th;
    pose[1] = t_init[1];
    pose[2] = t_init[2];
    pose[3] = cosf(th);
    pose[4] = sinf(th);
  }
  for (int j = n + tid; j < round_up(n, 4); j += kThreads)
    cl.resid0[j] = cl.resid1[j] = kBig;
  __syncthreads();

  // Both clouds into the block: from the ranges, or as given.
  int my_src = 0;
  for (int j = tid; j < n; j += kThreads) {
    float2 d, s;
    unsigned char dv, sv;
    if (p.from_ranges) {
      beam_point(p, dst_in[j], j, d, dv);
      beam_point(p, src_in[j], j, s, sv);
    } else {
      d = reinterpret_cast<const float2*>(dst_in)[j];
      s = reinterpret_cast<const float2*>(src_in)[j];
      dv = dok_in[j] != 0;
      sv = sok_in[j] != 0;
    }
    cl.dst[j] = d;
    cl.dok[j] = dv;
    cl.src[j] = s;
    cl.sok[j] = sv;
    if (!dv) atomicMin(&first_masked, j);
    my_src += sv;
  }
  my_src = warp_sum(my_src);
  if (lane == 0 && my_src) atomicAdd(&src_count, my_src);
  __syncthreads();

  // The valid targets compacted in index order (a block scan per pass).
  int n_valid = 0;
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + tid;
    const bool f = j < n && cl.dok[j];
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_count[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (f) {
      const int at = n_valid + before + __popc(bal & ((1u << lane) - 1u));
      cl.vpts[at] = cl.dst[j];
      cl.vidx[at] = j;
    }
    n_valid += total;
    __syncthreads();
  }
  if (tid == 0 && (n_valid & 1))
    cl.vpts[n_valid] = make_float2(INFINITY, INFINITY);
  // Every block has started before any writes into another's memory.
  sync_cluster(p.cluster);
  const float n_src = clamp_min(static_cast<float>(src_count), kTiny);

  const int g = p.group, gl = tid & (g - 1), gid = tid / g;
  const int groups = kThreads / g;
  const unsigned gmask =
      g == 32 ? 0xffffffffu : ((1u << g) - 1u) << (lane & ~(g - 1));
  const float4* vp4 = reinterpret_cast<const float4*>(cl.vpts);
  const int pairs = (n_valid + 1) >> 1, quads = round_up(n, 4) >> 2;
  const int n_runs = (n + p.chunk - 1) / p.chunk;
  float rmse = 0.0f, frac = 0.0f, delta = 0.0f, eig = 0.0f;

  for (int it = 0; it < p.max_iter; ++it) {
    const int par = it & 1;
    float* const resid = par ? cl.resid1 : cl.resid0;
    float4* const terms = par ? cl.terms1 : cl.terms0;
    const float tx = pose[1], ty = pose[2], c = pose[3], s = pose[4];

    // 1. Nearest neighbours of this block's rows; each row's residual and
    // terms into every block.
    for (int row = gid; row < my_rows; row += groups) {
      const int i = row0 + row;
      float v = kBig;
      float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (cl.sok[i]) {
        float mx, my;
        apply(c, s, tx, ty, cl.src[i], mx, my);
        float best = INFINITY;
        int at = INT_MAX;
        int q = gl;
        for (; q + g < pairs; q += 2 * g) {
          const float4 a = vp4[q], b = vp4[q + g];
          nn_step(mx, my, a.x, a.y, 2 * q, best, at);
          nn_step(mx, my, a.z, a.w, 2 * q + 1, best, at);
          nn_step(mx, my, b.x, b.y, 2 * (q + g), best, at);
          nn_step(mx, my, b.z, b.w, 2 * (q + g) + 1, best, at);
        }
        if (q < pairs) {
          const float4 a = vp4[q];
          nn_step(mx, my, a.x, a.y, 2 * q, best, at);
          nn_step(mx, my, a.z, a.w, 2 * q + 1, best, at);
        }
        for (int o = g >> 1; o > 0; o >>= 1) {
          const float od = __shfl_xor_sync(gmask, best, o);
          const int oa = __shfl_xor_sync(gmask, at, o);
          const bool take = od < best || (od == best && oa < at);
          best = take ? od : best;
          at = take ? oa : at;
        }
        if (gl == 0) {
          int j = at == INT_MAX ? 0 : cl.vidx[at];
          float d = best;
          const int jm = first_masked;
          if (jm < n && (kBig < d || (kBig == d && jm < j))) {
            j = jm;
            d = kBig;
          }
          const float nd = __fsqrt_rn(d);
          if (nd <= p.max_corr_dist) {
            v = nd;
            t = row_terms(cl, n, j, mx, my);
          }
        }
      }
      if (gl == 0) {
        for (int r = 0; r < p.cluster; ++r) {
          at_rank(resid, r, p.cluster)[i] = v;
          at_rank(terms, r, p.cluster)[i] = t;
        }
      }
    }
    sync_cluster(p.cluster);                                   // [1]

    // 2. The normal equations in the plain version's order, with the
    // residual gate at outlier_thresh, while warp 27 counts whether it sits
    // there; taken anew at the quantile's gate where it does not.
    // Thread 6·r + e: AᵀWA's entry e over run r of the rows; warps 31, 30
    // and 29: AᵀWb's three rows, each lane over the rows lane, lane+32, …;
    // warp 28: Σw and Σw·nn_d. A row off the gate enters as cuBLAS takes
    // it, a zero term (aw = a·w), without a branch.
    auto normal_equations = [&](float rej) {
      if (tid < kPairs * n_runs) {
        const int r = tid / kPairs, e = tid - r * kPairs;
        const int l = e < 3 ? 0 : e < 5 ? 1 : 2;      // (0,0) (0,1) (0,2)
        const int m = e < 3 ? e : e < 5 ? e - 2 : 2;  // (1,1) (1,2) (2,2)
        const int j0 = r * p.chunk, j1 = min(n, j0 + p.chunk);
        float acc = 0.0f;
#pragma unroll 4
        for (int j = j0; j < j1; ++j) {
          const float v = resid[j];
          const float4 t = terms[j];
          const bool in = v < kBig && v <= rej;
          acc = __fmaf_rn(in ? term(t, l) : 0.0f, term(t, m), acc);
        }
        runs[r][e] = acc;
      } else if (warp >= kWarps - 3) {
        const int e = kWarps - 1 - warp;
        float acc = 0.0f;
#pragma unroll 4
        for (int j = lane; j < n; j += 32) {
          const float v = resid[j];
          const float4 t = terms[j];
          const bool in = v < kBig && v <= rej;
          acc = __fmaf_rn(in ? term(t, e) : 0.0f, t.w, acc);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o));
        if (lane == 0) rhs[e] = acc;
      } else if (warp == kWarps - 4) {
        float w = 0.0f, wd = 0.0f;
        for (int j = lane; j < n; j += 32) {
          const float v = resid[j];
          if (v < kBig && v <= rej) {
            w = __fadd_rn(w, 1.0f);
            wd = __fadd_rn(wd, v);
          }
        }
        w = warp_sum(w);
        wd = warp_sum(wd);
        if (lane == 0) {
          wsum_s[0] = w;
          wsum_s[1] = wd;
        }
      }
    };
    if (warp == kWarps - 5) {
      // The gate is max(outlier_thresh, outlier_scale·s[k]), s the gated
      // residuals sorted, k = (2·cnt)//5: outlier_thresh exactly when more
      // than k gated residuals meet outlier_scale·v <= outlier_thresh (or
      // none is gated: then no row counts).
      int cnt = 0, small = 0;
      for (int j = lane; j < n; j += 32) {
        const float v = resid[j];
        cnt += v < kBig;
        small += v < kBig && __fmul_rn(p.outlier_scale, v) <= p.outlier_thresh;
      }
      cnt = warp_sum(cnt);
      small = warp_sum(small);
      if (lane == 0) quantile_k = cnt > 0 && small <= (2 * cnt) / 5
                                      ? (2 * cnt) / 5 : -1;
    }
    normal_equations(p.outlier_thresh);
    __syncthreads();
    const int k = quantile_k;
    if (k >= 0) {
      // The sorted element at k is the largest gated v with #{u < v} <= k:
      // each block's gated rows count the residuals below them.
      const float4* va4 = reinterpret_cast<const float4*>(resid);
      float best = -1.0f;
      for (int row = gid; row < my_rows; row += groups) {
        const float v = resid[row0 + row];
        if (!(v < kBig)) continue;
        int below = 0;
#pragma unroll 4
        for (int q = gl; q < quads; q += g) {
          const float4 u = va4[q];
          below += (u.x < v) + (u.y < v) + (u.z < v) + (u.w < v);
        }
        for (int o = g >> 1; o > 0; o >>= 1)
          below += __shfl_xor_sync(gmask, below, o);
        best = below <= k ? fmaxf(best, v) : best;
      }
      best = warp_max(best);
      if (lane == 0) part_cand[warp] = best;
      __syncthreads();
      if (warp == 0) {
        best = warp_max(part_cand[lane]);
        if (lane < p.cluster)
          at_rank(&cand[par][0], lane, p.cluster)[rank] = best;
      }
      sync_cluster(p.cluster);                                 // [2]
      const float med = warp_max(
          (lane & 7) < p.cluster ? cand[par][lane & 7] : -1.0f);
      normal_equations(
          clamp_min(__fmul_rn(p.outlier_scale, med), p.outlier_thresh));
      __syncthreads();
    }

    // 3. Warp 0: lane e adds entry e's runs in row order; lane 0 solves.
    float ata[kPairs];
    if (warp == 0) {
      float acc = 0.0f;
      if (lane < kPairs) {
#pragma unroll 4
        for (int r = 0; r < n_runs; ++r) acc = __fadd_rn(acc, runs[r][lane]);
      }
#pragma unroll
      for (int e = 0; e < kPairs; ++e)
        ata[e] = __shfl_sync(0xffffffffu, acc, e);
    }
    if (tid == 0) {
      float a[3][3] = {{__fadd_rn(ata[0], kTiny), ata[1], ata[2]},
                       {ata[1], __fadd_rn(ata[3], kTiny), ata[4]},
                       {ata[2], ata[4], __fadd_rn(ata[5], kTiny)}};
      float b[3] = {rhs[0], rhs[1], rhs[2]};
      float x[3];
      solve3(a, b, x);
      // T ← compose(x, T).
      const float ca = cosf(x[0]), sa = sinf(x[0]);
      const float th = __fadd_rn(x[0], pose[0]);
      pose[1] = __fsub_rn(__fadd_rn(x[1], __fmul_rn(ca, tx)), __fmul_rn(sa, ty));
      pose[2] = __fadd_rn(__fadd_rn(x[2], __fmul_rn(sa, tx)), __fmul_rn(ca, ty));
      pose[0] = th;
      pose[3] = cosf(th);
      pose[4] = sinf(th);
      const float wsum = clamp_min(wsum_s[0], kTiny);
      rmse = __fdiv_rn(wsum_s[1], wsum);
      frac = __fdiv_rn(wsum_s[0], n_src);
      delta = __fsqrt_rn(__fadd_rn(sq_sum(x[0], x[1]), __fmul_rn(x[2], x[2])));
      // The normal matrix (Σw·n nᵀ) / Σw: AᵀWA's lower-right block.
      const float n00 = __fdiv_rn(ata[3], wsum), n01 = __fdiv_rn(ata[4], wsum);
      const float n11 = __fdiv_rn(ata[5], wsum);
      const float tr = __fadd_rn(n00, n11);
      const float det = __fsub_rn(__fmul_rn(n00, n11), __fmul_rn(n01, n01));
      const float disc = __fsqrt_rn(
          clamp_min(__fsub_rn(__fdiv_rn(__fmul_rn(tr, tr), 4.0f), det), 0.0f));
      eig = __fsub_rn(__fdiv_rn(tr, 2.0f), disc);
    }
    __syncthreads();
  }

  if (rank == 0 && tid == 0) {
    out[0] = atan2f(pose[4], pose[3]);
    out[1] = pose[1];
    out[2] = pose[2];
    out[3] = rmse;
    out[4] = frac;
    out[5] = delta;
    out[6] = eig;
    *converged = rmse <= p.converged_rmse && delta <= p.transform_eps &&
                 frac >= p.min_inlier_frac && eig >= p.min_normal_eig &&
                 src_count > 0;
  }
  // No block leaves while another may still write into its memory.
  if (p.cluster > 1) cg::this_cluster().sync();
}

}  // namespace

extern "C" {

// One ICP match on `stream` (params->cluster blocks, one cluster). From
// ranges (from_ranges = 1): src and dst are (n,) float32 scans and the
// masks are null; else (n, 2) float32 points with (n,) bool masks. t_init
// (3,) float32; out (7,) float32 = [θ (wrapped), x, y, rmse, inlier
// fraction, |last step|, least normal eigenvalue]; converged one bool.
// scratch: cloud_bytes(n) bytes where global_layout is set, else null.
// Returns cudaGetLastError() after the launch.
int tpunav_icp(const IcpParams* params, const float* src,
               const unsigned char* src_ok, const float* dst,
               const unsigned char* dst_ok, const float* t_init, float* out,
               unsigned char* converged, unsigned char* scratch,
               void* stream) {
  const IcpParams p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.global_layout) {
    icp_kernel<true><<<1, kThreads, 0, s>>>(p, src, src_ok, dst, dst_ok,
                                            t_init, out, converged, scratch);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = cloud_bytes(p.n);
  cudaError_t err = cudaFuncSetAttribute(
      icp_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = p.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, icp_kernel<false>, p, src, src_ok, dst,
                           dst_ok, t_init, out, converged, scratch);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
