// Kernels K3 and K4: the per-particle occupancy-grid update with its
// distance field, and the distance field alone, hand-written for Hopper
// (sm_90a).
//
// K3 replaces tpunav/ops/pallas_map_update.py:_map_kernel (launched by
// map_update_batch); K4 replaces _edt_kernel (launched by edt_batch). Both
// call one device function, edt_plane, so K4's field on K3's output grids
// is K3's field bit for bit (the contract of
// tests_tpu/test_tpu_gate.py:test_edt_batch_bit_identical_to_fused_kernel).
//
// K3, one block per particle, in four phases separated by barriers:
//   1. the beam table (each beam's range, -1 if invalid) goes into shared
//      memory, and the endpoint count image is zeroed;
//   2. one thread per beam finds its endpoint cell and adds 1 to that
//      cell's count with a shared-memory integer atomicAdd (exact and
//      independent of order; it replaces the TPU kernel's one-hot matmul);
//   3. one thread per cell: bearing by the polynomial atan2 of trig.cuh,
//      covering beam = round_half_up(bearing/δ) mod beams-per-revolution,
//      read straight from the shared table (it replaces the 360-way select
//      unroll); the free test r_cell < r_beam − res outside the 3×3-dilated
//      endpoint mask; the angular-multiplicity mass
//      m = min(res/(max(r,res/2)·δ), B); and the new log-odds
//      g + free·m·d_free + d_occ·count, written straight to device memory.
//      The cell's EDT seed (0 if occupied, else a large value) goes into
//      the shared working plane;
//   4. edt_plane.
// edt_plane, the exact EDT in O(HW) integer operations per particle:
//   - the row pass: one thread per row sweeps it forward and back, leaving
//     g = min(big, |x − nearest occupied x'|) in the working plane (int);
//   - the column envelopes: the lower envelope of the parabolas
//     (y − k)² + g(k)² down each column (Meijster, Roerdink and
//     Hesselink's separable EDT, the integer form of
//     Felzenszwalb–Huttenlocher), on a stack of (k, first row) pairs with
//     Meijster's integer Sep (no float division). Each column's rows are
//     split into two runs with an envelope each, built by one thread per
//     (run, column), which halves the serial chain;
//   - the evaluation: one thread per (column, chunk of rows) finds each
//     run's covering entry at the chunk's first row by a binary search and
//     follows it down, takes the lesser of the runs' values, and writes
//     min(sqrt(d²)·res, max_occ_dist) — or max_occ_dist everywhere for a
//     map with no occupied cell — straight to device memory, coalesced.
// Every value before the sqrt is an exact integer (d² < 2^24), so the field
// is the brute-force minimum's, and esdf's, bit for bit.
//
// Shared memory, per block: the working plane as (H, S) ints with an odd
// row stride S = W | 1, so that thread-per-row accesses hit 32 distinct
// banks; the column stacks as (H, W) ints, one packed int16 pair
// (k, first row) per entry, interleaved by column (stack[j·W + x]) so that
// neighbouring threads touch neighbouring banks; and the runs' stack tops
// (2·W ints). In K3 the stacks reuse the endpoint count image, dead after
// phase 3; K4 allocates one more (H, W) plane. K3 also holds the beam
// table: 53 KB at 80×80, 207 KB at 160×160; two planes fit a block's
// shared memory up to about 168×168 cells. Beyond that (the wrapper
// decides from the card's opt-in limit) the two planes of each block move
// to its slice of a global scratch, and only the stack tops and the beam
// table stay in shared memory: one code path, whose body is inlined once
// with shared and once with global planes, so the compiler keeps
// shared-memory loads where the planes are shared. tpunav's kernels take
// planes up to h·w·4 ≤ 420 KiB (about 320×320); so do these.
//
// What bounds them on this card: bytes. At P=500, 80×80, K3 reads 12.8 MB
// and writes 25.6 MB (≈11.5 µs at 3.35 TB/s) and K4 moves 25.6 MB
// (≈7.6 µs). The design touches device memory once per input and output
// cell and keeps every intermediate in shared memory. A column pass that
// tries all H rows per cell is O(H²W), and a row stride of W = 80 puts a
// warp's rows on two banks (a 16-way conflict); this EDT is linear in the
// cells, its rows sit at an odd stride, its stack's top two
// entries stay in registers (a pop waits on no shared-memory load), and
// four blocks fit an SM at 80×80, so P=500 runs in one wave. What is left
// is K3's per-cell pass (phase 3: per cell three IEEE divisions, a sqrt,
// the atan2 polynomial, two integer divisions and the 3×3 endpoint test),
// which this design leaves as it was, and the
// envelope's serial pushes: tools/map_update_phases.py splits a block's
// clock by phase.
//
// The bearing path rounds exactly as tpunav_torch/ops/map_update.py's plain
// version: every multiply, add and divide is a round-to-nearest intrinsic,
// which nvcc never contracts into a fused multiply-add.

#include <cuda_runtime.h>
#include <math.h>

#include "trig.cuh"

namespace {

constexpr int kThreads = 512;
// Four blocks of an 80×80 map fit an SM's shared memory; asking for them
// caps registers at 32 a thread (a few bytes spill), so that P=500
// particles run in one wave on 132 SMs.
constexpr int kBlocksPerSm = 4;

}  // namespace

// Mirrors tpunav_torch/ops/map_update.py:_MapParams (ctypes.Structure).
// Every float is a double expression of the configuration rounded once on
// the host, as tpunav's trace-time constants are.
struct MapParams {
  int particles;     // P
  int height;        // H
  int width;         // W
  int beams;         // B
  int beams_full;    // beams per revolution
  float xmin;
  float ymin;
  float inv_res;     // 1/res
  float res;
  float x0;          // xmin + res/2
  float y0;          // ymin + res/2
  float beam_min;
  float two_pi;      // 2π
  float inv_two_pi;  // 1/(2π)
  float inv_delta;   // 1/δ
  float delta;       // δ
  float half_res;    // res/2
  float d_free;      // l_free − l_prior
  float d_occ;       // l_occ − l_prior
  float l_occ;
  float big;         // H + W + 2, the EDT's "no occupied cell" distance
  float max_occ;     // max_occ_dist
};

namespace {

// The working plane's odd row stride.
__device__ __forceinline__ int plane_stride(int w) { return w | 1; }

__device__ __forceinline__ int sq(int v) { return v * v; }

// The column envelopes: each column's rows are split into S = kSegments
// runs of L = ceil(H/S) rows (fewer runs when the block has fewer than
// S·W threads), and one thread per (run, column) builds the lower envelope
// of its run's parabolas f_k(y) = (y − k)² + g(k)², k in the run, over all
// rows y of the column: Meijster's stack of (k, first row t) entries with
// his integer Sep. A run's entry j sits at stack[(r0 + j)·W + x], r0 its
// first row, packed (k << 16) | t; its top index goes to tops[run·W + x].
// The top entry and the one below it stay in registers, so a pop waits on
// no load; the entry below that is fetched behind it.
constexpr int kSegments = 2;

__device__ __forceinline__ int runs_of(int w) {
  return max(1, min(kSegments, static_cast<int>(blockDim.x) / w));
}

__device__ __forceinline__ void column_envelopes(int h, int w,
                                                 const int* plane, int* stack,
                                                 int* tops) {
  const int s = plane_stride(w), runs = runs_of(w);
  const int len = (h + runs - 1) / runs;
  for (int i = threadIdx.x; i < runs * w; i += blockDim.x) {
    const int run = i / w, x = i - run * w;
    const int r0 = run * len, r1 = min(h, r0 + len);
    if (r0 >= r1) {
      tops[i] = -1;                               // an empty run
      continue;
    }
    int* st = stack + r0 * w + x;                 // entry j at st[j·W]
    int q = 0, kq = r0, tq = 0, gq = sq(plane[r0 * s + x]);
    int kb = 0, tb = 0, gb = 0;
    st[0] = r0 << 16;
    for (int k = r0 + 1; k < r1; ++k) {
      const int gk = sq(plane[k * s + x]);
      // Pop every parabola that k's lies below at the top's first row.
      while (q >= 0 && sq(tq - kq) + gq > sq(tq - k) + gk) {
        --q;
        kq = kb;
        tq = tb;
        gq = gb;
        if (q >= 1) {
          const int e = st[(q - 1) * w];
          kb = e >> 16;
          tb = e & 0xffff;
          gb = sq(plane[kb * s + x]);
        }
      }
      if (q < 0) {
        q = 0;
        kq = k;
        tq = 0;
        gq = gk;
        st[0] = k << 16;
        continue;
      }
      // Sep(k_q, k): the last row where k_q's parabola is not above k's.
      // The numerator is ≥ 0 here (k_q's lies below k's at t_q ≥ 0), so
      // the integer division is the floor.
      const int t = 1 + static_cast<int>(
                            static_cast<unsigned>(sq(k) - sq(kq) + gk - gq) /
                            static_cast<unsigned>(2 * (k - kq)));
      if (t < h) {
        kb = kq;
        tb = tq;
        gb = gq;
        ++q;
        kq = k;
        tq = t;
        gq = gk;
        st[q * w] = (k << 16) | t;
      }
    }
    tops[i] = q;
  }
}

// The exact EDT of one plane. On entry `plane` ((H, S) ints, S =
// plane_stride(W), shared or the block's global scratch) holds 0 at
// occupied cells and big = H + W + 2 elsewhere, and a barrier has passed;
// `stack` (H·W ints, in the plane's memory) and `tops` (shared,
// kSegments·W ints) are free. Writes the capped distance field to `dout`
// (device memory).
__device__ __forceinline__ void edt_plane(const MapParams& p, int* plane,
                                          int* stack, int* tops, bool any_occ,
                                          float* __restrict__ dout) {
  const int h = p.height, w = p.width, s = plane_stride(w);
  // Row pass: 1D distance along each row, forward then backward.
  for (int y = threadIdx.x; y < h; y += blockDim.x) {
    int* row = plane + y * s;
    int d = row[0];
    for (int x = 1; x < w; ++x) {
      d = min(row[x], d + 1);
      row[x] = d;
    }
    for (int x = w - 2; x >= 0; --x) {
      d = min(row[x], d + 1);
      row[x] = d;
    }
  }
  __syncthreads();
  column_envelopes(h, w, plane, stack, tops);
  __syncthreads();
  // Evaluation: one thread per (column, chunk of rows). At the chunk's
  // first row each run's covering entry is found by a binary search on the
  // first rows (they increase up the stack), then followed down the chunk;
  // a cell takes the least d² = (y − k)² + g(k)² over the runs, exact in
  // float32, and the rows of a warp's columns are written coalesced.
  const int runs = runs_of(w), len = (h + runs - 1) / runs;
  const int chunks = max(1, static_cast<int>(blockDim.x) / w);
  const int rows = (h + chunks - 1) / chunks;
  for (int i = threadIdx.x; i < chunks * w; i += blockDim.x) {
    const int chunk = i / w, x = i - chunk * w;
    const int y0 = chunk * rows, y1 = min(h, y0 + rows);
    int k[kSegments], g2[kSegments], j[kSegments], next_t[kSegments];
#pragma unroll
    for (int r = 0; r < kSegments; ++r) {
      next_t[r] = h;
      k[r] = 0;
      g2[r] = 0;
      j[r] = -1;                                  // no envelope
      if (r >= runs) continue;
      const int top = tops[r * w + x];
      if (top < 0) continue;
      const int* st = stack + r * len * w + x;
      int lo = 0, hi = top;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if ((st[mid * w] & 0xffff) <= y0) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      j[r] = lo;
      k[r] = st[lo * w] >> 16;
      g2[r] = sq(plane[k[r] * s + x]);
      if (lo < top) next_t[r] = st[(lo + 1) * w] & 0xffff;
    }
    for (int y = y0; y < y1; ++y) {
      int d2 = 0x7fffffff;
#pragma unroll
      for (int r = 0; r < kSegments; ++r) {
        if (j[r] < 0) continue;
        if (next_t[r] <= y) {                     // the next entry takes over
          const int* st = stack + r * len * w + x;
          const int top = tops[r * w + x];
          ++j[r];
          const int e = st[j[r] * w];
          k[r] = e >> 16;
          g2[r] = sq(plane[k[r] * s + x]);
          next_t[r] = j[r] < top ? st[(j[r] + 1) * w] & 0xffff : h;
        }
        d2 = min(d2, sq(y - k[r]) + g2[r]);
      }
      dout[y * w + x] =
          any_occ ? fminf(__fmul_rn(__fsqrt_rn(static_cast<float>(d2)), p.res),
                          p.max_occ)
                  : p.max_occ;
    }
  }
}

// K3's block: one particle. `count` ((H, W) endpoint counts, later the
// column stacks) and `plane` ((H, S) EDT working plane) are shared or the
// block's global scratch; `tops` ((kSegments, W) stack tops) and `r_beam`
// ((B,) range or -1) are shared.
__device__ __forceinline__ void update_particle(
    const MapParams& p, const float* __restrict__ grids,
    const float* __restrict__ poses, const float* __restrict__ pose_trig,
    const float* __restrict__ beam_table, float* __restrict__ gout,
    float* __restrict__ dout, int* __restrict__ beam_out, int* count,
    int* plane, int* tops, float* r_beam) {
  const int h = p.height, w = p.width, hw = h * w, s = plane_stride(w);
  const int big = static_cast<int>(p.big);   // H + W + 2
  const int particle = blockIdx.x;
  const size_t base = static_cast<size_t>(particle) * hw;
  const float th = poses[particle * 3 + 0];
  const float px = poses[particle * 3 + 1];
  const float py = poses[particle * 3 + 2];
  const float c0 = pose_trig[particle * 2 + 0];
  const float s0 = pose_trig[particle * 2 + 1];
  const float* r = beam_table;                // (B,) range_min if invalid
  const float* cb = beam_table + p.beams;     // cos(beam)
  const float* sb = beam_table + 2 * p.beams; // sin(beam)
  const float* rm = beam_table + 3 * p.beams; // range, -1 if invalid

  // Phase 1: beam table in, counts zeroed.
  for (int b = threadIdx.x; b < p.beams; b += blockDim.x) r_beam[b] = rm[b];
  for (int c = threadIdx.x; c < hw; c += blockDim.x) count[c] = 0;
  __syncthreads();

  // Phase 2: endpoint counts (valid beams only).
  for (int b = threadIdx.x; b < p.beams; b += blockDim.x) {
    if (rm[b] < 0.0f) continue;
    const float ca = __fsub_rn(__fmul_rn(c0, cb[b]), __fmul_rn(s0, sb[b]));
    const float sa = __fadd_rn(__fmul_rn(s0, cb[b]), __fmul_rn(c0, sb[b]));
    const float ex = __fadd_rn(px, __fmul_rn(r[b], ca));
    const float ey = __fadd_rn(py, __fmul_rn(r[b], sa));
    const int ix = tpunav::cell_index(ex, p.xmin, p.inv_res, w);
    const int iy = tpunav::cell_index(ey, p.ymin, p.inv_res, h);
    atomicAdd(&count[iy * w + ix], 1);
  }
  __syncthreads();

  // Phase 3: the dense per-cell free-space pass and the new log-odds.
  int occ_any = 0;
  for (int c = threadIdx.x; c < hw; c += blockDim.x) {
    const int row = c / w, col = c - (c / w) * w;
    const float dx =
        __fadd_rn(__fsub_rn(p.x0, px), __fmul_rn(p.res, static_cast<float>(col)));
    const float dy =
        __fadd_rn(__fsub_rn(p.y0, py), __fmul_rn(p.res, static_cast<float>(row)));
    const float r_c = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    const float alpha = tpunav::positive_mod(
        __fsub_rn(__fsub_rn(tpunav::atan2_poly(dy, dx), th), p.beam_min),
        p.two_pi, p.inv_two_pi);
    const int b_full =
        static_cast<int>(tpunav::round_half_up(__fmul_rn(alpha, p.inv_delta))) %
        p.beams_full;
    if (beam_out != nullptr) beam_out[base + c] = b_full;
    const bool in_fov = b_full < p.beams;
    const float rb = r_beam[min(b_full, p.beams - 1)];

    bool near_end = false;
    for (int dr = -1; dr <= 1; ++dr) {
      const int rr = row + dr;
      if (rr < 0 || rr >= h) continue;
      for (int dc = -1; dc <= 1; ++dc) {
        const int cc = col + dc;
        if (cc >= 0 && cc < w && count[rr * w + cc] > 0) near_end = true;
      }
    }
    const bool free = in_fov && r_c < __fsub_rn(rb, p.res) && !near_end;
    const float m = fminf(
        __fdiv_rn(p.res, __fmul_rn(fmaxf(r_c, p.half_res), p.delta)),
        static_cast<float>(p.beams));
    const float g = __fadd_rn(
        __fadd_rn(grids[base + c], free ? __fmul_rn(m, p.d_free) : 0.0f),
        __fmul_rn(p.d_occ, static_cast<float>(count[c])));
    gout[base + c] = g;
    const bool occ = g >= p.l_occ;
    plane[row * s + col] = occ ? 0 : big;
    occ_any |= occ;
  }
  const bool any_occ = __syncthreads_or(occ_any) != 0;

  // Phase 4: the distance field of the new grid; the count image is dead.
  edt_plane(p, plane, count, tops, any_occ, dout + base);
}

// With `scratch` null the planes are shared (as map_update.py:_map_layout
// sizes it); otherwise each block's are its (H·W + H·S)-int slice of it.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
map_update_kernel(MapParams p, const float* __restrict__ grids,
                  const float* __restrict__ poses,
                  const float* __restrict__ pose_trig,
                  const float* __restrict__ beam_table,
                  float* __restrict__ gout, float* __restrict__ dout,
                  int* __restrict__ beam_out, int* scratch) {
  extern __shared__ float smem[];
  const int h = p.height, w = p.width, hw = h * w, s = plane_stride(w);
  if (scratch == nullptr) {
    int* count = reinterpret_cast<int*>(smem);
    int* tops = count + hw + h * s;
    update_particle(p, grids, poses, pose_trig, beam_table, gout, dout,
                    beam_out, count, count + hw, tops,
                    reinterpret_cast<float*>(tops + kSegments * w));
  } else {
    int* count = scratch + blockIdx.x * static_cast<size_t>(hw + h * s);
    int* tops = reinterpret_cast<int*>(smem);
    update_particle(p, grids, poses, pose_trig, beam_table, gout, dout,
                    beam_out, count, count + hw, tops,
                    reinterpret_cast<float*>(tops + kSegments * w));
  }
}

// K4's block: `plane` ((H, S)) and `stack` ((H, W)) are shared or the
// block's global scratch; `tops` is shared.
__device__ __forceinline__ void edt_particle(const MapParams& p,
                                             const float* __restrict__ grids,
                                             float* __restrict__ dout,
                                             int* plane, int* stack,
                                             int* tops) {
  const int h = p.height, w = p.width, hw = h * w, s = plane_stride(w);
  const int big = static_cast<int>(p.big);   // H + W + 2
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;
  int occ_any = 0;
  for (int c = threadIdx.x; c < hw; c += blockDim.x) {
    const bool occ = grids[base + c] >= p.l_occ;
    const int row = c / w;
    plane[row * s + (c - row * w)] = occ ? 0 : big;
    occ_any |= occ;
  }
  const bool any_occ = __syncthreads_or(occ_any) != 0;
  edt_plane(p, plane, stack, tops, any_occ, dout + base);
}

// With `scratch` null the planes are shared (map_update.py:_edt_layout);
// otherwise each block's are its (H·S + H·W)-int slice of it.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
edt_kernel(MapParams p, const float* __restrict__ grids,
           float* __restrict__ dout, int* scratch) {
  extern __shared__ int smem_i[];
  const int h = p.height, w = p.width, hw = h * w, s = plane_stride(w);
  if (scratch == nullptr) {
    edt_particle(p, grids, dout, smem_i, smem_i + h * s,
                 smem_i + h * s + hw);
  } else {
    int* plane = scratch + blockIdx.x * static_cast<size_t>(h * s + hw);
    edt_particle(p, grids, dout, plane, plane + h * s, smem_i);
  }
}

}  // namespace

extern "C" {

// K3 on `stream`. grids (P, H, W), poses (P, 3) [θ, x, y], pose_trig
// (P, 2) [cos θ, sin θ] and beam_table (4, B) [r (range_min where
// invalid); cos(beam); sin(beam); range (-1 where invalid)] are device
// float32 arrays; gout and dout (P, H, W). beam_out (P, H, W) int32 may be
// null; if not, it receives each cell's beam index (mod beams per
// revolution). scratch is null, or P·(H·W + H·(W|1)) ints for the planes
// of maps beyond shared memory. Returns cudaGetLastError() after the
// launch.
int tpunav_map_update(const MapParams* params, const float* grids,
                      const float* poses, const float* pose_trig,
                      const float* beam_table, float* gout, float* dout,
                      int* beam_out, int* scratch, void* stream) {
  const MapParams p = *params;
  // Keep in step with map_update.py:_map_layout.
  size_t words = kSegments * p.width + p.beams;
  if (scratch == nullptr)
    words += static_cast<size_t>(p.height) * p.width +
             static_cast<size_t>(p.height) * (p.width | 1);
  const size_t smem = words * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      map_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  map_update_kernel<<<p.particles, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      p, grids, poses, pose_trig, beam_table, gout, dout, beam_out, scratch);
  return static_cast<int>(cudaGetLastError());
}

// K4 on `stream`: dout (P, H, W) = the distance fields of grids (P, H, W).
// scratch as for K3, P·(H·(W|1) + H·W) ints.
int tpunav_edt(const MapParams* params, const float* grids, float* dout,
               int* scratch, void* stream) {
  const MapParams p = *params;
  // Keep in step with map_update.py:_edt_layout.
  size_t words = kSegments * p.width;
  if (scratch == nullptr)
    words += static_cast<size_t>(p.height) * p.width +
             static_cast<size_t>(p.height) * (p.width | 1);
  const size_t smem = words * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      edt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  edt_kernel<<<p.particles, kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(p, grids, dout, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
