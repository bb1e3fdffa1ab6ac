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
// edt_plane: each row is swept forward and back (1D distance along the
// row, exact small integers), squared in place, and each cell then takes
// the lower envelope min_k g²[k][x] + (y−k)² down its column and writes
// min(sqrt·res, max_occ_dist) — or max_occ_dist everywhere for a map with
// no occupied cell — straight to device memory.
//
// Shared memory: the count image and the working plane, one (H, W) plane
// each (25.6 KB at 80×80, 102 KB at 160×160), plus the beam table. Two
// planes fit up to about 168×168 cells; the wrapper checks the card's
// opt-in limit. K4 holds the working plane only.
//
// What bounds them on this card: bytes. At P=500, 80×80, K3 reads 12.8 MB
// and writes 25.6 MB (≈11.5 µs at 3.35 TB/s) and K4 moves 25.6 MB
// (≈7.6 µs); an exact EDT needs O(1) operations per cell, far below
// that. The design touches device memory once per input and output cell
// and keeps every intermediate in shared memory, but its column pass
// tries all H rows per cell (O(H²W) per particle, ≈0.5 G min/add over
// the batch), which is what keeps it from the bound; a linear-time
// envelope is later work.
//
// The bearing path rounds exactly as tpunav_torch/ops/map_update.py's plain
// version: every multiply, add and divide is a round-to-nearest intrinsic,
// which nvcc never contracts into a fused multiply-add.

#include <cuda_runtime.h>
#include <math.h>

#include "trig.cuh"

namespace {

constexpr int kThreads = 512;

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

// The exact two-phase EDT of one plane. On entry `plane` (shared, H·W)
// holds 0 at occupied cells and p.big elsewhere, and a barrier has passed.
// Writes the capped distance field to `dout` (device memory).
__device__ void edt_plane(const MapParams& p, float* plane, bool any_occ,
                          float* __restrict__ dout) {
  const int h = p.height, w = p.width;
  // Phase 1: 1D distance along each row, forward then backward.
  for (int y = threadIdx.x; y < h; y += blockDim.x) {
    float* row = plane + y * w;
    for (int x = 1; x < w; ++x) row[x] = fminf(row[x], row[x - 1] + 1.0f);
    for (int x = w - 2; x >= 0; --x) row[x] = fminf(row[x], row[x + 1] + 1.0f);
    for (int x = 0; x < w; ++x) row[x] = row[x] * row[x];
  }
  __syncthreads();
  // Phase 2: the squared-distance lower envelope down each column.
  for (int c = threadIdx.x; c < h * w; c += blockDim.x) {
    const int y = c / w, x = c - (c / w) * w;
    float d2 = plane[c];
    for (int k = 0; k < h; ++k) {
      const float dy = static_cast<float>((y - k) * (y - k));
      d2 = fminf(d2, plane[k * w + x] + dy);
    }
    dout[c] = any_occ ? fminf(__fmul_rn(__fsqrt_rn(d2), p.res), p.max_occ)
                      : p.max_occ;
  }
}

__global__ void __launch_bounds__(kThreads)
map_update_kernel(MapParams p, const float* __restrict__ grids,
                  const float* __restrict__ poses,
                  const float* __restrict__ pose_trig,
                  const float* __restrict__ beam_table,
                  float* __restrict__ gout, float* __restrict__ dout,
                  int* __restrict__ beam_out) {
  extern __shared__ float smem[];
  const int h = p.height, w = p.width, hw = h * w;
  int* count = reinterpret_cast<int*>(smem);  // (H, W) endpoint counts
  float* plane = smem + hw;                   // (H, W) EDT working plane
  float* r_beam = plane + hw;                 // (B,) range or -1

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
    plane[c] = occ ? 0.0f : p.big;
    occ_any |= occ;
  }
  const bool any_occ = __syncthreads_or(occ_any) != 0;

  // Phase 4: the distance field of the new grid.
  edt_plane(p, plane, any_occ, dout + base);
}

__global__ void __launch_bounds__(kThreads)
edt_kernel(MapParams p, const float* __restrict__ grids,
           float* __restrict__ dout) {
  extern __shared__ float plane[];
  const int hw = p.height * p.width;
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;
  int occ_any = 0;
  for (int c = threadIdx.x; c < hw; c += blockDim.x) {
    const bool occ = grids[base + c] >= p.l_occ;
    plane[c] = occ ? 0.0f : p.big;
    occ_any |= occ;
  }
  const bool any_occ = __syncthreads_or(occ_any) != 0;
  edt_plane(p, plane, any_occ, dout + base);
}

}  // namespace

extern "C" {

// K3 on `stream`. grids (P, H, W), poses (P, 3) [θ, x, y], pose_trig
// (P, 2) [cos θ, sin θ] and beam_table (4, B) [r (range_min where
// invalid); cos(beam); sin(beam); range (-1 where invalid)] are device
// float32 arrays; gout and dout (P, H, W). beam_out (P, H, W) int32 may be
// null; if not, it receives each cell's beam index (mod beams per
// revolution). Returns cudaGetLastError() after the launch.
int tpunav_map_update(const MapParams* params, const float* grids,
                      const float* poses, const float* pose_trig,
                      const float* beam_table, float* gout, float* dout,
                      int* beam_out, void* stream) {
  const MapParams p = *params;
  const size_t smem =
      (2 * static_cast<size_t>(p.height) * p.width + p.beams) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      map_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  map_update_kernel<<<p.particles, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      p, grids, poses, pose_trig, beam_table, gout, dout, beam_out);
  return static_cast<int>(cudaGetLastError());
}

// K4 on `stream`: dout (P, H, W) = the distance fields of grids (P, H, W).
int tpunav_edt(const MapParams* params, const float* grids, float* dout,
               void* stream) {
  const MapParams p = *params;
  const size_t smem = static_cast<size_t>(p.height) * p.width * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      edt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  edt_kernel<<<p.particles, kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(p, grids, dout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
