// Kernel K2: the batched likelihood-field sensor model, hand-written for
// Hopper (sm_90a).
//
// Replaces tpunav/ops/pallas_likelihood.py:_lik_kernel (the Pallas TPU
// kernel launched by _lik_pallas). For P particles × k pose samples it
// returns log P(z | m, x) (P, k): per valid beam, the beam endpoint's cell
// in the particle's own distance field gives d, and
//   log(z_hit·N(d; σ²) + z_rand/z_max)
// is summed over beams; a particle whose map has no occupied cell
// (min d ≥ max_occ_dist) scores 0.
//
// Layout: one block per (tile of kSamplesPerBlock samples, particle). The
// block copies the particle's (H, W) field (25.6 KB at 80×80, 102 KB at
// 160×160) and the beam table into shared memory, so every lookup is one
// shared-memory load; the empty-map flag is a block-wide OR of d < max_occ
// taken during the copy. Each warp takes one sample at a time: lane l
// handles beams l, l+32, ..., forms the endpoint from the sample's cos/sin
// and the beam's r·cos, r·sin, scores it in log space and keeps a float32
// partial sum; a shuffle tree gives the sample's total. Any P, k and B:
// nothing is padded.
//
// What bounds it on this card: bytes. At the bench shape (P=500, k=50,
// B=360, 80×80) the fields are 12.8 MB (≈4 µs at 3.35 TB/s); the 9 M
// lookups cost one expf and one logf each (≈18 M special-function
// operations, a few µs across the SFUs). The design reads each field from
// device memory once per sample tile and keeps it in shared memory for
// the tile's k·B lookups. Not carried over from the TPU kernel: the
// one-hot MXU gather, the hi/lo bf16 field split and the bf16x3 segment
// matmul, which existed only because the TPU has no dynamic gather.
//
// The endpoint and mixture use explicit round-to-nearest intrinsics in the
// order of tpunav_torch/ops/likelihood.py:_lik_reference, so a cell index
// can differ from the plain version only where cosf/sinf do.

#include <cuda_runtime.h>
#include <math.h>

#include "trig.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSamplesPerBlock = 32;

}  // namespace

// Mirrors tpunav_torch/ops/likelihood.py:_LikParams (ctypes.Structure).
// Products of configuration constants are formed on the host in double.
struct LikParams {
  int particles;      // P
  int samples;        // k
  int height;         // H
  int width;          // W
  int beams;          // B
  float xmin;
  float ymin;
  float inv_res;      // 1/resolution
  float neg_half_inv_var;  // -0.5/σ_hit²
  float zh_norm;      // z_hit / sqrt(2π σ_hit²)
  float floor_p;      // z_rand / z_max
  float max_occ;      // max_occ_dist
};

namespace {

__global__ void __launch_bounds__(kThreads)
likelihood_field_kernel(LikParams p, const float* __restrict__ dists,
                        const float* __restrict__ samples,
                        const float* __restrict__ beam_table,
                        float* __restrict__ out) {
  extern __shared__ float smem[];
  const int hw = p.height * p.width;
  float* field = smem;                 // (H, W)
  float* rm = smem + hw;               // range, -1 if invalid, (B,)
  float* rcb = rm + p.beams;           // r·cos(beam), (B,)
  float* rsb = rcb + p.beams;          // r·sin(beam), (B,)

  const int particle = blockIdx.y;
  const float* src = dists + static_cast<size_t>(particle) * hw;
  int occ = 0;
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    const float d = src[i];
    field[i] = d;
    occ |= d < p.max_occ;
  }
  for (int i = threadIdx.x; i < 3 * p.beams; i += kThreads)
    rm[i] = beam_table[i];
  const bool any_occ = __syncthreads_or(occ) != 0;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kSamplesPerBlock;
  const int last = min(first + kSamplesPerBlock, p.samples);
  for (int s = first + warp; s < last; s += kWarps) {
    const size_t row = static_cast<size_t>(particle) * p.samples + s;
    const float* q = samples + row * 3;
    const float th = q[0], sx = q[1], sy = q[2];
    const float c0 = cosf(th);
    const float s0 = sinf(th);
    float acc = 0.0f;
    for (int b = lane; b < p.beams; b += 32) {
      if (rm[b] < 0.0f) continue;
      const float ex =
          __fsub_rn(__fadd_rn(sx, __fmul_rn(c0, rcb[b])), __fmul_rn(s0, rsb[b]));
      const float ey =
          __fadd_rn(__fadd_rn(sy, __fmul_rn(s0, rcb[b])), __fmul_rn(c0, rsb[b]));
      const int ix = tpunav::cell_index(ex, p.xmin, p.inv_res, p.width);
      const int iy = tpunav::cell_index(ey, p.ymin, p.inv_res, p.height);
      const float d = field[iy * p.width + ix];
      const float e = expf(__fmul_rn(__fmul_rn(p.neg_half_inv_var, d), d));
      acc += logf(__fadd_rn(__fmul_rn(p.zh_norm, e), p.floor_p));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[row] = any_occ ? acc : 0.0f;
  }
}

}  // namespace

extern "C" {

// K2 on `stream`. dists (P, H, W), samples (P, k, 3) and beam_table
// (3, B) = [range (-1 where invalid); r·cos(beam); r·sin(beam)], with r
// range_min where invalid, are device float32 arrays; out (P, k).
// Returns cudaGetLastError() after the launch.
int tpunav_likelihood_field(const LikParams* params, const float* dists,
                            const float* samples, const float* beam_table,
                            float* out, void* stream) {
  const LikParams p = *params;
  const size_t smem =
      (static_cast<size_t>(p.height) * p.width + 3 * p.beams) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      likelihood_field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.samples + kSamplesPerBlock - 1) / kSamplesPerBlock,
                  p.particles);
  likelihood_field_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      p, dists, samples, beam_table, out);
  return static_cast<int>(cudaGetLastError());
}

// The largest dynamic shared memory one block may opt in to on the
// current device, in bytes (0 if the query fails).
int tpunav_max_dynamic_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

}  // extern "C"
