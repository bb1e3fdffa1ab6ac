// Kernel K2: the batched likelihood-field sensor model, hand-written for
// Hopper (sm_90a).
//
// Replaces tpunav/ops/pallas_likelihood.py:_lik_kernel (the Pallas TPU
// kernel launched by _lik_pallas). For P particles × k pose samples it
// returns log P(z | m, x) (P, k): per valid beam, the beam endpoint's cell
// in the particle's own distance field gives d, and
//   lp(d) = log(z_hit·N(d; σ²) + z_rand/z_max)
// is summed over beams; a particle whose map has no occupied cell
// (min d ≥ max_occ_dist) scores 0.
//
// What bounds it on this card. The bytes (at the course's shape, P=500,
// k+1=51 samples, B=360 beams, 80×80: 12.8 MB of fields, 3.8 µs at
// 3.35 TB/s) bound the function; this design is bound by issue: per
// particle 6,400 mixtures of ~54 instructions (expf and logf are
// libdevice's, to keep the per-lookup design's bits) and 18,360 lookups
// of ~24
// (the endpoint, its cell, one load, one add), ≈ 12 µs of issue over
// 132 SMs at the card's clock, beside the field's load.
//
// The design. lp depends only on d, a property of the cell, so each
// particle's field is turned into a table of lp once and every lookup is
// then one load and one add; the design this replaces evaluated the
// mixture on each of the 18,360 lookups of a particle. Two paths share every device
// function below:
//   - fused (one launch), where a block's shared memory holds the table and
//     there are at least as many particles as SMs: one 512-thread block per
//     particle with all k samples, so each field is read from device memory
//     once (coalesced loads) and 500 blocks fit one wave
//     (four blocks an SM). The table sits at the odd row stride W | 1, so
//     the lanes of a warp, whose endpoints run down a wall, hit distinct
//     banks. The block then stages each sample's cos θ, sin θ, x, y once
//     and compacts the valid beams;
//   - two-pass (two launches) for fields beyond shared memory (320×320 is
//     400 KB) or fewer particles than SMs: a table launch writes lp
//     (P, H, W) and per-chunk occupancy flags to a global scratch, then a
//     lookup launch, a block per (8 samples, particle), reads the table
//     through the read-only cache.
// Each sample is scored by a warp in both: lane l sums the compacted beams
// l, l+32, … in order (a loop that every lane runs alike, then the last
// partial pass) and a xor tree adds the 32 partial sums: the order of the
// per-lookup design exactly, so where every beam is valid both paths give
// its bits (the table holds the very expression it evaluated per lookup). A lookup's
// cell comes from cell_bits (no conversion instruction), and its address
// with the bias of cell_bits folded into the table's base.
// Tried and dropped, measured slower at the course's shape (H100, one
// call): the field brought in by one or four bulk asynchronous copies
// (cp.async.bulk with mbarriers) into a staging region, or by 4-byte
// cp.async groups into the table, each turned into lp as it landed.
// Not carried over from the TPU kernel: the one-hot MXU gather, the hi/lo
// bf16 field split and the bf16x3 segment matmul, which existed only
// because the TPU has no dynamic gather.
//
// The endpoint and mixture use explicit round-to-nearest intrinsics in the
// order of tpunav_torch/ops/likelihood.py:_lik_reference, so a cell index
// can differ from the plain version only where cosf/sinf do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "trig.cuh"

namespace {

constexpr int kThreads = 512;        // fused: one block per particle
constexpr int kBlocksPerSm = 4;      // 500 particles in one wave on 132 SMs
constexpr int kLookupWarps = 8;      // two-pass: a warp per sample
constexpr int kTableThreads = 256;
constexpr int kTableCells = 2048;    // two-pass: cells per table block

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

// lp(d), the per-lookup expression of the design this replaces.
__device__ __forceinline__ float mixture(const LikParams& p, float d) {
  const float e = expf(__fmul_rn(__fmul_rn(p.neg_half_inv_var, d), d));
  return logf(__fadd_rn(__fmul_rn(p.zh_norm, e), p.floor_p));
}

// The valid beams of the (3, B) table [range (-1 if invalid); r·cos; r·sin],
// in order, as (r·cos, r·sin) pairs in `beams`; `counts` holds ceil(B/32)
// ints. Every thread of the block calls it and gets the number of valid
// beams; it ends with a barrier.
__device__ int compact_beams(const float* __restrict__ table, int nb,
                             float2* beams, int* counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, chunks = (nb + 31) / 32;
  for (int c = warp; c < chunks; c += warps) {
    const int b = c * 32 + lane;
    const unsigned m = __ballot_sync(0xffffffffu, b < nb && table[b] >= 0.0f);
    if (lane == 0) counts[c] = __popc(m);
  }
  __syncthreads();
  for (int c = warp; c < chunks; c += warps) {
    int at = 0;
    for (int i = 0; i < c; ++i) at += counts[i];
    const int b = c * 32 + lane;
    const bool valid = b < nb && table[b] >= 0.0f;
    const unsigned m = __ballot_sync(0xffffffffu, valid);
    if (valid)
      beams[at + __popc(m & ((1u << lane) - 1u))] =
          make_float2(table[nb + b], table[2 * nb + b]);
  }
  int total = 0;
  for (int i = 0; i < chunks; ++i) total += counts[i];
  __syncthreads();
  return total;
}

// (cos θ, sin θ, x, y) of `count` samples, rows [θ, x, y] at `q`.
__device__ __forceinline__ void stage_samples(const float* __restrict__ q,
                                              int count, float4* trig) {
  for (int s = threadIdx.x; s < count; s += blockDim.x) {
    const float th = q[3 * s];
    trig[s] = make_float4(cosf(th), sinf(th), q[3 * s + 1], q[3 * s + 2]);
  }
}

// The lp table in shared memory, H rows of `stride` floats, read at the
// cell whose cell_bits are (ry, rx), with the bias folded into `base` =
// the table's shared address − 4·kCellBias·(stride + 1) (mod 2^32).
struct SharedTable {
  uint32_t base;
  unsigned stride;
  __device__ __forceinline__ float operator()(unsigned ry, unsigned rx) const {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];"
                 : "=f"(v)
                 : "r"(base + 4u * (ry * stride + rx)));
    return v;
  }
};

// The two-pass path's lp table (H, W) in device memory, read through the
// read-only cache.
struct GlobalTable {
  const float* __restrict__ lut;
  unsigned stride;
  __device__ __forceinline__ float operator()(unsigned ry, unsigned rx) const {
    return __ldg(lut + (ry * stride + rx - tpunav::kCellBias * (stride + 1)));
  }
};

// lp at the endpoint of beam t = (r·cos, r·sin) from sample q = (cos θ,
// sin θ, x, y), in the order of the plain version.
template <typename Table>
__device__ __forceinline__ float lookup(const LikParams& p, const Table& lut,
                                        float4 q, float2 t) {
  const float ex =
      __fsub_rn(__fadd_rn(q.z, __fmul_rn(q.x, t.x)), __fmul_rn(q.y, t.y));
  const float ey =
      __fadd_rn(__fadd_rn(q.w, __fmul_rn(q.y, t.x)), __fmul_rn(q.x, t.y));
  return lut(tpunav::cell_bits(ey, p.ymin, p.inv_res, p.height),
             tpunav::cell_bits(ex, p.xmin, p.inv_res, p.width));
}

// out[s] for each of `count` staged samples, a warp per sample; a barrier
// must have passed since the table, the beams and the samples were
// written. Lane l adds the lp of beams l, l+32, … in order: first the
// passes in which every lane has a beam, as one loop that every lane runs
// alike, then the last partial pass on the lanes that have one. A xor tree
// adds the 32 partial sums.
template <typename Table>
__device__ __forceinline__ void score_samples(const LikParams& p,
                                              const Table& lut,
                                              const float2* beams, int nvalid,
                                              const float4* trig, int count,
                                              float* __restrict__ out) {
  const int lane = threadIdx.x & 31, full = nvalid >> 5;
  const bool extra = lane < (nvalid & 31);
  const float2* mine = beams + lane;
  for (int s = threadIdx.x >> 5; s < count; s += blockDim.x >> 5) {
    const float4 q = trig[s];         // cos θ, sin θ, x, y
    float acc = 0.0f;
#pragma unroll 4
    for (int j = 0; j < full; ++j)
      acc = __fadd_rn(acc, lookup(p, lut, q, mine[32 * j]));
    if (extra) acc = __fadd_rn(acc, lookup(p, lut, q, mine[32 * full]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    if (lane == 0) out[s] = acc;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// The next (row, column) of a thread that steps kThreads cells at a time:
// dr = kThreads / W, dc = kThreads mod W.
__device__ __forceinline__ void step_cell(int& row, int& col, int dr, int dc,
                                          int w) {
  row += dr;
  col += dc;
  if (col >= w) {
    col -= w;
    ++row;
  }
}

// The fused path's lp table: H rows at the odd stride W | 1, so that the
// 32 lanes' endpoints along a wall of the map, in consecutive rows of one
// column, fall on 32 distinct banks (at stride 80 they would share two);
// rounded up to 16 bytes.
__host__ __device__ __forceinline__ int table_floats(int h, int w) {
  return (h * (w | 1) + 3) / 4 * 4;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
likelihood_field_kernel(LikParams p, const float* __restrict__ dists,
                        const float* __restrict__ samples,
                        const float* __restrict__ beam_table,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int h = p.height, w = p.width, hw = h * w, stride = w | 1;
  const int particle = blockIdx.x;
  float* lut = smem;
  float4* trig = reinterpret_cast<float4*>(smem + table_floats(h, w));
  float2* beams = reinterpret_cast<float2*>(trig + p.samples);
  int* counts = reinterpret_cast<int*>(beams + p.beams);

  // The field, read once with coalesced loads, becomes its lp table; the
  // empty-map OR is taken on the way. Thread t takes cells t, t + 512, …,
  // stepping its (row, column) without a division.
  const float* src = dists + static_cast<size_t>(particle) * hw;
  const int dr = kThreads / w, dc = kThreads - dr * w;
  int row = threadIdx.x / w, col = threadIdx.x - row * w, occ = 0;
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    const float d = src[i];
    occ |= d < p.max_occ;
    lut[row * stride + col] = mixture(p, d);
    step_cell(row, col, dr, dc, w);
  }
  stage_samples(samples + static_cast<size_t>(particle) * p.samples * 3,
                p.samples, trig);
  const int nvalid = compact_beams(beam_table, p.beams, beams, counts);
  const bool any_occ = __syncthreads_or(occ) != 0;
  float* out_row = out + static_cast<size_t>(particle) * p.samples;
  if (!any_occ) {
    for (int s = threadIdx.x; s < p.samples; s += kThreads) out_row[s] = 0.0f;
    return;
  }
  const SharedTable table{
      smem_addr(lut) - 4u * tpunav::kCellBias * (stride + 1u),
      static_cast<unsigned>(stride)};
  score_samples(p, table, beams, nvalid, trig, p.samples, out_row);
}

// Two-pass, launch 1: lp of kTableCells cells of one particle, and whether
// any of them is occupied.
__global__ void __launch_bounds__(kTableThreads)
likelihood_table_kernel(LikParams p, const float* __restrict__ dists,
                        float* __restrict__ lut, int* __restrict__ occupied) {
  const int hw = p.height * p.width;
  const size_t base = static_cast<size_t>(blockIdx.y) * hw;
  const int c1 = min(hw, (blockIdx.x + 1) * kTableCells);
  int occ = 0;
  for (int i = blockIdx.x * kTableCells + threadIdx.x; i < c1;
       i += kTableThreads) {
    const float d = dists[base + i];
    occ |= d < p.max_occ;
    lut[base + i] = mixture(p, d);
  }
  occ = __syncthreads_or(occ);
  if (threadIdx.x == 0) occupied[blockIdx.y * gridDim.x + blockIdx.x] = occ;
}

// Two-pass, launch 2: kLookupWarps samples of one particle against its lp
// table in device memory.
__global__ void __launch_bounds__(kLookupWarps * 32)
likelihood_lookup_kernel(LikParams p, const float* __restrict__ samples,
                         const float* __restrict__ beam_table,
                         const float* __restrict__ lut,
                         const int* __restrict__ occupied, int chunks,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float4* trig = reinterpret_cast<float4*>(smem);
  float2* beams = reinterpret_cast<float2*>(trig + kLookupWarps);
  int* counts = reinterpret_cast<int*>(beams + p.beams);
  const int particle = blockIdx.y, first = blockIdx.x * kLookupWarps;
  const int count = min(kLookupWarps, p.samples - first);
  const size_t row0 = static_cast<size_t>(particle) * p.samples + first;
  int occ = 0;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    occ |= occupied[particle * chunks + c];
  stage_samples(samples + row0 * 3, count, trig);
  const int nvalid = compact_beams(beam_table, p.beams, beams, counts);
  const bool any_occ = __syncthreads_or(occ) != 0;
  if (!any_occ) {
    if (threadIdx.x < count) out[row0 + threadIdx.x] = 0.0f;
    return;
  }
  const GlobalTable table{
      lut + static_cast<size_t>(particle) * p.height * p.width,
      static_cast<unsigned>(p.width)};
  score_samples(p, table, beams, nvalid, trig, count, out + row0);
}

}  // namespace

extern "C" {

// K2 on `stream`. dists (P, H, W), samples (P, k, 3) and beam_table
// (3, B) = [range (-1 where invalid); r·cos(beam); r·sin(beam)], with r
// range_min where invalid, are device float32 arrays; out (P, k). With
// scratch null this is the fused path, one launch; otherwise scratch holds
// P·H·W + P·ceil(H·W/2048) floats and this is the two-pass path, two
// launches (likelihood.py:_plan chooses). Returns cudaGetLastError() after
// the last launch.
int tpunav_likelihood_field(const LikParams* params, const float* dists,
                            const float* samples, const float* beam_table,
                            float* scratch, float* out, void* stream) {
  const LikParams p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = p.height * p.width;
  const size_t beam_bytes = 8 * static_cast<size_t>(p.beams) +
                            4 * static_cast<size_t>((p.beams + 31) / 32);
  cudaError_t err;
  if (scratch == nullptr) {
    // Keep in step with likelihood.py:_fused_bytes.
    const size_t smem = 4 * static_cast<size_t>(table_floats(p.height, p.width)) +
                        16 * static_cast<size_t>(p.samples) + beam_bytes;
    err = cudaFuncSetAttribute(likelihood_field_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    likelihood_field_kernel<<<p.particles, kThreads, smem, s>>>(
        p, dists, samples, beam_table, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = (hw + kTableCells - 1) / kTableCells;
  int* occupied =
      reinterpret_cast<int*>(scratch + static_cast<size_t>(p.particles) * hw);
  likelihood_table_kernel<<<dim3(chunks, p.particles), kTableThreads, 0, s>>>(
      p, dists, scratch, occupied);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // Keep in step with likelihood.py:_lookup_bytes.
  const size_t smem = 16 * kLookupWarps + beam_bytes;
  err = cudaFuncSetAttribute(likelihood_lookup_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  likelihood_lookup_kernel<<<dim3((p.samples + kLookupWarps - 1) /
                                      kLookupWarps,
                                  p.particles),
                             kLookupWarps * 32, smem, s>>>(
      p, samples, beam_table, scratch, occupied, chunks, out);
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
