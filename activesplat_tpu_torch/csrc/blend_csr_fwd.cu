// CSR blend forward: exact (uncapped) front-to-back alpha compositing of each
// 16x16 tile's whole depth-ordered list of Gaussian rows.
//
// Replaces: activesplat_tpu/ops/raster_pallas.py, `_blend_csr_kernel` as
// called by `_blend_csr_fwd_pallas` (TPU kernel B3), with and without the
// per-segment entry log-transmittance stash.
//
// Input layout: the entry rows of all tiles concatenated, [mx, my, a, b, c,
// op, col0..7, pad, pad], each tile's run padded to a multiple of CSEG=256
// rows, so that every CSEG-row segment belongs to one tile. Per tile, the
// wrapper passes the index of its first segment and its segment count (a
// tile's segments are consecutive); segments of no tile (padding past the
// last run) are never read.
//
// What bounds it on an H100: not memory. A walked segment reads 16 KB of
// rows; the outputs are 256 pixels x (C + 1) floats per tile plus one
// 1 KB stash row per segment. The function needs the power of every (row,
// pixel) pair of a walked segment (11 float32 operations) and, where alpha
// is not zero, two exp and one log1p (special-function-unit work) and about
// 14 float32 operations more at C=5: compute bounds it. This kernel spends
// the two expf and the log1pf on every pair of a walked segment.
//
// Design: the Pallas kernel runs one grid step per segment and keeps the
// tile's output block resident across a tile's consecutive steps. Here one
// 256-thread block per tile, one thread per pixel, walks the tile's segments
// in order, carrying its log-transmittance and 8 colour accumulators in
// registers (B1's design with the loop over K replaced by the loop over the
// tile's CSR run). Each segment is staged in shared memory (16 KB, four
// float4 per thread). The whole tile stops walking once every pixel's
// transmittance is below exp(LOG_EPS), tested at each CSEG segment start
// with one __syncthreads_or: the Pallas kernel's "max logT < LOG_EPS" test at
// the same 256-row granularity, which decides which segments are skipped.
// The stash is written for every segment of the tile, skipped ones too: the
// backward re-derives the skip from it. A tile with no segment gets zeros.
// The in-segment log prefix is summed sequentially (Hillis-Steele in the
// Pallas kernel). Blocks are unbalanced (a wall tile's run is ~100x a
// median tile's); that is left as it is.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after launch.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;  // pixels per tile = threads per block
constexpr int CSEG = 256;        // rows per segment
constexpr int N_ATTR = 16;       // [mx, my, a, b, c, op, col0..7, pad, pad]
constexpr int MAX_C = 8;
constexpr int SEG_F4 = CSEG * N_ATTR / 4;  // float4s per segment
constexpr float LOG_EPS = -5.55f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;

__global__ void __launch_bounds__(PX)
blend_csr_fwd_kernel(const float* __restrict__ rows, const int* __restrict__ seg_u0,
                     const int* __restrict__ seg_v0, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int n_channels,
                     float* __restrict__ accum, float* __restrict__ logt_out,
                     float* __restrict__ entry) {
  __shared__ __align__(16) float seg[CSEG * N_ATTR];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int count = tile_count[tile];  // uniform over the block

  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.0f;
  float logt = 0.0f;

  if (count > 0) {
    const int start = tile_start[tile];
    const float px = static_cast<float>(seg_u0[start] + p % TILE);
    const float py = static_cast<float>(seg_v0[start] + p / TILE);
    bool saturated = false;  // uniform over the block

    for (int s = start; s < start + count; ++s) {
      if (entry != nullptr) entry[static_cast<size_t>(s) * PX + p] = logt;
      if (!saturated) saturated = !__syncthreads_or(logt >= LOG_EPS);
      if (saturated) continue;

      const float4* src = reinterpret_cast<const float4*>(rows) + static_cast<size_t>(s) * SEG_F4;
#pragma unroll
      for (int i = 0; i < SEG_F4 / PX; ++i) reinterpret_cast<float4*>(seg)[i * PX + p] = src[i * PX + p];
      __syncthreads();

      float excl = 0.0f;  // exclusive in-segment log prefix
      for (int j = 0; j < CSEG; ++j) {
        const float* r = seg + j * N_ATTR;
        const float dx = r[0] - px;
        const float dy = r[1] - py;
        const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
        float alpha = fminf(r[5] * expf(power), ALPHA_MAX);
        if (!(power <= 0.0f && alpha >= ALPHA_MIN)) alpha = 0.0f;
        const float w = alpha * expf(excl + logt);
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) acc[c] += w * r[6 + c];
        excl += log1pf(-alpha);
      }
      logt += excl;
      __syncthreads();  // the next segment overwrites seg
    }
  }

  const size_t pix = static_cast<size_t>(tile) * PX + p;
  for (int c = 0; c < n_channels; ++c) accum[pix * n_channels + c] = acc[c];
  logt_out[pix] = logt;
}

}  // namespace

extern "C" int blend_csr_fwd(const void* rows, const void* seg_u0, const void* seg_v0,
                             const void* tile_start, const void* tile_count, int n_tiles,
                             int n_channels, void* accum, void* logt, void* entry,
                             void* stream) {
  if (n_tiles > 0) {
    blend_csr_fwd_kernel<<<n_tiles, PX, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows), static_cast<const int*>(seg_u0),
        static_cast<const int*>(seg_v0), static_cast<const int*>(tile_start),
        static_cast<const int*>(tile_count), n_channels, static_cast<float*>(accum),
        static_cast<float*>(logt), static_cast<float*>(entry));
  }
  return static_cast<int>(cudaGetLastError());
}
