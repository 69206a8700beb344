// Dual CSR blend forward: B3's exact front-to-back compositing of each 16x16
// tile's whole depth-ordered list, carrying a second log-transmittance
// composited over the alphas masked by each row's band bit.
//
// Replaces: activesplat_tpu/ops/raster_pallas.py, `_blend_csr_dual_kernel` as
// called by `blend_csr_dual_pallas` (TPU kernel B5). One walk serves both
// top-down maps: the whole map's colour and transmittance, and the
// height-sliced map's transmittance.
//
// Input layout: B3's entry rows [mx, my, a, b, c, op, col0..7, band, pad]
// (the band bit, 0 or 1, in the padding column 14), each tile's run padded
// to a multiple of CSEG=256 rows; per tile the wrapper passes the index of
// its first segment and its segment count.
//
// What bounds it on an H100: compute, as for B3. A walked segment reads
// 16 KB of rows; the outputs are 256 pixels x (C + 2) floats per tile. The
// function needs B3's work (the power of every (row, pixel) pair of a walked
// segment; two exp and one log1p where alpha is not zero) plus, where the
// band bit is set and alpha is not zero, one more log1p and one add. This
// kernel spends B3's two expf and log1pf and the band's log1pf on every pair
// of a walked segment.
//
// Design: B3's, with the second carry in a register. One 256-thread block per
// tile, one thread per pixel, walks the tile's segments in order; each
// segment is staged in shared memory (16 KB). Alpha is computed once; the
// band carry adds log1pf(-alpha * band). The whole tile stops walking once
// every pixel's BAND transmittance is below exp(LOG_EPS), tested at each CSEG
// segment start with one __syncthreads_or: the band alpha is at most the
// full alpha, so band saturation implies full saturation, and the full
// composite walks on past its own saturation until the band saturates (the
// Pallas kernel's rule). Both in-segment log prefixes are summed sequentially
// and added to the carries at the segment's end, in B3's order, so that the
// band carry is bitwise B3's logT over rows whose opacity is multiplied by
// the band bit, and with every band bit set (accum, logT) is bitwise B3's.
// A tile with no segment gets zeros. Blocks are unbalanced (a wall tile's
// run is many times a floor tile's); that is left as it is.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after launch.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;  // pixels per tile = threads per block
constexpr int CSEG = 256;        // rows per segment
constexpr int N_ATTR = 16;       // [mx, my, a, b, c, op, col0..7, band, pad]
constexpr int MAX_C = 8;
constexpr int BAND_COL = 14;
constexpr int SEG_F4 = CSEG * N_ATTR / 4;  // float4s per segment
constexpr float LOG_EPS = -5.55f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;

__global__ void __launch_bounds__(PX)
blend_csr_dual_kernel(const float* __restrict__ rows, const int* __restrict__ seg_u0,
                      const int* __restrict__ seg_v0, const int* __restrict__ tile_start,
                      const int* __restrict__ tile_count, int n_channels,
                      float* __restrict__ accum, float* __restrict__ logt_out,
                      float* __restrict__ logt_band_out) {
  __shared__ __align__(16) float seg[CSEG * N_ATTR];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int count = tile_count[tile];  // uniform over the block

  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.0f;
  float logt = 0.0f;
  float logt_band = 0.0f;

  if (count > 0) {
    const int start = tile_start[tile];
    const float px = static_cast<float>(seg_u0[start] + p % TILE);
    const float py = static_cast<float>(seg_v0[start] + p / TILE);

    for (int s = start; s < start + count; ++s) {
      // once the band saturates the tile stays saturated: stop walking
      if (!__syncthreads_or(logt_band >= LOG_EPS)) break;

      const float4* src = reinterpret_cast<const float4*>(rows) + static_cast<size_t>(s) * SEG_F4;
#pragma unroll
      for (int i = 0; i < SEG_F4 / PX; ++i) reinterpret_cast<float4*>(seg)[i * PX + p] = src[i * PX + p];
      __syncthreads();

      float excl = 0.0f;       // exclusive in-segment log prefix
      float excl_band = 0.0f;  // the same over alpha * band
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
        excl_band += log1pf(-(alpha * r[BAND_COL]));
      }
      logt += excl;
      logt_band += excl_band;
      __syncthreads();  // the next segment overwrites seg
    }
  }

  const size_t pix = static_cast<size_t>(tile) * PX + p;
  for (int c = 0; c < n_channels; ++c) accum[pix * n_channels + c] = acc[c];
  logt_out[pix] = logt;
  logt_band_out[pix] = logt_band;
}

}  // namespace

extern "C" int blend_csr_dual_fwd(const void* rows, const void* seg_u0, const void* seg_v0,
                                  const void* tile_start, const void* tile_count, int n_tiles,
                                  int n_channels, void* accum, void* logt, void* logt_band,
                                  void* stream) {
  if (n_tiles > 0) {
    blend_csr_dual_kernel<<<n_tiles, PX, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows), static_cast<const int*>(seg_u0),
        static_cast<const int*>(seg_v0), static_cast<const int*>(tile_start),
        static_cast<const int*>(tile_count), n_channels, static_cast<float*>(accum),
        static_cast<float*>(logt), static_cast<float*>(logt_band));
  }
  return static_cast<int>(cudaGetLastError());
}
