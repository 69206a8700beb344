// Tile blend forward: front-to-back alpha compositing of each 16x16 tile's
// depth-ordered Gaussian rows.
//
// Replaces: activesplat_tpu/ops/raster_pallas.py, `_blend_kernel` as called
// by `_blend_fwd_pallas` (TPU kernel B1), with and without the per-segment
// entry log-transmittance stash.
//
// What bounds it on an H100: not memory. A tile reads K rows of 64 bytes
// (16 KB at K=256) and writes 256 pixels x (C + 1 + K/64) floats, about 6 MB
// for 256 tiles, 2 us at 3.35 TB/s. The function needs the power of every
// (row, pixel) pair of a walked segment (11 float32 operations) and, where
// alpha is not zero, two exp and one log1p (special-function-unit work) and
// about 14 float32 operations more at C=5: compute bounds it. This kernel
// spends the two expf and the log1pf on every pair of a walked segment.
//
// Design: one 256-thread block per tile, one thread per pixel. Each
// SEG=64-row segment is staged in shared memory (4 KB, one float4 per
// thread) and every thread walks its rows in order, carrying its
// log-transmittance and 8 colour accumulators in registers: no (K, pixels)
// intermediate ever leaves the SM. The whole tile stops walking once every
// pixel's transmittance is below exp(LOG_EPS), tested at each segment start
// with one __syncthreads_or, exactly the Pallas kernel's "max logT < LOG_EPS"
// test. The per-row weights use the in-segment exclusive log prefix plus the
// segment's entry logT, as the Pallas kernel does; only the summation order
// of the prefix differs (sequential here, Hillis-Steele there).
//
// C interface (loaded with ctypes): returns cudaGetLastError() after launch.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;  // pixels per tile = threads per block
constexpr int SEG = 64;          // rows per staged segment
constexpr int N_ATTR = 16;       // [mx, my, a, b, c, op, col0..7, pad, pad]
constexpr int MAX_C = 8;
constexpr float LOG_EPS = -5.55f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;

__global__ void __launch_bounds__(PX)
blend_fwd_kernel(const float* __restrict__ rows, const int* __restrict__ u0,
                 const int* __restrict__ v0, int k, int n_channels,
                 float* __restrict__ accum, float* __restrict__ logt_out,
                 float* __restrict__ entry) {
  __shared__ __align__(16) float seg[SEG * N_ATTR];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float px = static_cast<float>(u0[tile] + p % TILE);
  const float py = static_cast<float>(v0[tile] + p / TILE);
  const int n_seg = k / SEG;
  const float4* tile_rows =
      reinterpret_cast<const float4*>(rows + static_cast<size_t>(tile) * k * N_ATTR);

  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.0f;
  float logt = 0.0f;
  bool saturated = false;  // uniform over the block

  for (int s = 0; s < n_seg; ++s) {
    if (entry != nullptr) {
      // stashed for every segment, skipped ones included: the backward
      // re-derives the skip from it
      entry[(static_cast<size_t>(tile) * n_seg + s) * PX + p] = logt;
    }
    if (!saturated) saturated = !__syncthreads_or(logt >= LOG_EPS);
    if (saturated) continue;

    // SEG * N_ATTR floats = PX float4s: one per thread
    reinterpret_cast<float4*>(seg)[p] = tile_rows[s * (SEG * N_ATTR / 4) + p];
    __syncthreads();

    float excl = 0.0f;  // exclusive in-segment log prefix
    for (int j = 0; j < SEG; ++j) {
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

  const size_t pix = static_cast<size_t>(tile) * PX + p;
  for (int c = 0; c < n_channels; ++c) accum[pix * n_channels + c] = acc[c];
  logt_out[pix] = logt;
}

}  // namespace

extern "C" int blend_tiles_fwd(const void* rows, const void* u0, const void* v0,
                               int n_tiles, int k, int n_channels, void* accum,
                               void* logt, void* entry, void* stream) {
  if (n_tiles > 0) {
    blend_fwd_kernel<<<n_tiles, PX, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows), static_cast<const int*>(u0),
        static_cast<const int*>(v0), k, n_channels, static_cast<float*>(accum),
        static_cast<float*>(logt), static_cast<float*>(entry));
  }
  return static_cast<int>(cudaGetLastError());
}
