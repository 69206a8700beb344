// Tile blend backward: the analytic gradient of blend_fwd.cu with respect to
// every tile row [mx, my, a, b, c, op, col0..7].
//
// Replaces: activesplat_tpu/ops/raster_pallas.py, `_blend_bwd_kernel` as
// called by `_blend_bwd_pallas` (TPU kernel B2).
//
// What bounds it on an H100: not memory. A tile reads its K rows, the stashed
// entry log-transmittances and the pixel cotangents and writes K rows, about
// 11 MB for 256 tiles at K=256 (3 us at 3.35 TB/s). The function needs the
// power of every (row, pixel) pair of a walked segment and, only where alpha
// is not zero, three special-function results (exp of the power,
// log1p(-alpha), exp of the prefix logT) and about 50 float32 operations at
// C=5, the pixel sums of the row's gradients included: the float32 and
// special-function rates bound it. About nine pairs in ten of a walked
// segment are dead (alpha 0), and in the main path's rows about four
// warp-rows in five hold no live pair.
//
// Design. The Pallas kernel walks a tile's SEG=64-row segments back to front
// in one grid step, carrying the suffix colour-dot
//     b(p) = sum over the rows behind of w_j(p) s_j(p),  s_j = col_j . g_accum(p),
// and adds each segment's total S_s(p) = sum_j w_j s_j to it in one step
// (raster_pallas.py:224). A segment's total depends only on its stashed
// entry logT and the cotangent, not on b, so the carry into segment s is a
// fold of the later totals, b_in(s) = ((0 + S_{n-1}) + S_{n-2}) + ... +
// S_{s+1}, and the segments need not run in series. Two launches:
//   Pass 1 (tile_bwd_suffix_kernel), one 256-thread block per (tile,
//   segment), one thread per pixel: a segment the forward skipped (entry
//   logT below LOG_EPS at every pixel) writes S = 0; otherwise the block
//   stages its 64 rows (4 KB) and walks them front to back from the stashed
//   entry logT, the log prefix carried in a register as the forward carries
//   it, and writes S_s(p). Scratch (T, K/SEG, PX) float32, every entry
//   written.
//   Pass 2 (tile_bwd_walk_kernel), one block per (tile, segment): a skipped
//   segment writes zero rows; otherwise each pixel folds the later totals in
//   the order above (at most 15 loads at K=1,024) and walks its segment
//   front to back, the log prefix again in a register, with the suffix
//   behind row k formed as the plain version forms it, total minus the
//   inclusive sum:
//     B_k = b_in + (S_s - sum_{j<=k} w_j s_j),
//     dL/dalpha_k = T_k s_k - (B_k + g_logT) / max(1 - alpha_k, 1/256),
//   chained through alpha = min(op exp(power), 0.99) as the Pallas kernel
//   does (raster_pallas.py:182-224). The fold reads only totals that pass 1
//   wrote, so the result does not depend on which block ends first, and
//   needs no per-tile counter.
// A back-to-front walk needs every row's exclusive log prefix in reverse
// order: 64 KB of shared memory a block (two blocks a SM), or a front-to-back
// pre-pass and a refill of each 16-row sub-chunk's prefix (16 KB), which
// evaluates every pair three times. Walking front to back from the segment's
// own total evaluates each pair once and keeps no prefix.
//
// The walk's helpers (pixels, reach mask, staging, dead-pair test, the
// reduce-scatter pixel sum, the per-warp partials) and its footprint are in
// blend_bwd_walk.cuh, shared with B4. Pass 1: 4 KB, eight blocks a SM.
//
// C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for C outside
// 1..8).

#include "blend_bwd_walk.cuh"

using namespace bwd_walk;

namespace {

template <int C>
__global__ void __launch_bounds__(PX)
tile_bwd_suffix_kernel(const float* __restrict__ rows, const int* __restrict__ u0,
                       const int* __restrict__ v0, const float* __restrict__ entry,
                       const float* __restrict__ g_accum, int n_seg, float margin,
                       float* __restrict__ suffix, int* __restrict__ audit) {
  __shared__ __align__(16) float seg[SEG * N_ATTR];
  const int tile = blockIdx.x / n_seg;
  const int s = blockIdx.x % n_seg;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lp = local_pixel(p);
  const size_t at = (static_cast<size_t>(tile) * n_seg + s) * PX + lp;
  const float logt_in = entry[at];
  if (!__syncthreads_or(logt_in >= LOG_EPS)) {  // the forward skipped this segment
    suffix[at] = 0.0f;
    return;
  }
  const float x0 = static_cast<float>(u0[tile]);
  const float y0 = static_cast<float>(v0[tile]);
  stage_rows(rows, (static_cast<size_t>(tile) * n_seg + s) * SEG, seg, margin, x0, y0, p);

  const float px = x0 + static_cast<float>(lp % TILE);
  const float py = y0 + static_cast<float>(lp / TILE);
  const size_t pix = static_cast<size_t>(tile) * PX + lp;
  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = g_accum[pix * C + c];

  float run = 0.0f;  // the segment's log step (unused here)
  suffix[at] = piece_total<C>(seg, px, py, g, logt_in, warp, audit, run);
}

template <int C>
__global__ void __launch_bounds__(PX, 4)
tile_bwd_walk_kernel(const float* __restrict__ rows, const int* __restrict__ u0,
                     const int* __restrict__ v0, const float* __restrict__ entry,
                     const float* __restrict__ g_accum, const float* __restrict__ g_logt,
                     const float* __restrict__ suffix, int n_seg,
                     float* __restrict__ d_rows) {
  __shared__ __align__(16) float seg[SEG * N_ATTR];
  __shared__ float partial[N_WARPS * SEG * N_COLS];  // (warp, row, column) warp sums

  const int tile = blockIdx.x / n_seg;
  const int s = blockIdx.x % n_seg;
  const int p = threadIdx.x;
  const int lane = p % 32;
  const int warp = p / 32;
  const int lp = local_pixel(p);
  const size_t first_row = (static_cast<size_t>(tile) * n_seg + s) * SEG;
  const size_t at = (static_cast<size_t>(tile) * n_seg + s) * PX + lp;
  const float logt_in = entry[at];
  if (!__syncthreads_or(logt_in >= LOG_EPS)) {  // skipped by the forward: zero rows
    zero_rows(d_rows + first_row * N_ATTR, p);
    return;
  }
  // the carry behind this segment, folded in the reference's order
  float b_in = 0.0f;
  for (int later = n_seg - 1; later > s; --later)
    b_in += suffix[(static_cast<size_t>(tile) * n_seg + later) * PX + lp];
  const float total = suffix[at];  // this segment's own S_s
  const float x0 = static_cast<float>(u0[tile]);
  const float y0 = static_cast<float>(v0[tile]);
  stage_rows(rows, first_row, seg, DEAD_MARGIN, x0, y0, p);

  const float px = x0 + static_cast<float>(lp % TILE);
  const float py = y0 + static_cast<float>(lp / TILE);
  const size_t pix = static_cast<size_t>(tile) * PX + lp;
  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = g_accum[pix * C + c];
  const float glt = g_logt[pix];

  walk_rows<C>(seg, partial, px, py, g, glt, logt_in, b_in, total, warp, lane);
  __syncthreads();
  write_rows<C>(partial, d_rows + first_row * N_ATTR, p);
}

}  // namespace

extern "C" int tile_bwd_suffix(const void* rows, const void* u0, const void* v0,
                               const void* entry, const void* g_accum, int n_tiles, int k,
                               int n_channels, float margin, void* suffix, void* audit,
                               void* stream) {
  const int n_seg = k / SEG;
  return with_channels(n_channels, [&](auto c) {
    constexpr int C = decltype(c)::value;
    if (n_tiles > 0 && n_seg > 0)
      tile_bwd_suffix_kernel<C><<<n_tiles * n_seg, PX, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(rows), static_cast<const int*>(u0),
          static_cast<const int*>(v0), static_cast<const float*>(entry),
          static_cast<const float*>(g_accum), n_seg, margin, static_cast<float*>(suffix),
          static_cast<int*>(audit));
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int tile_bwd_walk(const void* rows, const void* u0, const void* v0,
                             const void* entry, const void* g_accum, const void* g_logt,
                             const void* suffix, int n_tiles, int k, int n_channels,
                             void* d_rows, void* stream) {
  const int n_seg = k / SEG;
  return with_channels(n_channels, [&](auto c) {
    constexpr int C = decltype(c)::value;
    if (n_tiles > 0 && n_seg > 0)
      tile_bwd_walk_kernel<C><<<n_tiles * n_seg, PX, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(rows), static_cast<const int*>(u0),
          static_cast<const int*>(v0), static_cast<const float*>(entry),
          static_cast<const float*>(g_accum), static_cast<const float*>(g_logt),
          static_cast<const float*>(suffix), n_seg, static_cast<float*>(d_rows));
    return static_cast<int>(cudaGetLastError());
  });
}

// out[0:5] pass 1, out[5:10] pass 2, each: registers a thread, static and
// dynamic shared bytes a block, local (spill) bytes a thread, resident
// blocks per SM at 256 threads.
extern "C" int tile_bwd_occupancy(int n_channels, void* out) {
  int* o = static_cast<int*>(out);
  return with_channels(n_channels, [&](auto c) {
    constexpr int C = decltype(c)::value;
    cudaError_t err = kernel_occupancy(tile_bwd_suffix_kernel<C>, o);
    if (err == cudaSuccess) err = kernel_occupancy(tile_bwd_walk_kernel<C>, o + 5);
    return static_cast<int>(err);
  });
}
