// CSR blend backward: the analytic gradient of blend_csr_fwd.cu with respect
// to every entry row [mx, my, a, b, c, op, col0..7].
//
// Replaces: activesplat_tpu/ops/raster_pallas.py, `_blend_csr_bwd_kernel` as
// called by `_blend_csr_bwd_pallas` (TPU kernel B4).
//
// What bounds it on an H100: not memory. A walked segment reads its 16 KB of
// rows and one 1 KB stash row and writes 16 KB of gradients; each tile reads
// its pixel cotangents once. The function needs the power of every (row,
// pixel) pair of a walked segment and, only where alpha is not zero, three
// special-function results (exp of the power, log1p(-alpha), exp of the
// prefix logT) and about 50 float32 operations at C=5, the pixel sums of the
// row's gradients included: the float32 and special-function rates bound
// it. About nine pairs in ten of a walked segment are dead (alpha 0).
//
// The reference. The Pallas kernel runs one grid step per 256-row segment in
// reverse order, carrying the suffix colour-dot
//     b(p) = sum over the rows behind of w_j(p) s_j(p),  s_j = col_j . g_accum(p),
// in VMEM; the carry starts at zero behind each tile's last segment (where
// the next segment's tile id differs), and each segment adds its own total
// S(p) = sum_j w_j s_j in one step. A segment whose stashed entry logT is
// below LOG_EPS at every pixel was skipped by the forward: zero rows, carry
// unchanged. The skip is decided per 256-row segment: a walked segment is
// walked whole, even where a later part of it starts below LOG_EPS.
//
// Design. A tile's run is about one segment on the training stream (279
// segments for 256 tiles), so one block per segment would give no more
// parallelism than one block per tile. Each segment is cut into four 64-row
// pieces, one 256-thread block each (one thread per pixel), and the carry
// is rebuilt from per-piece totals, in two launches:
//   Pass 1 (csr_bwd_pieces_kernel), one block per (segment, piece): a
//   skipped or padding segment writes zeros; otherwise the block stages the
//   piece's 64 rows and walks them front to back from transmittance 1
//   (piece_total), writing per pixel the piece's log step
//   L_q = sum_j log1p(-alpha_j) and its unscaled total
//   W_q = sum_j alpha_j exp(local exclusive prefix_j) s_j. Scratch
//   (n_seg, 4, PX, 2) float32, every entry written.
//   Pass 2 (csr_bwd_walk_kernel), one block per (segment, piece): a skipped
//   or padding segment writes zero rows. Otherwise each pixel forms every
//   piece's entry logT e_q = entry(s) + ((L_0 + L_1) + ... + L_{q-1}) and
//   scaled total P_q = exp(e_q) W_q, the segment total S = ((P_0 + P_1) +
//   P_2) + P_3, and the carry behind its piece
//     b = b_tile(s) + ((P_3 + P_2) + ... + P_{q+1}),
//   where b_tile(s) = ((0 + S_last) + ...) + S_{s+1} folds the totals of the
//   tile's later segments in the reference's order (each rebuilt the same
//   way from pass 1's scratch: four expf a pixel; runs are 1-8 segments).
//   The tile's last segment is found as the reference finds it, by the tile
//   id of the segments after s. It then walks the piece front to back from
//   e_q with B2's body (walk_rows, blend_bwd_walk.cuh):
//     B_k = b + (P_q - sum_{j<=k} w_j s_j),
//     dL/dalpha_k = T_k s_k - (B_k + g_logT) / max(1 - alpha_k, 1/256),
//   chained through alpha = min(op exp(power), 0.99) (raster_pallas.py:
//   674-730), and writes the piece's 64 gradient rows.
// Pass 2 reads only what pass 1 wrote, so the result does not depend on
// which block ends first, and needs no per-tile counter. The sums are
// reassociated against the sequential walk (the log prefix and the carry
// are summed piece by piece): only their rounding differs.
//
// The walk's helpers (8x4-pixel warps, the per-row reach mask, staging with
// the dead-pair threshold, the reduce-scatter pixel sum, the fixed-order
// cross-warp sum), its footprint (4 KB of rows, 32 KB of per-warp partials,
// four blocks a SM) and why tensor cores do not serve it are in
// blend_bwd_walk.cuh, shared with B2. The reach mask takes its origin from
// the segment's seg_u0/seg_v0.
//
// C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for C outside
// 1..8).

#include "blend_bwd_walk.cuh"

using namespace bwd_walk;

namespace {

constexpr int CSEG = 256;               // rows per segment (the skip granularity)
constexpr int N_PIECES = CSEG / SEG;    // 64-row pieces per segment

// Whether segment s is walked: a tile's segment (not padding) whose stashed
// entry logT is at least LOG_EPS at some pixel. Every thread of the block
// takes part.
__device__ __forceinline__ bool segment_walked(int tile, int n_tiles, float logt) {
  return __syncthreads_or(tile < n_tiles && logt >= LOG_EPS);
}

// Segment s at pixel lp, from pass 1's scratch: each piece's entry logT
// e_q = logt + ((L_0 + L_1) + ... + L_{q-1}) and scaled total
// P_q = exp(e_q) W_q.
__device__ __forceinline__ void scaled_pieces(const float2* __restrict__ pieces, size_t s, int lp,
                                              float logt, float (&e)[N_PIECES],
                                              float (&total)[N_PIECES]) {
  float steps = 0.0f;
#pragma unroll
  for (int q = 0; q < N_PIECES; ++q) {
    const float2 lw = pieces[(s * N_PIECES + q) * PX + lp];
    e[q] = logt + steps;
    total[q] = expf(e[q]) * lw.y;
    steps += lw.x;
  }
}

template <int C>
__global__ void __launch_bounds__(PX)
csr_bwd_pieces_kernel(const float* __restrict__ rows, const int* __restrict__ seg_tile,
                      const int* __restrict__ seg_u0, const int* __restrict__ seg_v0,
                      const float* __restrict__ entry, const float* __restrict__ g_accum,
                      int n_tiles, float margin, float2* __restrict__ pieces,
                      int* __restrict__ audit) {
  __shared__ __align__(16) float seg[SEG * N_ATTR];
  const int s = blockIdx.x / N_PIECES;
  const int q = blockIdx.x % N_PIECES;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lp = local_pixel(p);
  const int tile = seg_tile[s];
  float2* out = pieces + static_cast<size_t>(blockIdx.x) * PX + lp;
  if (!segment_walked(tile, n_tiles, entry[static_cast<size_t>(s) * PX + lp])) {
    *out = make_float2(0.0f, 0.0f);
    return;
  }
  const float x0 = static_cast<float>(seg_u0[s]);
  const float y0 = static_cast<float>(seg_v0[s]);
  stage_rows(rows, static_cast<size_t>(s) * CSEG + q * SEG, seg, margin, x0, y0, p);

  const float px = x0 + static_cast<float>(lp % TILE);
  const float py = y0 + static_cast<float>(lp / TILE);
  const size_t pix = static_cast<size_t>(tile) * PX + lp;
  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = g_accum[pix * C + c];

  float run = 0.0f;  // the piece's log step L_q
  const float total = piece_total<C>(seg, px, py, g, 0.0f, warp, audit, run);
  *out = make_float2(run, total);
}

template <int C>
__global__ void __launch_bounds__(PX, 4)
csr_bwd_walk_kernel(const float* __restrict__ rows, const int* __restrict__ seg_tile,
                    const int* __restrict__ seg_u0, const int* __restrict__ seg_v0,
                    const float* __restrict__ entry, const float* __restrict__ g_accum,
                    const float* __restrict__ g_logt, const float2* __restrict__ pieces,
                    int n_seg, int n_tiles, float* __restrict__ d_rows) {
  __shared__ __align__(16) float seg[SEG * N_ATTR];
  __shared__ float partial[N_WARPS * SEG * N_COLS];  // (warp, row, column) warp sums

  const int s = blockIdx.x / N_PIECES;
  const int q = blockIdx.x % N_PIECES;
  const int p = threadIdx.x;
  const int lane = p % 32;
  const int warp = p / 32;
  const int lp = local_pixel(p);
  const size_t first_row = static_cast<size_t>(s) * CSEG + q * SEG;
  const int tile = seg_tile[s];
  const float logt = entry[static_cast<size_t>(s) * PX + lp];
  if (!segment_walked(tile, n_tiles, logt)) {  // skipped by the forward, or padding
    zero_rows(d_rows + first_row * N_ATTR, p);
    return;
  }
  // the carry behind this segment: the tile's later segments' totals,
  // folded from its last segment (the last whose tile id is this one's)
  int end = s + 1;
  while (end < n_seg && seg_tile[end] == tile) ++end;
  float b = 0.0f;
  for (int later = end - 1; later > s; --later) {
    float e[N_PIECES], total[N_PIECES];
    scaled_pieces(pieces, later, lp, entry[static_cast<size_t>(later) * PX + lp], e, total);
    float seg_total = 0.0f;
#pragma unroll
    for (int i = 0; i < N_PIECES; ++i) seg_total += total[i];
    b += seg_total;
  }
  // this segment's pieces: the entry and total of piece q, and the pieces behind it
  float e[N_PIECES], total[N_PIECES];
  scaled_pieces(pieces, s, lp, logt, e, total);
  float behind = 0.0f, e_q = 0.0f, total_q = 0.0f;
#pragma unroll
  for (int i = N_PIECES - 1; i >= 0; --i) {
    if (i > q) behind += total[i];
    if (i == q) {
      e_q = e[i];
      total_q = total[i];
    }
  }
  b += behind;

  const float x0 = static_cast<float>(seg_u0[s]);
  const float y0 = static_cast<float>(seg_v0[s]);
  stage_rows(rows, first_row, seg, DEAD_MARGIN, x0, y0, p);

  const float px = x0 + static_cast<float>(lp % TILE);
  const float py = y0 + static_cast<float>(lp / TILE);
  const size_t pix = static_cast<size_t>(tile) * PX + lp;
  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = g_accum[pix * C + c];
  const float glt = g_logt[pix];

  walk_rows<C>(seg, partial, px, py, g, glt, e_q, b, total_q, warp, lane);
  __syncthreads();
  write_rows<C>(partial, d_rows + first_row * N_ATTR, p);
}

}  // namespace

extern "C" int csr_bwd_pieces(const void* rows, const void* seg_tile, const void* seg_u0,
                              const void* seg_v0, const void* entry, const void* g_accum,
                              int n_seg, int n_tiles, int n_channels, float margin, void* pieces,
                              void* audit, void* stream) {
  return with_channels(n_channels, [&](auto c) {
    constexpr int C = decltype(c)::value;
    if (n_seg > 0)
      csr_bwd_pieces_kernel<C><<<n_seg * N_PIECES, PX, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(rows), static_cast<const int*>(seg_tile),
          static_cast<const int*>(seg_u0), static_cast<const int*>(seg_v0),
          static_cast<const float*>(entry), static_cast<const float*>(g_accum), n_tiles, margin,
          static_cast<float2*>(pieces), static_cast<int*>(audit));
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int csr_bwd_walk(const void* rows, const void* seg_tile, const void* seg_u0,
                            const void* seg_v0, const void* entry, const void* g_accum,
                            const void* g_logt, const void* pieces, int n_seg, int n_tiles,
                            int n_channels, void* d_rows, void* stream) {
  return with_channels(n_channels, [&](auto c) {
    constexpr int C = decltype(c)::value;
    if (n_seg > 0)
      csr_bwd_walk_kernel<C><<<n_seg * N_PIECES, PX, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(rows), static_cast<const int*>(seg_tile),
          static_cast<const int*>(seg_u0), static_cast<const int*>(seg_v0),
          static_cast<const float*>(entry), static_cast<const float*>(g_accum),
          static_cast<const float*>(g_logt), static_cast<const float2*>(pieces), n_seg, n_tiles,
          static_cast<float*>(d_rows));
    return static_cast<int>(cudaGetLastError());
  });
}

// out[0:5] pass 1, out[5:10] pass 2, each: registers a thread, static and
// dynamic shared bytes a block, local (spill) bytes a thread, resident
// blocks per SM at 256 threads.
extern "C" int csr_bwd_occupancy(int n_channels, void* out) {
  int* o = static_cast<int*>(out);
  return with_channels(n_channels, [&](auto c) {
    constexpr int C = decltype(c)::value;
    cudaError_t err = kernel_occupancy(csr_bwd_pieces_kernel<C>, o);
    if (err == cudaSuccess) err = kernel_occupancy(csr_bwd_walk_kernel<C>, o + 5);
    return static_cast<int>(err);
  });
}
