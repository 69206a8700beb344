// The exact CSR forward blend, written once for B3 (blend_csr_fwd.cu, with
// and without the per-segment entry log-transmittance stash) and B5
// (blend_csr_dual.cu, a second carry over alpha * band). Each source
// instantiates these templates (colour channels C in 1..8, DUAL) behind its
// C entry points. The per-tile combine (combine_tile) also serves the dense
// tile blend B1 (blend_fwd.cu), whose partials have the same layout.
//
// Input layout: the entry rows of all tiles concatenated, [mx, my, a, b, c,
// op, col0..7, band, pad], each tile's run padded to a multiple of CSEG=256
// rows, so that every CSEG-row segment belongs to one tile (seg_tile; id
// n_tiles marks padding segments past the last run, which nothing reads).
//
// What bounds it on an H100: compute. A walked segment reads 16 KB of rows;
// the function needs the power of every (row, pixel) pair of a walked
// segment (11 float32 operations) and, only where alpha is not zero, two
// exp and one log1p (special-function-unit work; B5 one more log1p where
// the band bit is set) and 4 + 2C float32 operations more.
//
// Design. The Pallas kernel runs one grid step per segment, in order,
// carrying the tile's state in VMEM. Hopper's blocks run in parallel and
// carry nothing between them, so the walk is split in two launches:
//   Pass 1, one 256-thread block per segment, one thread per pixel: the
//   segment is staged in shared memory and composited by itself from
//   transmittance 1, summing its rows in order (j = 0..255, the exclusive
//   log prefix carried sequentially). Per pixel it writes the colour
//   partial P[c] = sum_j alpha_j exp(excl_j) col_j[c], the log step
//   L = sum_j log1p(-alpha_j) and, with DUAL, the band step over
//   alpha_j * band_j: (n_seg, PX, C + 1 [+ 1]) float32.
//   Pass 2, one block per tile, one thread per pixel: the tile's segments
//   in order. At each segment start the whole-tile exit (every pixel's
//   carry below LOG_EPS, the band carry with DUAL) is tested with one
//   __syncthreads_or; the stash takes the entry logT; then
//   accum += exp(logT) P and logT += L (the band carry likewise). The
//   partials of AHEAD segments are loaded at once, and one vote on the
//   carry at the entry of the chunk's last segment (a pixel's carry never
//   increases) stands for the chunk's votes unless the exit falls inside
//   it: a long run costs one barrier per AHEAD segments.
// L is the one-block-per-tile walk's in-segment sum and the combine adds
// the steps in its order, so logT, the stash and every exit decision are
// that walk's bitwise; only accum is reassociated (exp(logT) sum in place
// of sum exp(excl + logT)). B3 and B5 share this code, so B5's band carry
// is bitwise B3's logT over the band-masked rows, and with every band bit
// set B5's (accum, logT) is B3's.
//
// Two launches, not one with a per-tile arrival counter: the combine's
// work per segment is C + 1 floats per pixel, its launch costs a few
// microseconds, and a separate pass reads the same partials whichever
// block finished last, with no fence or counter to reset.
//
// Segments the exit already rules out: logT never increases and an entry
// logT is at most 0, so once a segment's own max_p L < LOG_EPS (the band
// step with DUAL) every later segment of its tile is skipped by the walk
// (round-to-nearest is monotonic: fl(a + b) <= b for a <= 0). Such a block
// publishes its index with atomicMin on skip_from[tile] (filled by the
// wrapper per call); a later block of the tile that reads a smaller index
// skips its walk and writes nothing. The combine stops at or before every
// such segment, so the output does not depend on the schedule.
//
// Dead pairs: per row, thr = log(ALPHA_MIN) - log(op) - margin (+inf for
// op <= 0, so padding rows are dead). A pair with power > 0 or power < thr
// has alpha 0 by the full formula; it skips both expf, the log1pf (both
// for B5) and the C FMAs. Its contribution and log step were exact zeros,
// so skipping them changes no bit. The margin (1e-3 in the log domain) is
// far above the error of logf, expf and the product's rounding; with
// `audit` set, pass 1 counts the pairs the test kills although the full
// formula keeps them (the smoke requires 0).
//
// Tensor cores do not serve this walk: a pair's power is a 6-term
// quadratic form, and expanding it into a product cancels catastrophically
// in float32 at pixel coordinates in the hundreds; TF32 is off by the
// port's rule (device.py); the colour sum is 2C FMAs per live pair, fewer
// than the special functions beside it. The 16 KB staging copy is plain
// float4 loads: with one block per segment eight blocks are resident on an
// SM and hide each other's staging.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace csr_walk {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;  // pixels per tile = threads per block
constexpr int CSEG = 256;        // rows per segment
constexpr int N_ATTR = 16;       // [mx, my, a, b, c, op, col0..7, band, pad]
constexpr int BAND_COL = 14;
constexpr int THR_COL = 15;      // the staged copy's padding column: the row's threshold
constexpr int SEG_F4 = CSEG * N_ATTR / 4;  // float4s per segment
constexpr int AHEAD = 8;         // segments whose partials the combine loads at once
constexpr float LOG_EPS = -5.55f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;

template <int C, bool DUAL>
__global__ void __launch_bounds__(PX)
csr_partials_kernel(const float* __restrict__ rows, const int* __restrict__ seg_tile,
                    const int* __restrict__ seg_u0, const int* __restrict__ seg_v0,
                    int n_tiles, float margin, int* __restrict__ skip_from,
                    float* __restrict__ part, int* __restrict__ audit) {
  constexpr int NV = C + 1 + DUAL;
  __shared__ __align__(16) float seg[CSEG * N_ATTR];
  const int s = blockIdx.x;
  const int p = threadIdx.x;
  const int tile = seg_tile[s];
  if (tile >= n_tiles) return;  // a padding segment: never read
  // one thread reads the tile's published exit (L2, not a stale L1 line)
  if (__syncthreads_or(p == 0 && __ldcg(skip_from + tile) < s)) return;

  const float4* src = reinterpret_cast<const float4*>(rows) + static_cast<size_t>(s) * SEG_F4;
#pragma unroll
  for (int i = 0; i < SEG_F4 / PX; ++i) reinterpret_cast<float4*>(seg)[i * PX + p] = src[i * PX + p];
  __syncthreads();
  const float op = seg[p * N_ATTR + 5];
  seg[p * N_ATTR + THR_COL] = op <= 0.0f ? INFINITY : logf(ALPHA_MIN) - logf(op) - margin;
  __syncthreads();

  const float px = static_cast<float>(seg_u0[s] + p % TILE);
  const float py = static_cast<float>(seg_v0[s] + p / TILE);
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float excl = 0.0f;       // exclusive in-segment log prefix
  float excl_band = 0.0f;  // the same over alpha * band
  for (int j = 0; j < CSEG; ++j) {
    const float* r = seg + j * N_ATTR;
    const float dx = r[0] - px;
    const float dy = r[1] - py;
    const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
    if (power > 0.0f || power < r[THR_COL]) {  // dead: alpha is 0
      if (audit != nullptr && power <= 0.0f && fminf(r[5] * expf(power), ALPHA_MAX) >= ALPHA_MIN)
        atomicAdd(audit, 1);
      continue;
    }
    const float alpha = fminf(r[5] * expf(power), ALPHA_MAX);
    if (!(power <= 0.0f && alpha >= ALPHA_MIN)) continue;
    const float w = alpha * expf(excl);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += w * r[6 + c];
    excl += log1pf(-alpha);
    if (DUAL) {
      const float alpha_band = alpha * r[BAND_COL];
      if (alpha_band != 0.0f) excl_band += log1pf(-alpha_band);
    }
  }

  // this segment saturates its tile by itself: publish it (all threads
  // take part in the vote)
  if (!__syncthreads_or((DUAL ? excl_band : excl) >= LOG_EPS) && p == 0) atomicMin(skip_from + tile, s);

  float* out = part + (static_cast<size_t>(s) * PX + p) * NV;
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = acc[c];
  out[C] = excl;
  if (DUAL) out[C + 1] = excl_band;
}

// The combine of one tile whose `count` segments start at segment `start`
// of `part`, at pixel p (one thread a pixel; every thread of the block
// calls it for the same tile). The dense tile blend (blend_fwd.cu, B1)
// calls it with the arithmetic range tile * K/64 .. + K/64.
template <int C, bool DUAL>
__device__ __forceinline__ void combine_tile(const float* __restrict__ part, int start, int count,
                                             int tile, int p, float* __restrict__ accum,
                                             float* __restrict__ logt_out,
                                             float* __restrict__ band_out,
                                             float* __restrict__ entry) {
  constexpr int NV = C + 1 + DUAL;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float logt = 0.0f;
  float logt_band = 0.0f;

  if (count > 0) {
    const int end = start + count;
    int s = start;
    while (s < end) {
      // the partials of up to AHEAD segments, loaded before their exit
      // tests (those past the exit are loaded and not used)
      const int n = min(AHEAD, end - s);
      float q[AHEAD][NV];
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) {
        if (i < n) {
          const float* src = part + (static_cast<size_t>(s + i) * PX + p) * NV;
#pragma unroll
          for (int v = 0; v < NV; ++v) q[i][v] = src[v];
        }
      }
      // the exit carry at the entry of the chunk's last segment, summed as
      // the walk sums it: a pixel's carry never increases, so where one
      // pixel's is still >= LOG_EPS every segment of the chunk is walked
      // and one vote serves the chunk; else each segment votes. A step is
      // <= 0, so fminf keeps the sum bitwise; it also keeps the partials of
      // segments that pass 1 skipped (whatever the scratch held) from
      // lifting the probe: such a segment follows one whose step already
      // took every pixel below LOG_EPS
      float probe = DUAL ? logt_band : logt;
#pragma unroll
      for (int i = 0; i + 1 < AHEAD; ++i)
        if (i + 1 < n) probe = fminf(probe, probe + q[i][DUAL ? C + 1 : C]);
      const bool open = __syncthreads_or(probe >= LOG_EPS);
      int walked = 0;
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) {
        if (i >= n || !(open || __syncthreads_or((DUAL ? logt_band : logt) >= LOG_EPS))) break;
        if (entry != nullptr) entry[static_cast<size_t>(s + i) * PX + p] = logt;
        const float t = expf(logt);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += t * q[i][c];
        logt += q[i][C];
        if (DUAL) logt_band += q[i][C + 1];
        walked = i + 1;
      }
      s += walked;
      if (walked < n) break;  // the tile saturated
    }
    // the segments from the exit on keep the exit's logT in the stash
    if (entry != nullptr)
      for (; s < end; ++s) entry[static_cast<size_t>(s) * PX + p] = logt;
  }

  const size_t pix = static_cast<size_t>(tile) * PX + p;
#pragma unroll
  for (int c = 0; c < C; ++c) accum[pix * C + c] = acc[c];
  logt_out[pix] = logt;
  if (DUAL) band_out[pix] = logt_band;
}

template <int C, bool DUAL>
__global__ void __launch_bounds__(PX)
csr_combine_kernel(const float* __restrict__ part, const int* __restrict__ tile_start,
                   const int* __restrict__ tile_count, float* __restrict__ accum,
                   float* __restrict__ logt_out, float* __restrict__ band_out,
                   float* __restrict__ entry) {
  const int tile = blockIdx.x;  // count is uniform over the block
  combine_tile<C, DUAL>(part, tile_start[tile], tile_count[tile], tile, threadIdx.x, accum,
                        logt_out, band_out, entry);
}

// The launches, with C dispatched from the run-time channel count; each
// returns cudaGetLastError() (cudaErrorInvalidValue for C outside 1..8).
template <bool DUAL, int C = 1>
int launch_partials(int n_channels, int n_seg, cudaStream_t stream, const float* rows,
                    const int* seg_tile, const int* seg_u0, const int* seg_v0, int n_tiles,
                    float margin, int* skip_from, float* part, int* audit) {
  if constexpr (C > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (n_channels != C)
      return launch_partials<DUAL, C + 1>(n_channels, n_seg, stream, rows, seg_tile, seg_u0,
                                          seg_v0, n_tiles, margin, skip_from, part, audit);
    if (n_seg > 0)
      csr_partials_kernel<C, DUAL><<<n_seg, PX, 0, stream>>>(rows, seg_tile, seg_u0, seg_v0,
                                                              n_tiles, margin, skip_from, part,
                                                              audit);
    return static_cast<int>(cudaGetLastError());
  }
}

template <bool DUAL, int C = 1>
int launch_combine(int n_channels, int n_tiles, cudaStream_t stream, const float* part,
                   const int* tile_start, const int* tile_count, float* accum, float* logt,
                   float* logt_band, float* entry) {
  if constexpr (C > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (n_channels != C)
      return launch_combine<DUAL, C + 1>(n_channels, n_tiles, stream, part, tile_start,
                                         tile_count, accum, logt, logt_band, entry);
    if (n_tiles > 0)
      csr_combine_kernel<C, DUAL><<<n_tiles, PX, 0, stream>>>(part, tile_start, tile_count,
                                                               accum, logt, logt_band, entry);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace csr_walk
