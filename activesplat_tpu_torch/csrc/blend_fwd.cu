// Tile blend forward: front-to-back alpha compositing of each 16x16 tile's
// depth-ordered Gaussian rows, with and without the per-segment entry
// log-transmittance stash (the backward's residual).
//
// Replaces: activesplat_tpu/ops/raster_pallas.py, `_blend_kernel` as called
// by `_blend_fwd_pallas` (TPU kernel B1).
//
// What bounds it on an H100: not memory. A tile reads K rows of 64 bytes
// (16 KB at K=256) and writes 256 pixels x (C + 1 + K/64) floats, about 6 MB
// for 256 tiles, 2 us at 3.35 TB/s. The function needs the power of every
// (row, pixel) pair of a walked segment (11 float32 operations) and, only
// where alpha is not zero, two exp and one log1p (special-function work) and
// 4 + 2C float32 operations more: compute bounds it. About one pair in nine
// of a walked segment is live in the main path's rows, and one 8x4-pixel
// warp-row in five holds a live pair.
//
// Design. The Pallas kernel walks a tile's SEG=64-row segments in order in
// one grid step, carrying logT from segment to segment. Hopper's blocks run
// in parallel and carry nothing between them, so the walk is split in two
// launches, made by one C call (blend_tiles_fwd):
//   Pass 1 (tile_fwd_partials_kernel), one 256-thread block per (tile,
//   segment): 4 blocks a tile at K=256, 16 at K=1,024. Blocks are numbered
//   rank-major, blockIdx.x = s * T + tile, so that every tile's first
//   segments are scheduled before any tile's later ones. The block stages
//   its 64 rows (4 KB) with each row's dead-pair threshold and warp reach
//   mask (blend_bwd_walk.cuh's stage_rows) and composites the segment by
//   itself from transmittance 1, summing its rows in order with the
//   exclusive log prefix carried in a register. Per pixel it writes the
//   colour partial P[c] = sum_j alpha_j exp(excl_j) col_j[c] and the log
//   step L = sum_j log1p(-alpha_j): (T, K/SEG, PX, C + 1) float32.
//   Pass 2 (tile_fwd_combine_kernel), one block per tile: B3's per-tile
//   combine (blend_csr_walk.cuh's combine_tile) over the tile's K/SEG
//   segments, whose range is arithmetic (no per-tile map is built). At each
//   segment start the whole-tile exit (every pixel's logT below LOG_EPS) is
//   voted with __syncthreads_or; the stash takes the entry logT for every
//   segment, skipped ones included (the backward re-derives the skip from
//   it); then accum += exp(logT) P and logT += L.
// L is the one-block-per-tile walk's in-segment sum and the combine adds the
// steps in that walk's order, so logT, the stash and every exit decision are
// that walk's bitwise; only accum is reassociated (exp(logT) sum in place of
// sum exp(excl + logT)). Two launches, not one with a per-tile arrival
// counter, for the reasons blend_csr_walk.cuh gives.
//
// Pixels: thread p holds pixel local_pixel(p), warp w the 8x4-pixel block
// at x = 8 (w % 2), y = 4 (w / 2), as B2's walk does; fewer warps straddle
// a Gaussian's edge than with 16x2 strips.
//
// Dead work: per row, thr = log(ALPHA_MIN) - log(op) - margin (+inf for op
// <= 0, so padding rows are dead). A pair with power > 0 or power < thr has
// alpha 0 by the full formula; it skips both expf, the log1pf and the C
// FMAs. Its contribution and log step were exact zeros, so skipping them
// changes no bit. A warp that the row's reach mask rules out (the ellipse
// power >= thr misses its pixel block) skips the row at once (in the main
// path's rows four warp-rows in five). With `audit` set every pair is
// evaluated, and the live pairs that the test or the mask kills are
// counted (the smoke requires 0); the audit is a template parameter, so the
// kernel that the wrapper launches carries none of its code in the loop.
//
// What sets pass 1: the live warp-rows' arithmetic (expf, log1pf, expf and
// C FMAs); the smoke times the pass walking no row beside the whole.
// Variants tried on the card and not kept:
// the rows that reach a warp gathered by ballot and visited by bit scans;
// each lane walking only its own live rows (divergence is not what costs);
// two rows an iteration (nor is latency); the partials' stores coalesced
// through shared memory (they drain behind other blocks' work).
//
// Segments the exit already rules out: logT never increases and an entry
// logT is at most 0, so once a segment's own max_p L < LOG_EPS every later
// segment of its tile is skipped by the combine (round-to-nearest is
// monotonic: fl(a + b) <= b for a <= 0). Such a block publishes its index
// with atomicMin on skip_from[tile] (reset by the C call); the vote takes no
// block barrier (each warp adds to a shared word and the last one to finish
// decides), so every warp stores its partials as soon as it is done. A
// later block of the tile that reads a smaller index skips its walk and
// writes nothing. The combine stops at or before every such segment, so the
// output does not depend on the schedule. In rank-major order the later
// segments at K=1,024 start after the first ones have published.
//
// Tensor cores do not serve this walk (blend_csr_walk.cuh says why).
//
// C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after its launches (cudaErrorInvalidValue for C
// outside 1..8).

#include "blend_bwd_walk.cuh"
#include "blend_csr_walk.cuh"

using namespace bwd_walk;

namespace {

constexpr unsigned VOTE_DONE = 16;  // > N_WARPS: the saturated count stays in the low bits

template <int C, bool AUDIT>
__global__ void __launch_bounds__(PX)
tile_fwd_partials_kernel(const float* __restrict__ rows, const int* __restrict__ u0,
                         const int* __restrict__ v0, int n_tiles, int n_seg, float margin,
                         unsigned reach_and, int* __restrict__ skip_from,
                         float* __restrict__ part, int* __restrict__ audit) {
  __shared__ __align__(16) float seg[SEG * N_ATTR];
  __shared__ unsigned votes;  // VOTE_DONE for each warp that is done, plus 1 if it saturated
  const int s = blockIdx.x / n_tiles;  // rank-major: each tile's s-th segment
  const int tile = blockIdx.x % n_tiles;
  const int p = threadIdx.x;
  // one thread reads the tile's published exit (L2, not a stale L1 line)
  if (__syncthreads_or(p == 0 && __ldcg(skip_from + tile) < s)) return;
  if (p == 0) votes = 0;  // stage_rows' barriers publish it
  const float x0 = static_cast<float>(u0[tile]);
  const float y0 = static_cast<float>(v0[tile]);
  stage_rows(rows, (static_cast<size_t>(tile) * n_seg + s) * SEG, seg, margin, x0, y0, p);

  const unsigned warp_bit = 1u << (p / 32);
  const int lp = local_pixel(p);
  const float px = x0 + static_cast<float>(lp % TILE);
  const float py = y0 + static_cast<float>(lp / TILE);
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float excl = 0.0f;  // exclusive in-segment log prefix
#pragma unroll 2
  for (int j = 0; j < SEG; ++j) {
    const float* r = seg + j * N_ATTR;
    const bool reached = __float_as_uint(r[REACH_COL]) & reach_and & warp_bit;
    if (!AUDIT && !reached) continue;  // the whole warp is dead for this row
    float dx, dy;
    const float power = pair_power(r, px, py, dx, dy);
    if (!reached || power > 0.0f || power < r[THR_COL]) {  // dead: alpha is 0
      if (AUDIT && power <= 0.0f && fminf(r[5] * expf(power), ALPHA_MAX) >= ALPHA_MIN)
        atomicAdd(audit, 1);
      continue;
    }
    const float alpha = fminf(r[5] * expf(power), ALPHA_MAX);
    if (!(power <= 0.0f && alpha >= ALPHA_MIN)) continue;
    const float w = alpha * expf(excl);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += w * r[6 + c];
    excl += log1pf(-alpha);
  }

  // this segment saturates its tile by itself: publish it. No block barrier:
  // each warp adds its vote to a shared word, and the last warp to finish
  // publishes if all saturated
  const unsigned saturated = !__any_sync(FULL, excl >= LOG_EPS);
  if (p % 32 == 0 && atomicAdd(&votes, VOTE_DONE + saturated) == (VOTE_DONE + 1) * (N_WARPS - 1) &&
      saturated)
    atomicMin(skip_from + tile, s);

  float* out = part + ((static_cast<size_t>(tile) * n_seg + s) * PX + lp) * (C + 1);
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = acc[c];
  out[C] = excl;
}

template <int C>
__global__ void __launch_bounds__(PX)
tile_fwd_combine_kernel(const float* __restrict__ part, int n_seg, float* __restrict__ accum,
                        float* __restrict__ logt, float* __restrict__ entry) {
  const int tile = blockIdx.x;
  csr_walk::combine_tile<C, false>(part, tile * n_seg, n_seg, tile, threadIdx.x, accum, logt,
                                   nullptr, entry);
}

// Pass 1 after resetting the tile's exit words (bytes 0x7f: a large index).
int partials(const float* rows, const int* u0, const int* v0, int n_tiles, int k, int n_channels,
             float margin, unsigned reach_and, int* skip_from, float* part,
             int* audit, cudaStream_t stream) {
  const int n_seg = k / SEG;
  if (n_tiles == 0 || n_seg == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(skip_from, 0x7f, sizeof(int) * n_tiles, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return with_channels(n_channels, [&](auto c) {
    constexpr int C = decltype(c)::value;
    const auto kernel = audit == nullptr ? tile_fwd_partials_kernel<C, false>
                                         : tile_fwd_partials_kernel<C, true>;
    kernel<<<n_tiles * n_seg, PX, 0, stream>>>(rows, u0, v0, n_tiles, n_seg, margin, reach_and,
                                               skip_from, part, audit);
    return static_cast<int>(cudaGetLastError());
  });
}

int combine(const float* part, int n_tiles, int k, int n_channels, float* accum, float* logt,
            float* entry, cudaStream_t stream) {
  const int n_seg = k / SEG;
  return with_channels(n_channels, [&](auto c) {
    constexpr int C = decltype(c)::value;
    if (n_tiles > 0 && n_seg > 0)
      tile_fwd_combine_kernel<C><<<n_tiles, PX, 0, stream>>>(part, n_seg, accum, logt, entry);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// B1, both passes: `part` (T, K/SEG, PX, C + 1) and `skip_from` (T,) are
// scratch; `entry` (T, K/SEG, PX) may be null (no stash).
extern "C" int blend_tiles_fwd(const void* rows, const void* u0, const void* v0, int n_tiles,
                               int k, int n_channels, void* skip_from, void* part, void* accum,
                               void* logt, void* entry, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int err = partials(static_cast<const float*>(rows), static_cast<const int*>(u0),
                           static_cast<const int*>(v0), n_tiles, k, n_channels, DEAD_MARGIN,
                           ALL_WARPS, static_cast<int*>(skip_from), static_cast<float*>(part),
                           nullptr, st);
  if (err != 0) return err;
  return combine(static_cast<const float*>(part), n_tiles, k, n_channels,
                 static_cast<float*>(accum), static_cast<float*>(logt),
                 static_cast<float*>(entry), st);
}

// Pass 1 alone. Each row's warp mask is taken as mask & reach_and:
// ALL_WARPS as the kernel runs; a bit cleared from reach_and drops that warp
// (a planted fault the audit must catch). `audit` may be null.
extern "C" int tile_fwd_partials(const void* rows, const void* u0, const void* v0, int n_tiles,
                                 int k, int n_channels, float margin, int reach_and,
                                 void* skip_from, void* part, void* audit, void* stream) {
  return partials(static_cast<const float*>(rows), static_cast<const int*>(u0),
                  static_cast<const int*>(v0), n_tiles, k, n_channels, margin,
                  static_cast<unsigned>(reach_and), static_cast<int*>(skip_from),
                  static_cast<float*>(part), static_cast<int*>(audit),
                  static_cast<cudaStream_t>(stream));
}

// Pass 2 alone; `entry` may be null.
extern "C" int tile_fwd_combine(const void* part, int n_tiles, int k, int n_channels, void* accum,
                                void* logt, void* entry, void* stream) {
  return combine(static_cast<const float*>(part), n_tiles, k, n_channels,
                 static_cast<float*>(accum), static_cast<float*>(logt),
                 static_cast<float*>(entry), static_cast<cudaStream_t>(stream));
}

// out[0:5] pass 1 (as the wrapper launches it), out[5:10] pass 2, each:
// registers a thread, static and dynamic shared bytes a block, local
// (spill) bytes a thread, resident blocks per SM at 256 threads.
extern "C" int tile_fwd_occupancy(int n_channels, void* out) {
  int* o = static_cast<int*>(out);
  return with_channels(n_channels, [&](auto c) {
    constexpr int C = decltype(c)::value;
    cudaError_t err = kernel_occupancy(tile_fwd_partials_kernel<C, false>, o);
    if (err == cudaSuccess) err = kernel_occupancy(tile_fwd_combine_kernel<C>, o + 5);
    return static_cast<int>(err);
  });
}
