// The bin kernel route (B6): per-(block, tile) member counts, then the
// depth-ordered member ids at list positions [off, off + K) of every 16x16
// tile. Two kernels; between them the caller takes torch.cumsum of the
// counts over blocks.
//
// Replaces: activesplat_tpu/ops/raster_pallas.py, `_bin_slots_kernel` as
// called by `bin_slots_pallas` (TPU kernel B6), and the counting front that
// feeds it in activesplat_tpu/ops/raster_tiled.py (the int8 interval
// einsum and the byte planes).
//
// Gaussians are in depth order and cut into blocks of 128 (nb blocks, the
// last padded). A tile's member ranks are numbered in that order.
//
// Pass 1, bin_count_kernel: one 128-thread block per 128-Gaussian block,
// a thread per Gaussian. Inputs: `valid` (N,) bool and the tile bounds tx0,
// tx1, ty0, ty1 (N,) float32, integral and clamped to the grid (the
// caller's tile_aabbs). Outputs: `words` (nb * 128,) int32, one packed AABB
// per Gaussian, tx0 << 24 | tx1 << 16 | ty0 << 8 | ty1, and 0xff000000
// (tx0 = 255 > tx1 = 0, an empty interval, as the reference's byte planes
// give) for an invalid Gaussian and the padding;
// `counts` (nb, T) int32, row b the members of block b in each tile. The
// block adds its members' rectangles into a shared-memory histogram with
// shared atomics (a count is order-free, so they give it exactly), a chunk
// of CHUNK tiles at a time (any T), and writes each chunk as a coalesced
// row segment.
//
// Pass 2, bin_slots_kernel: 128-thread CTAs, each taking one 128-Gaussian
// block b and a range of `per` tiles (per = T, halved down to 32 while the
// blocks give fewer than MIN_CTAS CTAs: a small visible prefix still fills
// the card). Input `cum` (nb, T) int32, the inclusive cumsum of `counts`
// over blocks (the reference's layout), and `words`. Output (T, K) int64:
// slot j of tile t holds the id of the member of rank off + j, or the
// sentinel n at and past the tile's count. Block b's members of tile t have
// ranks [lo, hi) with lo = cum[b - 1, t] (0 for b = 0) and hi = cum[b, t];
// the tile is in the block's window when hi > lo, lo < off + K and hi >
// off. The CTA loads the block's 128 words once, one a thread, reads its
// two cum row segments (coalesced) and gathers the tiles in its window into
// a shared list (a ballot a warp); each warp then takes a listed tile,
// tests the block's 128 Gaussians against it (four compares each), and
// four ballots give their membership bits: a member's rank is its popcount
// below its lane plus the members of the groups of 32 before it, in
// Gaussian order, and it writes its id to slot lo + rank - off when that
// lies in [0, K). Every slot is written by exactly one thread: no atomics
// on the output, nothing depends on the order of CTAs or of the list. The
// sentinels are written by a tail of the same grid, a thread per slot.
// Nothing else is read: no slot search, no transpose of cum.
//
// What bounds it on an H100: neither pass does floating-point work. Pass 1
// moves its inputs (17 bytes a Gaussian) and writes nb x T counts; its
// integer work is one shared increment per (Gaussian, tile of its
// rectangle). Pass 2 moves the words of the blocks in some tile's window,
// two cum entries per (tile, block) pair and the int64 output; its work is
// four compares per Gaussian of each pair in a window and one per slot.
// Both are latency-bound at the main path's sizes: a few thousand blocks of
// a few microseconds each.
//
// C interface (loaded with ctypes): each returns cudaGetLastError() after
// its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK = 128;       // Gaussians per block, a thread each
constexpr int MAX_NB = 4096;   // the caller's gate on the block count
constexpr int WARPS = BLK / 32;
constexpr int CHUNK = 4096;    // tiles of one histogram pass of bin_count_kernel (16 KB)
constexpr int LIST = 1024;     // tiles scanned for one window list of bin_slots_kernel
constexpr int MIN_CTAS = 1024; // bin_slots_kernel's CTAs over the Gaussian blocks, at least
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(BLK)
bin_count_kernel(const unsigned char* __restrict__ valid, const float* __restrict__ tx0,
                 const float* __restrict__ tx1, const float* __restrict__ ty0,
                 const float* __restrict__ ty1, int n, int tiles_x, int n_tiles,
                 int* __restrict__ words, int* __restrict__ counts) {
  __shared__ int hist[CHUNK];
  const int b = blockIdx.x;
  const int g = b * BLK + threadIdx.x;
  int x0 = 1, x1 = 0, y0 = 1, y1 = 0;  // an empty rectangle: padding and invalid
  unsigned word = 0xff000000u;
  if (g < n && valid[g]) {
    const int a0 = static_cast<int>(tx0[g]), a1 = static_cast<int>(tx1[g]);
    const int c0 = static_cast<int>(ty0[g]), c1 = static_cast<int>(ty1[g]);
    word = static_cast<unsigned>(a0) << 24 | static_cast<unsigned>(a1) << 16 |
           static_cast<unsigned>(c0) << 8 | static_cast<unsigned>(c1);
    // clipped to the grid, so that a row never spills into the next
    x0 = max(a0, 0);
    x1 = min(a1, tiles_x - 1);
    y0 = max(c0, 0);
    y1 = c1;
  }
  words[g] = static_cast<int>(word);

  int* row = counts + static_cast<size_t>(b) * n_tiles;
  for (int first = 0; first < n_tiles; first += CHUNK) {
    const int len = min(CHUNK, n_tiles - first);
    for (int i = threadIdx.x; i < len; i += BLK) hist[i] = 0;
    __syncthreads();
    if (x0 <= x1) {
      // the rows of the rectangle that meet this chunk; each tile lies in
      // exactly one chunk, so no tile is counted twice
      const int r0 = max(y0, first / tiles_x);
      const int r1 = min(y1, (first + len - 1) / tiles_x);
      for (int y = r0; y <= r1; ++y) {
        const int base = y * tiles_x - first;  // chunk index of tile (0, y)
        const int lo = max(x0, -base), hi = min(x1, len - 1 - base);
        for (int x = lo; x <= hi; ++x) atomicAdd(&hist[base + x], 1);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += BLK) row[first + i] = hist[i];
    __syncthreads();  // the histogram is cleared for the next chunk
  }
}

__global__ void __launch_bounds__(BLK)
bin_slots_kernel(const int* __restrict__ cum, const int* __restrict__ words, int nb, int n_tiles,
                 int k, int off, int tiles_x, int n, int per, int64_t* __restrict__ out) {
  const int chunks = (n_tiles + per - 1) / per;
  if (blockIdx.x >= nb * chunks) {  // the tail: a thread per slot, n at and past the count
    const int i = (blockIdx.x - nb * chunks) * BLK + threadIdx.x;  // T * K < 2^31
    if (i < n_tiles * k) {
      const int t = i / k, j = i % k;
      if (off + j >= cum[static_cast<size_t>(nb - 1) * n_tiles + t]) out[i] = n;
    }
    return;
  }
  __shared__ int word_s[BLK];
  __shared__ int list_t[LIST];
  __shared__ int list_lo[LIST];
  __shared__ int list_n;
  const int b = blockIdx.x % nb;  // this CTA: Gaussian block b, tiles [t0, t1)
  const int t0 = blockIdx.x / nb * per;
  const int t1 = min(t0 + per, n_tiles);
  word_s[threadIdx.x] = words[b * BLK + threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int wr[WARPS];  // the block's 128 words, lane l holding word g * 32 + l of group g
#pragma unroll
  for (int g = 0; g < WARPS; ++g) wr[g] = word_s[g * 32 + lane];
  const int* cur = cum + static_cast<size_t>(b) * n_tiles;
  const int* prev = cur - n_tiles;  // read only for b > 0
  const int end = off + k;

  for (int first = t0; first < t1; first += LIST) {
    if (threadIdx.x == 0) list_n = 0;
    __syncthreads();
    const int last = min(first + LIST, t1);
    for (int base = first + warp * 32; base < last; base += BLK) {  // uniform over the warp
      const int t = base + lane;
      bool in = false;
      int lo = 0;
      if (t < last) {
        const int hi = cur[t];
        lo = b > 0 ? prev[t] : 0;
        in = hi > lo && lo < end && hi > off;  // some member's rank lies in the window
      }
      const unsigned mask = __ballot_sync(FULL, in);
      int at = 0;
      if (lane == 0 && mask) at = atomicAdd(&list_n, __popc(mask));
      at = __shfl_sync(FULL, at, 0) + __popc(mask & below);
      if (in) {
        list_t[at] = t;
        list_lo[at] = lo;
      }
    }
    __syncthreads();
    const int m = list_n;  // uniform over the block
    for (int e = warp; e < m; e += WARPS) {  // uniform over the warp
      const int t = list_t[e];
      const int ttx = t % tiles_x, tty = t / tiles_x;
      int base = list_lo[e] - off;  // the slot of the block's first member of t
      int64_t* dst = out + static_cast<size_t>(t) * k;
#pragma unroll
      for (int g = 0; g < WARPS; ++g) {
        const int a = wr[g];
        const bool member = ((a >> 24) & 0xff) <= ttx && ttx <= ((a >> 16) & 0xff) &&
                            ((a >> 8) & 0xff) <= tty && tty <= (a & 0xff);
        const unsigned mask = __ballot_sync(FULL, member);
        if (member) {
          const int slot = base + __popc(mask & below);
          if (slot >= 0 && slot < k) dst[slot] = static_cast<int64_t>(b) * BLK + g * 32 + lane;
        }
        base += __popc(mask);
      }
    }
    __syncthreads();  // the list is rewritten by the next chunk
  }
}

}  // namespace

extern "C" int bin_count(const void* valid, const void* tx0, const void* tx1, const void* ty0,
                         const void* ty1, int n, int tiles_x, int n_tiles, void* words,
                         void* counts, void* stream) {
  const int nb = (n + BLK - 1) / BLK;
  if (nb > MAX_NB || nb < 1 || tiles_x < 1 || n_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bin_count_kernel<<<nb, BLK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(valid), static_cast<const float*>(tx0),
      static_cast<const float*>(tx1), static_cast<const float*>(ty0),
      static_cast<const float*>(ty1), n, tiles_x, n_tiles, static_cast<int*>(words),
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bin_slots(const void* cum, const void* words, int nb, int n_tiles, int k, int off,
                         int tiles_x, int n, void* out, void* stream) {
  const int64_t slots = static_cast<int64_t>(n_tiles) * k;
  if (nb > MAX_NB || nb < 1 || tiles_x < 1 || slots >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (slots > 0) {
    // tiles a CTA scans: halved (down to a warp's 32) until the Gaussian
    // blocks give MIN_CTAS CTAs, so that a small nb still fills the card
    int per = n_tiles;
    while (per > 32 && static_cast<int64_t>(nb) * ((n_tiles + per - 1) / per) < MIN_CTAS) {
      per = (per + 1) / 2;
    }
    const int64_t grid = static_cast<int64_t>(nb) * ((n_tiles + per - 1) / per) +
                         (slots + BLK - 1) / BLK;
    bin_slots_kernel<<<static_cast<unsigned>(grid), BLK, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cum), static_cast<const int*>(words), nb, n_tiles, k, off,
        tiles_x, n, per, static_cast<int64_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
