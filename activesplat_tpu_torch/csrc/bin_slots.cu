// Bin slot search: the depth-ordered member ids at list positions
// [off, off + K) of every 16x16 tile.
//
// Replaces: activesplat_tpu/ops/raster_pallas.py, `_bin_slots_kernel` as
// called by `bin_slots_pallas` (TPU kernel B6).
//
// Inputs, per render: `cum` (T, nb) int32, each tile's inclusive cumsum over
// 128-Gaussian blocks of its member counts (Gaussians in depth order); `aabb`
// (nb * 128,) int32, one byte-packed tile AABB per Gaussian,
// tx0 << 24 | tx1 << 16 | ty0 << 8 | ty1, with tx0 = 255 for an invalid or
// padding Gaussian (an empty interval). Output (T, K) int64: for slot s, the
// id of the tile's (s+1)-th member, or the sentinel n past the tile's count.
//
// What bounds it on an H100: its integer work (per filled slot a block
// search and four compares for each of the block's 128 members) more than
// its bytes (each tile's cum row, the AABB words of the blocks its slots
// land in, 8 bytes per output slot); it does no floating-point work. Its
// time is latency: a binary search in shared memory and one 512-byte block
// load per slot, eight slots in flight per tile.
//
// Design: the Pallas kernel finds each slot's block with a flat (K, nb)
// compare and fetches the block's AABB rows by one-hot MXU products, and
// takes the in-block prefix as a triangular matmul, because Mosaic has no
// gather. Here one 256-thread block per tile stages the tile's cum row in
// shared memory (nb <= 4096 under the caller's gate: 16 KB), and one warp
// per slot (eight slots in flight per block, strided over K):
//   - the slot's block is the first b with cum[b] > s, by a binary search of
//     the staged row (every lane searches; the reads broadcast);
//   - prior = cum[b - 1], so the slot is the (s - prior)-th member (0-based)
//     of block b;
//   - the 128 AABB words of block b are read four per lane (coalesced), and
//     four __ballot_sync give the block's 128 membership bits in this tile;
//   - __popc over the four words finds the word holding the needed bit, and
//     one more ballot (the lane whose bit is set and has `need` set bits
//     below it) its position.
// A slot past the count writes n without touching the AABB words. No wgmma,
// TMA or shared-memory staging of the AABB words: every block is read by
// only the slots that land in it.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK = 128;          // Gaussians per block
constexpr int MAX_NB = 4096;      // the caller's gate on the block count
constexpr int THREADS = 256;      // eight warps, one slot each at a time
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
bin_slots_kernel(const int* __restrict__ cum, const int* __restrict__ aabb, int nb, int k,
                 int off, int tiles_x, int n, int64_t* __restrict__ out) {
  __shared__ int row[MAX_NB];
  const int tile = blockIdx.x;
  const int* src = cum + static_cast<size_t>(tile) * nb;
  for (int i = threadIdx.x; i < nb; i += THREADS) row[i] = src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ttx = tile % tiles_x;
  const int tty = tile / tiles_x;
  const int count = row[nb - 1];
  int64_t* dst = out + static_cast<size_t>(tile) * k;

  for (int j = warp; j < k; j += WARPS) {
    const int s = off + j;  // the global slot id (uniform over the warp)
    if (s >= count) {
      if (lane == 0) dst[j] = n;
      continue;
    }
    // first block whose inclusive count passes s
    int lo = 0, hi = nb - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] > s) hi = mid; else lo = mid + 1;
    }
    const int b = lo;
    int need = s - (b > 0 ? row[b - 1] : 0);  // members of block b before the slot

    const int* words = aabb + static_cast<size_t>(b) * BLK;
    unsigned mask[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int a = words[w * 32 + lane];
      const int tx0 = (a >> 24) & 0xff, tx1 = (a >> 16) & 0xff;
      const int ty0 = (a >> 8) & 0xff, ty1 = a & 0xff;
      const bool member = tx0 <= ttx && ttx <= tx1 && ty0 <= tty && tty <= ty1;
      mask[w] = __ballot_sync(FULL, member);
    }
    int pos = BLK;  // not found: one past the block, as the reference's count gives
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int c = __popc(mask[w]);
      if (need < c) {  // uniform: the masks are the warp's
        const bool hit = ((mask[w] >> lane) & 1u) && __popc(mask[w] & ((1u << lane) - 1u)) == need;
        pos = w * 32 + __ffs(__ballot_sync(FULL, hit)) - 1;
        break;
      }
      need -= c;
    }
    if (lane == 0) dst[j] = static_cast<int64_t>(b) * BLK + pos;
  }
}

}  // namespace

extern "C" int bin_slots(const void* cum, const void* aabb, int n_tiles, int nb, int k, int off,
                         int tiles_x, int n, void* out, void* stream) {
  if (nb > MAX_NB || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles > 0 && k > 0) {
    bin_slots_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cum), static_cast<const int*>(aabb), nb, k, off, tiles_x, n,
        static_cast<int64_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
