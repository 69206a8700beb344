// The row gathers' backward: the gradient of table[ids] with respect to an
// (N+1, W) float32 table whose last row N pads the blends' lists, each row
// the sum of the incoming gradient rows gathered from it.
//
// Replaces: activesplat_tpu/ops/raster_pallas.py holds no kernel for this
// step. The JAX package gathers the rows with `pad_data[global_ids]`
// (activesplat_tpu/ops/raster_tiled.py) and XLA lowers the gather's
// backward, a scatter-add. Here it takes the place of PyTorch's own index
// backward (`_index_put_impl_` with accumulate, whose sorted kernel sums
// each row's duplicates in one thread: the padding row's run, a fifth of
// the rows at 512x512, is one serial chain).
//
// The caller (ops/raster_cuda.py, gather_rows_bwd) orders the ids first in
// plain PyTorch on the device, with no host sync: a stable sort of the ids
// as int32 keys gives `perm` (R,) int64, the gathered rows' positions in id
// order, and a search of the sorted keys gives `starts` (N+1,) int32, the
// first sorted position of each table row g. Row g < N sums the rows
// perm[starts[g]] .. perm[starts[g+1] - 1].
//
// gather_rows_bwd_kernel: one thread per element (g, c) of the table
// gradient, so that the writes are coalesced and every element is written
// exactly once: a row with no entry gets zero (no separate zero fill), and
// row N gets zero without its run being read (its gradient is dropped by
// the caller: the padding row is built from constants). Each thread sums
// its run in position order from zero, the order of the library's sorted
// kernel, so rows below N have its bits; the loads of a run are issued
// UNROLL at a time ahead of the adds, which keep their order. No atomics:
// the result is the same from run to run. The incoming gradient is read
// through its row stride (the 11 live columns of the blends' 16-wide rows:
// no contiguous copy first). Ids outside [0, N] fall outside every run and
// are dropped.
//
// What bounds it on an H100: bytes. It reads the incoming gradient rows (R
// x W float32), the ids' positions (R int64) and writes the table once
// ((N+1) x W float32); one add per gathered element. A run is one thread's
// dependent chain of adds, so the longest non-padding run (a Gaussian in
// every tile of a window: up to T rows) sets the tail.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after its
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;  // loads of a run in flight ahead of their adds

__global__ void __launch_bounds__(THREADS)
gather_rows_bwd_kernel(const float* __restrict__ grad, int64_t row_stride,
                       const int64_t* __restrict__ perm, const int* __restrict__ starts,
                       int n_rows, int width, float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= static_cast<int64_t>(n_rows) * width) {
    return;
  }
  const int g = static_cast<int>(e / width);
  const int c = static_cast<int>(e - static_cast<int64_t>(g) * width);
  float acc = 0.0f;
  if (g < n_rows - 1) {  // row N, the padding row, stays zero
    const float* col = grad + c;
    int j = starts[g];
    const int end = starts[g + 1];
    for (; j + UNROLL <= end; j += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        v[u] = col[perm[j + u] * row_stride];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        acc += v[u];
      }
    }
    for (; j < end; ++j) {
      acc += col[perm[j] * row_stride];
    }
  }
  out[e] = acc;
}

}  // namespace

extern "C" int gather_rows_bwd(const void* grad, int64_t row_stride, const void* perm,
                               const void* starts, int n_rows, int width, void* out,
                               void* stream) {
  const int64_t total = static_cast<int64_t>(n_rows) * width;
  if (n_rows < 1 || width < 1 || row_stride < 0 || total >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  gather_rows_bwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad), row_stride, static_cast<const int64_t*>(perm),
      static_cast<const int*>(starts), n_rows, width, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
