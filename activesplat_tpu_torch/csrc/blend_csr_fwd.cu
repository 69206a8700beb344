// CSR blend forward (B3): exact (uncapped) front-to-back alpha compositing of
// each 16x16 tile's whole depth-ordered list of Gaussian rows, with and
// without the per-segment entry log-transmittance stash (the backward's
// residual, written for every segment of a tile, skipped ones too; zero for
// padding segments, which the wrapper zero-fills). Tiles with no segment
// get zeros.
//
// Replaces: activesplat_tpu/ops/raster_pallas.py, `_blend_csr_kernel` as
// called by `_blend_csr_fwd_pallas` (TPU kernel B3).
//
// The walk, its bound and its design (one block per segment, then a
// per-tile combine) are in blend_csr_walk.cuh, shared with B5.
//
// C interface (loaded with ctypes): each entry point launches one pass and
// returns cudaGetLastError().

#include "blend_csr_walk.cuh"

extern "C" int blend_csr_fwd_partials(const void* rows, const void* seg_tile, const void* seg_u0,
                                      const void* seg_v0, int n_seg, int n_tiles, int n_channels,
                                      float margin, void* skip_from, void* part, void* audit,
                                      void* stream) {
  return csr_walk::launch_partials<false>(
      n_channels, n_seg, static_cast<cudaStream_t>(stream), static_cast<const float*>(rows),
      static_cast<const int*>(seg_tile), static_cast<const int*>(seg_u0),
      static_cast<const int*>(seg_v0), n_tiles, margin, static_cast<int*>(skip_from),
      static_cast<float*>(part), static_cast<int*>(audit));
}

extern "C" int blend_csr_fwd_combine(const void* part, const void* tile_start,
                                     const void* tile_count, int n_tiles, int n_channels,
                                     void* accum, void* logt, void* entry, void* stream) {
  return csr_walk::launch_combine<false>(
      n_channels, n_tiles, static_cast<cudaStream_t>(stream), static_cast<const float*>(part),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<float*>(accum), static_cast<float*>(logt), nullptr, static_cast<float*>(entry));
}
