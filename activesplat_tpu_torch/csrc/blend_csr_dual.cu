// Dual CSR blend forward (B5): B3's exact front-to-back compositing of each
// 16x16 tile's whole depth-ordered list, carrying a second
// log-transmittance composited over the alphas masked by each row's band
// bit (column 14, 0 or 1). One walk serves both top-down maps: the whole
// map's colour and transmittance, and the height-sliced map's
// transmittance. The whole-tile exit tests the band carry alone (band
// alpha <= alpha, so band saturation implies full saturation, and the full
// composite walks on past its own saturation until then). Tiles with no
// segment get zeros.
//
// Replaces: activesplat_tpu/ops/raster_pallas.py, `_blend_csr_dual_kernel`
// as called by `blend_csr_dual_pallas` (TPU kernel B5).
//
// The walk, its bound and its design (one block per segment, then a
// per-tile combine) are in blend_csr_walk.cuh, shared with B3: the band
// carry is bitwise B3's logT over the band-masked rows, and with every band
// bit set (accum, logT) is bitwise B3's.
//
// C interface (loaded with ctypes): each entry point launches one pass and
// returns cudaGetLastError().

#include "blend_csr_walk.cuh"

extern "C" int blend_csr_dual_partials(const void* rows, const void* seg_tile, const void* seg_u0,
                                       const void* seg_v0, int n_seg, int n_tiles, int n_channels,
                                       float margin, void* skip_from, void* part, void* audit,
                                       void* stream) {
  return csr_walk::launch_partials<true>(
      n_channels, n_seg, static_cast<cudaStream_t>(stream), static_cast<const float*>(rows),
      static_cast<const int*>(seg_tile), static_cast<const int*>(seg_u0),
      static_cast<const int*>(seg_v0), n_tiles, margin, static_cast<int*>(skip_from),
      static_cast<float*>(part), static_cast<int*>(audit));
}

extern "C" int blend_csr_dual_combine(const void* part, const void* tile_start,
                                      const void* tile_count, int n_tiles, int n_channels,
                                      void* accum, void* logt, void* logt_band, void* stream) {
  return csr_walk::launch_combine<true>(
      n_channels, n_tiles, static_cast<cudaStream_t>(stream), static_cast<const float*>(part),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<float*>(accum), static_cast<float*>(logt), static_cast<float*>(logt_band),
      nullptr);
}
