// CSR blend backward: the analytic gradient of blend_csr_fwd.cu with respect
// to every entry row [mx, my, a, b, c, op, col0..7].
//
// Replaces: activesplat_tpu/ops/raster_pallas.py, `_blend_csr_bwd_kernel` as
// called by `_blend_csr_bwd_pallas` (TPU kernel B4).
//
// What bounds it on an H100: not memory. A walked segment reads its 16 KB of
// rows and one 1 KB stash row and writes 16 KB of gradients; each tile reads
// its pixel cotangents once. The function needs, per (row, pixel) pair whose
// alpha is not zero, three special-function results (exp of the power,
// log1p(-alpha), exp of the prefix logT) and about 50 float32 operations at
// C=5, the pixel sums of the row's gradients included: the float32 rate
// bounds it. This kernel spends six special-function calls on every pair of
// a walked segment, live or not: expf and log1pf twice in the two prefix
// passes below, expf of the power and of the prefix in the walk.
//
// Design: one 256-thread block per tile, one thread per pixel, walking the
// tile's segments back to front from the forward's stashed entry logT (the
// Pallas kernel runs one grid step per segment in reverse order and resets
// its suffix carry at each tile's last segment; here the carry is a register
// that starts at zero for the block's tile). A segment whose stashed entry
// logT is below LOG_EPS at every pixel was skipped by the forward and gets
// zero rows; the skip is decided per 256-row segment, as the forward's exit.
// The exclusive in-segment log prefix of a 256-row segment would take
// 256 KB of shared memory (256 rows x 256 pixels), more than a block may
// have, so a walked segment is split into four 64-row sub-chunks: one pass
// over the segment's 256 alphas records each thread's log prefix at the
// start of every sub-chunk, then the sub-chunks are walked back to front,
// each with B2's body: the sub-chunk's exclusive prefix recomputed into
// 64 KB of dynamic shared memory (its own column per thread, summed in the
// same sequential order as the forward, so bitwise the forward's prefix),
// then the rows walked back to front carrying the suffix colour-dot
//     B_k(p) = sum_{j>k} w_j(p) (col_j . g_accum(p))
// in a register:
//     dL/dalpha_k = T_k s_k - (B_k + g_logT) / max(1 - alpha_k, 1/256),
// chained through alpha = min(op exp(power), 0.99) as the Pallas kernel does
// (raster_pallas.py:674-730). Each row's 14 gradients are reduced over the
// tile's pixels with warp shuffles into per-warp partials in shared memory,
// which one pass after each sub-chunk sums in a fixed order (deterministic;
// every entry row belongs to one tile, so no atomics).
//
// C interface (loaded with ctypes): returns cudaGetLastError() after launch.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int CSEG = 256;             // rows per segment (the skip granularity)
constexpr int SUB = 64;               // rows per sub-chunk
constexpr int N_SUB = CSEG / SUB;
constexpr int N_ATTR = 16;
constexpr int MAX_C = 8;
constexpr int N_GRAD = 6 + MAX_C;     // d(mx, my, a, b, c, op, col0..7)
constexpr int N_WARPS = PX / 32;
constexpr int SEG_F4 = CSEG * N_ATTR / 4;
constexpr float LOG_EPS = -5.55f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;

constexpr size_t SMEM_BYTES = sizeof(float) * (CSEG * N_ATTR + N_SUB * PX + SUB * PX +
                                               SUB * N_WARPS * N_GRAD);

__device__ __forceinline__ float row_alpha(const float* r, float px, float py) {
  const float dx = r[0] - px;
  const float dy = r[1] - py;
  const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
  const float alpha = fminf(r[5] * expf(power), ALPHA_MAX);
  return (power <= 0.0f && alpha >= ALPHA_MIN) ? alpha : 0.0f;
}

__global__ void __launch_bounds__(PX)
blend_csr_bwd_kernel(const float* __restrict__ rows, const int* __restrict__ seg_u0,
                     const int* __restrict__ seg_v0, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, const float* __restrict__ entry,
                     const float* __restrict__ g_accum, const float* __restrict__ g_logt,
                     int n_channels, float* __restrict__ d_rows) {
  extern __shared__ __align__(16) float smem[];
  float* seg = smem;                        // (CSEG, N_ATTR) staged rows
  float* sub_entry = seg + CSEG * N_ATTR;   // (N_SUB, PX) prefix at each sub-chunk start
  float* prefix = sub_entry + N_SUB * PX;   // (SUB, PX) exclusive log prefix
  float* partial = prefix + SUB * PX;       // (SUB, N_WARPS, N_GRAD)

  const int tile = blockIdx.x;
  const int count = tile_count[tile];  // uniform over the block
  if (count == 0) return;
  const int start = tile_start[tile];
  const int p = threadIdx.x;
  const int lane = p % 32;
  const int warp = p / 32;
  const float px = static_cast<float>(seg_u0[start] + p % TILE);
  const float py = static_cast<float>(seg_v0[start] + p / TILE);
  const size_t pix = static_cast<size_t>(tile) * PX + p;

  float g[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) g[c] = c < n_channels ? g_accum[pix * n_channels + c] : 0.0f;
  const float glt = g_logt[pix];
  float b_suffix = 0.0f;

  for (int s = start + count - 1; s >= start; --s) {
    const float logt_in = entry[static_cast<size_t>(s) * PX + p];
    float4* d_out = reinterpret_cast<float4*>(d_rows) + static_cast<size_t>(s) * SEG_F4;
    if (!__syncthreads_or(logt_in >= LOG_EPS)) {
      // saturated: the forward skipped this segment
#pragma unroll
      for (int i = 0; i < SEG_F4 / PX; ++i) d_out[i * PX + p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const float4* src = reinterpret_cast<const float4*>(rows) + static_cast<size_t>(s) * SEG_F4;
#pragma unroll
    for (int i = 0; i < SEG_F4 / PX; ++i) reinterpret_cast<float4*>(seg)[i * PX + p] = src[i * PX + p];
    __syncthreads();

    float run = 0.0f;
    for (int j = 0; j < CSEG; ++j) {
      if (j % SUB == 0) sub_entry[(j / SUB) * PX + p] = run;
      run += log1pf(-row_alpha(seg + j * N_ATTR, px, py));
    }

    for (int q = N_SUB - 1; q >= 0; --q) {
      const float* sub = seg + q * SUB * N_ATTR;
      run = sub_entry[q * PX + p];
      for (int j = 0; j < SUB; ++j) {
        prefix[j * PX + p] = run;
        run += log1pf(-row_alpha(sub + j * N_ATTR, px, py));
      }

      for (int j = SUB - 1; j >= 0; --j) {
        const float* r = sub + j * N_ATTR;
        const float ca = r[2], cb = r[3], cc = r[4], op = r[5];
        const float dx = r[0] - px;
        const float dy = r[1] - py;
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        const float exp_power = expf(power);
        const float raw = op * exp_power;
        float alpha = fminf(raw, ALPHA_MAX);
        const bool live = power <= 0.0f && alpha >= ALPHA_MIN;
        if (!live) alpha = 0.0f;
        const bool unclipped = live && raw < ALPHA_MAX;

        const float t_k = expf(logt_in + prefix[j * PX + p]);
        float s_k = 0.0f;
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) s_k += r[6 + c] * g[c];
        const float w = alpha * t_k;
        const float one_minus = fmaxf(1.0f - alpha, 1.0f / 256.0f);
        const float d_alpha = alpha > 0.0f ? t_k * s_k - (b_suffix + glt) / one_minus : 0.0f;
        b_suffix += w * s_k;

        const float d_raw = unclipped ? d_alpha : 0.0f;
        const float d_power = d_raw * alpha;  // alpha == raw where unclipped

        float v[N_GRAD];
        v[0] = d_power * (-(ca * dx + cb * dy));
        v[1] = d_power * (-(cc * dy + cb * dx));
        v[2] = d_power * (-0.5f * dx * dx);
        v[3] = d_power * (-dx * dy);
        v[4] = d_power * (-0.5f * dy * dy);
        // exp_power may be inf where power > 0; such a pair is never unclipped
        v[5] = unclipped ? d_raw * exp_power : 0.0f;
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) v[6 + c] = w * g[c];
#pragma unroll
        for (int i = 0; i < N_GRAD; ++i) {
          float x = v[i];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
          v[i] = x;
        }
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < N_GRAD; ++i) partial[(j * N_WARPS + warp) * N_GRAD + i] = v[i];
        }
      }
      __syncthreads();

      // SUB * N_ATTR outputs, four consecutive columns per thread; columns
      // 14 and 15 are padding and stay zero
      const int j = p / 4;
      const int col0 = (p % 4) * 4;
      float out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = col0 + k;
        float sum = 0.0f;
        if (col < N_GRAD) {
          for (int w8 = 0; w8 < N_WARPS; ++w8) sum += partial[(j * N_WARPS + w8) * N_GRAD + col];
        }
        out[k] = sum;
      }
      d_out[q * (SUB * N_ATTR / 4) + p] = make_float4(out[0], out[1], out[2], out[3]);
      __syncthreads();  // prefix, partial and (after q = 0) seg are reused
    }
  }
}

}  // namespace

extern "C" int blend_csr_bwd(const void* rows, const void* seg_u0, const void* seg_v0,
                             const void* tile_start, const void* tile_count,
                             const void* entry, const void* g_accum, const void* g_logt,
                             int n_tiles, int n_channels, void* d_rows, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blend_csr_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles > 0) {
    blend_csr_bwd_kernel<<<n_tiles, PX, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows), static_cast<const int*>(seg_u0),
        static_cast<const int*>(seg_v0), static_cast<const int*>(tile_start),
        static_cast<const int*>(tile_count), static_cast<const float*>(entry),
        static_cast<const float*>(g_accum), static_cast<const float*>(g_logt), n_channels,
        static_cast<float*>(d_rows));
  }
  return static_cast<int>(cudaGetLastError());
}
