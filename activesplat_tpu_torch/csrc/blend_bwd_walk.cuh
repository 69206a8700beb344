// The analytic backward walk of a 64-row piece of a blend, written once for
// B2 (blend_bwd.cu, the tile blend's 64-row segments) and B4
// (blend_csr_bwd.cu, the four 64-row pieces of each 256-row CSR segment).
// Each source instantiates these templates (colour channels C in 1..8)
// behind its C entry points. A block is 256 threads, one per pixel of a
// 16x16 tile, and holds one 64-row piece at a time.
//
// Rows: [mx, my, a, b, c, op, col0..7, pad, pad]; the gradient of a row is
// d(mx, my, a, b, c, op, col0..C-1), columns from 6 + C on zero.
//
// The two steps each source builds on:
//   piece_total: the piece walked front to back from an entry logT, the
//   exclusive log prefix carried in a register as the forward carries it;
//   returns sum_j w_j s_j with w_j = alpha_j exp(logT_in + prefix_j) and
//   s_j = col_j . g_accum(p), and leaves the piece's log step in `run`.
//   walk_rows: the piece walked front to back again with the suffix behind
//   row k formed as total minus the inclusive sum:
//     B_k = b_in + (total - sum_{j<=k} w_j s_j),
//     dL/dalpha_k = T_k s_k - (B_k + g_logT) / max(1 - alpha_k, 1/256),
//   chained through alpha = min(op exp(power), 0.99) as the Pallas kernels
//   do (raster_pallas.py:182-224, :680-730); each row's 6+C gradients are
//   summed over the warp into per-warp partials; write_rows then sums the
//   eight warps in a fixed order and stores the piece's 64 gradient rows.
//
// Footprint of a walk block: 4 KB of rows and 32 KB of per-warp partials
// (8 warps x 64 rows x 16 columns), about 50 registers a thread; with
// __launch_bounds__(256, 4) four blocks (32 warps) are resident a SM.
//
// Pixels: warp w holds the tile's 8x4-pixel block (x 8(w%2)..+7, y
// 4(w/2)..+3), more compact than a 16x2 strip, so fewer warps straddle a
// Gaussian's edge and fewer warp-rows hold a live pair.
//
// The pixel sum. A row's 6+C gradients (padded to 16 values) are summed over
// each warp by a reduce-scatter butterfly: at offset 16 each lane keeps the
// half of its values that its lane bit 4 selects and adds the partner's copy
// of that half (8 shuffles), then likewise at offsets 8, 4 and 2 (4, 2 and 1
// shuffles), and at offset 1 the two lanes of a pair add their one value:
// 16 shuffles, after which lanes 2c and 2c+1 hold column c's warp sum. The
// even lane writes it to the per-warp partials; after the walk one thread per
// (row, column) sums the eight warps in a fixed order, so the result is
// deterministic. A warp-row with no live pair (every value +-0) skips the
// exchange and writes zeros; one that the reach mask rules out (below)
// skips the pair's arithmetic too.
//
// Dead pairs: per row, thr = log(ALPHA_MIN) - log(op) - margin (+inf for
// op <= 0, so padding rows are dead), as blend_csr_walk.cuh computes it. A
// pair with power > 0 or power < thr has alpha 0 by the full formula; it
// skips every expf and log1pf, its colour FMAs and its gradients, whose
// values were exact zeros. The margin (1e-3 in the log domain) is far above
// the error of logf, expf and the product's rounding. Per row and warp, a
// reach mask rules out whole warp-rows: power >= thr is an ellipse whose
// bounding box, widened by 0.1% and 0.01 px, misses the warp's pixel block.
// With `audit` set, piece_total evaluates every pair and counts those that
// the test or the mask kills although the full formula keeps them (the
// smoke requires 0).
//
// Tensor cores do not serve the walk: a pair's power is a 6-term quadratic
// form, and expanding it into a product cancels catastrophically in float32
// at pixel coordinates in the hundreds; TF32 is off by the port's rule
// (device.py); the two colour products of a pair (s_j = col_j . g and the
// colour gradients w_j g) are C-wide, 2C FMAs per live pair, fewer than the
// special functions beside them.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

namespace bwd_walk {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;  // pixels per tile = threads per block
constexpr int SEG = 64;          // rows per piece
constexpr int N_ATTR = 16;
constexpr int REACH_COL = 14;    // the staged copy's padding columns: the row's warp mask...
constexpr int THR_COL = 15;      // ...and its dead-pair threshold
constexpr int N_WARPS = PX / 32;
constexpr int N_COLS = 16;       // values a lane feeds the butterfly (6 + C, zero padded)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ALL_WARPS = (1u << N_WARPS) - 1;
constexpr float LOG_EPS = -5.55f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float DEAD_MARGIN = 1e-3f;

// The tile-local pixel (y * 16 + x) of thread p: warp w takes the 8x4 block
// at x = 8 (w % 2), y = 4 (w / 2), lane l its pixel (l % 8, l / 8).
__device__ __forceinline__ int local_pixel(int p) {
  const int w = p / 32, l = p % 32;
  return (4 * (w / 2) + l / 8) * TILE + 8 * (w % 2) + l % 8;
}

// The warps of the tile that may hold a pair of this row with power >= thr,
// a bit each. power >= thr is the ellipse a dx^2 + 2b dx dy + c dy^2 <=
// reach = -2 thr, whose extent is |dx| <= sqrt(reach c / det), |dy| <=
// sqrt(reach a / det); the extents are widened by 0.1% and 0.01 px, far
// above the rounding of the power. A row whose conic is not clearly
// positive definite reaches every warp.
__device__ __forceinline__ unsigned reach_mask(const float* r, float thr, float x0, float y0) {
  if (thr == INFINITY) return 0u;  // op <= 0: every pair is dead
  const float a = r[2], b = r[3], c = r[4];
  const float det = a * c - b * b;
  const float reach = -2.0f * thr;
  if (!(reach > 0.0f && reach < INFINITY && a > 0.0f && c > 0.0f && det > 1e-3f * a * c))
    return ALL_WARPS;
  const float ex = sqrtf(reach * c / det) * 1.001f + 0.01f;
  const float ey = sqrtf(reach * a / det) * 1.001f + 0.01f;
  unsigned mask = 0u;
#pragma unroll
  for (int w = 0; w < N_WARPS; ++w) {
    const float xl = x0 + 8 * (w % 2), yl = y0 + 4 * (w / 2);
    if (!(r[0] + ex < xl || r[0] - ex > xl + 7.0f || r[1] + ey < yl || r[1] - ey > yl + 3.0f))
      mask |= 1u << w;
  }
  return mask;
}

// Stage a piece's 64 rows (one float4 a thread) and write each row's
// dead-pair threshold and warp mask, for the tile at (x0, y0), into its
// padding columns.
__device__ __forceinline__ void stage_rows(const float* __restrict__ rows, size_t first_row,
                                           float* seg, float margin, float x0, float y0, int p) {
  reinterpret_cast<float4*>(seg)[p] = reinterpret_cast<const float4*>(rows + first_row * N_ATTR)[p];
  __syncthreads();
  if (p < SEG) {
    float* r = seg + p * N_ATTR;
    const float op = r[5];
    const float thr = op <= 0.0f ? INFINITY : logf(ALPHA_MIN) - logf(op) - margin;
    r[THR_COL] = thr;
    r[REACH_COL] = __uint_as_float(reach_mask(r, thr, x0, y0));
  }
  __syncthreads();
}

__device__ __forceinline__ bool in_reach(const float* r, int warp) {
  return (__float_as_uint(r[REACH_COL]) >> warp) & 1u;
}

__device__ __forceinline__ float pair_power(const float* r, float px, float py, float& dx,
                                            float& dy) {
  const float4 q = reinterpret_cast<const float4*>(r)[0];
  const float cc = r[4];
  dx = q.x - px;
  dy = q.y - py;
  return -0.5f * (q.z * dx * dx + cc * dy * dy) - q.w * dx * dy;
}

// Halve the values a lane holds: keep those its lane bit selects, plus the
// partner's (lane ^ OFF) copy of them.
template <int HALF, int OFF>
__device__ __forceinline__ void butterfly_step(float (&v)[N_COLS], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float keep = upper ? v[i + HALF] : v[i];
    const float send = upper ? v[i] : v[i + HALF];
    v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// Reduce-scatter over the warp: returns the warp sum of column lane >> 1.
__device__ __forceinline__ float warp_column_sum(float (&v)[N_COLS], int lane) {
  butterfly_step<8, 16>(v, lane);
  butterfly_step<4, 8>(v, lane);
  butterfly_step<2, 4>(v, lane);
  butterfly_step<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// The staged piece walked front to back from logt_in at pixel (px, py):
// returns sum_j w_j s_j and leaves the piece's log step in `run` (which
// must start at 0). Dead pairs and ruled-out warp-rows add nothing; with
// `audit` set every pair is evaluated and each live pair that the dead-pair
// test or the reach mask kills is counted.
template <int C>
__device__ __forceinline__ float piece_total(const float* seg, float px, float py,
                                             const float (&g)[C], float logt_in, int warp,
                                             int* __restrict__ audit, float& run) {
  float total = 0.0f;
#pragma unroll 2
  for (int j = 0; j < SEG; ++j) {
    const float* r = seg + j * N_ATTR;
    const bool reached = in_reach(r, warp);
    if (!reached && audit == nullptr) continue;  // the whole warp is dead for this row
    float dx, dy;
    const float power = pair_power(r, px, py, dx, dy);
    if (!reached || power > 0.0f || power < r[THR_COL]) {  // dead: alpha is 0
      if (audit != nullptr && power <= 0.0f && fminf(r[5] * expf(power), ALPHA_MAX) >= ALPHA_MIN)
        atomicAdd(audit, 1);
      continue;
    }
    const float alpha = fminf(r[5] * expf(power), ALPHA_MAX);
    if (!(power <= 0.0f && alpha >= ALPHA_MIN)) continue;
    float s_k = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) s_k += r[6 + c] * g[c];
    const float w = alpha * expf(logt_in + run);
    total += w * s_k;
    run += log1pf(-alpha);
  }
  return total;
}

// The staged piece's gradients at pixel (px, py), entering at logt_in with
// the carry b_in of the rows behind the piece and the piece's own total
// (piece_total's, scaled to logt_in): each row's warp sums go into
// partial[(warp, row, column)]. A warp-row that the reach mask rules out,
// or that holds no live pair, skips the exchange.
template <int C>
__device__ __forceinline__ void walk_rows(const float* seg, float* partial, float px, float py,
                                          const float (&g)[C], float glt, float logt_in,
                                          float b_in, float total, int warp, int lane) {
  static_assert(6 + C <= N_COLS, "the butterfly carries 16 columns");
  float run = 0.0f;   // exclusive in-piece log prefix, as piece_total carries it
  float incl = 0.0f;  // inclusive in-piece sum of w_j s_j
#pragma unroll 2
  for (int j = 0; j < SEG; ++j) {
    const float* r = seg + j * N_ATTR;
    bool maybe = in_reach(r, warp);
    if (!maybe) {  // the whole warp is dead for this row
      if (lane % 2 == 0) partial[(warp * SEG + j) * N_COLS + lane / 2] = 0.0f;
      continue;
    }
    float v[N_COLS];
#pragma unroll
    for (int n = 0; n < N_COLS; ++n) v[n] = 0.0f;
    bool live = false;
    float dx = 0.0f, dy = 0.0f, power = 0.0f;
    if (maybe) {
      power = pair_power(r, px, py, dx, dy);
      maybe = !(power > 0.0f || power < r[THR_COL]);  // else dead: alpha is 0
    }
    if (maybe) {
      const float ca = r[2], cb = r[3], cc = r[4], op = r[5];
      const float exp_power = expf(power);
      const float raw = op * exp_power;
      const float alpha = fminf(raw, ALPHA_MAX);
      live = power <= 0.0f && alpha >= ALPHA_MIN;
      if (live) {
        const bool unclipped = raw < ALPHA_MAX;
        const float t_k = expf(logt_in + run);
        float s_k = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) s_k += r[6 + c] * g[c];
        const float w = alpha * t_k;
        incl += w * s_k;
        const float b_k = b_in + (total - incl);  // the rows behind k
        const float one_minus = fmaxf(1.0f - alpha, 1.0f / 256.0f);
        const float d_alpha = t_k * s_k - (b_k + glt) / one_minus;
        run += log1pf(-alpha);
        const float d_raw = unclipped ? d_alpha : 0.0f;
        const float d_power = d_raw * alpha;  // alpha == raw where unclipped
        v[0] = d_power * (-(ca * dx + cb * dy));
        v[1] = d_power * (-(cc * dy + cb * dx));
        v[2] = d_power * (-0.5f * dx * dx);
        v[3] = d_power * (-dx * dy);
        v[4] = d_power * (-0.5f * dy * dy);
        v[5] = unclipped ? d_raw * exp_power : 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) v[6 + c] = w * g[c];
      }
    }
    float sum = 0.0f;
    if (__any_sync(FULL, live)) sum = warp_column_sum(v, lane);
    if (lane % 2 == 0) partial[(warp * SEG + j) * N_COLS + lane / 2] = sum;
  }
}

// After walk_rows and a barrier: the piece's 64 x 16 outputs at d_out, four
// (row, column) pairs a thread, each the eight warps' partials summed in
// order; columns from 6 + C on (unused colours and the two padding columns)
// are zero.
template <int C>
__device__ __forceinline__ void write_rows(const float* partial, float* __restrict__ d_out, int p) {
  for (int o = p; o < SEG * N_COLS; o += PX) {
    float out = 0.0f;
    if (o % N_COLS < 6 + C) {
#pragma unroll
      for (int w8 = 0; w8 < N_WARPS; ++w8) out += partial[w8 * SEG * N_COLS + o];
    }
    d_out[o] = out;
  }
}

// Zero a piece's 64 gradient rows (one float4 a thread).
__device__ __forceinline__ void zero_rows(float* __restrict__ d_out, int p) {
  reinterpret_cast<float4*>(d_out)[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Call f with std::integral_constant<int, C> for the run-time channel count.
template <int C = 1, typename F>
int with_channels(int n_channels, F&& f) {
  if constexpr (C > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (n_channels != C) return with_channels<C + 1>(n_channels, f);
    return f(std::integral_constant<int, C>{});
  }
}

// registers, static shared bytes, dynamic shared bytes, local bytes, resident blocks per SM
template <typename K>
cudaError_t kernel_occupancy(K kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = 0;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 4, kernel, PX, 0);
}

}  // namespace bwd_walk
