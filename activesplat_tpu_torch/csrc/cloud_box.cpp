// The pixels of a depth frame that can hold an extreme of its world-space
// cloud, for the mapper's change log (activesplat_tpu_torch/mapper/splatam.py
// `_log_change`, through mapper/cloud_box.py, which builds this file at
// first use and loads it with ctypes).
//
// The change log's box is numpy's: per valid pixel (depth > 0)
//   x = (u - cx) / fx * z,  y = (v - cy) / fy * z,
//   p = [x, y, z] @ R.T + t            (a BLAS product, rounded its own way),
// and the box is p's minimum and maximum per axis. This pass computes each
// pixel's p approximately, p~ = z * ((u - cx) / fx * R_i0 + (v - cy) / fy *
// R_i1 + R_i2) + t_i, which lies within
//   D_i = 64 * 2^-53 * (zmax * C_i + |t_i|) + 16 * DBL_MIN
// of numpy's value for every pixel, whatever order or fused multiply-adds
// the product uses (C_i bounds |(u - cx) / fx| |R_i0| + |(v - cy) / fy| |R_i1|
// + |R_i2| over the frame; the rounding of numpy's formula is at most about
// 10 * 2^-53 times that sum, and the absolute term covers subnormals). A
// pixel whose numpy value is the minimum then has p~ <= min p~ + 2 D_i, and
// one whose value is the maximum has p~ >= max p~ - 2 D_i. The second pass
// collects every pixel inside either band on any axis. Where many pixels tie
// (a wall seen square on, a floor's row at one depth) the bands hold them
// all, so the third pass keeps, of each row's and then each column's run of
// candidates at one depth, its two ends, which hold the run's extremes. The
// caller evaluates numpy's own formula on the pixels left, in row-major
// order.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kRelative = 64.0 * 0x1p-53;
constexpr double kAbsolute = 16.0 * DBL_MIN;
constexpr double kInf = INFINITY;

// four pixels at a time (GCC vector extensions; -march=native picks the
// instructions)
typedef double v4d __attribute__((vector_size(32)));
typedef float v4f __attribute__((vector_size(16)));
typedef int64_t v4i __attribute__((vector_size(32)));

inline v4d load4(const float* z) {
  v4f f;
  std::memcpy(&f, z, sizeof f);
  return __builtin_convertvector(f, v4d);
}

inline v4d load4(const double* x) {
  v4d d;
  std::memcpy(&d, x, sizeof d);
  return d;
}

inline double lesser(double a, double b) { return a < b ? a : b; }
inline double greater(double a, double b) { return a > b ? a : b; }

// Of each run of entries of idx with one line (line(i)) and one depth, keeps
// the first and the last; returns the new count.
template <typename Line>
int64_t keep_ends(const float* depth, int64_t* idx, int64_t m, Line line) {
  int64_t k = 0;
  for (int64_t j = 0; j < m;) {
    int64_t e = j + 1;
    while (e < m && line(idx[e]) == line(idx[j]) && depth[idx[e]] == depth[idx[j]]) ++e;
    idx[k++] = idx[j];
    if (e - 1 > j) idx[k++] = idx[e - 1];
    j = e;
  }
  return k;
}

}  // namespace

extern "C" {

// depth: H*W float32; rot: 9 row-major; trans: 3. idx: room for H*W indices.
// Writes the number of valid pixels (depth > 0) to *valid and the flat
// indices of the candidates to idx; returns their count. Returns -1, and
// writes nothing else, when a valid pixel is +inf or the inputs could make
// p~ non-finite: the caller then evaluates numpy's formula on every pixel.
int64_t cloud_box_candidates(const float* depth, int64_t height, int64_t width, double fx,
                             double fy, double cx, double cy, const double* rot,
                             const double* trans, int64_t* idx, int64_t* valid) {
  const double t[3] = {trans[0], trans[1], trans[2]};
  for (int i = 0; i < 3; ++i) {
    if (!std::isfinite(t[i])) return -1;
  }
  // the tables: (u - cx) / fx * R_i0 per u, (v - cy) / fy * R_i1 + R_i2 per
  // [v][i]; and C_i's largest column and row parts
  std::vector<double> col[3], row(3 * height);
  double col_abs[3] = {0, 0, 0}, row_abs[3] = {0, 0, 0};
  for (int i = 0; i < 3; ++i) col[i].resize(width);
  for (int64_t u = 0; u < width; ++u) {
    const double a = (static_cast<double>(u) - cx) / fx;
    for (int i = 0; i < 3; ++i) {
      const double x = a * rot[i * 3];
      if (!std::isfinite(x)) return -1;
      col[i][u] = x;
      col_abs[i] = greater(col_abs[i], std::fabs(x));
    }
  }
  for (int64_t v = 0; v < height; ++v) {
    const double b = (static_cast<double>(v) - cy) / fy;
    for (int i = 0; i < 3; ++i) {
      const double y = b * rot[i * 3 + 1];
      row[v * 3 + i] = y + rot[i * 3 + 2];
      if (!std::isfinite(row[v * 3 + i])) return -1;
      row_abs[i] = greater(row_abs[i], std::fabs(y) + std::fabs(rot[i * 3 + 2]));
    }
  }
  double c[3];
  for (int i = 0; i < 3; ++i) {
    c[i] = col_abs[i] + row_abs[i];
    // FLT_MAX * c + |t| far below DBL_MAX: no p~ or bound overflows
    if (!(FLT_MAX * c[i] + std::fabs(t[i]) < 1e300)) return -1;
  }

  // pass 1: the extremes of p~, per frame and per row, and the largest depth
  double lo[3] = {kInf, kInf, kInf}, hi[3] = {-kInf, -kInf, -kInf};
  std::vector<double> row_lo(3 * height), row_hi(3 * height);
  int64_t n = 0;
  double zmax = 0.0;
  for (int64_t v = 0; v < height; ++v) {
    const float* drow = depth + v * width;
    const double* rb = &row[v * 3];
    v4d lo4[3], hi4[3], zmax4 = {0, 0, 0, 0};
    v4i n4 = {0, 0, 0, 0}, inf4 = {0, 0, 0, 0};
    for (int i = 0; i < 3; ++i) {
      lo4[i] = v4d{kInf, kInf, kInf, kInf};
      hi4[i] = -lo4[i];
    }
    int64_t u = 0;
    for (; u + 4 <= width; u += 4) {
      const v4d z = load4(drow + u);
      const v4i ok = z > 0.0;  // numpy's depth > 0: NaN, zero and negatives are holes
      inf4 |= z > FLT_MAX;
      n4 -= ok;
      zmax4 = z > zmax4 ? z : zmax4;
      for (int i = 0; i < 3; ++i) {
        const v4d p = z * (load4(&col[i][u]) + rb[i]) + t[i];
        lo4[i] = (ok & (p < lo4[i])) ? p : lo4[i];
        hi4[i] = (ok & (p > hi4[i])) ? p : hi4[i];
      }
    }
    double rlo[3], rhi[3];
    for (int i = 0; i < 3; ++i) {
      rlo[i] = lesser(lesser(lo4[i][0], lo4[i][1]), lesser(lo4[i][2], lo4[i][3]));
      rhi[i] = greater(greater(hi4[i][0], hi4[i][1]), greater(hi4[i][2], hi4[i][3]));
    }
    if (inf4[0] | inf4[1] | inf4[2] | inf4[3]) return -1;
    n += n4[0] + n4[1] + n4[2] + n4[3];
    zmax = greater(zmax, greater(greater(zmax4[0], zmax4[1]), greater(zmax4[2], zmax4[3])));
    for (; u < width; ++u) {
      const double z = drow[u];
      if (!(z > 0.0)) continue;
      if (z > FLT_MAX) return -1;
      ++n;
      zmax = greater(zmax, z);
      for (int i = 0; i < 3; ++i) {
        const double p = z * (col[i][u] + rb[i]) + t[i];
        rlo[i] = lesser(rlo[i], p);
        rhi[i] = greater(rhi[i], p);
      }
    }
    for (int i = 0; i < 3; ++i) {
      row_lo[v * 3 + i] = rlo[i];
      row_hi[v * 3 + i] = rhi[i];
      lo[i] = lesser(lo[i], rlo[i]);
      hi[i] = greater(hi[i], rhi[i]);
    }
  }
  *valid = n;
  if (n == 0) return 0;

  // the bands: within 2 D_i of an extreme
  double below[3], above[3];
  for (int i = 0; i < 3; ++i) {
    const double band = 2.0 * (kRelative * (zmax * c[i] + std::fabs(t[i])) + kAbsolute);
    below[i] = lo[i] + band;
    above[i] = hi[i] - band;
  }

  // pass 2: the pixels in a band, over the rows that reach one
  int64_t m = 0;
  for (int64_t v = 0; v < height; ++v) {
    bool reach = false;
    for (int i = 0; i < 3; ++i) {
      reach |= row_lo[v * 3 + i] <= below[i] || row_hi[v * 3 + i] >= above[i];
    }
    if (!reach) continue;
    const float* drow = depth + v * width;
    const double* rb = &row[v * 3];
    int64_t u = 0;
    for (; u + 4 <= width; u += 4) {
      const v4d z = load4(drow + u);
      v4i in = {0, 0, 0, 0};
      for (int i = 0; i < 3; ++i) {
        const v4d p = z * (load4(&col[i][u]) + rb[i]) + t[i];
        in |= (p <= below[i]) | (p >= above[i]);
      }
      in &= z > 0.0;
      if (in[0] | in[1] | in[2] | in[3]) {
        for (int k = 0; k < 4; ++k) {
          if (in[k]) idx[m++] = v * width + u + k;
        }
      }
    }
    for (; u < width; ++u) {
      const double z = drow[u];
      if (!(z > 0.0)) continue;
      bool in = false;
      for (int i = 0; i < 3; ++i) {
        const double p = z * (col[i][u] + rb[i]) + t[i];
        in |= p <= below[i] || p >= above[i];
      }
      if (in) idx[m++] = v * width + u;
    }
  }

  // pass 3: numpy's coordinate is monotone in u along a row at one depth
  // (x = (u - cx) / fx * z is monotone in u, y and z are fixed, and each
  // rounding step of the product, the same for every row of it, and of the
  // sum is monotone in x), and in v along a column at one depth. So of the
  // candidates that share a row and a depth, one after another, the first
  // and the last hold the others' extremes; then the same down the columns.
  m = keep_ends(depth, idx, m, [width](int64_t i) { return i / width; });
  std::vector<int64_t> by_col(idx, idx + m);
  std::sort(by_col.begin(), by_col.end(), [width](int64_t a, int64_t b) {
    return a % width != b % width ? a % width < b % width : a < b;
  });
  m = keep_ends(depth, by_col.data(), m, [width](int64_t i) { return i % width; });
  std::copy(by_col.begin(), by_col.begin() + m, idx);
  std::sort(idx, idx + m);
  return m;
}

}  // extern "C"
