// Native RGB-D raycaster of the benchmark's simulator: a frozen copy of
// activesplat_tpu_torch/csrc/raycast.cpp (see benchmark/sim/SOURCES.md for
// the commit it was taken from). Plain C interface, loaded through ctypes by
// benchmark/sim/boxworld.py, which builds it with g++ at first use into
// benchmark/sim/build/.
//
// Axis-aligned room interior + box obstacles, checker-textured faces,
// z-depth, distance shading, depth clamped to 0 outside [depth_min,
// depth_max].

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Vec3 {
  double x, y, z;
};

inline double checker(double u, double v, double period) {
  double s = std::floor(u / period) + std::floor(v / period);
  double m = s - 2.0 * std::floor(s / 2.0);  // mod 2, handles negatives
  return 0.72 + 0.28 * m;
}

const double kFaceColors[6][3] = {
    {0.85, 0.35, 0.30}, {0.30, 0.65, 0.85}, {0.45, 0.40, 0.35},
    {0.90, 0.90, 0.85}, {0.35, 0.80, 0.45}, {0.85, 0.75, 0.30},
};
const double kObstacleColor[3] = {0.55, 0.35, 0.70};

}  // namespace

extern "C" {

// rgb: H*W*3 float32 out; depth: H*W float32 out.
// c2w: 16 doubles row-major; intr: fx, fy, cx, cy.
// obstacles: K * 6 doubles (minx,miny,minz,maxx,maxy,maxz).
void raycast_rgbd(const double* c2w, double fx, double fy, double cx,
                  double cy, int width, int height, const double* size,
                  const double* obstacles, int n_obstacles, double depth_min,
                  double depth_max, float* rgb, float* depth) {
  const Vec3 origin{c2w[3], c2w[7], c2w[11]};
  const double lo[3] = {0.0, 0.0, 0.0};
  const double hi[3] = {size[0], size[1], size[2]};

  for (int v = 0; v < height; ++v) {
    for (int u = 0; u < width; ++u) {
      const double dc[3] = {(u - cx) / fx, (v - cy) / fy, 1.0};
      double dir[3];
      for (int i = 0; i < 3; ++i)
        dir[i] = c2w[i * 4 + 0] * dc[0] + c2w[i * 4 + 1] * dc[1] +
                 c2w[i * 4 + 2] * dc[2];
      const double org[3] = {origin.x, origin.y, origin.z};

      double inv[3];
      for (int i = 0; i < 3; ++i)
        inv[i] = (std::fabs(dir[i]) > 1e-12)
                     ? 1.0 / dir[i]
                     : (dir[i] >= 0 ? 1e30 : -1e30);

      // room interior: exit t
      double t_room = 1e30;
      int room_face = 0;
      for (int a = 0; a < 3; ++a) {
        double t1 = (lo[a] - org[a]) * inv[a];
        double t2 = (hi[a] - org[a]) * inv[a];
        double t_exit = t1 > t2 ? t1 : t2;
        if (t_exit < t_room) {
          t_room = t_exit;
          room_face = a * 2 + (dir[a] > 0 ? 1 : 0);
        }
      }

      double best_t = t_room;
      int hit_kind = 0;  // 0 = room wall, k+1 = obstacle k
      int hit_axis = 0;
      for (int k = 0; k < n_obstacles; ++k) {
        const double* ob = obstacles + k * 6;
        double t_enter = -1e30, t_exit = 1e30;
        int enter_axis = 0;
        for (int a = 0; a < 3; ++a) {
          double t1 = (ob[a] - org[a]) * inv[a];
          double t2 = (ob[3 + a] - org[a]) * inv[a];
          double tn = t1 < t2 ? t1 : t2;
          double tf = t1 < t2 ? t2 : t1;
          if (tn > t_enter) {
            t_enter = tn;
            enter_axis = a;
          }
          if (tf < t_exit) t_exit = tf;
        }
        if (t_enter > 1e-6 && t_enter < t_exit && t_enter < best_t) {
          best_t = t_enter;
          hit_kind = k + 1;
          hit_axis = enter_axis;
        }
      }

      const double pt[3] = {org[0] + best_t * dir[0], org[1] + best_t * dir[1],
                            org[2] + best_t * dir[2]};
      double col[3];
      if (hit_kind == 0) {
        int axis = room_face / 2;
        int ua = (axis + 1) % 3, va = (axis + 2) % 3;
        double tex = checker(pt[ua], pt[va], 0.5);
        for (int c = 0; c < 3; ++c) col[c] = kFaceColors[room_face][c] * tex;
      } else {
        double tu = (hit_axis == 0) ? pt[1] : pt[0];
        double tv = (hit_axis == 2) ? pt[1] : pt[2];
        double tex = checker(tu, tv, 0.25);
        double hue = 0.85 + 0.15 * std::cos(hit_kind * 2.1);
        for (int c = 0; c < 3; ++c) col[c] = kObstacleColor[c] * hue * tex;
      }

      double z = best_t;  // dc.z == 1 -> ray t is exactly z-depth
      double shade = 1.0 / (1.0 + 0.04 * z);
      int idx = v * width + u;
      for (int c = 0; c < 3; ++c) {
        double value = col[c] * shade;
        rgb[idx * 3 + c] =
            static_cast<float>(value < 0 ? 0 : (value > 1 ? 1 : value));
      }
      depth[idx] = (z >= depth_min && z <= depth_max)
                       ? static_cast<float>(z)
                       : 0.0f;
    }
  }
}

}  // extern "C"
