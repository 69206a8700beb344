"""OpenCV's raster rules in numpy, for the planner (counterpart of the cv2
calls in activesplat_tpu/planner and runtime/planner_fsm.py).

The planner decides by counting pixels: a path is safe when drawing it in
white over the obstacle map adds no white pixel. One pixel off flips an
action, so each function here follows OpenCV's own algorithm (imgproc's
drawing.cpp, contours, morphology, approxPolyDP, pointPolygonTest) and its
integer arithmetic, and gives OpenCV's pixels bitwise:

- `line`: thickness 1 is the 8-connected LineIterator (Bresenham, walked
  left to right, the end points first clipped to the image by clipLine);
  a thicker line is ThickLine: clipped to the image grown by its
  thickness on every side, then a quadrilateral in 16-bit fixed point
  filled by FillConvexPoly (its edges drawn by the fixed-point Line2), with
  a filled circle of radius (thickness + 1) // 2 at each capped end.
- `polylines`: PolyLine, each segment a ThickLine capped at its end (the
  first at both ends).
- `circle`: the filled midpoint circle (Circle with fill).
- `draw_contours` (filled, as fillPoly): CollectPolyEdges (each edge also
  drawn as a line) and FillEdgeCollection's even-odd scanline fill.
- `point_polygon_test`: the signed distance or the inside sign, with the
  point and the differences in float32 as OpenCV's Point2f holds them.
- `approx_poly_dp`: Douglas-Peucker with OpenCV's start points, its
  distance from a point to the chord's segment (not its line), and its
  final pass that drops points on almost straight runs.
- `erode`, `dilate`, `morphology_open`: min / max over the kernel's
  footprint anchored at (w // 2, h // 2), the outside neutral.
- `arrowed_line`, `gray2bgr`.

Points are integer (x, y) pairs; images are uint8 (H, W) or (H, W, C),
drawn in place and returned as cv2 returns them.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def _tdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _color(img: np.ndarray, color) -> np.ndarray:
    """The color as the image's channels (a scalar fills every channel's
    first entry as cv2's scalarToRawData does: missing entries are 0)."""
    ch = 1 if img.ndim == 2 else img.shape[2]
    vals = list(np.atleast_1d(np.asarray(color, np.float64)))[:ch]
    vals += [0.0] * (ch - len(vals))
    return np.clip(np.rint(vals), 0, 255).astype(img.dtype)


class _Painter:
    """Pixels and horizontal spans set to one color, clipped to the image."""

    def __init__(self, img: np.ndarray, color) -> None:
        self.img = img
        self.h, self.w = img.shape[:2]
        self.c = _color(img, color)
        self.c = self.c[0] if img.ndim == 2 else self.c

    def points(self, xs, ys) -> None:
        xs = np.asarray(xs, np.int64)
        ys = np.asarray(ys, np.int64)
        ok = (xs >= 0) & (xs < self.w) & (ys >= 0) & (ys < self.h)
        self.img[ys[ok], xs[ok]] = self.c

    def hline(self, y: int, x1: int, x2: int) -> None:
        """Row y from x1 to x2 inclusive, clipped."""
        if 0 <= y < self.h and x1 < self.w and x2 >= 0:
            self.img[y, max(x1, 0) : min(x2, self.w - 1) + 1] = self.c


# ---------------------------------------------------------------------- #
# lines


def _clip(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """clipLine: (inside, x1, y1, x2, y2), the segment cut to [0, w-1] x
    [0, h-1]; the end points as clipLine leaves them also where it misses."""
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """The segment cut to the w x h image (clipLine), or None where it
    misses the image."""
    inside, *pts = _clip(w, h, x1, y1, x2, y2)
    return tuple(pts) if inside else None


def line_points(w: int, h: int, p1, p2) -> Tuple[np.ndarray, np.ndarray]:
    """The pixels of the 8-connected LineIterator from p1 to p2 in a w x h
    image (leftToRight: a line drawn right to left is walked from its other
    end). The minor coordinate of the k-th pixel steps when the iterator's
    error term err = dx - 2dy (+2dx - 2dy a diagonal step, -2dy a straight
    one) is negative, which makes it ceil((2 dy k - dx) / (2 dx))."""
    x1, y1, x2, y2 = int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1])
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    if dy > dx:  # vertical: y is the major axis
        k = np.arange(dy + 1, dtype=np.int64)
        minor = -((dy - 2 * dx * k) // (2 * dy))
        return x1 + minor, y1 + sy * k
    k = np.arange(dx + 1, dtype=np.int64)
    if dx == 0:
        return k + x1, k + y1
    minor = -((dx - 2 * dy * k) // (2 * dx))
    return x1 + k, y1 + sy * minor


def _line2_points(w: int, h: int, p1, p2) -> Tuple[List[int], List[int]]:
    """Line2: the 8-connected line between two points in 16-bit fixed point
    (the edges of a filled convex polygon), clipped to the image scaled to
    fixed point."""
    clipped = clip_line(w << XY_SHIFT, h << XY_SHIFT, int(p1[0]), int(p1[1]),
                        int(p2[0]), int(p2[1]))
    if clipped is None:
        return [], []
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += _HALF
    y1 += _HALF
    xs = [(x2 + _HALF) >> XY_SHIFT]
    ys = [(y2 + _HALF) >> XY_SHIFT]
    n = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        xs += ((x1 >> XY_SHIFT) + n).tolist()
        ys += ((y1 + n * y_step) >> XY_SHIFT).tolist()
    else:
        xs += ((x1 + n * x_step) >> XY_SHIFT).tolist()
        ys += ((y1 >> XY_SHIFT) + n).tolist()
    return xs, ys


def _circle_spans(cx: int, cy: int, radius: int):
    """The (row, x from, x to) spans of Circle with fill: the midpoint
    circle's octant walk, each step filling rows cy +- dy over cx +- dx and
    rows cy +- dx over cx +- dy."""
    spans = []
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        spans += [(cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                  (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)]
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return spans


def _fill_convex_poly(p: _Painter, v: Sequence[Tuple[int, int]], shift: int) -> None:
    """FillConvexPoly for 8-connected drawing: each edge drawn as a line,
    then the scanlines between the polygon's left and right chains."""
    npts = len(v)
    delta = (1 << shift) >> 1
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i in range(npts):
        x, y = v[i]
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        q = (x << (XY_SHIFT - shift), y << (XY_SHIFT - shift))
        if shift == 0:
            xs, ys = line_points(p.w, p.h, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                                 (q[0] >> XY_SHIFT, q[1] >> XY_SHIFT))
        else:
            xs, ys = _line2_points(p.w, p.h, p0, q)
        p.points(xs, ys)
        p0 = q
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= p.w or ymin >= p.h:
        return
    ymax = min(ymax, p.h - 1)
    # per chain: [vertex index, index step, x, dx, end row]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0 = e[0]
                idx = (idx0 + e[1]) % npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e[4] = ty
                        e[3] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + e[1]) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            p.hline(y, (edge[left][2] + _HALF) >> XY_SHIFT, (edge[right][2] + _HALF) >> XY_SHIFT)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _thick_line(p: _Painter, p0, p1, thickness: int, flags: int) -> None:
    """ThickLine for 8-connected drawing at shift 0; flags bit 1 caps the
    first end, bit 2 the second."""
    x0, y0 = int(p0[0]), int(p0[1])
    x1, y1 = int(p1[0]), int(p1[1])
    if thickness > 1:
        t = thickness
        inside, x0, y0, x1, y1 = _clip(p.w + 2 * t, p.h + 2 * t, x0 + t, y0 + t, x1 + t, y1 + t)
        if not inside:
            return
        x0, y0, x1, y1 = x0 - t, y0 - t, x1 - t, y1 - t
    if thickness <= 1:
        p.points(*line_points(p.w, p.h, (x0, y0), (x1, y1)))
        return
    fx0, fy0, fx1, fy1 = x0 << XY_SHIFT, y0 << XY_SHIFT, x1 << XY_SHIFT, y1 << XY_SHIFT
    dx = (fx0 - fx1) / XY_ONE
    dy = (fy1 - fy0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (thick + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _round(dy * r), _round(dx * r)
        _fill_convex_poly(p, [(fx0 + dpx, fy0 + dpy), (fx0 - dpx, fy0 - dpy),
                              (fx1 - dpx, fy1 - dpy), (fx1 + dpx, fy1 + dpy)], XY_SHIFT)
    radius = (thick + _HALF) >> XY_SHIFT
    for i, (cx, cy) in enumerate(((fx0, fy0), (fx1, fy1))):
        if flags & (i + 1):
            for row, a, b in _circle_spans((cx + _HALF) >> XY_SHIFT, (cy + _HALF) >> XY_SHIFT,
                                           radius):
                p.hline(row, a, b)


def _round(x: float) -> int:
    """cvRound: to nearest, halves to even."""
    return int(np.rint(x))


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, pt1, pt2, color, thickness) with LINE_8. A thick line
    is first clipped to the image grown by its thickness on every side."""
    _thick_line(_Painter(img, color), pt1, pt2, int(thickness), 3)
    return img


def polylines(img: np.ndarray, pts_list, is_closed: bool, color,
              thickness: int = 1) -> np.ndarray:
    """cv2.polylines(img, pts_list, is_closed, color, thickness), LINE_8."""
    p = _Painter(img, color)
    for pts in pts_list:
        v = np.asarray(pts).reshape(-1, 2)
        if len(v) == 0:
            continue
        i = len(v) - 1 if is_closed else 0
        flags = 2 + (not is_closed)
        prev = v[i]
        for j in range(int(not is_closed), len(v)):
            _thick_line(p, prev, v[j], int(thickness), flags)
            prev = v[j]
            flags = 2
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = -1) -> np.ndarray:
    """cv2.circle(img, center, radius, color, -1): the filled circle (the
    only kind the planner draws)."""
    if thickness >= 0:
        raise NotImplementedError("only filled circles (thickness < 0) are drawn")
    p = _Painter(img, color)
    for row, a, b in _circle_spans(int(center[0]), int(center[1]), int(radius)):
        p.hline(row, a, b)
    return img


def draw_contours(img: np.ndarray, contours, color, thickness: int = -1) -> np.ndarray:
    """cv2.drawContours(img, contours, -1, color, -1), which is
    cv2.fillPoly(img, contours, color), LINE_8, shift 0: every polygon's
    edges go into one collection, each drawn as a line, and each scanline
    is filled between its crossings taken in pairs in x order (even-odd).
    An edge that leaves the image keeps its rows but takes its x from the
    segment clipLine leaves of it (a vertical edge where that is a point).
    Only filled contours are drawn (all the planner draws)."""
    if thickness >= 0:
        raise NotImplementedError("only filled contours (thickness < 0) are drawn")
    p = _Painter(img, color)
    edges = []  # (y0, y1, x at y0, dx) in 16-bit fixed point
    for poly in contours:
        v = np.asarray(poly).reshape(-1, 2).astype(np.int64)
        if len(v) == 0:
            continue
        pt0 = (int(v[-1][0]) << XY_SHIFT, int(v[-1][1]))
        for x, y in v.tolist():
            pt1 = (x << XY_SHIFT, y)
            t0x, t1x = (pt0[0] + _HALF) >> XY_SHIFT, (pt1[0] + _HALF) >> XY_SHIFT
            p.points(*line_points(p.w, p.h, (t0x, pt0[1]), (t1x, pt1[1])))
            c0, c1 = list(pt0), list(pt1)
            if not (0 <= t0x < p.w and 0 <= t1x < p.w and 0 <= pt0[1] < p.h
                    and 0 <= pt1[1] < p.h):
                # the clipped end points, kept where clipLine misses too
                _, cx0, cy0, cx1, cy1 = _clip(p.w, p.h, t0x, pt0[1], t1x, pt1[1])
                c0 = [cx0 << XY_SHIFT, cy0 if cy0 != cy1 else pt0[1]]
                c1 = [cx1 << XY_SHIFT, cy1 if cy0 != cy1 else pt1[1]]
            if pt0[1] != pt1[1]:
                dx = _tdiv(c1[0] - c0[0], c1[1] - c0[1])
                if pt0[1] < pt1[1]:
                    edges.append((pt0[1], pt1[1], c0[0] + (pt0[1] - c0[1]) * dx, dx))
                else:
                    edges.append((pt1[1], pt0[1], c1[0] + (pt1[1] - c1[1]) * dx, dx))
            pt0 = pt1
    _fill_edges(p, edges)
    return img


def _fill_edges(p: _Painter, edges) -> None:
    """FillEdgeCollection: on each row, the active edges (y0 <= y < y1) in x
    order, filled in pairs from ceil(x_a) to floor(x_b): the pixels whose
    left corner lies between the crossings. All rows at once: every
    (row, crossing) pair, sorted by row and x, paired within its row."""
    if len(edges) < 2:
        return
    e = np.array(edges, np.int64).reshape(-1, 4)
    y0, y1, x0, dx = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    x_end = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= p.h or max(x0.max(), x_end.max()) < 0
            or min(x0.min(), x_end.min()) >= (p.w << XY_SHIFT)):
        return
    first = np.maximum(y0, 0)
    rows = np.maximum(np.minimum(y1, p.h) - first, 0)
    edge = np.repeat(np.arange(len(e)), rows)
    if len(edge) == 0:
        return
    row = first[edge] + np.arange(len(edge)) - np.repeat(np.cumsum(rows) - rows, rows)
    x = x0[edge] + (row - y0[edge]) * dx[edge]
    order = np.lexsort((x, row))
    row, x = row[order], x[order]
    start = np.searchsorted(row, row, side="left")
    rank = np.arange(len(row)) - start
    last = np.searchsorted(row, row, side="right") - 1
    left = np.flatnonzero((rank % 2 == 0) & (np.arange(len(row)) < last))
    r, a, b = row[left], (x[left] + XY_ONE - 1) >> XY_SHIFT, x[left + 1] >> XY_SHIFT
    keep = (a < p.w) & (b >= 0)
    r, a, b = r[keep], np.maximum(a[keep], 0), np.minimum(b[keep], p.w - 1)
    keep = a <= b
    r, a, b = r[keep], a[keep], b[keep]
    diff = np.zeros((p.h, p.w + 1), np.int32)
    np.add.at(diff, (r, a), 1)
    np.add.at(diff, (r, b + 1), -1)
    p.img[np.cumsum(diff[:, : p.w], axis=1) > 0] = p.c


def arrowed_line(img: np.ndarray, pt1, pt2, color, thickness: int = 1,
                 tip_length: float = 0.1) -> np.ndarray:
    """cv2.arrowedLine: the line, then two tip strokes of tip_length times
    its length at +-45 degrees from its end."""
    tip = tip_length * math.hypot(pt1[0] - pt2[0], pt1[1] - pt2[1])
    line(img, pt1, pt2, color, thickness)
    angle = math.atan2(pt1[1] - pt2[1], pt1[0] - pt2[0])
    for sign in (1, -1):
        p = (_round(pt2[0] + tip * math.cos(angle + sign * math.pi / 4)),
             _round(pt2[1] + tip * math.sin(angle + sign * math.pi / 4)))
        line(img, p, pt2, color, thickness)
    return img


# ---------------------------------------------------------------------- #
# polygons


def point_polygon_test(contour: np.ndarray, pt, measure_dist: bool) -> float:
    """cv2.pointPolygonTest for an integer contour: +1 / -1 / 0 (inside,
    outside, on an edge), or the signed distance to the nearest edge."""
    cnt = np.asarray(contour).reshape(-1, 2)
    total = len(cnt)
    if total == 0:
        return -float(np.finfo(np.float64).max) if measure_dist else -1.0
    px, py = np.float32(pt[0]), np.float32(pt[1])
    ix, iy = _round(float(px)), _round(float(py))
    if not measure_dist and ix == px and iy == py:
        counter = 0
        vx, vy = int(cnt[-1][0]), int(cnt[-1][1])
        for x, y in cnt.tolist():
            v0x, v0y, vx, vy = vx, vy, x, y
            if (v0y <= iy and vy <= iy) or (v0y > iy and vy > iy) or (v0x < ix and vx < ix):
                if iy == vy and (ix == vx or (iy == v0y and (
                        (v0x <= ix <= vx) or (vx <= ix <= v0x)))):
                    return 0.0
                continue
            dist = (iy - v0y) * (vx - v0x) - (ix - v0x) * (vy - v0y)
            if dist == 0:
                return 0.0
            if vy < v0y:
                dist = -dist
            counter += dist > 0
        return -1.0 if counter % 2 == 0 else 1.0
    f = cnt.astype(np.float32)
    counter = 0
    if not measure_dist:
        vx, vy = f[-1]
        for x, y in f:
            v0x, v0y, vx, vy = vx, vy, x, y
            if (v0y <= py and vy <= py) or (v0y > py and vy > py) or (v0x < px and vx < px):
                if py == vy and (px == vx or (py == v0y and (
                        (v0x <= px <= vx) or (vx <= px <= v0x)))):
                    return 0.0
                continue
            dist = float(py - v0y) * float(vx - v0x) - float(px - v0x) * float(vy - v0y)
            if dist == 0:
                return 0.0
            if vy < v0y:
                dist = -dist
            counter += dist > 0
        return -1.0 if counter % 2 == 0 else 1.0
    return float(signed_distances(cnt, np.array([[pt[0], pt[1]]]))[0])


def signed_distances(contour: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """cv2.pointPolygonTest(contour, pt, True) for each (x, y) row of
    `pts`: the distance to the nearest edge, positive inside.

    OpenCV keeps a running minimum of num / den over the edges in order,
    comparing by cross-multiplication, and a zero distance stops its loop
    (and with it the crossing count). Edges far above a point's least ratio
    never end up as its minimum, so only the near-least ones are walked in
    order, as OpenCV walks them; the rest is vectorized over points and
    edges."""
    cnt = np.asarray(contour).reshape(-1, 2).astype(np.float32)
    pts = np.asarray(pts, np.float64).reshape(-1, 2).astype(np.float32)
    total = len(cnt)
    if total == 0:
        return np.full(len(pts), -np.finfo(np.float64).max)
    v, v0 = cnt[None], np.roll(cnt, 1, axis=0)[None]
    px, py = pts[:, :1], pts[:, 1:]
    dx = (v[..., 0] - v0[..., 0]).astype(np.float64)
    dy = (v[..., 1] - v0[..., 1]).astype(np.float64)
    dx1 = (px - v0[..., 0]).astype(np.float64)
    dy1 = (py - v0[..., 1]).astype(np.float64)
    dx2 = (px - v[..., 0]).astype(np.float64)
    dy2 = (py - v[..., 1]).astype(np.float64)
    before = dx1 * dx + dy1 * dy <= 0
    after = dx2 * dx + dy2 * dy >= 0
    num = np.where(before, dx1 * dx1 + dy1 * dy1,
                   np.where(after, dx2 * dx2 + dy2 * dy2, (dy1 * dx - dx1 * dy) ** 2))
    den = np.where(before | after, 1.0, dx * dx + dy * dy)
    zero = num == 0
    n_used = np.where(zero.any(axis=1), np.argmax(zero, axis=1), total)
    ratio = num / den
    near = ratio <= ratio.min(axis=1, keepdims=True) * (1 + 1e-6)
    cross = ~(((v0[..., 1] <= py) & (v[..., 1] <= py)) | ((v0[..., 1] > py) & (v[..., 1] > py))
              | ((v0[..., 0] < px) & (v[..., 0] < px)))
    side = dy1 * dx - dx1 * dy
    side = np.where(dy < 0, -side, side)
    counted = cross & (side > 0) & (np.arange(total)[None] < n_used[:, None])
    odd = counted.sum(axis=1) % 2 == 1
    out = np.empty(len(pts))
    for i in range(len(pts)):
        min_num, min_den = float(np.finfo(np.float32).max), 1.0
        for j in np.flatnonzero(near[i]).tolist():
            if num[i, j] * min_den < min_num * den[i, j]:
                min_num, min_den = float(num[i, j]), float(den[i, j])
                if min_num == 0:
                    break
        d = math.sqrt(min_num / min_den)
        out[i] = d if odd[i] else -d
    return out


def approx_poly_dp(contour: np.ndarray, epsilon: float, closed: bool) -> np.ndarray:
    """cv2.approxPolyDP for an integer contour, returned as (K, 1, 2) int32."""
    src = [tuple(p) for p in np.asarray(contour).reshape(-1, 2).astype(np.int64).tolist()]
    count = len(src)
    if count == 0:
        return np.zeros((0, 1, 2), np.int32)
    eps = epsilon * epsilon
    init_iters = 3
    slice_ = [0, 0]
    right = [0, 0]
    stack: List[Tuple[int, int]] = []
    dst: List[Tuple[int, int]] = []
    is_closed = closed
    le_eps = False
    pos = 0
    start_pt = (-1000000, -1000000)
    if not is_closed:
        right[0] = count
        end_pt = src[0]
        start_pt = src[count - 1]
        if start_pt != end_pt:
            stack.append((0, count - 1))
        else:
            is_closed = True
            init_iters = 1
    if is_closed:
        right[0] = 0
        for _ in range(init_iters):
            max_dist = 0.0
            pos = (pos + right[0]) % count
            start_pt = src[pos]
            pos = (pos + 1) % count
            for j in range(1, count):
                pt = src[pos]
                pos = (pos + 1) % count
                ddx, ddy = float(pt[0] - start_pt[0]), float(pt[1] - start_pt[1])
                dist = ddx * ddx + ddy * ddy
                if dist > max_dist:
                    max_dist = dist
                    right[0] = j
            le_eps = max_dist <= eps
        if not le_eps:
            right[1] = slice_[0] = pos % count
            slice_[1] = right[0] = (right[0] + slice_[0]) % count
            stack.append(tuple(right))
            stack.append(tuple(slice_))
        else:
            dst.append(start_pt)
    while stack:
        s0, s1 = stack.pop()
        end_pt = src[s1]
        pos = s0
        start_pt = src[pos]
        pos = (pos + 1) % count
        if pos != s1:
            ddx, ddy = float(end_pt[0] - start_pt[0]), float(end_pt[1] - start_pt[1])
            len2 = ddx * ddx + ddy * ddy
            max_dist = 0.0
            while pos != s1:
                pt = src[pos]
                pos = (pos + 1) % count
                vx, vy = float(pt[0] - start_pt[0]), float(pt[1] - start_pt[1])
                dot = vx * ddx + vy * ddy
                if dot <= 0:
                    dist = vx * vx + vy * vy
                elif dot >= len2:
                    ex, ey = float(pt[0] - end_pt[0]), float(pt[1] - end_pt[1])
                    dist = ex * ex + ey * ey
                else:
                    cross = vy * ddx - vx * ddy
                    dist = cross * cross / len2
                if dist > max_dist:
                    max_dist = dist
                    right[0] = (pos + count - 1) % count
            le_eps = max_dist <= eps
        else:
            le_eps = True
            start_pt = src[s0]
        if le_eps:
            dst.append(start_pt)
        else:
            stack.append((right[0], s1))
            stack.append((s0, right[0]))
    if not is_closed:
        dst.append(src[count - 1])
    # drop points on almost straight runs
    is_closed = closed
    count = new_count = len(dst)
    pos = count - 1 if is_closed else 0
    start_pt = dst[pos]
    pos = (pos + 1) % count
    wpos = pos
    pt = dst[pos]
    pos = (pos + 1) % count
    i = int(not is_closed)
    while i < count - int(not is_closed) and new_count > 2:
        end_pt = dst[pos]
        pos = (pos + 1) % count
        ddx, ddy = float(end_pt[0] - start_pt[0]), float(end_pt[1] - start_pt[1])
        dist = abs((pt[0] - start_pt[0]) * ddy - (pt[1] - start_pt[1]) * ddx)
        inner = float((pt[0] - start_pt[0]) * (end_pt[0] - pt[0])
                      + (pt[1] - start_pt[1]) * (end_pt[1] - pt[1]))
        if dist * dist <= 0.5 * eps * (ddx * ddx + ddy * ddy) and ddx != 0 and ddy != 0 \
                and inner >= 0:
            new_count -= 1
            dst[wpos] = start_pt = end_pt
            wpos = (wpos + 1) % count
            pt = dst[pos]
            pos = (pos + 1) % count
            i += 2
            continue
        dst[wpos] = start_pt = pt
        wpos = (wpos + 1) % count
        pt = end_pt
        i += 1
    if not is_closed:
        dst[wpos] = pt
    return np.asarray(dst[:new_count], np.int32).reshape(-1, 1, 2)


# ---------------------------------------------------------------------- #
# morphology and pixels


def _morph(img: np.ndarray, kernel: np.ndarray, op) -> np.ndarray:
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape[:2]
    neutral = 255 if op is np.minimum else 0
    pad = np.full((h + kh - 1, w + kw - 1) + img.shape[2:], neutral, img.dtype)
    pad[ay : ay + h, ax : ax + w] = img
    out = np.full_like(img, neutral)
    for i, j in zip(*np.nonzero(kernel)):
        op(out, pad[i : i + h, j : j + w], out=out)
    return out


def erode(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.erode: the minimum over the kernel anchored at its centre."""
    return _morph(img, kernel, np.minimum)


def dilate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.dilate: the maximum over the kernel anchored at its centre."""
    return _morph(img, kernel, np.maximum)


def morphology_open(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.morphologyEx(MORPH_OPEN): erode, then dilate."""
    return dilate(erode(img, kernel), kernel)


def gray2bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(COLOR_GRAY2BGR)."""
    return np.repeat(img[..., None], 3, axis=2)
