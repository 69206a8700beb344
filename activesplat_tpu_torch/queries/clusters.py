"""Host-side invisibility clustering and hole-volume scoring in numpy and scipy
(counterpart of activesplat_tpu/queries/clusters.py, reference
src/mapper/__init__.py:8-117).

The reference package calls OpenCV and scikit-learn here; the port rewrites
each call so that it needs neither:

- DBSCAN on up to GRID_DBSCAN_MIN_POINTS points (`_dbscan_labels`): radius
  neighbours from a k-d tree (exact integer distances on pixel grids), core
  points with >= min_samples neighbours (self included), clusters as the
  connected components of the core graph numbered by their lowest core
  index, and each border point given to the lowest-numbered cluster with a
  core within eps: the labels scikit-learn's DBSCAN assigns, since it grows
  clusters in index order and a border point keeps the first cluster that
  reaches it.
- the grid DBSCAN above that size (`_grid_dbscan_labels`): the disk
  correlation (filter2D), the binary dilation (dilate), 8-connected
  labelling numbered as OpenCV's block scan numbers (connectedComponents),
  and the nearest core under OpenCV's 5x5 chamfer metric (weights 1, 1.4,
  2.1969 in 16-bit fixed point) as a minimum over the window of offsets
  within eps (distanceTransformWithLabels(DIST_L2, 5)). Where two cores tie
  for nearest, OpenCV's two-pass sweep decides by its scan order and the
  port takes the first offset in (distance, row, column) order; the tests
  count those cases.
- the 15x15 elliptical structuring element (getStructuringElement).
- the outer borders of the dilated hole (findContours(RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE), `outer_contours`, which the planner also uses):
  Suzuki-Abe border following from the first raster pixel of each
  component not inside another's hole, each straight run compressed to its
  end points, in OpenCV's order, and the shoelace area (contourArea) to
  pick the largest. The
  border's points (not just its hull) must match, since each is lifted to
  3-D with its own depth.
- the rank-deficient ring's jitter draws from an explicit
  np.random.Generator (the reference draws from numpy's global state).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import scipy.ndimage
import scipy.sparse
import scipy.sparse.csgraph
import scipy.spatial

# Above this many pixels DBSCAN switches to the grid path (a k-d tree walk
# over a mostly invisible 150x360 panorama is the planner's early-
# exploration hot path); below it the exact DBSCAN labels are kept.
GRID_DBSCAN_MIN_POINTS = 5000

# OpenCV's DIST_L2 5x5 chamfer weights (axial, diagonal, knight move) in its
# 16-bit fixed point: cvRound(w * 65536) of the float weights 1, 1.4, 2.1969
_CHAMFER_FIX = (65536, 91750, 143976)
_CHAMFER_SCALE = np.float32(1.0 / 65536)

# Suzuki-Abe chain codes: direction s -> (dx, dy), counter-clockwise from +x
# on an image whose y axis points down
_CHAIN = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))


def _disk_kernel(radius: float) -> np.ndarray:
    r = int(np.floor(radius))
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
    return (yy * yy + xx * xx <= radius * radius).astype(np.uint8)


def ellipse_kernel(width: int, height: int) -> np.ndarray:
    """OpenCV's MORPH_ELLIPSE structuring element of (width, height): row i
    spans c +- round(c sqrt((r^2 - dy^2) / r^2)), r = height // 2,
    c = width // 2, dy = i - r (round half to even)."""
    r, c = height // 2, width // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    out = np.zeros((height, width), np.uint8)
    for i in range(height):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            out[i, max(c - dx, 0) : min(c + dx + 1, width)] = 1
    return out


def _chamfer_offsets(eps: float):
    """Offsets (dy, dx) whose 5x5 chamfer distance is <= eps, with that
    distance in float32 as OpenCV computes it, nearest first (ties in
    raster order of the offset)."""
    r = int(np.ceil(eps))
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
    a = np.maximum(np.abs(yy), np.abs(xx))
    b = np.minimum(np.abs(yy), np.abs(xx))
    knight = np.minimum(b, a - b)
    axial, diag, long = _CHAMFER_FIX
    fixed = axial * (a - b - knight) + diag * (b - knight) + long * knight
    dist = fixed.astype(np.float32) * _CHAMFER_SCALE
    keep = dist <= eps
    order = np.lexsort((xx[keep], yy[keep], dist[keep]))
    return yy[keep][order], xx[keep][order], dist[keep][order]


def _label_like_opencv(mask: np.ndarray) -> np.ndarray:
    """8-connected components of `mask` (0 background), numbered 1.. in the
    order OpenCV's block-based scan (connectedComponents) first meets them:
    by the 2x2 block (row // 2, col // 2) of their first pixel in block
    raster order."""
    comp, n = scipy.ndimage.label(mask, structure=np.ones((3, 3), int))
    if n == 0:
        return comp
    ys, xs = np.nonzero(comp)
    block = (ys // 2) * ((mask.shape[1] + 1) // 2) + xs // 2
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, comp[ys, xs], block)
    rank = np.empty(n + 1, np.int64)
    rank[0] = 0
    rank[1 + np.argsort(first[1:], kind="stable")] = np.arange(1, n + 1)
    return rank[comp]


def _grid_cores(shape, points, eps, min_samples):
    """(core mask, cluster id image: 1.. on cores, 0 elsewhere) of the grid
    DBSCAN."""
    mask = np.zeros(shape, np.uint8)
    mask[points[:, 0], points[:, 1]] = 1
    counts = scipy.ndimage.correlate(
        mask.astype(np.float32), _disk_kernel(eps).astype(np.float32), mode="constant", cval=0.0
    )
    core = (counts >= min_samples - 0.5) & (mask > 0)
    merged = scipy.ndimage.binary_dilation(core, structure=_disk_kernel(eps / 2.0).astype(bool))
    return core, np.where(core, _label_like_opencv(merged), 0)


def _shifted_cores(comp, eps):
    """For each chamfer offset within eps, nearest first: (distance, the
    cluster id image shifted by it, 0 off the image)."""
    h, w = comp.shape
    pad = int(np.ceil(eps))
    comp_p = np.pad(comp, pad)
    for dy, dx, dist in zip(*_chamfer_offsets(eps)):
        yield dist, comp_p[pad + dy : pad + dy + h, pad + dx : pad + dx + w]


def _grid_dbscan_labels(
    shape: Tuple[int, int], points: np.ndarray, eps: float, min_samples: int
) -> np.ndarray:
    """DBSCAN for integer grid points via image morphology.

    core = points with >= min_samples neighbours in the eps-disk (self
    included); clusters = connected components of the cores dilated by an
    eps/2 disk (cores within eps overlap); border points join the cluster of
    their nearest core within eps under the 5x5 chamfer metric; the rest is
    noise (-1)."""
    core, comp = _grid_cores(shape, points, eps, min_samples)
    if not core.any():
        return np.full(len(points), -1, np.int64)
    # offsets nearest first: the first core met at a pixel is its nearest
    label = np.zeros(shape, np.int64)
    for _, shifted in _shifted_cores(comp, eps):
        take = (label == 0) & (shifted > 0)
        label[take] = shifted[take]
    return label[points[:, 0], points[:, 1]] - 1


def _dbscan_exact(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """scikit-learn's DBSCAN labels (euclidean, distance <= eps)."""
    n = len(points)
    pairs = scipy.spatial.cKDTree(points).query_pairs(eps + 1e-9, output_type="ndarray")
    if len(pairs):
        d2 = ((points[pairs[:, 0]] - points[pairs[:, 1]]).astype(np.float64) ** 2).sum(1)
        pairs = pairs[d2 <= eps * eps]
    n_nb = 1 + np.bincount(pairs.ravel(), minlength=n)  # self included
    core = n_nb >= min_samples
    labels = np.full(n, -1, np.int64)
    if not core.any():
        return labels
    both = core[pairs[:, 0]] & core[pairs[:, 1]]
    graph = scipy.sparse.coo_matrix(
        (np.ones(int(both.sum())), (pairs[both, 0], pairs[both, 1])), shape=(n, n)
    )
    _, comp = scipy.sparse.csgraph.connected_components(graph, directed=False)
    core_ids = np.flatnonzero(core)
    # clusters numbered by their lowest core index
    first = np.full(comp.max() + 1, n)
    np.minimum.at(first, comp[core_ids], core_ids)
    used = np.unique(comp[core_ids])
    number = np.full(comp.max() + 1, -1)
    number[used[np.argsort(first[used])]] = np.arange(len(used))
    labels[core_ids] = number[comp[core_ids]]
    # a border point: the lowest-numbered cluster among its core neighbours
    src = np.concatenate([pairs[:, 0], pairs[:, 1]])
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]])
    sel = core[src] & ~core[dst]
    big = np.iinfo(np.int64).max
    cand = np.full(n, big)
    np.minimum.at(cand, dst[sel], labels[src[sel]])
    labels[cand < big] = cand[cand < big]
    return labels


def _dbscan_labels(
    shape: Tuple[int, int], points: np.ndarray, eps: float, min_samples: int
) -> np.ndarray:
    if len(points) > GRID_DBSCAN_MIN_POINTS:
        return _grid_dbscan_labels(shape, points, eps, min_samples)
    return _dbscan_exact(points, eps, min_samples)


def get_invisibility_clusters(
    invisibility: np.ndarray, cluster_invisibility_threshold: float = 30.0
) -> Tuple[List[np.ndarray], List[float]]:
    """Cluster pixels with invisibility > 0.3; keep clusters whose summed
    invisibility exceeds the threshold. Returns (centers (row, col), sums)
    (get_invisibility_clusters, src/mapper/__init__.py:92-117)."""
    points = np.column_stack(np.where(invisibility > 0.3))
    if len(points) == 0:
        return [], []
    labels = _dbscan_labels(invisibility.shape, points, eps=5, min_samples=10)
    centers, sums = [], []
    for label in set(labels):
        if label == -1:
            continue
        members = points[labels == label]
        total = float(np.sum(invisibility[members[:, 0], members[:, 1]]))
        if total > cluster_invisibility_threshold:
            centers.append(members.mean(axis=0))
            sums.append(total)
    return centers, sums


def _outer_border(img: np.ndarray, y0: int, x0: int) -> np.ndarray:
    """The outer border of the 8-connected component whose first raster
    pixel is (y0, x0) in `img` (nonzero = foreground, zero-padded by one
    pixel), traced as OpenCV's border follower traces it, with each straight
    run compressed to its end points (CHAIN_APPROX_SIMPLE). Returns (K, 2)
    (x, y) points in `img`'s coordinates. Pixels are walked as offsets into
    the flattened image."""
    w = img.shape[1]
    fg = (img != 0).tobytes()
    offs = [dy * w + dx for dx, dy in _CHAIN]
    p0 = y0 * w + x0
    # the last neighbour of the start, searched clockwise from up-left
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        if fg[p0 + offs[s]] or s == s_end:
            break
    if s == s_end:  # a single pixel
        return np.array([[x0, y0]])
    i1 = p0 + offs[s]
    p = p0
    prev_s = s ^ 4
    out = []
    while True:
        # the next foreground neighbour counter-clockwise after the previous
        for step in range(1, 9):
            if fg[p + offs[(s + step) & 7]]:
                s = (s + step) & 7
                break
        if s != prev_s:
            out.append(p)
            prev_s = s
        nxt = p + offs[s]
        if nxt == p0 and p == i1:
            break
        p = nxt
        s = (s + 4) & 7
    out = np.array(out)
    return np.stack([out % w, out // w], axis=1)


def _shoelace_area(contour: np.ndarray) -> float:
    """contourArea: the polygon's area from its (x, y) vertices."""
    x = contour[:, 0].astype(np.float64)
    y = contour[:, 1].astype(np.float64)
    return abs(float(np.sum(np.roll(x, 1) * y - x * np.roll(y, 1)))) * 0.5


def outer_contours(mask: np.ndarray) -> List[np.ndarray]:
    """findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE): the outer border of
    every 8-connected component of `mask` that does not lie in another
    component's hole, as (K, 2) (x, y) points, in OpenCV's order (the
    borders last found first). A component lies in a hole when the
    4-connected background left of its first raster pixel is not the
    background around the image."""
    comp, n = scipy.ndimage.label(mask > 0, structure=np.ones((3, 3), int))
    if n == 0:
        return []
    img = np.pad((mask > 0).astype(np.uint8), 1)
    background, _ = scipy.ndimage.label(img == 0)
    flat = comp.ravel()
    firsts = np.full(n + 1, flat.size)
    np.minimum.at(firsts, flat, np.arange(flat.size))
    out = []
    for c in range(n, 0, -1):
        y0, x0 = divmod(int(firsts[c]), mask.shape[1])
        if background[y0 + 1, x0] == background[0, 0]:
            out.append(_outer_border(img, y0 + 1, x0 + 1) - 1)
    return out


def largest_outer_contour(mask: np.ndarray) -> Optional[np.ndarray]:
    """The outer border with the largest area among the 8-connected
    components of `mask` (RETR_EXTERNAL, CHAIN_APPROX_SIMPLE, then the max
    of contourArea), as (K, 2) (x, y) points; None for an empty mask.
    max() keeps the first of equal areas, in OpenCV's order."""
    return max(outer_contours(mask), key=_shoelace_area, default=None)


def get_convexhull_volume(
    depth: np.ndarray,  # (H, W_total) stitched panorama depth
    invisibility: np.ndarray,  # (H, W_total)
    vfov_deg: float = 150.0,
    depth_far: float = 15.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[float, float]:
    """Score map holes: cluster highly invisible pixels (> 0.8), take each
    cluster's dilated outer border, lift it to (azimuth, elevation, depth)
    coordinates and sum the ConvexHull volumes weighted by the cluster's
    invisibility (get_convexhull_volume, src/mapper/__init__.py:8-90).
    Returns (sum of invisibility * volume, sum of volumes). A ring of rank
    below 3 is jittered by 1e-10 with `rng` (default: seeded with 0)."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    points = np.column_stack(np.where(invisibility > 0.8))
    if len(points) == 0:
        return 0.0, 0.0
    rng = np.random.default_rng(0) if rng is None else rng
    labels = _dbscan_labels(invisibility.shape, points, eps=5, min_samples=25)
    kernel = ellipse_kernel(15, 15).astype(bool)
    h_rad_per_px = np.deg2rad(360.0 / depth.shape[1])
    v_rad_per_px = np.deg2rad(vfov_deg / depth.shape[0])

    inv_volume_sum = 0.0
    volume_sum = 0.0
    for label in set(labels):
        if label == -1:
            continue
        members = points[labels == label]
        mask = np.zeros(invisibility.shape, bool)
        mask[members[:, 0], members[:, 1]] = True
        cluster_invisibility = invisibility[members[:, 0], members[:, 1]]
        contour = largest_outer_contour(scipy.ndimage.binary_dilation(mask, structure=kernel))
        if contour is None:
            continue
        ring = []
        for x, y in contour:
            z = depth[y, x]
            if z >= depth_far:  # unmapped or far pixels carry no geometry
                continue
            ring.append([x * h_rad_per_px, y * v_rad_per_px, z])
        ring = np.asarray(ring, np.float64)
        volume = 0.0
        if len(ring) >= 4:
            if np.linalg.matrix_rank(ring - ring.mean(0)) < 3:
                ring = ring + rng.normal(scale=1e-10, size=ring.shape)
            try:
                volume = float(scipy.spatial.ConvexHull(ring).volume)
            except scipy.spatial.QhullError:
                volume = 0.0
        inv_volume_sum += float(np.sum(cluster_invisibility)) * volume
        volume_sum += volume
    return inv_volume_sum, volume_sum


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """OpenCV's INTER_AREA resize of a float64 image to (width, height), for
    shrinking: an integer ratio of 2 in both axes averages each 2x2 block
    ((a + b) + c) + d then times 0.25; otherwise each output pixel is the
    area-weighted mean of the source cells it covers, with OpenCV's float32
    weights, summed along x and then along y in source order."""
    src = np.asarray(img, np.float64)
    h, w = src.shape
    if h == 2 * height and w == 2 * width:
        s = src.reshape(height, 2, width, 2)
        return (((s[:, 0, :, 0] + s[:, 0, :, 1]) + s[:, 1, :, 0]) + s[:, 1, :, 1]) * 0.25
    if height > h or width > w:
        raise ValueError("resize_area only shrinks")
    rows = _area_weights(h, height, h / height)
    cols = _area_weights(w, width, w / width)
    tmp = np.zeros((h, width))
    for di, si, a in cols:
        tmp[:, di] += src[:, si] * a
    out = np.zeros((height, width))
    for di, si, a in rows:
        out[di] += tmp[si] * a
    return out


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """OpenCV's INTER_LINEAR resize of a uint8 image (H, W) to (width,
    height), bitwise: source positions (d + 0.5) * scale - 0.5 in float32,
    11-bit fixed-point weights rounded from float32, columns clamped to the
    border (weight 1 on the edge pixel) and rows not (the border row taken
    twice with both weights); the horizontal pass in integers, then the
    vertical pass as OpenCV's vectorized path computes it,
    ((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16), rounded by (+2) >> 2."""
    src = np.asarray(img, np.int64)
    sy, sy1, b0, b1 = _linear_taps(src.shape[0], height, clamp=False)
    sx, sx1, a0, a1 = _linear_taps(src.shape[1], width, clamp=True)
    rows = src[:, sx] * a0 + src[:, sx1] * a1  # (H, width), weights sum to 2048
    out = (((rows[sy] >> 4) * b0[:, None]) >> 16) + (((rows[sy1] >> 4) * b1[:, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def _linear_taps(ssize: int, dsize: int, clamp: bool):
    """(first source index, second source index, weight0, weight1) per
    destination index, the weights in 1/2048 units."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= ssize - 1)
        f = np.where(edge, np.float32(0.0), f)
        s = np.clip(s, 0, ssize - 1)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return np.clip(s, 0, ssize - 1), np.clip(s + 1, 0, ssize - 1), w0, w1


def _area_weights(ssize: int, dsize: int, scale: float):
    """computeResizeAreaTab: (destination, source, float32 weight) triples
    in OpenCV's order."""
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, float(np.float32((sx1 - fsx1) / cell))))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, float(np.float32(1.0 / cell))))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, float(np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell))))
    return tab
