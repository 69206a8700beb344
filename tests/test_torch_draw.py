"""The port's numpy counterparts of the planner's OpenCV calls
(planner/draw.py, queries/clusters.outer_contours) against cv2, and its
Dijkstra (planner/graph.py) against networkx, on seeded random cases:
end points outside the image, zero-length lines, thickness 1 to 9, open
and closed polylines, self-intersecting and overlapping polygons,
self-touching contours.

Tolerance: none. Every image, contour, distance, path and length is
compared for equality."""

import cv2
import networkx as nx
import numpy as np
import pytest
import scipy.ndimage

from activesplat_tpu_torch.planner import draw
from activesplat_tpu_torch.planner import graph as pg
from activesplat_tpu_torch.queries.clusters import outer_contours

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

CASES = 200


def rand_point(rng, w, h, margin):
    return (int(rng.integers(-margin, w + margin)), int(rng.integers(-margin, h + margin)))


def rand_size(rng):
    return int(rng.integers(1, 60)), int(rng.integers(1, 60))


def blobs(rng, h, w):
    """A binary image of smooth blobs (or noise): components with holes,
    touching diagonals and one-pixel spurs."""
    if rng.random() < 0.3:
        return (rng.random((h, w)) < 0.5).astype(np.uint8) * 255
    field = scipy.ndimage.gaussian_filter(rng.random((h, w)), rng.uniform(0.5, 3))
    return (field > rng.uniform(0.3, 0.7)).astype(np.uint8) * 255


@pytest.mark.parametrize("thick", [False, True], ids=["thickness 1", "thickness 2-9"])
def test_line(thick):
    rng = np.random.default_rng(int(thick))
    for _ in range(CASES):
        w, h = rand_size(rng)
        p1 = rand_point(rng, w, h, 20)
        p2 = p1 if rng.random() < 0.05 else rand_point(rng, w, h, 20)
        t = int(rng.integers(2, 10)) if thick else 1
        shape = (h, w) if rng.random() < 0.7 else (h, w, 3)
        color = 255 if len(shape) == 2 else (10, 200, 30)
        want = cv2.line(np.zeros(shape, np.uint8), p1, p2, color, t)
        got = draw.line(np.zeros(shape, np.uint8), p1, p2, color, t)
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h} {p1} {p2} t={t}")


def test_polylines():
    rng = np.random.default_rng(2)
    for _ in range(CASES):
        w, h = rand_size(rng)
        margin = 20 if rng.random() < 0.5 else 0
        k = int(rng.integers(1, 7))
        pts = np.stack([rng.integers(-margin, w + margin, k),
                        rng.integers(-margin, h + margin, k)], 1).astype(np.int32)
        t, closed = int(rng.integers(1, 10)), bool(rng.random() < 0.3)
        want = cv2.polylines(np.zeros((h, w), np.uint8), [pts], closed, 255, t)
        got = draw.polylines(np.zeros((h, w), np.uint8), [pts], closed, 255, t)
        np.testing.assert_array_equal(got, want, err_msg=f"{pts.tolist()} t={t} closed={closed}")


def test_filled_circle():
    rng = np.random.default_rng(3)
    for _ in range(CASES):
        w, h = rand_size(rng)
        c, r = rand_point(rng, w, h, 10), int(rng.integers(0, 15))
        want = cv2.circle(np.zeros((h, w), np.uint8), c, r, 255, -1)
        got = draw.circle(np.zeros((h, w), np.uint8), c, r, 255, -1)
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h} {c} r={r}")


def test_filled_contours():
    """drawContours(-1, thickness -1): one even-odd fill of all contours;
    random (self-intersecting, overlapping, partly outside) polygons and the
    borders findContours traces."""
    rng = np.random.default_rng(4)
    for _ in range(CASES):
        w, h = rand_size(rng)
        margin = int(rng.integers(0, 30)) if rng.random() < 0.5 else 0
        polys = [np.stack([rng.integers(-margin, w + margin, k), rng.integers(-margin, h + margin, k)],
                          1).astype(np.int32).reshape(-1, 1, 2)
                 for k in rng.integers(1, 9, int(rng.integers(1, 4)))]
        if rng.random() < 0.3:
            polys = cv2.findContours(blobs(rng, h, w), cv2.RETR_EXTERNAL,
                                     cv2.CHAIN_APPROX_SIMPLE)[0] or polys
        color = int(rng.integers(1, 256))
        want = cv2.drawContours(np.zeros((h, w), np.uint8), polys, -1, color, -1)
        got = draw.draw_contours(np.zeros((h, w), np.uint8), polys, color)
        np.testing.assert_array_equal(got, want)


def test_find_external_contours():
    """RETR_EXTERNAL, CHAIN_APPROX_SIMPLE: every outer border but those of
    components inside another's hole, the same points in the same order."""
    rng = np.random.default_rng(5)
    for _ in range(CASES):
        h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        img = blobs(rng, h, w)
        want = cv2.findContours(img, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
        got = outer_contours(img)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.reshape(-1, 2))


def test_point_polygon_test():
    """The inside sign (integer and float branches) and the signed distance,
    one point at a time and batched (signed_distances)."""
    rng = np.random.default_rng(6)
    for _ in range(CASES):
        w, h = rand_size(rng)
        k = int(rng.integers(1, 9))
        c = np.stack([rng.integers(0, w, k), rng.integers(0, h, k)], 1).astype(np.int32)
        if rng.random() < 0.3:
            found = cv2.findContours(blobs(rng, h, w), cv2.RETR_EXTERNAL,
                                     cv2.CHAIN_APPROX_SIMPLE)[0]
            c = found[0] if found else c
        for _ in range(5):
            pt = (float(rng.uniform(-5, w + 5)), float(rng.uniform(-5, h + 5)))
            if rng.random() < 0.3:
                pt = (float(int(pt[0])), float(int(pt[1])))  # the integer branch
            for measure in (False, True):
                assert draw.point_polygon_test(c, pt, measure) == \
                    cv2.pointPolygonTest(c, pt, measure), (c.tolist(), pt, measure)
        pts = rng.uniform(-5, max(w, h) + 5, (20, 2))
        np.testing.assert_array_equal(draw.signed_distances(c, pts),
                                      [cv2.pointPolygonTest(c, tuple(p), True) for p in pts])


def test_approx_poly_dp():
    rng = np.random.default_rng(7)
    for _ in range(CASES):
        h, w = int(rng.integers(8, 70)), int(rng.integers(8, 70))
        found = cv2.findContours(blobs(rng, h, w), cv2.RETR_EXTERNAL,
                                 cv2.CHAIN_APPROX_SIMPLE)[0]
        k = int(rng.integers(1, 12))
        curves = list(found) + [np.stack([rng.integers(0, w, k), rng.integers(0, h, k)],
                                         1).astype(np.int32).reshape(-1, 1, 2)]
        for c in curves:
            eps, closed = float(rng.uniform(0.3, 6)), bool(rng.random() < 0.8)
            np.testing.assert_array_equal(draw.approx_poly_dp(c, eps, closed),
                                          cv2.approxPolyDP(c, eps, closed))


def test_morphology_and_pixels():
    """morphologyEx(MORPH_OPEN) and dilate with ellipse and rectangle
    kernels (even sizes anchored at w // 2), and GRAY2BGR."""
    rng = np.random.default_rng(8)
    for _ in range(CASES):
        h, w = rand_size(rng)
        img = (rng.random((h, w)) < 0.6).astype(np.uint8) * 255
        kw, kh = int(rng.integers(1, 8)), int(rng.integers(1, 8))
        shape = cv2.MORPH_ELLIPSE if rng.random() < 0.5 else cv2.MORPH_RECT
        kernel = cv2.getStructuringElement(shape, (kw, kh))
        np.testing.assert_array_equal(draw.morphology_open(img, kernel),
                                      cv2.morphologyEx(img, cv2.MORPH_OPEN, kernel))
        np.testing.assert_array_equal(draw.dilate(img, kernel), cv2.dilate(img, kernel))
        np.testing.assert_array_equal(draw.gray2bgr(img), cv2.cvtColor(img, cv2.COLOR_GRAY2BGR))


def test_arrowed_line():
    rng = np.random.default_rng(9)
    for _ in range(CASES):
        w, h = rand_size(rng)
        p1, p2 = rand_point(rng, w, h, 5), rand_point(rng, w, h, 5)
        t = int(rng.integers(1, 4))
        want = cv2.arrowedLine(np.zeros((h, w, 3), np.uint8), p1, p2, (0, 255, 10), t)
        got = draw.arrowed_line(np.zeros((h, w, 3), np.uint8), p1, p2, (0, 255, 10), t)
        np.testing.assert_array_equal(got, want)


def random_graph(rng, n):
    """A symmetric weight matrix with many equal weights (ties between
    paths) and some unreachable nodes."""
    a = np.zeros((n, n))
    for _ in range(int(rng.integers(n, 3 * n))):
        u, v = rng.integers(0, n - n // 5, 2)
        if u != v:
            a[u, v] = a[v, u] = float(rng.choice([1.0, 2.0, 3.0, 0.5, rng.uniform(0.1, 3)]))
    return a


def test_dijkstra_matches_networkx():
    """Paths (ties resolved alike), path lengths, the edge list with weights,
    and the two failures (no path, no such source) as networkx raises them."""
    rng = np.random.default_rng(10)
    for _ in range(40):
        n = int(rng.integers(2, 40))
        a = random_graph(rng, n)
        g, ref = pg.Graph.from_numpy_array(a), nx.from_numpy_array(a)
        assert g.edges(data=True) == list(ref.edges(data=True))
        assert [list(g.neighbors(u)) for u in g] == [list(ref.neighbors(u)) for u in ref]
        assert dict(pg.all_pairs_dijkstra_path_length(g)) == \
            dict(nx.all_pairs_dijkstra_path_length(ref))
        for s, t in rng.integers(0, n + 2, (10, 2)).tolist():
            try:
                want = nx.dijkstra_path(ref, s, t)
            except (nx.NetworkXNoPath, nx.NodeNotFound) as err:
                kind = pg.NoPath if isinstance(err, nx.NetworkXNoPath) else pg.NodeNotFound
                with pytest.raises(kind):
                    pg.dijkstra_path(g, s, t)
                continue
            assert pg.dijkstra_path(g, s, t) == want
