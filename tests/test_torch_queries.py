"""The port's panorama queries and host-side hole scoring against the JAX
package (which calls OpenCV and scikit-learn, installed here), on the same
numpy inputs: DBSCAN labels (exact and grid), the invisibility clusters, the
convex-hull volume, the elliptical kernel, the INTER_AREA resize, the
coordinate helpers, render_panorama and the global and local invisibility
queries. The JAX views take its exact CSR render (Pallas in interpret mode)
by patching forward_backend to "pallas", as tests/test_queries.py does.

Tolerances. Rendered values 1e-5 (the same float32 walk, sums in another
order). The score inputs are quantized on both sides (uint16 mm, uint8 /
255) and compared exactly; on equal inputs the scores agree to 1e-9
relative (volumes: the same hull of the same points), the reach exactly and
the best pose to 1e-9. The grid DBSCAN may differ from OpenCV only at
border points whose nearest cores tie under the chamfer metric and belong to
different clusters; the tests count them. A rank-deficient hull ring is
jittered from another random stream; the tests count those rings."""

import itertools
import sys

import cv2
import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN

import activesplat_tpu.queries.panorama as jpano
from activesplat_tpu.models.gaussians import GaussianBuffer as JaxBuffer
from activesplat_tpu.queries import clusters as jc
from activesplat_tpu.queries import topdown as jtd
from activesplat_tpu.runtime.synthetic import BoxWorld
from activesplat_tpu_torch.queries import clusters as tc
from activesplat_tpu_torch.queries import panorama as tpano
from activesplat_tpu_torch.queries import topdown as ttd
from tests.test_queries import buffer_from_points, world_topdown_cfg
from tests.test_torch_topdown import CFG_FIELDS, port_buffer

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (150, 360)


# --------------------------------------------------------------------------- #
# Scenes for the hole scoring
# --------------------------------------------------------------------------- #


def blob_scene(seed=1):
    """tests/test_queries.py:129-153: four discs and isolated speckles."""
    rng = np.random.default_rng(seed)
    inv = np.zeros(SHAPE)
    yy, xx = np.mgrid[: SHAPE[0], : SHAPE[1]]
    for cy, cx, r in [(40, 60, 18), (100, 200, 25), (70, 300, 12), (20, 330, 9)]:
        inv[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 0.95
    inv[rng.uniform(size=SHAPE) < 0.002] = 0.95
    return inv


def speckle_scene(seed=2):
    """Quantized invisibility with dense random speckle over bands: clusters
    touch and border points sit between them."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 256, SHAPE)
    k[:, 100:180] = np.where(rng.uniform(size=(SHAPE[0], 80)) < 0.6, 0, 255)
    k[rng.uniform(size=SHAPE) < 0.25] = 10
    return 1.0 - k / 255.0


def early_scene(seed=3):
    """An early-exploration panorama: mostly invisible, one mapped wall band
    with holes, depth rising with the column."""
    rng = np.random.default_rng(seed)
    alpha = np.zeros(SHAPE)
    alpha[40:110, 90:270] = 1.0
    alpha[60:80, 150:175] = 0.0
    alpha[rng.uniform(size=SHAPE) < 0.01] = 0.5
    yy, xx = np.mgrid[: SHAPE[0], : SHAPE[1]]
    depth = np.where(alpha > 0, 2.0 + 0.5 * np.sin(xx / 17.0) * np.cos(yy / 13.0), 0.0)
    return 1.0 - np.round(alpha * 255) / 255.0, np.round(depth * 1000) / 1000.0


def nearest_core_ties(shape, points, eps, min_samples) -> np.ndarray:
    """(N,) bool: the border points whose nearest cores (chamfer metric,
    within eps) tie and belong to different clusters. There OpenCV's sweep
    order, not the metric, picks the cluster; the tests count them."""
    core, comp = tc._grid_cores(shape, points, eps, min_samples)
    best = np.full(shape, np.inf, np.float32)
    first = np.zeros(shape, np.int64)
    tied = np.zeros(shape, bool)
    for dist, shifted in tc._shifted_cores(comp, eps):
        hit = shifted > 0
        tied |= hit & (dist == best) & (shifted != first)
        new = hit & (dist < best)
        best[new], first[new] = dist, shifted[new]
    return (tied & ~core)[points[:, 0], points[:, 1]]


SCENES = {"blob": blob_scene, "speckle": speckle_scene, "early": lambda: early_scene()[0]}


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("threshold,min_samples", [(0.3, 10), (0.8, 25)])
def test_dbscan_labels_match_jax(scene, threshold, min_samples):
    """_dbscan_labels on every scene (the grid path above 5,000 points) and
    the exact path on a subsample of at most 5,000 against scikit-learn:
    labels equal except at counted chamfer ties; noise sets equal."""
    inv = SCENES[scene]()
    pts = np.column_stack(np.where(inv > threshold))
    ref = jc._dbscan_labels(SHAPE, pts, 5, min_samples)
    got = tc._dbscan_labels(SHAPE, pts, 5, min_samples)
    tied = (nearest_core_ties(SHAPE, pts, 5, min_samples)
            if len(pts) > tc.GRID_DBSCAN_MIN_POINTS else np.zeros(len(pts), bool))
    assert not ((got != ref) & ~tied).any()
    np.testing.assert_array_equal(got == -1, ref == -1)
    print(f"{scene}: {len(pts)} points, {int(tied.sum())} chamfer ties, "
          f"{int((got != ref).sum())} labelled otherwise than OpenCV")
    sub = pts[np.random.default_rng(0).permutation(len(pts))[:3000]]
    np.testing.assert_array_equal(
        tc._dbscan_exact(sub, 5, min_samples), DBSCAN(eps=5, min_samples=min_samples).fit_predict(sub)
    )


def test_grid_dbscan_blob_coclustering():
    """test_grid_dbscan_matches_sklearn's scene: the port's grid labels
    partition it as scikit-learn does, and equal OpenCV's exactly."""
    inv = blob_scene()
    pts = np.column_stack(np.where(inv > 0.8))
    ref = DBSCAN(eps=5, min_samples=25).fit_predict(pts)
    got = tc._grid_dbscan_labels(SHAPE, pts, eps=5, min_samples=25)
    np.testing.assert_array_equal(got, jc._grid_dbscan_labels(SHAPE, pts, eps=5, min_samples=25))
    np.testing.assert_array_equal(got == -1, ref == -1)
    both = np.flatnonzero(ref >= 0)
    sample = np.random.default_rng(1).choice(both, size=60, replace=False)
    for i, j in itertools.combinations(sample, 2):
        assert (ref[i] == ref[j]) == (got[i] == got[j])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_invisibility_clusters_match_jax(scene):
    inv = SCENES[scene]()
    ref_c, ref_s = jc.get_invisibility_clusters(inv, 25.0)
    got_c, got_s = tc.get_invisibility_clusters(inv, 25.0)
    assert len(got_s) == len(ref_s) > 0
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-12)
    np.testing.assert_allclose(np.array(got_c), np.array(ref_c), rtol=1e-12)


@pytest.mark.parametrize("scene", ["blob", "early"])
def test_convexhull_volume_matches_jax(scene, monkeypatch):
    """Equal (inv_sum, volume) where no hull ring is rank-deficient, 1e-9
    relative; rings that take the jitter are counted."""
    if scene == "early":
        inv, depth = early_scene()
    else:
        inv = blob_scene()
        depth = 1.0 + np.random.default_rng(5).uniform(size=SHAPE)
    jittered = []
    real_rank = np.linalg.matrix_rank
    monkeypatch.setattr(np.linalg, "matrix_rank", lambda a: jittered.append(real_rank(a) < 3) or real_rank(a))
    np.random.seed(0)
    ref = jc.get_convexhull_volume(depth, inv)
    got = tc.get_convexhull_volume(depth, inv)
    assert ref[1] > 0
    # a jittered ring is flat: its hull volume is of the jitter's order
    # (1e-10 per coordinate), and each side draws other jitter
    n_jit = sum(jittered) // 2
    print(f"{scene}: {n_jit} of {len(jittered) // 2} hull rings jittered")
    assert n_jit == {"blob": 0, "early": 1}[scene]
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-6 * n_jit)


def test_contours_match_opencv():
    """The largest outer border (points, in order) of random dilated blobs
    and speckle against findContours + contourArea."""
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[:60, :80]
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (15, 15))
    for i in range(40):
        m = np.zeros((60, 80), np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            cy, cx, r = rng.integers(0, 60), rng.integers(0, 80), rng.integers(1, 10)
            m[(yy - cy) ** 2 + ((xx - cx) * rng.uniform(0.5, 2)) ** 2 <= r * r] = 255
        m[rng.uniform(size=m.shape) < 0.01] = 255
        if i % 2:
            m = cv2.dilate(m, kernel)
        contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        ref = max(contours, key=cv2.contourArea).reshape(-1, 2)
        got = tc.largest_outer_contour(m)
        np.testing.assert_array_equal(got, ref)
        assert tc._shoelace_area(got) == cv2.contourArea(ref)
    assert tc.largest_outer_contour(np.zeros((5, 5), np.uint8)) is None


def test_ellipse_kernel_and_area_resize_match_opencv():
    for size in [(15, 15), (7, 5), (4, 6)]:
        np.testing.assert_array_equal(
            tc.ellipse_kernel(*size), cv2.getStructuringElement(cv2.MORPH_ELLIPSE, size)
        )
    rng = np.random.default_rng(7)
    for scale in (1.0, 0.5):  # the panorama's shape at each pano scale
        h, w = int(round(150 * scale)), int(round(360 * scale))
        invis = 1.0 - rng.integers(0, 256, (h, w)) / 255.0
        size = (int(w * 0.5), int(h * 0.5))
        np.testing.assert_array_equal(
            tc.resize_area(invis, *size), cv2.resize(invis, size, interpolation=cv2.INTER_AREA)
        )


def test_coordinate_helpers_match_jax():
    cfg = world_topdown_cfg(BoxWorld.single_room(seed=1))
    tcfg = ttd.TopdownConfig(**{f: getattr(cfg, f) for f in CFG_FIELDS})
    pts = np.array([[1.0, 0.5, 2.0], [4.5, 1.0, 5.0], [3.3, 0.0, 0.7]])
    np.testing.assert_array_equal(ttd.world_to_topdown(pts, tcfg), jtd.world_to_topdown(pts, cfg))
    rng = np.random.default_rng(8)
    for _ in range(5):
        c2w = np.eye(4)
        c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        np.testing.assert_array_equal(ttd.heading_to_topdown(c2w, tcfg), jtd.heading_to_topdown(c2w, cfg))
    np.testing.assert_array_equal(
        ttd.horizon_bbox_topdown(pts[0], pts[1], tcfg), jtd.horizon_bbox_topdown(pts[0], pts[1], cfg)
    )


# --------------------------------------------------------------------------- #
# The panorama queries
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_exact_views():
    """The JAX views through the exact CSR render (Pallas, interpret mode),
    for the whole module so that the tests share the JAX compiles."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys.modules["activesplat_tpu.ops.render"], "forward_backend", lambda: "pallas")
        for fn in (jpano._render_views, jpano._render_views_quantized):
            fn.clear_cache()
        yield
        for fn in (jpano._render_views, jpano._render_views_quantized):
            fn.clear_cache()


def pose(center):
    c2w = np.eye(4)
    c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
    c2w[:3, 3] = center
    return c2w


def hole_buffer():
    """tests/test_queries.py:105-126: a half-cylinder of splats around the
    camera, the back hemisphere a hole."""
    rng = np.random.default_rng(5)
    n = 20000
    az = rng.uniform(-np.pi / 2, np.pi / 2, n)
    y = rng.uniform(-2.0, 2.0, n)
    center = np.array([3.0, 1.25, 3.0])
    pts = center + np.stack([2.0 * np.sin(az), y, -2.0 * np.cos(az)], axis=-1)
    return buffer_from_points(pts, scale=0.08), center


def test_render_panorama_matches_jax(jax_exact_views):
    """tests/test_queries.py:156-187's scene: rgb, depth and invisibility
    within 1e-5."""
    rng = np.random.default_rng(7)
    pts = np.stack([rng.uniform(2, 4, 3000), rng.uniform(0.5, 2, 3000), rng.uniform(2, 4, 3000)], -1)
    jbuf = buffer_from_points(pts, scale=0.05)
    c2w = pose([3.0, 1.25, 3.0])
    ref = jpano.render_panorama(jbuf, c2w, chunk=256)
    got = tpano.render_panorama(port_buffer(jbuf), c2w, chunk=256)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5)
    assert got[0].max() > 0 and got[1].max() > 0


def node_c2w(view_c2w, position):
    c2w = np.array(view_c2w)
    c2w[0, 3], c2w[2, 3] = position[0], position[2]
    return c2w


def test_global_invisibility_matches_jax(jax_exact_views, monkeypatch):
    """Two nodes and one skipped node (at the origin). The port's quantized
    score inputs equal JAX's but for pixels whose value sits within 1e-5 of
    a rounding boundary (counted); the port's scoring of JAX's quantized
    inputs equals JAX's scores; end to end the reach is equal."""
    jbuf, center = hole_buffer()
    tbuf = port_buffer(jbuf)
    c2w = pose(center)
    nodes = np.array([center, [0.0, 0.0, 0.0], center + [0.5, 0.0, -0.3]])
    seen = []
    real = jpano._render_views_quantized
    monkeypatch.setattr(jpano, "_render_views_quantized", lambda *a: seen.append(real(*a)) or seen[-1])
    ref = jpano.global_invisibility(jbuf, c2w, nodes, chunk=256)
    keep = [0, 1, 2, 6, 7, 8]  # JAX renders the skipped node's views too
    ref_q = [np.asarray(x)[keep] for x in seen[0]]
    got = tpano.global_invisibility(tbuf, c2w, nodes, chunk=256)

    poses = np.concatenate([tpano.pano_view_poses(node_c2w(c2w, nodes[i])) for i in (0, 2)])
    got_q = tpano._render_views_quantized(tbuf, poses, 256, 1.0)
    _, depth, alpha = tpano._render_views(tbuf, poses, 256, 1.0)
    n_edge = 0
    for g, r, f, unit in zip(got_q, ref_q, (depth, alpha), (1000.0, 255.0)):
        g, r = g.numpy().astype(np.int64), r.astype(np.int64)
        edge = np.abs((f.numpy().astype(np.float64) * unit) % 1.0 - 0.5) < 1e-5 * unit
        assert not ((g != r) & ~edge).any() and (np.abs(g - r) <= 1).all()
        n_edge += int((g != r).sum())
    print(f"{n_edge} of {2 * ref_q[0].size} quantized inputs on a rounding boundary differ")

    monkeypatch.setattr(tpano, "_render_views_quantized",
                        lambda *a: tuple(torch.from_numpy(x) for x in ref_q))
    same = tpano.global_invisibility(tbuf, c2w, nodes, chunk=256)
    assert same[1] == got[1] == ref[1] == (0.0, 0.0, 0.0)
    for s_, g, r in zip(same, got, ref):
        np.testing.assert_allclose(s_[:2], r[:2], rtol=1e-9)
        assert s_[2] == g[2] == r[2]
        if n_edge == 0:
            np.testing.assert_allclose(g[:2], r[:2], rtol=1e-6)
    assert ref[0][1] > 0


@pytest.mark.parametrize("case", ["empty", "hole"])
def test_local_invisibility_matches_jax(case, jax_exact_views):
    """tests/test_queries.py:92-126: an empty map (everything invisible, no
    cluster direction off centre) and the half-cylinder hole (a
    reorientation); sum, invisibility panorama and best pose."""
    jbuf, center = hole_buffer()
    if case == "empty":  # the hole map's capacity: the JAX side compiles once
        jbuf = JaxBuffer.empty(jbuf.capacity)
    c2w = pose(center)
    ref = jpano.local_invisibility(jbuf, c2w, chunk=256)
    got = tpano.local_invisibility(port_buffer(jbuf), c2w, chunk=256)
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[2], ref[2])
    if case == "empty":
        assert got[2].shape == (150, 360) and got[0] > 0.99 * got[2].size
    else:
        assert ref[1] is not None
    if ref[1] is None:
        assert got[1] is None
    else:
        np.testing.assert_allclose(got[1], ref[1], atol=1e-9)
