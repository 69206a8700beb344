"""The port's planner library against the JAX package's (which calls OpenCV
and networkx, installed here) on the same numpy inputs: the 9 tests of
tests/test_planner.py on the port, each also holding the port's result
bitwise equal to the reference's, and seeded partially observed maps through
the whole pipeline (obstacle map, Voronoi graph, start vertex, paths,
subregions, escape plans).

Tolerance: none. Maps, contours, vertices, edges and their weights, node
sets, paths, subregion labels and escape plans are compared for equality.
Both sides draw the Voronoi sampling jitter from numpy's global stream, so
each pair of calls is seeded alike."""

import numpy as np
import pytest

from activesplat_tpu.planner import navigation as jnav
from activesplat_tpu.planner import occupancy as jocc
from activesplat_tpu.planner import voronoi as jvor
from activesplat_tpu_torch.planner import navigation as tnav
from activesplat_tpu_torch.planner import occupancy as tocc
from activesplat_tpu_torch.planner import voronoi as tvor
from activesplat_tpu_torch.runtime.synthetic import BoxWorld

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def world_occupancy(world: BoxWorld, pixels_per_meter=10.0):
    """Ground-truth occupancy: free=255 where the agent fits (as
    tests/test_planner.py rasterizes it)."""
    sx, _, sz = world.size
    w, h = int(sx * pixels_per_meter), int(sz * pixels_per_meter)
    free = np.zeros((h, w), np.uint8)
    for v in range(h):
        for u in range(w):
            if world.is_free(np.array([(u + 0.5) / pixels_per_meter, (v + 0.5) / pixels_per_meter])):
                free[v, u] = 255
    return free


def same_contours(a, b):
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x).reshape(-1, 2), np.asarray(y).reshape(-1, 2))
        for x, y in zip(a, b))


def graphs(seed, *args, **kw):
    """The reference's and the port's Voronoi graph from the same stream."""
    np.random.seed(seed)
    j = jvor.build_voronoi_graph(*args, **kw)
    np.random.seed(seed)
    t = tvor.build_voronoi_graph(*args, **kw)
    return j, t


def assert_same_graph(j, t):
    np.testing.assert_array_equal(t.vertices, j.vertices)
    np.testing.assert_array_equal(t.nodes_index, j.nodes_index)
    np.testing.assert_array_equal(t.high_connectivity_nodes_index, j.high_connectivity_nodes_index)
    assert len(t.pruned_chains) == len(j.pruned_chains)
    for a, b in zip(t.pruned_chains, j.pruned_chains):
        np.testing.assert_array_equal(a, b)
    assert list(t.graph.edges(data=True)) == list(j.graph.edges(data=True))
    np.testing.assert_array_equal(t.obstacle_map, j.obstacle_map)


@pytest.fixture(scope="module")
def occupancy():
    world = BoxWorld.two_room(seed=0)
    free = world_occupancy(world)
    unobserved = np.zeros_like(free)  # fully observed
    agent = np.array([50.0, 15.0])  # pixel (u, v) in room 1 (z=1.5m, x=5m)
    kernel = tocc.default_kernel(2.0)
    np.testing.assert_array_equal(kernel, jocc.default_kernel(2.0))
    port = tocc.build_obstacle_map(free, unobserved, agent, kernel, approx_precision=2.0)
    ref = jocc.build_obstacle_map(free, unobserved, agent, kernel, approx_precision=2.0)
    np.testing.assert_array_equal(port[0], ref[0])
    assert same_contours([port[1]], [ref[1]]) and same_contours(port[2], ref[2])
    obstacle_map, outer, children = port
    j, t = graphs(0, obstacle_map, outer, children, edge_sample_num=2, agent_radius_pixel=1.7,
                  inaccessible_points=np.zeros((0, 2)))
    assert_same_graph(j, t)
    return world, free, obstacle_map, outer, children, agent, t


def test_obstacle_map_basics(occupancy):
    world, free, obstacle_map, outer, children, agent, _ = occupancy
    assert obstacle_map.dtype == np.uint8
    assert obstacle_map[int(agent[1]), int(agent[0])] == 255
    frac_free = (obstacle_map == 255).mean()
    assert 0.2 < frac_free < 0.98
    wall_row = obstacle_map[30, :]
    assert (wall_row == 0).sum() > wall_row.size * 0.5


def test_voronoi_graph_structure(occupancy):
    _, _, obstacle_map, _, _, _, vg = occupancy
    assert len(vg.vertices) > 5
    assert len(vg.nodes_index) >= 1
    for v in vg.vertices:
        assert obstacle_map[int(round(v[1])), int(round(v[0]))] == 255, v
    for a, b, data in vg.graph.edges(data=True):
        expected = np.linalg.norm(vg.vertices[a] - vg.vertices[b])
        np.testing.assert_allclose(data["weight"], expected, rtol=1e-6)


def test_dijkstra_cross_room(occupancy):
    _, _, obstacle_map, _, _, agent, vg = occupancy
    start = tvor.closest_reachable_vertex(vg.vertices, obstacle_map, agent, 1.7)
    assert start == jvor.closest_reachable_vertex(vg.vertices, obstacle_map, agent, 1.7)
    goal = tvor.closest_node(vg.vertices, np.arange(len(vg.vertices)), np.array([50.0, 45.0]))
    port = tnav.safe_dijkstra_path(vg.graph, start, goal, vg.vertices, obstacle_map, agent, 1.0)
    path_idx, path, connected = port
    assert connected
    assert path is not None and len(path) >= 1
    assert tnav.polyline_is_safe(obstacle_map, path, 2)
    for p in path:
        if abs(p[1] - 30) < 3:  # crossing the wall row: inside the doorway
            assert 38 <= p[0] <= 54, p
    np.random.seed(0)
    jvg = jvor.build_voronoi_graph(obstacle_map, occupancy[3], occupancy[4], edge_sample_num=2,
                                   agent_radius_pixel=1.7, inaccessible_points=np.zeros((0, 2)))
    ref = jnav.safe_dijkstra_path(jvg.graph, start, goal, jvg.vertices, obstacle_map, agent, 1.0)
    np.testing.assert_array_equal(path_idx, ref[0])
    np.testing.assert_array_equal(path, ref[1])
    assert connected == ref[2]


def test_fast_forward_shortens(occupancy):
    _, _, obstacle_map, _, _, agent, _ = occupancy
    path = np.array([[50.0, 17.0], [50.0, 20.0], [50.0, 24.0], [50.0, 27.0]])
    ff = tnav.fast_forward_path(path, obstacle_map, agent, 1.0)
    assert len(ff) <= len(path)
    assert np.allclose(ff[-1], path[-1])
    np.testing.assert_array_equal(ff, jnav.fast_forward_path(path, obstacle_map, agent, 1.0))


def test_interpolate_path():
    path = np.array([[0.0, 0.0], [5.0, 1.0], [10.0, 0.0], [15.0, 3.0]])
    smooth = tnav.interpolate_path(path, num=30)
    assert smooth.shape == (30, 2)
    np.testing.assert_allclose(smooth[0], path[0], atol=1e-6)
    np.testing.assert_allclose(smooth[-1], path[-1], atol=1e-6)
    np.testing.assert_array_equal(smooth, jnav.interpolate_path(path, num=30))


def test_line_safety():
    grid = np.full((50, 50), 255, np.uint8)
    grid[:, 25] = 0  # a wall
    assert tnav.line_is_safe(grid, np.array([5, 5]), np.array([20, 20]), 1)
    assert not tnav.line_is_safe(grid, np.array([5, 25]), np.array([45, 25]), 1)
    rng = np.random.default_rng(0)
    for _ in range(200):
        a, b = rng.integers(-10, 60, 2), rng.integers(-10, 60, 2)
        t = int(rng.integers(1, 8))
        assert tnav.line_is_safe(grid, a, b, t) == jnav.line_is_safe(grid, a, b, t)
        path = rng.integers(-5, 55, (int(rng.integers(1, 6)), 2))
        assert tnav.polyline_is_safe(grid, path, t) == jnav.polyline_is_safe(grid, path, t)


def test_escape_plan_turns_away_from_wall():
    grid = np.full((60, 60), 255, np.uint8)
    grid[:, 40:] = 0  # wall on the right (east)
    agent = np.array([38.0, 30.0])
    heading = np.array([1.0, 0.0])  # facing the wall
    kw = dict(agent_turn_angle_deg=30.0, agent_step_size_pixel=8.0,
              inaccessible_directions=np.zeros((0, 2)))
    direction, mask = tnav.get_escape_plan(grid, agent, heading, rng=np.random.default_rng(0),
                                           **kw)
    assert direction in (-1, 1)
    assert mask.dtype == bool and mask.any()
    assert len(mask) == 12
    ref = jnav.get_escape_plan(grid, agent, heading, rng=np.random.default_rng(0), **kw)
    assert direction == ref[0]
    np.testing.assert_array_equal(mask, ref[1])


def test_splat_inaccessible():
    grid = np.full((40, 40), 255, np.uint8)
    db = {(20.0, 20.0): np.array([[1.0, 0.0]]), (5.0, 30.0): np.array([[0.0, 1.0], [-1, -1]])}
    out = tnav.splat_inaccessible(grid, db, splat_size_pixel=4.0)
    assert out[20, 24] == 0  # splat one step ahead of the failed heading
    assert out[20, 10] == 255
    np.testing.assert_array_equal(out, jnav.splat_inaccessible(grid, db, splat_size_pixel=4.0))


def test_subregions_two_rooms(occupancy):
    _, _, obstacle_map, _, _, _, vg = occupancy
    subregions = tvor.compute_subregions(vg.graph, vg.nodes_index, vg.vertices,
                                         meter_per_pixel=0.1)
    assert set(subregions.keys()) == set(int(i) for i in vg.nodes_index)
    if len(vg.nodes_index) >= 2:
        rows = vg.vertices[vg.nodes_index][:, 1]
        if rows.min() < 25 and rows.max() > 35:
            assert len(set(subregions.values())) >= 2
    np.random.seed(0)
    jvg = jvor.build_voronoi_graph(obstacle_map, occupancy[3], occupancy[4], edge_sample_num=2,
                                   agent_radius_pixel=1.7, inaccessible_points=np.zeros((0, 2)))
    assert subregions == jvor.compute_subregions(jvg.graph, jvg.nodes_index, jvg.vertices,
                                                 meter_per_pixel=0.1)


def partial_view(free: np.ndarray, seed: int):
    """A partly observed map: unobserved where a few random discs cover it."""
    rng = np.random.default_rng(seed)
    h, w = free.shape
    yy, xx = np.mgrid[:h, :w]
    unobserved = np.zeros_like(free)
    for _ in range(int(rng.integers(1, 5))):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 15)
        unobserved[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 255
    free = free.copy()
    free[rng.random(free.shape) < 0.002] = 0  # salt: small obstacles
    return free, unobserved


@pytest.mark.parametrize("seed", range(4))
def test_pipeline_matches_reference(seed):
    """Partly observed two-room and single-room maps through the whole
    pipeline, the reference's and the port's results equal at every step."""
    world = (BoxWorld.two_room if seed % 2 == 0 else BoxWorld.single_room)(seed=seed)
    free, unobserved = partial_view(world_occupancy(world), seed)
    rng = np.random.default_rng(seed)
    ys, xs = np.nonzero(free)
    agent = np.array([xs[len(xs) // 3] + 0.4, ys[len(ys) // 3] + 0.3])
    kernel = tocc.default_kernel(2.5)
    approx = None if seed == 3 else 2.0
    port = tocc.build_obstacle_map(free, unobserved, agent, kernel, approx)
    ref = jocc.build_obstacle_map(free, unobserved, agent, kernel, approx)
    np.testing.assert_array_equal(port[0], ref[0])
    assert same_contours([port[1]], [ref[1]]) and same_contours(port[2], ref[2])
    fails = np.asarray([agent + rng.normal(scale=5.0, size=2)])
    j, t = graphs(seed, port[0], port[1], port[2], edge_sample_num=3, agent_radius_pixel=2.0,
                  inaccessible_points=fails)
    assert_same_graph(j, t)
    start = tvor.closest_reachable_vertex(t.vertices, port[0], agent, 2.0)
    assert start == jvor.closest_reachable_vertex(j.vertices, port[0], agent, 2.0)
    for node in list(t.nodes_index[:3]) + [len(t.vertices) + 5]:
        got = tnav.safe_dijkstra_path(t.graph, start, node, t.vertices, port[0], agent, 2.0)
        want = jnav.safe_dijkstra_path(j.graph, start, node, j.vertices, port[0], agent, 2.0)
        assert got[2] == want[2]
        for a, b in zip(got[:2], want[:2]):
            assert (a is None and b is None) or np.array_equal(a, b)
    assert tvor.compute_subregions(t.graph, t.nodes_index, t.vertices, 0.05) == \
        jvor.compute_subregions(j.graph, j.nodes_index, j.vertices, 0.05)
    heading = np.array([np.cos(seed), np.sin(seed)])
    failed_dirs = np.array([[np.cos(seed + 0.5), np.sin(seed + 0.5)]])
    for inacc in (np.zeros((0, 2)), failed_dirs):
        got = tnav.get_escape_plan(port[0], agent, heading, 10.0, 6.0, inacc,
                                   rng=np.random.default_rng(seed))
        want = jnav.get_escape_plan(port[0], agent, heading, 10.0, 6.0, inacc,
                                    rng=np.random.default_rng(seed))
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
