"""Path planning, safety line tests, escape recovery (counterpart of
activesplat_tpu/planner/navigation.py, with the port's numpy drawing rules
and Dijkstra in place of OpenCV and networkx).

Fresh implementations with the reference's behavior
(src/planner/planner.py:473-528, 631-759). Obstacle maps: 255 = free.
The core safety primitive is the 'line test': rasterize the intended path in
white over the map; if the white pixel count grew, the path crossed an
obstacle.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, Optional, Tuple

import numpy as np
from scipy.interpolate import splev, splprep
from scipy.spatial.distance import cdist

from activesplat_tpu_torch.planner import draw
from activesplat_tpu_torch.planner.graph import Graph, NodeNotFound, NoPath, dijkstra_path


def line_is_safe(
    obstacle_map: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    thickness_pixels: int,
) -> bool:
    free_pixels = np.count_nonzero(obstacle_map)
    test = draw.line(
        obstacle_map.copy(), np.int32(start), np.int32(end), 255, int(thickness_pixels)
    )
    return np.count_nonzero(test) == free_pixels


def polyline_is_safe(
    obstacle_map: np.ndarray, path: np.ndarray, thickness_pixels: int
) -> bool:
    free_pixels = np.count_nonzero(obstacle_map)
    test = draw.polylines(
        obstacle_map.copy(), [np.int32(path)], False, 255, int(thickness_pixels)
    )
    return np.count_nonzero(test) == free_pixels


def fast_forward_path(
    path: np.ndarray,
    obstacle_map: np.ndarray,
    agent_position: np.ndarray,
    agent_radius_pixel: float,
) -> np.ndarray:
    """Skip leading waypoints directly reachable in a straight safe line,
    preferring the farthest such waypoint that still gets closer
    (optimize_navigation_path_using_fast_forward, planner.py:473-495)."""
    last_distance = np.inf
    index = 0
    for index, point in enumerate(path[::-1]):
        if not line_is_safe(
            obstacle_map, agent_position, point, int(np.ceil(agent_radius_pixel * 3))
        ):
            continue
        distance = np.linalg.norm(agent_position - point)
        if distance > last_distance:
            break
        last_distance = distance
    return path[-(index + 1) :]


def safe_dijkstra_path(
    graph: Graph,
    start_index: int,
    end_index: int,
    vertices: np.ndarray,
    obstacle_map: np.ndarray,
    agent_position: np.ndarray,
    agent_radius_pixel: float,
    fast_forward_radius_ratio: float = 1.0,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], bool]:
    """Dijkstra on the Voronoi graph + fast-forward + whole-path safety test
    (get_safe_dijkstra_path, planner.py:497-528). Returns
    (path_indices, path_pixels, graph_connected)."""
    try:
        path_index = dijkstra_path(graph, int(start_index), int(end_index))
    except (NoPath, NodeNotFound):
        return None, None, False
    path = vertices[path_index]
    path = fast_forward_path(
        path, obstacle_map, agent_position, agent_radius_pixel * fast_forward_radius_ratio
    )
    if polyline_is_safe(obstacle_map, path, int(np.ceil(agent_radius_pixel * 2))):
        return np.asarray(path_index), path, True
    return None, None, True


def interpolate_path(path: np.ndarray, num: int = 50) -> np.ndarray:
    """B-spline smoothing of a pixel path (interpolate_path,
    planner.py:753-759)."""
    if len(path) < 2:
        return path
    k = min(3, len(path) - 1)
    # splprep requires strictly increasing parameterization; dedupe points
    keep = [0]
    for i in range(1, len(path)):
        if np.linalg.norm(path[i] - path[keep[-1]]) > 1e-9:
            keep.append(i)
    path = path[keep]
    if len(path) < 2:
        return path
    k = min(3, len(path) - 1)
    tck, _ = splprep(path.T, s=0, k=k)
    u = np.linspace(0, 1, num)
    return np.vstack(splev(u, tck)).T


def splat_inaccessible(
    obstacle_map: np.ndarray,
    inaccessible_database: Dict[Tuple[float, float], np.ndarray],
    splat_size_pixel: float,
) -> np.ndarray:
    """Paint known-failed directions as obstacles: for each failed position,
    stamp a filled circle one splat ahead along each failed heading
    (splat_inaccessible_database, planner.py:62-109, without the debug
    dumps)."""
    result = obstacle_map.copy()
    radius = max(int(round(splat_size_pixel / 2)), 1)
    h, w = result.shape[:2]
    for translation, rotation_vectors in inaccessible_database.items():
        pos = np.asarray(translation, np.float64)
        if len(rotation_vectors) == 0:
            continue
        vecs = np.asarray(rotation_vectors, np.float64)
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        vecs = vecs / np.maximum(norms, 1e-12)
        centers = np.int32(np.round(pos + vecs * splat_size_pixel))
        for cx, cy in centers:
            if 0 <= cx < w and 0 <= cy < h:
                draw.circle(result, (int(cx), int(cy)), radius, 0, -1)
    return result


class TurnTestResult(Enum):
    BOTH_FREE = 0
    LEFT_FREE = 1
    RIGHT_FREE = -1
    LEFT_MORE_FREE = 2
    RIGHT_MORE_FREE = -2
    RIGHT_TRY_FAILED = 3
    LEFT_TRY_FAILED = -3
    BOTH_BLOCKED_EQUALLY = 4
    BOTH_TRY_FAILED = 5


def _rotate(vec: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """Rotate a unit 2-vector by angles theta (array) -> (len(theta), 2)."""
    cos, sin = np.cos(theta), np.sin(theta)
    return np.stack([vec[0] * cos - vec[1] * sin, vec[0] * sin + vec[1] * cos], -1)


def get_escape_plan(
    obstacle_map: np.ndarray,
    agent_position: np.ndarray,
    agent_rotation_vector: np.ndarray,  # unit (2,) heading in pixels
    agent_turn_angle_deg: float,
    agent_step_size_pixel: float,
    inaccessible_directions: np.ndarray,  # (K, 2) unit vectors already failed
    rng: Optional[np.random.Generator] = None,
) -> Tuple[int, np.ndarray]:
    """Escape recovery: probe one-step translations after successive turns in
    both directions; choose the first fully-free direction, otherwise the
    side with more free probes; return (turn direction +1 left / -1 right,
    per-turn 'try translating here' mask over a full 360 spin)
    (get_escape_plan, planner.py:631-751)."""
    rng = rng or np.random.default_rng()
    turn_rad = np.radians(agent_turn_angle_deg)
    half_turns = int(np.ceil(180.0 / agent_turn_angle_deg))
    theta = (np.arange(half_turns) + 1) * turn_rad
    left_vecs = _rotate(agent_rotation_vector, theta)
    right_vecs = _rotate(agent_rotation_vector, -theta)

    def is_inaccessible(vecs):
        if len(inaccessible_directions) == 0:
            return np.zeros(len(vecs), bool)
        return np.any(cdist(vecs, inaccessible_directions) < turn_rad * 0.1, axis=1)

    left_blocked = is_inaccessible(left_vecs)
    right_blocked = is_inaccessible(right_vecs)

    free_pixels = np.count_nonzero(obstacle_map)

    def probe(vec):
        test = draw.line(
            obstacle_map.copy(),
            np.int32(agent_position),
            np.int32(agent_position + vec * agent_step_size_pixel),
            255,
            1,
        )
        return np.count_nonzero(test)

    results = []
    for lv, lb, rv, rb in zip(left_vecs, left_blocked, right_vecs, right_blocked):
        left_count = np.inf if lb else probe(lv)
        right_count = np.inf if rb else probe(rv)
        if left_count == free_pixels == right_count:
            results.append(TurnTestResult.BOTH_FREE.value)
        elif left_count == free_pixels:
            results.append(TurnTestResult.LEFT_FREE.value)
        elif right_count == free_pixels:
            results.append(TurnTestResult.RIGHT_FREE.value)
        elif left_count == np.inf and right_count == np.inf:
            results.append(TurnTestResult.BOTH_TRY_FAILED.value)
        elif right_count == np.inf:
            results.append(TurnTestResult.RIGHT_TRY_FAILED.value)
        elif left_count == np.inf:
            results.append(TurnTestResult.LEFT_TRY_FAILED.value)
        elif left_count < right_count:
            results.append(TurnTestResult.LEFT_MORE_FREE.value)
        elif left_count > right_count:
            results.append(TurnTestResult.RIGHT_MORE_FREE.value)
        else:
            results.append(TurnTestResult.BOTH_BLOCKED_EQUALLY.value)
    results = np.array(results)

    abs_results = np.abs(results)
    if 1 in abs_results:
        direction = int(results[np.argwhere(abs_results == 1)[0, 0]])
        # BOTH_FREE (0) counts as left per the sign convention below
        direction = 1 if direction >= 0 else -1
    else:
        scored = results.copy()
        neutral = (abs_results == TurnTestResult.BOTH_TRY_FAILED.value) | (
            abs_results == TurnTestResult.BOTH_BLOCKED_EQUALLY.value
        )
        scored[neutral] = 0
        direction = int(np.sign(scored.sum()))
        if direction == 0:
            direction = int(rng.choice([-1, 1]))

    total_turns = int(np.ceil(360.0 / agent_turn_angle_deg))
    try_mask = np.zeros(total_turns, bool)
    fail_value = (
        TurnTestResult.LEFT_TRY_FAILED.value
        if direction > 0
        else TurnTestResult.RIGHT_TRY_FAILED.value
    )
    try_mask[:half_turns] = results != fail_value

    remaining_theta = (np.arange(half_turns, total_turns) + 1) * turn_rad * direction
    remaining_vecs = _rotate(agent_rotation_vector, remaining_theta)
    remaining_blocked = is_inaccessible(remaining_vecs)
    try_mask[half_turns:] = ~remaining_blocked
    if not try_mask.any():
        try_mask[:] = True  # degenerate fallback: everything failed, retry all
    return direction, try_mask
