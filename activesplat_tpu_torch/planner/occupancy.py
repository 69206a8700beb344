"""Occupancy-map construction from top-down renders (counterpart of
activesplat_tpu/planner/occupancy.py; reference src/planner/planner.py:111-199).

Conventions (identical to the reference):

  * maps are uint8 images, 255 = free/traversable, 0 = obstacle/unknown;
  * 'visible map' input is 255 where the area is UNOBSERVED (the mapper's
    white-background render is pure white where nothing was mapped).

The OpenCV calls of the JAX package are the port's numpy rules: contours
from `queries/clusters.py` (findContours, contourArea, the ellipse kernel),
everything drawn or tested from `planner/draw.py`. Contours are (K, 1, 2)
int32 arrays, as cv2 returns them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from activesplat_tpu_torch.planner import draw
from activesplat_tpu_torch.queries.clusters import _shoelace_area, ellipse_kernel, outer_contours


def find_external_contours(image: np.ndarray) -> List[np.ndarray]:
    """cv2.findContours(image, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]."""
    return [c.reshape(-1, 1, 2).astype(np.int32) for c in outer_contours(image)]


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea."""
    return _shoelace_area(np.asarray(contour).reshape(-1, 2))


def clip_free_map_to_observed(
    free_map: np.ndarray, unobserved_map: np.ndarray, kernel: np.ndarray
) -> np.ndarray:
    """Constrain the free map to the largest observed region, drop unobserved
    islands, then morphologically open + dilate (update_topdown_free_map,
    planner.py:111-132)."""
    observed = np.bitwise_not(unobserved_map)
    contours = find_external_contours(observed)
    if not contours:
        return np.zeros_like(free_map)
    main_region = np.zeros_like(observed)
    draw.draw_contours(main_region, [max(contours, key=contour_area)], 255)

    # free space within the main observed region
    result = np.bitwise_and(main_region, free_map)
    # remove pixels that are inside the main region hull but never observed
    result[np.bitwise_and(main_region, unobserved_map) == 255] = 0
    result = draw.morphology_open(result, kernel)
    return draw.dilate(result, np.ones((3, 3), np.uint8))  # MORPH_RECT (3, 3)


def build_obstacle_map(
    free_map: np.ndarray,
    unobserved_map: np.ndarray,
    agent_position: np.ndarray,  # (2,) pixel (u, v)
    kernel: np.ndarray,
    approx_precision: Optional[float],
) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """The planner's working map: the polygon-approximated free-space region
    containing the agent, minus child obstacle polygons (get_obstacle_map,
    planner.py:134-199). Returns (obstacle_map 255=free, outer contour,
    child obstacle contours)."""
    clipped = clip_free_map_to_observed(free_map, unobserved_map, kernel)
    agent_pt = (float(agent_position[0]), float(agent_position[1]))

    def contour_containing_agent(image):
        contours = find_external_contours(image)
        if not contours:
            return None
        dists = np.array(
            [draw.point_polygon_test(c, agent_pt, False) for c in contours]
        )
        inside = np.where(dists >= 0)[0]
        if len(inside) == 0:
            return None
        return contours[inside[np.argmin(dists[inside])]]

    outer = contour_containing_agent(clipped)
    if outer is None:
        # fall back to the raw free map (planner.py:153-164)
        outer = contour_containing_agent(free_map)
    if outer is None:
        # degenerate: agent outside all free space — take the largest region
        contours = find_external_contours(clipped if clipped.any() else free_map)
        outer = max(contours, key=contour_area)

    outer_approx = (
        outer if approx_precision is None else draw.approx_poly_dp(outer, approx_precision, True)
    )

    white = np.full_like(free_map, 255)
    black = np.zeros_like(free_map)
    outside_approx = draw.draw_contours(white.copy(), [outer_approx], 0)
    outside_exact = draw.draw_contours(white.copy(), [outer], 0)
    region_approx = draw.draw_contours(black.copy(), [outer_approx], 255)

    # obstacles inside the region: anything free-map-0 within the approx hull
    children_src = np.bitwise_not(
        np.bitwise_or(np.bitwise_or(outside_exact, outside_approx), free_map)
    )
    children = []
    for contour in find_external_contours(children_src):
        if contour_area(contour) <= 0:
            continue
        approx = (
            contour
            if approx_precision is None
            else draw.approx_poly_dp(contour, approx_precision, True)
        )
        if contour_area(approx) > 0:
            children.append(approx)
    obstacle_map = draw.draw_contours(region_approx, children, 0)
    return obstacle_map, outer_approx, children


def default_kernel(agent_radius_pixel: float) -> np.ndarray:
    size = max(3, int(np.ceil(agent_radius_pixel)) | 1)
    return ellipse_kernel(size, size)
