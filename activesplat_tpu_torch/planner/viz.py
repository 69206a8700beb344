"""Planner visualization renderers (counterpart of
activesplat_tpu/planner/viz.py, drawn with the port's numpy rules): headless
PNG producers in the role of the reference's draw_voronoi_graph /
plot_voronoi_subregions / visualize_agent (planner.py:372-423, 576-611;
gui_utils.py:283-307), without a GUI. Images are BGR, as OpenCV's are."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from activesplat_tpu_torch.io.png import write_png
from activesplat_tpu_torch.planner import draw


def imwrite(path: str, image: np.ndarray) -> None:
    """cv2.imwrite of a BGR (or grey) uint8 image: the same pixels through
    the port's PNG codec (the files are not byte-identical)."""
    write_png(path, image[..., ::-1] if image.ndim == 3 else image)


def _score_color(score: float, lo: float, hi: float):
    """Red-ramp colormap for node scores (reference uses cm 'Reds')."""
    t = 0.0 if hi <= lo else float(np.clip((score - lo) / (hi - lo), 0, 1))
    # BGR: light pink -> saturated red
    return (int(200 * (1 - t) + 20 * t), int(200 * (1 - t) + 20 * t), 255)


def draw_voronoi_graph(
    background: np.ndarray,  # (H, W) uint8 obstacle map (255 = free)
    vertices: np.ndarray,
    graph,  # planner.graph.Graph with weighted edges
    nodes_index: np.ndarray,
    nodes_score: Optional[np.ndarray],
    pruned_chains: List[np.ndarray],
    ridge_color=(255, 0, 0),
    ridge_thickness: int = 1,
    node_radius: int = 3,
    pruned_color=(0, 255, 0),
) -> np.ndarray:
    image = draw.gray2bgr(background)
    for chain in pruned_chains:
        if len(chain) >= 2:
            draw.polylines(image, [np.int32(chain)], False, pruned_color, 1)
    for a, b in graph.edges():
        draw.line(
            image,
            np.int32(vertices[a]),
            np.int32(vertices[b]),
            ridge_color,
            ridge_thickness,
        )
    if nodes_score is None:
        nodes_score = np.zeros(len(nodes_index))
    lo, hi = float(np.min(nodes_score, initial=0)), float(
        np.max(nodes_score, initial=1)
    )
    for node, score in zip(nodes_index, nodes_score):
        draw.circle(
            image,
            np.int32(vertices[int(node)]),
            node_radius,
            _score_color(float(score), lo, hi),
            -1,
        )
    return image


def draw_subregions(
    background: np.ndarray,
    vertices: np.ndarray,
    subregions: Dict[int, int],
    node_radius: int = 4,
) -> np.ndarray:
    """Color nodes by subregion id (plot_voronoi_subregions role)."""
    image = draw.gray2bgr(background)
    palette = [
        (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
        (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
        (188, 189, 34), (23, 190, 207),
    ]
    for node, cluster in subregions.items():
        color = palette[int(cluster) % len(palette)]
        draw.circle(image, np.int32(vertices[int(node)]), node_radius, color, -1)
    return image


def visualize_agent(
    topdown_map: np.ndarray,
    meter_per_pixel: float,
    agent_translation: np.ndarray,  # (2,) px
    agent_rotation_vector: np.ndarray,  # (2,) unit heading
    agent_color=(0, 120, 255),
    agent_radius: float = 0.17,
    heading_color=(0, 255, 0),
    heading_length: float = 10.0,
) -> np.ndarray:
    """Agent disc + heading arrow over a map (gui_utils.py:283-307 role)."""
    image = topdown_map.copy()
    if image.ndim == 2:
        image = draw.gray2bgr(image)
    tip = agent_translation + heading_length * agent_rotation_vector
    draw.arrowed_line(image, np.int32(agent_translation), np.int32(tip), heading_color, 1)
    draw.circle(
        image,
        np.int32(agent_translation),
        max(1, int(agent_radius / meter_per_pixel)),
        agent_color,
        -1,
    )
    return image
