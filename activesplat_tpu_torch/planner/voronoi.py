"""Voronoi skeleton graph over free space (counterpart of
activesplat_tpu/planner/voronoi.py, with the port's numpy drawing rules and
graph in place of OpenCV and networkx).

Fresh implementation of the reference's graph construction
(get_voronoi_graph, src/planner/planner.py:201-370): sample obstacle contour
edges, build a scipy Voronoi diagram of the samples, keep vertices safely
inside free space, iteratively prune degree<=1 chains (keeping 'nodes' =
vertices whose initial degree was >= 3), and weight remaining edges by
euclidean length. Exploration targets are the surviving nodes; nodes with
degree > 2 after pruning are 'high-connectivity' (junctions).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import scipy.cluster.hierarchy as hcluster
import scipy.spatial
from scipy.spatial.distance import cdist

from activesplat_tpu_torch.planner import draw
from activesplat_tpu_torch.planner.graph import Graph, all_pairs_dijkstra_path_length


@dataclasses.dataclass
class VoronoiGraph:
    graph: Graph  # nodes = vertex indices, edge weight = pixel length
    vertices: np.ndarray  # (V, 2) pixel coords
    nodes_index: np.ndarray  # indices of exploration-target vertices
    high_connectivity_nodes_index: np.ndarray
    pruned_chains: List[np.ndarray]  # dead-end polylines (for viz)
    obstacle_map: np.ndarray


def _sample_contour_edges(contours: List[np.ndarray], edge_sample_num: int) -> np.ndarray:
    """Evenly sample points along every polygon edge; resolution set by the
    shortest edge / edge_sample_num (planner.py:211-235)."""
    shortest = np.inf
    polys = []
    for contour in contours:
        verts = contour.reshape(-1, 2).astype(np.float64)
        if len(verts) < 2:
            continue
        lengths = np.linalg.norm(verts - np.roll(verts, 1, axis=0), axis=1)
        positive = lengths[lengths > 0]
        if len(positive):
            shortest = min(shortest, positive.min())
        polys.append((verts, lengths))
    assert np.isfinite(shortest), "no contour edges to sample"
    resolution = shortest / edge_sample_num

    samples = []
    for verts, lengths in polys:
        starts = verts
        ends = np.roll(verts, 1, axis=0)
        for start, end, length in zip(starts, ends, lengths):
            n = int(length / resolution)
            if n > 0:
                t = np.arange(n)[:, None] / n
                samples.append(start + t * (end - start))
    pts = np.concatenate(samples, 0)
    # break ties/collinearity for Voronoi robustness (planner.py:237-239)
    return pts + np.random.normal(scale=1e-10, size=pts.shape)


def build_voronoi_graph(
    obstacle_map: np.ndarray,
    outer_contour: np.ndarray,
    child_contours: List[np.ndarray],
    edge_sample_num: int,
    agent_radius_pixel: float,
    inaccessible_points: np.ndarray,
) -> VoronoiGraph:
    obstacle_points = _sample_contour_edges(
        [outer_contour] + list(child_contours), edge_sample_num
    )
    vor = scipy.spatial.Voronoi(obstacle_points)

    ridges = np.asarray(vor.ridge_vertices)
    ridges = ridges[np.all(ridges >= 0, axis=1)]
    vertices = np.asarray(vor.vertices)
    n = len(vertices)
    adj = np.zeros((n, n), np.float64)
    adj[ridges[:, 0], ridges[:, 1]] = 1
    adj[ridges[:, 1], ridges[:, 0]] = 1

    # keep vertices strictly inside free space with an agent-radius margin
    # (pointPolygonTest with distance, all vertices of a contour at once)
    inside = draw.signed_distances(outer_contour, vertices) > agent_radius_pixel
    for c in child_contours:
        inside &= ~(draw.signed_distances(c, vertices) > -agent_radius_pixel)
    keep = np.flatnonzero(inside)
    vertices = vertices[keep]
    adj = adj[np.ix_(keep, keep)]

    # drop isolated vertices
    deg = adj.sum(1)
    connected = deg > 0
    vertices = vertices[connected]
    adj = adj[np.ix_(*(np.where(connected)[0],) * 2)]
    deg = adj.sum(1)

    is_node = deg >= 3  # survives pruning (planner.py:269)

    # drop vertices adjacent to inaccessible points (failed positions),
    # unless they are nodes (planner.py:271-304)
    if len(inaccessible_points) > 0 and len(vertices) > 1:
        dists = cdist(np.asarray(inaccessible_points, np.float64), vertices)
        order = np.argsort(dists, axis=1)
        a_idx, b_idx = order[:, 0], order[:, 1]
        connected_pair = adj[a_idx, b_idx] > 0
        bad = np.zeros(len(vertices), bool)
        for point, a, b, conn in zip(
            np.asarray(inaccessible_points, np.float64), a_idx, b_idx, connected_pair
        ):
            if not conn:
                continue
            if not _segment_clears_circle(
                vertices[a], vertices[b], point, agent_radius_pixel
            ):
                bad[a] = True
                bad[b] = True
        bad &= ~is_node
        keep2 = ~bad
        vertices = vertices[keep2]
        adj = adj[np.ix_(*(np.where(keep2)[0],) * 2)]
        is_node = is_node[keep2]

    # iterative pruning of degree<=1 chains, recording them for viz
    pruned_chains: List[List[np.ndarray]] = []
    while True:
        deg = adj.sum(1)
        prune = (deg <= 1) & ~is_node
        if not prune.any():
            break
        prune_idx = np.where(prune)[0]
        for i in prune_idx:
            nbrs = np.where(adj[i] > 0)[0]
            if len(nbrs) == 0:
                continue
            chain_extended = False
            for chain in pruned_chains:
                if np.allclose(chain[-1], vertices[i]):
                    chain.append(vertices[nbrs[0]])
                    chain_extended = True
                    break
            if not chain_extended:
                pruned_chains.append([vertices[i], vertices[nbrs[0]]])
        keep3 = ~prune
        vertices = vertices[keep3]
        adj = adj[np.ix_(*(np.where(keep3)[0],) * 2)]
        is_node = is_node[keep3]

    # weight edges by euclidean length
    iu, ju = np.where(np.triu(adj) > 0)
    lengths = np.linalg.norm(vertices[iu] - vertices[ju], axis=1)
    adj[iu, ju] = lengths
    adj[ju, iu] = lengths

    deg = (adj > 0).sum(1)
    nodes_index = np.where(is_node)[0]
    high_conn = nodes_index[deg[nodes_index] > 2]

    return VoronoiGraph(
        graph=Graph.from_numpy_array(adj),
        vertices=vertices,
        nodes_index=nodes_index,
        high_connectivity_nodes_index=high_conn,
        pruned_chains=[np.asarray(c) for c in pruned_chains],
        obstacle_map=obstacle_map,
    )


def _segment_clears_circle(
    start: np.ndarray, end: np.ndarray, center: np.ndarray, radius: float
) -> bool:
    """True if the segment stays outside the circle (scalar version of
    is_line_segment_out_of_circle, planner.py:33-60)."""
    seg = end - start
    length = np.linalg.norm(seg)
    if length == 0:
        return bool(np.linalg.norm(center - start) > radius)
    t = np.clip(np.dot(center - start, seg) / (length * length), 0.0, 1.0)
    closest = start + t * seg
    return bool(np.linalg.norm(center - closest) > radius)


def segments_clear_circles(
    starts: np.ndarray, ends: np.ndarray, centers: np.ndarray, radius: float
) -> np.ndarray:
    """Vectorized segment-vs-circle clearance over paired rows."""
    seg = ends - starts
    length2 = np.einsum("ij,ij->i", seg, seg)
    length2 = np.maximum(length2, 1e-12)
    t = np.clip(np.einsum("ij,ij->i", centers - starts, seg) / length2, 0.0, 1.0)
    closest = starts + t[:, None] * seg
    return np.linalg.norm(centers - closest, axis=1) > radius


def closest_reachable_vertex(
    vertices: np.ndarray,
    obstacle_map: np.ndarray,
    agent_position: np.ndarray,
    agent_radius_pixel: float,
) -> int:
    """Nearest graph vertex with an obstacle-free straight line from the
    agent (get_closest_vertex_index, planner.py:425-462)."""
    order = np.argsort(np.linalg.norm(vertices - agent_position, axis=1))
    free_pixels = np.count_nonzero(obstacle_map)
    agent_mask = draw.circle(
        np.zeros_like(obstacle_map),
        np.int32(agent_position),
        int(np.ceil(agent_radius_pixel)),
        255,
        -1,
    )
    for idx in order:
        test = draw.line(
            obstacle_map.copy(),
            np.int32(agent_position),
            np.int32(vertices[idx]),
            255,
            int(np.ceil(agent_radius_pixel * 3)),
        )
        test[agent_mask > 0] = obstacle_map[agent_mask > 0]
        if np.count_nonzero(test) == free_pixels:
            return int(idx)
    # relaxed fallback: thin line, least obstruction wins (planner.py:450-462)
    obstruction = []
    for idx in order:
        test = draw.line(
            obstacle_map.copy(),
            np.int32(agent_position),
            np.int32(vertices[idx]),
            255,
            1,
        )
        count = np.count_nonzero(test)
        if count == free_pixels:
            return int(idx)
        obstruction.append(count)
    return int(order[int(np.argmin(obstruction))])


def closest_node(
    vertices: np.ndarray, nodes_index: np.ndarray, agent_position: np.ndarray
) -> int:
    dists = np.linalg.norm(vertices[nodes_index] - agent_position, axis=1)
    return int(nodes_index[int(np.argmin(dists))])


def compute_subregions(
    graph: Graph,
    nodes_index: np.ndarray,
    vertices: np.ndarray,
    meter_per_pixel: float,
    path_weight: float = 0.5,
    coord_weight: float = 0.5,
) -> Dict[int, int]:
    """Hierarchical clustering of nodes into subregions with a 2 m threshold
    over a blended path/euclidean metric (get_subregions,
    planner.py:530-574). Returns {vertex_index: cluster_id}."""
    n = len(nodes_index)
    if n == 0:
        return {}
    if n == 1:
        return {int(nodes_index[0]): 1}
    path_d = np.full((n, n), np.inf)
    lengths = dict(all_pairs_dijkstra_path_length(graph))
    for i, a in enumerate(nodes_index):
        for j, b in enumerate(nodes_index):
            if a in lengths and b in lengths[a]:
                path_d[i, j] = lengths[a][b]
    coord_d = cdist(vertices[nodes_index], vertices[nodes_index])
    combined = path_weight * path_d + coord_weight * coord_d
    combined = (combined + combined.T) / 2
    if np.isinf(combined).any():
        finite_max = combined[np.isfinite(combined)].max() if np.isfinite(combined).any() else 1.0
        combined[np.isinf(combined)] = finite_max + 1
    np.fill_diagonal(combined, 0.0)
    linkage = hcluster.linkage(
        scipy.spatial.distance.squareform(combined, checks=False), method="average"
    )
    clusters = hcluster.fcluster(
        linkage, t=2.0 / meter_per_pixel, criterion="distance"
    )
    return {int(node): int(cluster) for node, cluster in zip(nodes_index, clusters)}
