"""A small undirected weighted graph and its Dijkstra, in the order networkx
walks them (counterpart of the networkx calls in activesplat_tpu/planner:
`nx.from_numpy_array`, `nx.dijkstra_path`, `nx.all_pairs_dijkstra_path_length`).

The order matters where path lengths tie: the planner must pick the same
path as the reference. So the graph keeps networkx's adjacency order (each
node's neighbours in the order from_numpy_array first met them, which is
ascending index for a symmetric matrix), and the search keeps networkx's
heap entries (distance, push counter, node), its relaxation (a node is
re-pushed only on a strictly shorter distance) and its predecessor chain.
"""

from __future__ import annotations

from heapq import heappop, heappush
from itertools import count
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class NoPath(Exception):
    """The target is not reachable from the source (NetworkXNoPath)."""


class NodeNotFound(Exception):
    """The source is not a node of the graph (NodeNotFound)."""


class Graph:
    """Nodes 0..n-1 and weighted undirected edges; `adj[u]` maps each
    neighbour of u to its edge data {"weight": w}."""

    def __init__(self, n: int = 0) -> None:
        self.adj: List[Dict[int, Dict[str, float]]] = [{} for _ in range(n)]

    @classmethod
    def from_numpy_array(cls, a: np.ndarray) -> "Graph":
        """One edge per nonzero entry, weighted by it, added in row-major
        order as networkx adds them (a later (v, u) updates (u, v) in place)."""
        g = cls(a.shape[0])
        for u, v in zip(*np.nonzero(a)):
            u, v = int(u), int(v)
            data = g.adj[u].get(v, {})
            data["weight"] = float(a[u, v])
            g.adj[u][v] = data
            g.adj[v][u] = data
        return g

    def __len__(self) -> int:
        return len(self.adj)

    def __iter__(self) -> Iterator[int]:
        return iter(range(len(self.adj)))

    def __contains__(self, node) -> bool:
        return isinstance(node, (int, np.integer)) and 0 <= node < len(self.adj)

    def neighbors(self, node: int) -> Iterator[int]:
        return iter(self.adj[node])

    def edges(self, data: bool = False):
        """Each edge once, as networkx lists them: by node, then by its
        adjacency order, skipping neighbours already listed."""
        seen = set()
        out = []
        for u, nbrs in enumerate(self.adj):
            for v, d in nbrs.items():
                if v not in seen:
                    out.append((u, v, d) if data else (u, v))
            seen.add(u)
        return out


def _dijkstra(g: Graph, source: int, target: Optional[int] = None
              ) -> Tuple[Dict[int, float], Dict[int, int]]:
    """Final distances in the order they were settled, and each reached
    node's predecessor on the path that set its distance."""
    dist: Dict[int, float] = {}
    seen: Dict[int, float] = {source: 0}
    pred: Dict[int, int] = {}
    c = count()
    fringe = [(0, next(c), source)]
    while fringe:
        d, _, v = heappop(fringe)
        if v in dist:
            continue
        dist[v] = d
        if v == target:
            break
        for u, e in g.adj[v].items():
            vu = d + e.get("weight", 1)
            if u in dist:
                if vu < dist[u]:
                    raise ValueError("Contradictory paths found:", "negative weights?")
            elif u not in seen or vu < seen[u]:
                seen[u] = vu
                heappush(fringe, (vu, next(c), u))
                pred[u] = v
    return dist, pred


def dijkstra_path(g: Graph, source: int, target: int) -> List[int]:
    """The shortest path from source to target (nx.dijkstra_path)."""
    if source not in g:
        raise NodeNotFound(f"Node {source} not found in graph")
    if target == source:
        return [target]
    dist, pred = _dijkstra(g, source, target)
    if target not in dist:
        raise NoPath(f"No path to {target}.")
    path = [target]
    while path[-1] in pred:
        path.append(pred[path[-1]])
    return path[::-1]


def all_pairs_dijkstra_path_length(g: Graph) -> Iterator[Tuple[int, Dict[int, float]]]:
    """(node, {reached node: distance}) for every node
    (nx.all_pairs_dijkstra_path_length)."""
    for n in g:
        yield n, _dijkstra(g, n)[0]
