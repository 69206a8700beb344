"""Voronoi-graph exploration planner on the host (numpy / scipy), with
numpy counterparts of the reference's OpenCV calls (draw) and networkx
graph (graph)."""
