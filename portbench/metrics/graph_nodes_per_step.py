"""Kernel nodes of the step's captured CUDA graph, read through the CUDA
driver: what one replay of Model.step launches. An exact count."""
from __future__ import annotations


def read(run):
    nodes = run.get("graph_nodes")
    return float(sum(nodes.values())) if nodes else None
