"""Erdos-Renyi G(n, p), the paper's ER model (arXiv:1801.05522, Sec. IV):
each of the n (n - 1) / 2 pairs is an edge with probability p, drawn by
geometric skipping over the upper triangle."""
from __future__ import annotations

import numpy as np

from harness.graph import bernoulli_positions, rng, triangle_pairs


def edges(params: dict) -> tuple[np.ndarray, np.ndarray, int]:
    """(u, v, n): each undirected edge once, u < v. `params`: n,
    mean_degree (p = mean_degree / (n - 1)), graph_seed."""
    n = int(params["n"])
    p = float(params["mean_degree"]) / (n - 1)
    pos = bernoulli_positions(n * (n - 1) // 2, p, rng(params["graph_seed"], 1))
    u, v = triangle_pairs(pos, n)
    return u, v, n
