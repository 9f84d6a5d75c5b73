"""The roofline's byte counts against a count made by hand on a tiny
plan, and the card table's lookup."""
import numpy as np
import pytest

from gpubench_tiny import ROOT  # noqa: F401  (puts the paths in place)
from harness import roofline
from repro_torch.core.allocation import er_allocation
from repro_torch.core.graph_models import Graph
from repro_torch.core.shuffle_plan import compile_plan_csr

# Six vertices, K = 3 servers, r = 2: vertex v sits in batch v % 3 (the
# round-robin allocation); batch b = {0, 1}, {0, 2}, {1, 2} in order, so
# server s Maps the vertices of the two batches that hold it, and
# vertices are reduced round-robin too.
EDGES = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (0, 3), (1, 4)]


def tiny():
    u, v = np.array(EDGES).T
    g = Graph.from_edges(u, v, 6)
    alloc = er_allocation(6, 3, 2, interleave=True)
    return g, alloc, compile_plan_csr(g.csr, alloc)


def test_deliveries_by_hand():
    g, alloc, plan = tiny()
    need = [(i, j) for i, j in zip(g.csr.rows, g.csr.indices)
            if not alloc.map_sets[alloc.reduce_owner[i], j]]
    assert plan.all_k.size == len(need)
    assert plan.pair_k.size + plan.left_k.size == len(need)


def test_bytes_by_hand():
    g, alloc, plan = tiny()
    c = {"n": 6, "nnz": 2 * len(EDGES), "M": int(plan.all_k.size),
         "P": int(plan.pair_k.size), "L": int(plan.left_k.size),
         "coded_bits": int(plan.coded_bits), "B": 1}
    M, P, L = c["M"], c["P"], c["L"]
    seg = int(plan.col_width.sum()) // 8     # the coded segments, in bytes
    # K1: each delivered value read once, each coded segment and unicast
    # word written once.
    assert roofline.encode_bytes(c) == 4 * M + seg + 4 * L
    # K2: segments and unicast words read once, the P side values read
    # once, the M delivered words written once.
    assert roofline.decode_bytes(c) == seg + 4 * L + 4 * P + 4 * M
    assert roofline.shuffle_bytes(c) == 8 * M + 2 * seg + 8 * L + 4 * P
    # K3: 16 values, 7 row offsets, 6 sums.
    assert roofline.reduce_bytes(c) == 4 * (16 + 7 + 6)
    c4 = dict(c, B=4)
    assert roofline.reduce_bytes(c4) == 4 * (4 * 16 + 7 + 4 * 6)
    assert roofline.shuffle_bytes(c4) == 4 * roofline.shuffle_bytes(c)


def test_share_and_card():
    fig = roofline.card("NVIDIA H100 80GB HBM3")
    assert fig["hbm_bytes_per_s"] == 3.35e12
    # 3.35 MB an iteration for 10 iterations: 10 us at the bound; in
    # 40 us of device time, a quarter.
    assert roofline.roofline_pct(3_350_000, 10, 40e-6, fig) == pytest.approx(25.0)
    assert roofline.roofline_pct(1, 10, 0.0, fig) is None
    with pytest.raises(ValueError):
        roofline.card("NVIDIA A100-SXM4-80GB")
