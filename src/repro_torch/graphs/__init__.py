"""CSR-native O(edges) graph samplers and edge mutation batches (copies of
the reference's)."""
from __future__ import annotations

from .delta import EdgeDelta
from .samplers import (erdos_renyi, power_law, random_bipartite, sample,
                       stochastic_block)

__all__ = ["EdgeDelta", "erdos_renyi", "random_bipartite", "stochastic_block",
           "power_law", "sample"]
