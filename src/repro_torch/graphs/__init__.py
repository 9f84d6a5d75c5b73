"""CSR-native O(edges) graph samplers (copies of the reference's)."""
from __future__ import annotations

from .samplers import (erdos_renyi, power_law, random_bipartite, sample,
                       stochastic_block)

__all__ = ["erdos_renyi", "random_bipartite", "stochastic_block", "power_law",
           "sample"]
