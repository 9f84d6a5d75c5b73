"""Sharding rules of the port (the reference's `sharding/`), on DTensor."""
from .rules import (LOGICAL_RULES, activation_sharding, constrain,  # noqa: F401
                    param_shardings, set_mesh)
