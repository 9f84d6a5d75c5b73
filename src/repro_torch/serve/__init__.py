"""Admission-batched multi-query serving over one compiled coded session.

The coded Shuffle schedule is a function of (graph, allocation) only, so a
single `engine.CompiledEngine` can carry any number of concurrent queries as
payload columns of one exchange. `GraphService` is the front end: callers
`submit` individual queries (SSSP roots, personalized-PageRank preference
vectors), the service coalesces them - up to `max_batch` or an admission
timeout - and runs each admitted batch as ONE batched execution on the
session's device, fanning the per-query result columns back out through
futures.
"""
from .service import GraphService, ServeStats

__all__ = ["GraphService", "ServeStats"]
