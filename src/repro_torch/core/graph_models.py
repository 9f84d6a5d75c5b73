"""Graph representation (CSR-primary), plus its device view.

`Graph` stores one of two representations of the same undirected simple
graph and derives the other lazily:

  * **CSR-native** (`Graph.from_csr` / `Graph.from_edges`, what the
    `repro_torch.graphs` samplers produce): only `(indptr, indices)` live
    in memory - O(edges). The whole sparse pipeline (Map -> coded Shuffle
    -> segment Reduce, see `engine.py`) consumes nothing else.
  * **dense** (`Graph(adj, model, params)`): an [n, n] boolean adjacency,
    kept for small validation graphs. The CSR view is derived (and cached)
    on first use.

Dense materialization is *guarded*: accessing `adj` / `to_dense()` on a
CSR-native graph raises above `dense_limit` vertices (default
`DENSE_LIMIT`), so a stray dense touch on a large graph is a loud error
instead of a silent 10+ GB allocation.

Bitwise per-path oracle rule: the canonical CSR entry order (row major,
ascending column - exactly `np.nonzero(adj)` order) is the reduction order
of the sparse path. `CSR.apply_delta` mutates it by an `EdgeDelta` in
O(nnz + delta), bitwise `csr_from_undirected` of the mutated edge set (as
the reference's does).

`Graph.device_view(device)` uploads the tensors the device Map needs once
per device (column indices, clamped degrees, SSSP edge weights) and caches
them on the graph; `Graph.dense_device_view(device)` does the same for the
dense [n, n] path (adjacency, and the SSSP weight matrix on first use),
under the same `dense_limit` guard as `adj`.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# Vertices above which materializing any [n, n] view of a CSR-native graph
# raises (20_000^2 bools = 400 MB; the sparse path never needs it).
DENSE_LIMIT = 20_000


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed-sparse-row view of a symmetric adjacency.

    One entry per *directed* edge (i, j), in `np.nonzero(adj)` order: row
    major, ascending column within each row. That canonical entry order is
    the bitwise contract of the sparse path - every segment reduction
    accumulates each row's values in exactly this order.
    """

    indptr: np.ndarray       # [n+1] int64 row offsets
    indices: np.ndarray      # [nnz] int32 column (source vertex j) per entry
    rows: np.ndarray         # [nnz] int32 row (destination vertex i) per entry

    @property
    def n(self) -> int:
        return self.indptr.size - 1

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    def apply_delta(self, delta) -> "CSR":
        """Mutated CSR after an `EdgeDelta` batch, in O(nnz + delta).

        Both orientations of every inserted (deleted) undirected edge are
        spliced into (dropped from) the canonical entry stream by a sorted
        merge - untouched rows are copied, never re-sorted, so the result
        is bitwise identical to `csr_from_undirected` on the mutated edge
        set. Raises `ValueError` if a deleted edge is absent or an
        inserted edge already present.
        """
        del_pos, ins_pos, ins_rows, ins_cols = csr_delta_entries(self, delta)
        new_old, new_ins, nnz2 = merge_maps(self.nnz, del_pos, ins_pos)
        tgt = new_old.copy()
        tgt[del_pos] = nnz2                  # deleted entries -> trash slot
        indices2 = np.empty(nnz2 + 1, dtype=np.int32)
        indices2[tgt] = self.indices
        indices2[new_ins] = ins_cols
        indices2 = indices2[:nnz2]
        rows2 = np.empty(nnz2 + 1, dtype=np.int32)
        rows2[tgt] = self.rows
        rows2[new_ins] = ins_rows
        rows2 = rows2[:nnz2]
        counts = np.bincount(rows2, minlength=self.n)
        indptr2 = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr2[1:])
        return CSR(indptr2, indices2, rows2)


def merge_maps(size: int, del_pos: np.ndarray, ins_pos: np.ndarray):
    """Index bookkeeping for one sorted-merge splice.

    Given a length-`size` sorted sequence, sorted positions `del_pos` of
    elements to drop and sorted insertion points `ins_pos` (searchsorted
    convention: an element with point p lands before old element p; ties
    keep their given order), returns ``(new_old, new_ins, new_size)``:
    `new_old[a]` is the new index of old element a (meaningful only for
    survivors - callers scatter deletions to a trash slot, see
    `CSR.apply_delta`), `new_ins[t]` the new index of inserted element t.
    O(size + delta), no sorting: the old->new offset changes only at delta
    positions, so it is one difference-array cumsum.
    """
    diff = np.zeros(size + 2, dtype=np.int32)   # |offset| <= |delta|
    np.add.at(diff, ins_pos, 1)            # +1 from each insert point on
    np.add.at(diff, del_pos + 1, -1)       # -1 after each deleted element
    offset = np.cumsum(diff[:size + 1], dtype=np.int32)
    new_old = np.arange(size, dtype=np.int64) + offset[:size]
    new_ins = (ins_pos + np.arange(ins_pos.size, dtype=np.int64)
               - np.searchsorted(del_pos, ins_pos, side="left"))
    return new_old, new_ins, size - del_pos.size + ins_pos.size


def csr_delta_entries(csr: CSR, delta):
    """Locate an `EdgeDelta`'s directed entries in `csr`'s canonical order.

    Returns ``(del_pos, ins_pos, ins_rows, ins_cols)``: sorted entry
    positions of the 2 x num_delete deleted directed entries, sorted
    insertion points of the 2 x num_insert new ones, and the new entries'
    (row, col) in insertion-point order. Raises `ValueError` on a deleted
    edge that is absent or an inserted edge already present.

    Both the result (per delta) and the entry-key array (per CSR) are
    cached: `CSR.apply_delta` and `ShufflePlan.apply_delta` locate the
    same delta in the same CSR, and the second call must not redo the
    O(nnz log delta) work.
    """
    n = csr.n
    if delta.n != n:
        raise ValueError(
            f"delta is bound to n={delta.n} but the graph has n={n}")
    cached = csr.__dict__.get("_delta_entries")
    if cached is not None and cached[0] is delta:
        return cached[1]
    key = csr.__dict__.get("_entry_key")
    if key is None:
        key = csr.rows.astype(np.int64) * n + csr.indices
        csr.__dict__["_entry_key"] = key
    out = []
    for what, pairs, must_exist in (("delete", delta.delete, True),
                                    ("insert", delta.insert, False)):
        if pairs.shape[0] == 0:
            out.append((np.zeros(0, dtype=np.int64),) * 3)
            continue
        dk = np.concatenate([pairs[:, 0] * n + pairs[:, 1],
                             pairs[:, 1] * n + pairs[:, 0]])
        dk.sort()
        pos = np.searchsorted(key, dk)
        present = (pos < key.size) & (key[np.minimum(pos, key.size - 1)] == dk)
        offend = ~present if must_exist else present
        if offend.any():
            k = int(dk[np.flatnonzero(offend)[0]])
            u, v = min(k // n, k % n), max(k // n, k % n)
            raise ValueError(
                f"{what} edge ({u}, {v}) is "
                + ("not in the graph" if must_exist
                   else "already in the graph"))
        out.append((pos, dk // n, dk % n))
    (del_pos, _, _), (ins_pos, ins_r, ins_c) = out
    res = (del_pos, ins_pos,
           ins_r.astype(np.int32), ins_c.astype(np.int32))
    csr.__dict__["_delta_entries"] = (delta, res)
    return res


def csr_from_undirected(u: np.ndarray, v: np.ndarray, n: int) -> CSR:
    """Symmetric CSR from undirected edge endpoints (u[e], v[e]), u != v.

    Pairs must be unique as undirected edges; both orientations are emitted
    and sorted into the canonical entry order. O(edges log edges).
    """
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    rows = np.concatenate([u, v])
    cols = np.concatenate([v, u])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    counts = np.bincount(rows, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(indptr, cols.astype(np.int32), rows.astype(np.int32))


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """The tensors the device Map reads, uploaded once per device."""

    n: int
    indices: torch.Tensor    # [nnz] int64 source vertex of each CSR entry
    deg: torch.Tensor        # [n] float32 max(degree, 1)
    edge_weights: torch.Tensor   # [nnz] float64 (SSSP weights, CSR order)


class DenseDeviceGraph:
    """The [n, n] tensors the dense device Map and Reduce read, built on
    the device from the CSR view (never through a host [n, n] buffer)."""

    def __init__(self, g: "Graph", device: torch.device):
        csr = g.csr
        self.n = g.n
        self.device = device
        self._rows = torch.from_numpy(csr.rows.astype(np.int64)).to(device)
        self._cols = torch.from_numpy(csr.indices.astype(np.int64)).to(device)
        self._edge_weights = g.edge_weights
        self.adj = torch.zeros((g.n, g.n), dtype=torch.bool, device=device)
        self.adj[self._rows, self._cols] = True
        self.deg = torch.from_numpy(
            np.maximum(g.degrees(), 1).astype(np.float32)).to(device)

    @functools.cached_property
    def weights(self) -> torch.Tensor:
        """[n, n] float64 SSSP weights, +inf on non-edges (`Graph.weights`
        on the device)."""
        w = torch.full((self.n, self.n), float("inf"), dtype=torch.float64,
                       device=self.device)
        w[self._rows, self._cols] = torch.from_numpy(
            np.ascontiguousarray(self._edge_weights())).to(self.device)
        return w


class Graph:
    """An undirected graph realization plus the model metadata.

    Construct densely (`Graph(adj, model, params)`) or CSR-natively
    (`Graph.from_csr` / `Graph.from_edges`); see the module docstring for
    the CSR-primary contract and the dense-materialization guard.
    """

    def __init__(self, adj: np.ndarray | None = None, model: str = "",
                 params: dict | None = None, *, csr: CSR | None = None,
                 dense_limit: int = DENSE_LIMIT):
        if (adj is None) == (csr is None):
            raise ValueError("construct from exactly one of adj= or csr=")
        self.model = model
        self.params = {} if params is None else params
        self.dense_limit = int(dense_limit)
        self._dense_built = adj is not None
        if adj is not None:
            adj = np.asarray(adj)
            self._adj = adj if adj.dtype == bool else adj.astype(bool)
            self._n = int(adj.shape[0])
        else:
            self._adj = None
            self._n = csr.n
            self.__dict__["csr"] = csr      # pre-fill the cached_property

    # ---- constructors ----

    @classmethod
    def from_csr(cls, indptr: np.ndarray, indices: np.ndarray,
                 model: str = "", params: dict | None = None, *,
                 dense_limit: int = DENSE_LIMIT) -> "Graph":
        """CSR-native graph from (indptr, indices); indices must be sorted
        ascending within each row (the canonical entry order)."""
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int32)
        n = indptr.size - 1
        rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
        return cls(model=model, params=params,
                   csr=CSR(indptr, indices, rows), dense_limit=dense_limit)

    @classmethod
    def from_edges(cls, u: np.ndarray, v: np.ndarray, n: int,
                   model: str = "", params: dict | None = None, *,
                   dense_limit: int = DENSE_LIMIT) -> "Graph":
        """CSR-native graph from deduped undirected edge endpoint arrays."""
        return cls(model=model, params=params,
                   csr=csr_from_undirected(u, v, n), dense_limit=dense_limit)

    def __repr__(self) -> str:
        rep = "csr" if self._adj is None else "dense"
        return (f"Graph(model={self.model!r}, n={self._n}, "
                f"edges={self.num_edges}, {rep})")

    # ---- representations ----

    @property
    def n(self) -> int:
        return self._n

    @property
    def is_csr_native(self) -> bool:
        return self._adj is None

    @functools.cached_property
    def csr(self) -> CSR:
        """Cached CSR view (derived from `adj` for dense-built graphs)."""
        rows, cols = np.nonzero(self._adj)
        counts = np.bincount(rows, minlength=self._n)
        indptr = np.zeros(self._n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSR(indptr, cols.astype(np.int32), rows.astype(np.int32))

    def _check_dense(self, what: str, limit: int | None = None) -> None:
        limit = self.dense_limit if limit is None else limit
        if self._n > limit:
            raise ValueError(
                f"{what} would materialize an [{self._n}, {self._n}] dense "
                f"buffer (> dense_limit={limit}); the sparse path never "
                f"needs it - force with to_dense(limit=...) for a "
                f"validation-scale graph")

    @property
    def adj(self) -> np.ndarray:
        """[n, n] bool adjacency; lazily materialized (and guarded) for
        CSR-native graphs."""
        return self.to_dense()

    def to_dense(self, limit: int | None = None) -> np.ndarray:
        """Dense adjacency; `limit` overrides the construction-time
        `dense_limit` guard for one deliberate materialization."""
        if self._adj is None:
            self._check_dense("dense adjacency", limit)
            csr = self.csr
            a = np.zeros((self._n, self._n), dtype=bool)
            a[csr.rows, csr.indices] = True
            self._adj = a
        return self._adj

    # ---- derived quantities (representation-agnostic, cached) ----

    def degrees(self) -> np.ndarray:
        """[n] int64 vertex degrees, from whichever representation already
        exists."""
        d = self.__dict__.get("_degrees")
        if d is None:
            if "csr" in self.__dict__ or self._adj is None:
                d = np.diff(self.csr.indptr)
            else:
                d = self._adj.sum(axis=1, dtype=np.int64)
            self.__dict__["_degrees"] = d
        return d

    @property
    def num_edges(self) -> int:
        return int(self.degrees().sum()) // 2

    @property
    def density(self) -> float:
        """Directed-entry density nnz / n^2."""
        if self._n == 0:
            return 0.0
        return float(self.degrees().sum()) / (self._n * self._n)

    def edge_weights(self, low: float = 0.5, high: float = 1.5) -> np.ndarray:
        """[nnz] float64 positive edge weights in CSR entry order (for SSSP).

        One uniform draw per *undirected* edge, in canonical upper-triangle
        CSR order, shared bit-for-bit by both directed entries. O(edges)
        time and memory; cached per (low, high).
        """
        key = ("_edge_weights", float(low), float(high))
        w = self.__dict__.get(key)
        if w is None:
            csr = self.csr
            i64 = csr.rows.astype(np.int64)
            j64 = csr.indices.astype(np.int64)
            ukey = np.minimum(i64, j64) * self._n + np.maximum(i64, j64)
            upper = i64 < j64         # upper-tri entries: ukey already sorted
            rng = np.random.default_rng(0)
            w_upper = rng.uniform(low, high, size=int(np.count_nonzero(upper)))
            w = w_upper[np.searchsorted(ukey[upper], ukey)]
            self.__dict__[key] = w
        return w

    def weights(self, low: float = 0.5, high: float = 1.5) -> np.ndarray:
        """Dense [n, n] scatter of `edge_weights()`; +inf on non-edges.

        Cached per (low, high) and guarded like `adj` on CSR-native graphs
        (this float64 view is 8x the bool adjacency). Only the dense NumPy
        oracle calls this - the sparse path consumes `edge_weights()`.
        """
        key = ("_weights", float(low), float(high))
        w = self.__dict__.get(key)
        if w is None:
            if not self._dense_built:
                self._check_dense("weights()")
            w = np.full((self._n, self._n), np.inf)
            w[self.csr.rows, self.csr.indices] = self.edge_weights(low, high)
            self.__dict__[key] = w
        return w

    def dense_device_view(self, device: torch.device) -> DenseDeviceGraph:
        """The dense path's [n, n] tensors on `device`, built once and
        cached; guarded by `dense_limit` like `adj` on CSR-native graphs."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_dense_device_views", {})
        dd = cache.get(device)
        if dd is None:
            if not self._dense_built:
                self._check_dense("the dense device view")
            dd = cache[device] = DenseDeviceGraph(self, device)
        return dd

    def device_view(self, device: torch.device) -> DeviceGraph:
        """The device Map's tensors on `device`, uploaded once and cached."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_device_views", {})
        dg = cache.get(device)
        if dg is None:
            csr = self.csr
            deg = np.maximum(self.degrees(), 1).astype(np.float32)
            dg = DeviceGraph(
                n=self._n,
                indices=torch.from_numpy(csr.indices.astype(np.int64)).to(device),
                deg=torch.from_numpy(deg).to(device),
                edge_weights=torch.from_numpy(
                    np.ascontiguousarray(self.edge_weights())).to(device))
            cache[device] = dg
        return dg

    def padded(self, n2: int) -> "Graph":
        """This graph plus `n2 - n` virtual isolated vertices (CSR-native).

        Lets an arbitrary n meet the allocation's divisibility requirement
        (`allocation.divisible_n`): isolated vertices have no edges, hence
        no Map values, no Shuffle traffic, and no effect on any other
        vertex's reduction order.
        """
        if n2 < self._n:
            raise ValueError(f"cannot pad n={self._n} down to {n2}")
        if n2 == self._n:
            return self
        csr = self.csr
        indptr = np.concatenate([
            csr.indptr,
            np.full(n2 - self._n, csr.indptr[-1], dtype=np.int64)])
        params = dict(self.params)
        params["padded_from"] = self._n
        return Graph(model=self.model, params=params,
                     csr=CSR(indptr, csr.indices, csr.rows),
                     dense_limit=self.dense_limit)


def erdos_renyi(n: int, p: float, seed: int = 0) -> Graph:
    """ER(n, p) drawn densely, every edge present independently w.p. p:
    the reference's dense sampler (`core.graph_models.erdos_renyi`), draw
    for draw, so a seed gives both packages the same graph. The O(edges)
    streaming sampler of `repro_torch.graphs` draws another graph."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < p, 1)
    return Graph(upper | upper.T, "er", {"n": n, "p": p, "seed": seed})
