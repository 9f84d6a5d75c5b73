"""Real-dataset ingestion: edge-list loaders + normalization to CSR graphs
(a copy of the reference package's `graphs/io.py`, on the port's `Graph`).

Reads SNAP-style whitespace/comma-separated edge lists (`# `/`% ` comment
lines, one "u v" pair per line, arbitrary non-negative integer labels) and
normalizes them into the engine's undirected simple-graph contract:

  * every line is treated as one undirected edge (symmetrize),
  * self-loops dropped, duplicate edges (either orientation) deduped,
  * labels relabeled to a contiguous [0, n) range (ascending original id),
  * optionally restricted to the largest connected component,

then builds a CSR-native `Graph` - the dense [n, n] view is never touched,
so real datasets load at O(edges). `params["labels"]` maps each normalized
vertex id back to its original label.

A tiny committed real-world fixture (Zachary's karate club, with raw-format
noise: comments, duplicates, a self-loop, a detached component) lives at
`data/karate.edges` for tests and the card's smoke run; it is a byte-for-byte
copy of the reference's, so both packages load the same graph.
"""
from __future__ import annotations

import pathlib

import numpy as np

from ..core.graph_models import Graph

__all__ = ["read_edge_list", "normalize_edges", "load_graph",
           "fixture_path", "load_fixture", "write_edge_list"]

FIXTURE_DIR = pathlib.Path(__file__).parent / "data"


def fixture_path(name: str = "karate") -> pathlib.Path:
    """Path of a committed fixture edge list (default: karate club)."""
    return FIXTURE_DIR / f"{name}.edges"


def read_edge_list(source, comments: tuple[str, ...] = ("#", "%"),
                   chunk_bytes: int = 1 << 22,
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Raw (u, v) int64 label arrays from a path or an iterable of lines.

    Accepts whitespace- or comma-separated fields (CRLF tolerated); extra
    per-line fields (weights, timestamps) are ignored. No normalization is
    applied.

    Paths stream in `chunk_bytes` binary chunks through a vectorized byte
    parser (`_parse_block_fast`): separator translation, line/comment
    classification, and digit-run accumulation are all NumPy array passes,
    so a ~500k-line SNAP file parses in milliseconds instead of the
    per-line `int()` loop the ingest path used to bottleneck on. Any block
    the fast path cannot certify (non-digit bytes inside the first two
    fields, e.g. signs or floats) re-parses through the line-by-line
    reference `_parse_lines`, which is also the iterable-of-lines path -
    the two are byte-parity equivalent wherever both succeed.
    """
    if not isinstance(source, (str, pathlib.Path)):
        return _parse_lines(source, comments, 0)
    blocks: list[tuple[np.ndarray, np.ndarray]] = []
    with open(source, "rb") as f:
        carry = b""
        lineno = 0                       # complete lines consumed so far
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                if carry:                # final line without a newline
                    blocks.append(_parse_block(carry + b"\n", comments,
                                               lineno))
                break
            data = carry + chunk
            head, sep, carry = data.rpartition(b"\n")
            if not sep:                  # no newline yet: keep accumulating
                carry = data
                continue
            block = head + b"\n"
            blocks.append(_parse_block(block, comments, lineno))
            # Logical lines consumed: universal-newline semantics, so bare
            # '\r' terminators (fallback-parsed blocks) count too - error
            # line numbers stay global and chunk-size independent.
            lineno += (block.count(b"\n") + block.count(b"\r")
                       - block.count(b"\r\n"))
    if not blocks:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty.copy()
    return (np.concatenate([u for u, _ in blocks]),
            np.concatenate([v for _, v in blocks]))


def _parse_lines(source, comments: tuple[str, ...], base_lineno: int,
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Line-by-line reference parser (iterables + fast-path fallback).

    `base_lineno` offsets error messages when re-parsing one streamed block
    of a larger file.
    """
    us: list[int] = []
    vs: list[int] = []
    for lineno, line in enumerate(source, base_lineno + 1):
        line = line.strip()
        if not line or line.startswith(comments):
            continue
        fields = line.replace(",", " ").split()
        if len(fields) < 2:
            raise ValueError(f"line {lineno}: need at least two fields, "
                             f"got {line!r}")
        us.append(int(fields[0]))
        vs.append(int(fields[1]))
    return np.asarray(us, dtype=np.int64), np.asarray(vs, dtype=np.int64)


def _parse_block(data: bytes, comments: tuple[str, ...], base_lineno: int,
                 ) -> tuple[np.ndarray, np.ndarray]:
    """One newline-terminated block: fast path, else reference re-parse."""
    out = _parse_block_fast(data, comments)
    if out is None:
        out = _parse_lines(data.decode().splitlines(), comments, base_lineno)
    return out


def _token_values(b: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
                  ) -> np.ndarray:
    """int64 value of each digit run; one vectorized pass per digit place."""
    vals = np.zeros(starts.size, dtype=np.int64)
    for t in range(int(lengths.max()) if starts.size else 0):
        sel = lengths > t
        vals[sel] = vals[sel] * 10 + (b[starts[sel] + t] - ord("0"))
    return vals


def _parse_block_fast(data: bytes, comments: tuple[str, ...],
                      ) -> tuple[np.ndarray, np.ndarray] | None:
    """Vectorized (u, v) extraction from a newline-terminated byte block.

    Returns None when the block needs the reference parser: multi-byte
    comment prefixes, a data line with fewer than two digit runs, a
    non-digit byte at or before the end of a line's second field (sign,
    float, garbage - the reference either accepts or raises there), or a
    field too long for int64.
    """
    if not all(len(c) == 1 for c in comments):
        return None
    b = np.frombuffer(data, dtype=np.uint8)
    nl = b == ord("\n")
    # A bare '\r' (not part of CRLF) is a line terminator under the
    # reference's universal-newline semantics but intra-line whitespace
    # here - let the reference split those lines (str.splitlines does).
    cr = np.flatnonzero(b == ord("\r"))
    if cr.size and not nl[np.minimum(cr + 1, b.size - 1)].all():
        return None
    line_start = np.flatnonzero(np.concatenate([[True], nl[:-1]]))
    line_end = np.flatnonzero(nl)                   # one '\n' per line
    # Classification mirrors the reference's `line.strip()`: only true
    # whitespace is stripped (a leading comma is content, not blank), so
    # the first non-whitespace byte decides blank/comment/data.
    ws = (b == ord(" ")) | (b == ord("\t")) | (b == ord("\r"))
    content = ~ws & ~nl
    first = np.minimum.reduceat(
        np.where(content, np.arange(b.size, dtype=np.int64), b.size),
        line_start)
    blank = first >= line_end
    lead = b[np.minimum(first, b.size - 1)]
    comment = ~blank & np.isin(lead, np.frombuffer(
        "".join(comments).encode(), dtype=np.uint8))
    is_data = ~blank & ~comment

    dig = (b >= ord("0")) & (b <= ord("9"))
    starts = np.flatnonzero(dig & ~np.concatenate([[False], dig[:-1]]))
    lengths = np.flatnonzero(dig & ~np.concatenate([dig[1:], [False]])) \
        + 1 - starts
    tline = np.searchsorted(line_start, starts, side="right") - 1
    on_data = is_data[tline]
    starts, lengths, tline = starts[on_data], lengths[on_data], tline[on_data]
    if lengths.size and int(lengths.max()) > 18:    # int64 overflow risk
        return None
    if np.count_nonzero(np.bincount(tline, minlength=line_start.size)[is_data]
                        < 2):
        return None                                 # short line: reference
    # First two digit runs of each data line (tline is nondecreasing).
    tok0 = np.searchsorted(tline, np.flatnonzero(is_data))
    second_end = starts[tok0 + 1] + lengths[tok0 + 1]
    # A byte that is neither a digit nor a separator, at or before the end
    # of a line's second field, means the fields are not plain unsigned
    # integers - let the reference parser accept or raise there.
    garbage = np.flatnonzero(content & ~dig & (b != ord(",")))
    garbage = garbage[is_data[np.searchsorted(line_start, garbage,
                                              side="right") - 1]]
    if garbage.size:
        gline = np.searchsorted(line_start, garbage, side="right") - 1
        data_id = np.cumsum(is_data) - 1            # line -> data-line rank
        if (garbage <= second_end[data_id[gline]]).any():
            return None
    take = np.concatenate([tok0, tok0 + 1])
    vals = _token_values(b, starts[take], lengths[take])
    return vals[:tok0.size], vals[tok0.size:]


def _components(u: np.ndarray, v: np.ndarray, n: int) -> np.ndarray:
    """[n] min-vertex-id component label per vertex (vectorized min-label
    propagation with pointer jumping; O(edges * log diameter) passes)."""
    comp = np.arange(n, dtype=np.int64)
    while True:
        prev = comp.copy()
        np.minimum.at(comp, u, comp[v])
        np.minimum.at(comp, v, comp[u])
        comp = np.minimum(comp, comp[comp])        # pointer jumping
        if np.array_equal(comp, prev):
            break
    while True:                                     # full compression
        nxt = comp[comp]
        if np.array_equal(nxt, comp):
            return comp
        comp = nxt


def normalize_edges(u: np.ndarray, v: np.ndarray, *,
                    largest_cc: bool = False,
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Normalize raw undirected edge labels; see the module docstring.

    Returns (u2, v2, labels): deduped canonical (u2 < v2) edges over the
    contiguous vertex range [0, labels.size), with labels[new_id] = original
    label (ascending, so relabeling is order-preserving).
    """
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    lo, hi = np.minimum(u, v), np.maximum(u, v)    # symmetrize orientation
    keep = lo != hi                                 # strip self-loops
    lo, hi = lo[keep], hi[keep]
    labels, flat = np.unique(np.concatenate([lo, hi]), return_inverse=True)
    n = labels.size
    lo, hi = flat[:lo.size], flat[lo.size:]         # contiguous relabel
    pairs = np.unique(lo * n + hi)                  # dedup undirected pairs
    lo, hi = pairs // n, pairs % n
    if largest_cc:
        if n == 0:
            raise ValueError(
                "edge list has no edges after normalization (empty, "
                "comment-only, or self-loops only); cannot extract a "
                "largest connected component")
        comp = _components(lo, hi, n)
        roots, sizes = np.unique(comp, return_counts=True)
        big = roots[np.argmax(sizes)]
        keep_v = comp == big
        new_id = np.cumsum(keep_v) - 1
        sel = keep_v[lo]                            # == keep_v[hi]
        lo, hi = new_id[lo[sel]], new_id[hi[sel]]
        labels = labels[keep_v]
    return lo, hi, labels


def load_graph(source, *, largest_cc: bool = False, name: str | None = None,
               ) -> Graph:
    """Load + normalize an edge list into a CSR-native `Graph`.

    `params` records the provenance: original label map (`labels`), raw
    line/vertex counts, and whether the largest component was extracted.
    """
    u, v = read_edge_list(source)
    lo, hi, labels = normalize_edges(u, v, largest_cc=largest_cc)
    if name is None:
        name = (pathlib.Path(source).stem
                if isinstance(source, (str, pathlib.Path)) else "edges")
    return Graph.from_edges(lo, hi, labels.size, "real", {
        "name": name, "labels": labels, "raw_lines": int(u.size),
        "largest_cc": largest_cc})


def load_fixture(name: str = "karate", *, largest_cc: bool = True) -> Graph:
    """The committed real-world fixture graph, normalized (LCC by default:
    the raw file deliberately carries a detached noise component)."""
    return load_graph(fixture_path(name), largest_cc=largest_cc, name=name)


def write_edge_list(g: Graph, path, header: str | None = None) -> None:
    """Write one undirected edge per line in normalized vertex ids.

    The edge-list format carries edges only: isolated vertices (e.g.
    `Graph.padded` padding) and original labels are not representable, so
    a `load_graph` round-trip reproduces the CSR exactly iff every vertex
    has degree >= 1 (true for normalized largest-CC datasets); otherwise
    the reloaded graph is the edge-bearing subgraph, relabeled contiguous.
    """
    csr = g.csr
    upper = csr.rows < csr.indices
    with open(path, "w") as f:
        if header:
            for line in header.splitlines():
                f.write(f"# {line}\n")
        for i, j in zip(csr.rows[upper], csr.indices[upper]):
            f.write(f"{i} {j}\n")
