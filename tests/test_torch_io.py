"""The port's edge-list loader (`repro_torch.graphs.io`) against the
reference's (`repro.graphs.io`), array for array and byte for byte.

* The committed karate fixture is a byte copy of the reference's, and both
  loaders give equal raw labels, normalized edges, CSR arrays and label
  maps, with and without the largest-CC step.
* Generated SNAP-style edge lists (comments of both kinds, CRLF and bare
  CR line ends, commas, tabs, extra fields, duplicates in both
  orientations, self-loops, detached components, no trailing newline)
  parse equally at chunk sizes that cut lines anywhere, through the
  vectorised path and through the line-by-line fallback (signed fields
  force it); malformed lines raise the same error.
* `write_edge_list` writes the reference's bytes, and `allocate` pads as
  the reference's does.
"""
import numpy as np
import pytest

from repro import graphs as r_graphs
from repro.graphs import io as r_io
from repro_torch import graphs as t_graphs
from repro_torch.core.graph_models import Graph
from repro_torch.graphs import io as t_io

CHUNKS = (1 << 22, 64, 17, 5)


def _equal_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _equal_graphs(t, r):
    assert t.n == r.n and t.num_edges == r.num_edges and t.model == r.model
    _equal_arrays((t.csr.indptr, t.csr.indices, t.csr.rows),
                  (r.csr.indptr, r.csr.indices, r.csr.rows))
    assert t.params.keys() == r.params.keys()
    for k, v in r.params.items():
        if isinstance(v, np.ndarray):
            _equal_arrays((t.params[k],), (v,))
        else:
            assert t.params[k] == v, k


def test_fixture_is_a_byte_copy():
    assert t_io.fixture_path("karate") != r_io.fixture_path("karate")
    assert t_io.fixture_path().read_bytes() == r_io.fixture_path().read_bytes()


@pytest.mark.parametrize("largest_cc", [True, False])
def test_karate_loads_equal(largest_cc):
    _equal_graphs(t_graphs.load_fixture(largest_cc=largest_cc),
                  r_graphs.load_fixture(largest_cc=largest_cc))
    path = t_io.fixture_path()
    _equal_graphs(t_graphs.load_graph(path, largest_cc=largest_cc),
                  r_graphs.load_graph(path, largest_cc=largest_cc))


@pytest.mark.parametrize("chunk_bytes", CHUNKS)
def test_karate_raw_and_normalized_equal(chunk_bytes):
    path = t_io.fixture_path()
    raw = t_io.read_edge_list(path, chunk_bytes=chunk_bytes)
    _equal_arrays(raw, r_io.read_edge_list(path, chunk_bytes=chunk_bytes))
    for cc in (True, False):
        _equal_arrays(t_io.normalize_edges(*raw, largest_cc=cc),
                      r_io.normalize_edges(*raw, largest_cc=cc))


def _noisy_edge_list(seed: int, signed: bool) -> bytes:
    """A SNAP-style file with every kind of noise the loader accepts."""
    rng = np.random.default_rng(seed)
    lines = ["# generated edge list", "% second comment style", ""]
    labels = rng.choice(10 ** 6, size=60, replace=False)
    for _ in range(300):
        u, v = rng.choice(labels[:50], size=2)
        kind = rng.integers(0, 7)
        if kind == 0:
            lines.append(f"{u},{v}")
        elif kind == 1:
            lines.append(f"{u}\t{v}\t{rng.random():.3f}")
        elif kind == 2:
            lines.append(f"  {v} {u} 17 x")                 # reversed + fields
        elif kind == 3:
            lines.append(f"{u} {u}")                         # self-loop
        elif kind == 4:
            lines.append("   # indented comment")
        else:
            lines.append(f"{u} {v}")
    lines += [f"{labels[50]} {labels[51]}", f"{labels[52]} {labels[53]}"]
    if signed:
        lines.insert(5, f"+{labels[0]} {labels[1]}")
    ends = ["\n", "\r\n"]
    body = "".join(ln + ends[i % 2] for i, ln in enumerate(lines[:-1]))
    return (body + lines[-1]).encode()                       # no final newline


@pytest.mark.parametrize("signed", [False, True], ids=["fast", "fallback"])
@pytest.mark.parametrize("seed", [0, 1])
def test_generated_edge_lists_equal(tmp_path, seed, signed):
    path = tmp_path / "g.edges"
    path.write_bytes(_noisy_edge_list(seed, signed))
    for chunk_bytes in CHUNKS:
        raw = t_io.read_edge_list(path, chunk_bytes=chunk_bytes)
        _equal_arrays(raw, r_io.read_edge_list(path, chunk_bytes=chunk_bytes))
        assert raw[0].size > 200
    text = path.read_text().splitlines()
    _equal_arrays(t_io.read_edge_list(text), r_io.read_edge_list(text))
    for cc in (True, False):
        _equal_arrays(t_io.normalize_edges(*raw, largest_cc=cc),
                      r_io.normalize_edges(*raw, largest_cc=cc))
        _equal_graphs(t_graphs.load_graph(path, largest_cc=cc),
                      r_graphs.load_graph(path, largest_cc=cc))


def test_fallback_parser_equal_and_bare_cr(tmp_path):
    data = _noisy_edge_list(2, signed=True).replace(b"\r\n", b"\r")
    path = tmp_path / "cr.edges"
    path.write_bytes(data)
    assert t_io._parse_block_fast(data + b"\n", ("#", "%")) is None
    for chunk_bytes in CHUNKS:
        _equal_arrays(t_io.read_edge_list(path, chunk_bytes=chunk_bytes),
                      r_io.read_edge_list(path, chunk_bytes=chunk_bytes))


@pytest.mark.parametrize("text", ["1 2\n7\n3 4\n", "1 2\n1.5 2\n"])
def test_malformed_lines_raise_alike(tmp_path, text):
    path = tmp_path / "bad.edges"
    path.write_text(text)
    with pytest.raises(ValueError) as want:
        r_io.read_edge_list(path, chunk_bytes=3)
    with pytest.raises(ValueError) as got:
        t_io.read_edge_list(path, chunk_bytes=3)
    assert str(got.value) == str(want.value)


def test_empty_lists_and_largest_cc_of_nothing(tmp_path):
    path = tmp_path / "empty.edges"
    path.write_text("# only a comment\n5 5\n")
    _equal_arrays(t_io.read_edge_list(path), r_io.read_edge_list(path))
    with pytest.raises(ValueError, match="no edges"):
        t_io.normalize_edges(*t_io.read_edge_list(path), largest_cc=True)


@pytest.mark.parametrize("header", [None, "two\nlines"])
def test_write_edge_list_bytes_equal(tmp_path, header):
    g_t = t_graphs.load_fixture()
    g_r = r_graphs.load_fixture()
    t_graphs.write_edge_list(g_t, tmp_path / "t.edges", header=header)
    r_graphs.write_edge_list(g_r, tmp_path / "r.edges", header=header)
    assert (tmp_path / "t.edges").read_bytes() == (tmp_path / "r.edges").read_bytes()
    again = t_graphs.load_graph(tmp_path / "t.edges")
    assert np.array_equal(again.csr.indptr, g_t.csr.indptr)
    assert np.array_equal(again.csr.indices, g_t.csr.indices)


def test_components_equal():
    rng = np.random.default_rng(4)
    u, v = rng.integers(0, 200, size=(2, 150))
    assert np.array_equal(t_io._components(u, v, 200), r_io._components(u, v, 200))


@pytest.mark.parametrize("K,r,interleave", [(6, 2, False), (6, 3, True), (4, 1, False)])
def test_allocate_pads_as_the_reference(K, r, interleave):
    g_t, a_t = t_graphs.allocate(t_graphs.load_fixture(), K, r, interleave)
    g_r, a_r = r_graphs.allocate(r_graphs.load_fixture(), K, r, interleave)
    assert isinstance(g_t, Graph) and g_t.n == g_r.n == a_t.n == a_r.n
    assert np.array_equal(g_t.csr.indptr, g_r.csr.indptr)
    for f in ("batch_of", "map_sets", "reduce_owner"):
        assert np.array_equal(getattr(a_t, f), getattr(a_r, f))
    assert a_t.subsets == a_r.subsets
