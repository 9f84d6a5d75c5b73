"""Port host layer vs the reference: codec, samplers, allocations, plans.

The port's NumPy host layer (`repro_torch.core.{bitcodec, allocation,
shuffle_plan}`, `repro_torch.core.fused_shuffle.partition_plan`,
`repro_torch.graphs`) is a copy of the reference's, so for the same inputs
every array must be *bitwise* equal: codec words, sampled CSR arrays,
allocation fields, every `ShufflePlan` field and every
`FusedSparseSchedule` table. The case matrix is that of
`tests/test_schedule_invariants.py` (er / er-interleave / random
allocation / pl / rb spill / r=1) plus an SBM case and the karate fixture,
read from its file in the repo.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro import graphs as r_graphs
from repro.core import allocation as r_alloc
from repro.core import bitcodec as r_codec
from repro.core import graph_models as r_gm
from repro.core.fused_shuffle import partition_plan as r_partition
from repro.core.shuffle_plan import compile_plan_csr as r_compile
from repro_torch import graphs as t_graphs
from repro_torch.core import allocation as t_alloc
from repro_torch.core import bitcodec as t_codec
from repro_torch.core import convert
from repro_torch.core.fused_shuffle import partition_plan as t_partition
from repro_torch.core.shuffle_plan import compile_plan_csr as t_compile

KARATE = (pathlib.Path(__file__).resolve().parents[1]
          / "src" / "repro" / "graphs" / "data" / "karate.edges")


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_fields_equal(a, b) -> None:
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert isinstance(vb, np.ndarray), f.name
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


# ---- codec ----


def test_codec_words_bitwise_and_round_trip():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((257, 3)).astype(np.float32)
    x[0, 0], x[1, 0], x[2, 0] = np.inf, -0.0, np.nan
    want = r_codec.floats_to_words(x)
    got = t_codec.floats_to_words_t(torch.from_numpy(x))
    np.testing.assert_array_equal(t_codec.t_words_to_np(got), want)
    back = t_codec.words_to_floats_t(got).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), x.view(np.uint32))
    # the NumPy forms are copies of the reference's
    np.testing.assert_array_equal(t_codec.floats_to_words(x), want)
    np.testing.assert_array_equal(
        t_codec.words_to_floats(want).view(np.uint32), x.view(np.uint32))


@pytest.mark.parametrize("r", [1, 2, 3, 5, 32, 40])
def test_segment_tables_and_logical_shifts(r):
    rs, rm = r_codec.segment_words(r)
    ts, tm = t_codec.segment_words(r)
    np.testing.assert_array_equal(rs, ts)
    np.testing.assert_array_equal(rm, tm)
    assert r_codec.segment_bounds(r) == t_codec.segment_bounds(r)
    words = np.random.default_rng(r).integers(0, 2 ** 32, 64, dtype=np.uint32)
    w = t_codec.np_words_to_t(words)
    for s, m in zip(rs, rm):
        # (w << s) & m and its logical shift back, through int64 widening
        seg = t_codec.u64_to_words((t_codec.words_to_u64(w) << int(s)) & int(m))
        np.testing.assert_array_equal(t_codec.t_words_to_np(seg),
                                      (words << s) & m)
        back = t_codec.u64_to_words(t_codec.words_to_u64(seg) >> int(s))
        np.testing.assert_array_equal(t_codec.t_words_to_np(back),
                                      ((words << s) & m) >> s)


# ---- samplers + allocations ----


@pytest.mark.parametrize("model,kw", [
    ("er", dict(n=300, p=0.03)),
    ("pl", dict(n=200, gamma=2.5)),
    ("sbm", dict(n1=80, n2=40, p=0.1, q=0.02)),
    ("rb", dict(n1=60, n2=30, q=0.05)),
])
def test_streaming_samplers_byte_for_byte(model, kw):
    gr = r_graphs.sample(model, seed=13, **kw)
    gt = t_graphs.sample(model, seed=13, **kw)
    for f in ("indptr", "indices", "rows"):
        a, b = getattr(gr.csr, f), getattr(gt.csr, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(gr.edge_weights(), gt.edge_weights())
    np.testing.assert_array_equal(gr.degrees(), gt.degrees())


@pytest.mark.parametrize("make", [
    lambda m: m.er_allocation(48, 4, 2),
    lambda m: m.er_allocation(50, 5, 3, interleave=True, pad=True),
    lambda m: m.bipartite_allocation(48, 24, 6, 3),
    lambda m: m.random_allocation(40, 4, 2, seed=4),
], ids=["er", "er-interleave-pad", "bipartite", "random"])
def test_allocations_field_for_field(make):
    a, b = make(r_alloc), make(t_alloc)
    _assert_fields_equal(a, b)
    _assert_fields_equal(a, convert.allocation(_fields(a)))


# ---- plans + partitions over the schedule-invariant matrix ----


def _karate():
    raw = []
    for line in KARATE.read_text().splitlines():
        parts = line.split()
        if parts and parts[0][0] not in "#%":
            raw.append((int(parts[0]), int(parts[1])))
    u, v = np.array(raw).T
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    keep = lo != hi
    labels, flat = np.unique(np.concatenate([lo[keep], hi[keep]]),
                             return_inverse=True)
    m = int(keep.sum())
    pairs = np.unique(flat[:m] * labels.size + flat[m:])
    n = r_alloc.divisible_n(labels.size, 4, 2)
    g = r_gm.Graph.from_edges(pairs // labels.size, pairs % labels.size, n)
    return g, r_alloc.er_allocation(n, 4, 2)


def _cases():
    dn = r_alloc.divisible_n
    cases = []
    for seed in range(3):
        n = dn(40 + 10 * seed, 4, 2)
        cases.append((f"er{seed}", r_gm.erdos_renyi(n, 0.15 + 0.1 * seed,
                                                    seed=seed),
                      r_alloc.er_allocation(n, 4, 2)))
    n = dn(50, 5, 3)
    cases.append(("er-interleave", r_gm.erdos_renyi(n, 0.2, seed=3),
                  r_alloc.er_allocation(n, 5, 3, interleave=True)))
    cases.append(("random-alloc", r_gm.erdos_renyi(dn(40, 4, 2), 0.2, seed=4),
                  r_alloc.random_allocation(dn(40, 4, 2), 4, 2, seed=4)))
    cases.append(("pl", r_gm.power_law(dn(48, 4, 2), 2.5, seed=5),
                  r_alloc.er_allocation(dn(48, 4, 2), 4, 2)))
    cases.append(("rb-spill", r_gm.random_bipartite(48, 24, 0.3, seed=5),
                  r_alloc.bipartite_allocation(48, 24, 6, 3)))
    cases.append(("sbm", r_gm.stochastic_block(48, 24, 0.25, 0.1, seed=5),
                  r_alloc.bipartite_allocation(48, 24, 6, 2)))
    cases.append(("r1", r_gm.erdos_renyi(dn(40, 4, 1), 0.25, seed=6),
                  r_alloc.er_allocation(dn(40, 4, 1), 4, 1)))
    cases.append(("karate", *_karate()))
    return cases


_CASES = _cases()


def _port(g, alloc):
    csr = g.csr
    tg = convert.graph(csr.indptr, csr.indices, csr.rows, g.edge_weights())
    return tg, convert.allocation(_fields(alloc))


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_plan_and_partition_bitwise(case):
    _, g, alloc = case
    tg, ta = _port(g, alloc)
    rp, tp = r_compile(g.csr, alloc), t_compile(tg.csr, ta)
    _assert_fields_equal(rp, tp)
    _assert_fields_equal(rp, convert.shuffle_plan(_fields(rp)))
    assert (rp.coded_bits, rp.leftover_bits, rp.uncoded_bits) == \
        (tp.coded_bits, tp.leftover_bits, tp.uncoded_bits)
    _assert_fields_equal(rp.edge_tables(g.csr, alloc),
                         tp.edge_tables(tg.csr, ta))
    _assert_fields_equal(r_partition(rp, g.csr, alloc),
                         t_partition(tp, tg.csr, ta))


def test_missing_set_only_plan_bitwise():
    _, g, alloc = _CASES[0]
    tg, ta = _port(g, alloc)
    _assert_fields_equal(r_compile(g.csr, alloc, schedule=False),
                         t_compile(tg.csr, ta, schedule=False))


def test_matrix_really_spills():
    _, g, alloc = next(c for c in _CASES if c[0] == "rb-spill")
    tg, ta = _port(g, alloc)
    assert t_compile(tg.csr, ta).left_k.size > 0
