"""The port's attention primitives against the JAX package, on the CPU.

`rope`, `_softcap`, `_mask`, `attend`, `chunked_attend` and `geglu` of
`repro_torch.models.layers` get the same numpy-seeded inputs as the
reference's `repro.models.layers`: causal and bidirectional masks, window
8 and global, with and without the softcap and `kv_valid`, G < H and
G = H, a v head dim other than q's. Masks are equal. float32 results agree
within 1e-6 * max|ref| (the score and PV sums run in another order;
measured at most 4.5e-7 for attention, 1.2e-7 for geglu, 6e-8 for rope);
bf16 within 2^-7 * max|ref| (a bf16 rounding of an intermediate apart;
measured 2.4e-4 for attention, 4.7e-3 for geglu, rope equal).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

F32_TOL = 1e-6
BF16_TOL = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _rel(got, want) -> float:
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(a, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(dtype, theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, 17), (2, 12))
    jx, tx = _pair(x, dtype)
    got = tl.rope(tx, torch.from_numpy(np.ascontiguousarray(pos)), theta)
    want = jl.rope(jx, jnp.asarray(pos, jnp.int32), theta)
    assert got.dtype == tx.dtype
    assert _rel(got, want) <= DTYPES[dtype][2]


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap(cap):
    x = np.random.default_rng(1).standard_normal(1000).astype(np.float32) * 80
    got = tl._softcap(torch.from_numpy(x), cap)
    want = jl._softcap(jnp.asarray(x), cap)
    assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, -1, 1, 8])
def test_mask(causal, window):
    q = np.broadcast_to(np.arange(3, 19), (2, 16))
    k = np.broadcast_to(np.arange(20), (2, 20))
    got = tl._mask(torch.from_numpy(q.copy()), torch.from_numpy(k.copy()),
                   causal=causal, window=window)
    jw = None if window is None else jnp.int32(window)
    want = jl._mask(jnp.asarray(q), jnp.asarray(k), causal=causal, window=jw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _attn_inputs(seed, B, Sq, Sk, H, G, D, Dv=None, offset=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, G, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, G, Dv or D)).astype(np.float32)
    qpos = np.ascontiguousarray(np.broadcast_to(np.arange(offset, offset + Sq),
                                                (B, Sq)))
    kpos = np.ascontiguousarray(np.broadcast_to(np.arange(Sk), (B, Sk)))
    valid = np.ones((B, Sk), bool)
    valid[0, Sk - 3:] = False
    valid[1, :2] = False
    return q, k, v, qpos, kpos, valid


def _both(fn_j, fn_t, arrays, dtype, valid, kv_valid, **kw):
    q, k, v, qpos, kpos = arrays
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    jkv = jnp.asarray(valid) if kv_valid else None
    tkv = torch.from_numpy(valid) if kv_valid else None
    jwin = kw.pop("window")
    want = fn_j(jq, jk, jv, jnp.asarray(qpos), jnp.asarray(kpos),
                window=None if jwin is None else jnp.int32(jwin),
                kv_valid=jkv, **kw)
    got = fn_t(tq, tk, tv, torch.from_numpy(qpos), torch.from_numpy(kpos),
               window=jwin, kv_valid=tkv, **kw)
    return got, want


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("kv_valid", [False, True])
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_attend(causal, window, softcap, kv_valid, G, dtype):
    q, k, v, qpos, kpos, valid = _attn_inputs(3, 2, 16, 16, 4, G, 16)
    got, want = _both(jl.attend, tl.attend, (q, k, v, qpos, kpos), dtype,
                      valid, kv_valid, causal=causal, window=window,
                      softcap=softcap)
    assert got.shape == (2, 16, 4, 16) and got.dtype == DTYPES[dtype][1]
    assert _rel(got, want) <= DTYPES[dtype][2]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attend_v_head_dim_and_decode_shape(dtype):
    """Dv != D, one query at position 11 against 20 cached keys (the decode
    step's shapes), keys past it invalid."""
    q, k, v, qpos, kpos, _ = _attn_inputs(4, 3, 1, 20, 6, 2, 16, Dv=8,
                                          offset=11)
    valid = kpos <= 11
    got, want = _both(jl.attend, tl.attend, (q, k, v, qpos, kpos[:1]), dtype,
                      valid, True, causal=True, window=8, softcap=30.0)
    assert got.shape == (3, 1, 6, 8)
    assert _rel(got, want) <= DTYPES[dtype][2]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_attend(chunk, causal, window, softcap, G, dtype):
    """S = 32 in chunks of 8 (the chunked path) and of 32 (one `attend`)."""
    q, k, v, qpos, kpos, valid = _attn_inputs(5, 2, 32, 32, 4, G, 16)
    for kv_valid in (False, True):
        got, want = _both(
            lambda *a, **kw: jl.chunked_attend(*a, chunk=chunk, **kw),
            lambda *a, **kw: tl.chunked_attend(*a, chunk=chunk, **kw),
            (q, k, v, qpos, kpos), dtype, valid, kv_valid, causal=causal,
            window=window, softcap=softcap)
        assert got.shape == (2, 32, 4, 16)
        assert _rel(got, want) <= DTYPES[dtype][2]


def test_chunked_attend_is_attend_chunk_by_chunk():
    """The chunked form computes each query row as one `attend` does (the
    same ops on the same rows; the BLAS path may block the rows otherwise,
    so within the float32 gate); S must be a multiple of the chunk."""
    q, k, v, qpos, kpos, _ = _attn_inputs(6, 2, 32, 32, 4, 2, 16)
    args = [torch.from_numpy(a) for a in (q, k, v, qpos, kpos)]
    whole = tl.attend(*args, causal=True, window=8, softcap=50.0)
    chunked = tl.chunked_attend(*args, chunk=8, causal=True, window=8,
                                softcap=50.0)
    assert _rel(chunked, whole.numpy()) <= F32_TOL
    with pytest.raises(AssertionError):
        tl.chunked_attend(*[a[:, :12] if i in (0, 3) else a
                            for i, a in enumerate(args)], chunk=8)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_geglu(act, dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    wg = (rng.standard_normal((32, 64)) / 6).astype(np.float32)
    wu = (rng.standard_normal((32, 64)) / 6).astype(np.float32)
    wd = (rng.standard_normal((64, 32)) / 8).astype(np.float32)
    pairs = [_pair(a, dtype) for a in (x, wg, wu, wd)]
    want = jl.geglu(*[p[0] for p in pairs], act=act)
    got = tl.geglu(*[p[1] for p in pairs], act=act)
    assert got.dtype == DTYPES[dtype][1]
    assert _rel(got, want) <= DTYPES[dtype][2]


def test_gelu_is_the_tanh_form():
    """`jax.nn.gelu` defaults to the tanh approximation; the erf form is
    about 1e-3 away from it, far past the float32 gate."""
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    w = np.eye(1, dtype=np.float32)
    ones = np.ones((1, 1), np.float32)
    got = tl.geglu(torch.from_numpy(x)[None, :, None], *(
        torch.from_numpy(a) for a in (ones, ones, w)), act="gelu")
    want = jl.geglu(jnp.asarray(x)[None, :, None], *(
        jnp.asarray(a) for a in (ones, ones, w)), act="gelu")
    assert _rel(got, want) <= F32_TOL
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert _rel(erf[None, :, None], want) > 1e-4
