"""The port's chunked SSD against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
`ssd_chunk` (K6's wrapper, which runs its plain version for CPU tensors) is
held against `ssd_chunk_pallas` in interpret mode within rtol 1e-5 and
atol 1e-5 * max|ref| (float32, another summation order), also with bf16
x / b / c and with b / c shared by h groups, against the Pallas kernel on
the same values materialised in float32; `ops.ssd` against the reference's
`ops.ssd` and its sequential oracle at the reference's own 5e-4 on the
`tests/test_kernels.py` shapes, also with B / C shared by h groups; the state scan's sequential
walk (K7's plain version) against the reference's associative scan within
rtol 1e-5 and atol 1e-6 * max|ref| (the two orders round differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan import ref as jref
from repro.kernels.ssd_scan.ssd_scan import ssd_chunk_pallas
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan as k

SHAPES = [(1, 64, 8, 4, 16), (2, 128, 16, 8, 32), (3, 128, 32, 16, 64),
          (2, 256, 8, 8, 128), (1, 32, 64, 32, 32)]    # G, L, P, N, chunk


def _ssd_inputs(rng, G, L, P, N):
    return (rng.standard_normal((G, L, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, (G, L)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, G)).astype(np.float32),
            rng.standard_normal((G, L, N)).astype(np.float32),
            rng.standard_normal((G, L, N)).astype(np.float32),
            rng.standard_normal(G).astype(np.float32))


def _chunk_inputs(rng, G, Ch, Q, P, N):
    x = rng.standard_normal((G, Ch, Q, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (G, Ch, Q)).astype(np.float32)
    dta = dt * (-rng.uniform(0.5, 2.0, (G, 1, 1))).astype(np.float32)
    b = rng.standard_normal((G, Ch, Q, N)).astype(np.float32)
    c = rng.standard_normal((G, Ch, Q, N)).astype(np.float32)
    return x, dt, dta, b, c


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * scale)


@pytest.mark.parametrize("G,Ch,Q,P,N", [
    (1, 2, 8, 4, 4), (2, 2, 16, 8, 8), (2, 3, 32, 16, 16), (1, 2, 64, 64, 128),
    (1, 1, 128, 128, 4), (2, 1, 128, 8, 8), (1, 2, 32, 64, 32), (1, 1, 64, 4, 128),
])
def test_ssd_chunk_matches_pallas_interpret(G, Ch, Q, P, N):
    args = _chunk_inputs(np.random.default_rng(Q * P + N), G, Ch, Q, P, N)
    want = ssd_chunk_pallas(*map(jnp.asarray, args), interpret=True)
    got = k.ssd_chunk(*_t(*args))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        _close(g, w, rtol=1e-5, atol_rel=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 2, 4])
@pytest.mark.parametrize("G,Ch,Q,P,N", [(4, 2, 16, 8, 4), (4, 3, 64, 64, 128),
                                        (8, 1, 32, 16, 16)])
def test_ssd_chunk_bf16_and_shared_bc_match_pallas_interpret(G, Ch, Q, P, N, h,
                                                              dtype):
    """K6's contract on the serve path's inputs: x, b and c in bf16 (read as
    float32) and b / c of [G // h, ...] rows, group g reading row g // h.
    The Pallas kernel gets the same values in float32, materialised."""
    x, dt, dta, b, c = _chunk_inputs(np.random.default_rng(G * Q + h), G, Ch,
                                     Q, P, N)
    b, c = b[::h].copy(), c[::h].copy()
    xt, bt, ct = (torch.from_numpy(a).to(dtype) for a in (x, b, c))
    x32, b32, c32 = (t.float().numpy() for t in (xt, bt, ct))
    want = ssd_chunk_pallas(*map(jnp.asarray, (
        x32, dt, dta, np.repeat(b32, h, axis=0), np.repeat(c32, h, axis=0))),
        interpret=True)
    got = k.ssd_chunk(xt, *_t(dt, dta), bt, ct)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        _close(g, w, rtol=1e-5, atol_rel=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_past_one_block_matches_pallas_interpret(dtype):
    """Chunk 256 with Mamba2's P = 64 and N = 128, the reference's working
    set: staged in parts on the card in float32; the wrapper takes it on
    every device and its result agrees with `ssd_chunk_pallas`."""
    x, dt, dta, b, c = _chunk_inputs(np.random.default_rng(256), 2, 1, 256,
                                     64, 128)
    xt, bt, ct = (torch.from_numpy(a).to(dtype) for a in (x, b, c))
    want = ssd_chunk_pallas(*map(jnp.asarray, (
        xt.float().numpy(), dt, dta, bt.float().numpy(), ct.float().numpy())),
        interpret=True)
    got = k.ssd_chunk(xt, *_t(dt, dta), bt, ct)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        _close(g, w, rtol=1e-5, atol_rel=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_at_chunk_256_matches_reference(dtype):
    """`ops.ssd` at chunk 256, P = 64, N = 128 against the reference's
    `ops.ssd` on the same values, at its 5e-4."""
    x, dt, A, B, C, D = _ssd_inputs(np.random.default_rng(12), 2, 512, 64, 128)
    xt, Bt, Ct = (torch.from_numpy(a).to(dtype) for a in (x, B, C))
    y, hT = ops.ssd(xt, *_t(dt, A), Bt, Ct, *_t(D), chunk=256)
    y_jk, h_jk = jops.ssd(*map(jnp.asarray, (
        xt.float().numpy(), dt, A, Bt.float().numpy(), Ct.float().numpy(), D)),
        chunk=256)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jk), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_jk), rtol=5e-4,
                               atol=5e-4)


def test_ssd_chunk_masks_the_upper_triangle():
    """A token's y_intra reads no later token: changing x at t = 5 leaves
    y_intra[:5] bitwise unchanged."""
    x, dt, dta, b, c = _chunk_inputs(np.random.default_rng(3), 1, 1, 16, 8, 8)
    y0 = k.ssd_chunk(*_t(x, dt, dta, b, c))[0]
    x2 = x.copy()
    x2[:, :, 5] += 100.0
    y1 = k.ssd_chunk(*_t(x2, dt, dta, b, c))[0]
    assert torch.equal(y0[:, :, :5], y1[:, :, :5])
    assert not torch.equal(y0[:, :, 5:], y1[:, :, 5:])


@pytest.mark.parametrize("G,L,P,N,chunk", SHAPES)
def test_ssd_matches_reference_and_sequential_oracle(G, L, P, N, chunk):
    args = _ssd_inputs(np.random.default_rng(L + P), G, L, P, N)
    y, h = ops.ssd(*_t(*args), chunk=chunk)
    y_ref, h_ref = jref.ssd_scan_batched(*map(jnp.asarray, args))
    y_jk, h_jk = jops.ssd(*map(jnp.asarray, args), chunk=chunk)
    for got, want in ((y, y_ref), (h, h_ref), (y, y_jk), (h, h_jk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("h", [2, 4])
@pytest.mark.parametrize("G,L,P,N,chunk", [(4, 64, 8, 4, 16), (4, 128, 16, 8, 32),
                                           (8, 128, 32, 16, 64)])
def test_ssd_with_shared_bc_matches_reference(G, L, P, N, chunk, h):
    """`ops.ssd` with B / C of [G // h, L, N] against the reference's
    `ops.ssd` on them materialised per group, at its 5e-4, for the chunked
    form and the oracle (`use_kernel=False`)."""
    x, dt, A, B, C, D = _ssd_inputs(np.random.default_rng(L + h), G, L, P, N)
    B, C = B[::h].copy(), C[::h].copy()
    y_jk, h_jk = jops.ssd(*map(jnp.asarray, (x, dt, A, np.repeat(B, h, 0),
                                             np.repeat(C, h, 0), D)),
                          chunk=chunk)
    for use_kernel in (True, False):
        y, hT = ops.ssd(*_t(x, dt, A, B, C, D), chunk=chunk,
                        use_kernel=use_kernel)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_jk), rtol=5e-4,
                                   atol=5e-4)
        np.testing.assert_allclose(hT.numpy(), np.asarray(h_jk), rtol=5e-4,
                                   atol=5e-4)


@pytest.mark.parametrize("G,L,P,N,chunk", SHAPES)
def test_sequential_oracle_matches_reference_oracle(G, L, P, N, chunk):
    args = _ssd_inputs(np.random.default_rng(7 * L + N), G, L, P, N)
    h0 = np.random.default_rng(1).standard_normal((G, N, P)).astype(np.float32)
    y, h = ref.ssd_scan_batched(*_t(*args, h0))
    y_ref, h_ref = jref.ssd_scan_batched(*map(jnp.asarray, args + (h0,)))
    _close(y, y_ref, rtol=1e-5, atol_rel=1e-5)
    _close(h, h_ref, rtol=1e-5, atol_rel=1e-5)
    y1, h1 = ops.ssd(*_t(*args, h0), chunk=chunk, use_kernel=False)
    assert torch.equal(y1, y) and torch.equal(h1, h)


def test_ssd_single_head_oracle():
    x, dt, A, B, C, D = _ssd_inputs(np.random.default_rng(2), 1, 32, 8, 4)
    y, h = ref.ssd_scan(*_t(x[0], dt[0], A[0], B[0], C[0], D[0]))
    y_ref, h_ref = jref.ssd_scan(*map(jnp.asarray, (x[0], dt[0], A[0], B[0],
                                                     C[0], D[0])))
    _close(y, y_ref, rtol=1e-5, atol_rel=1e-5)
    _close(h, h_ref, rtol=1e-5, atol_rel=1e-5)


def test_ssd_chunk_invariance():
    args = _t(*_ssd_inputs(np.random.default_rng(4), 2, 128, 16, 8))
    y32, h32 = ops.ssd(*args, chunk=32)
    y64, h64 = ops.ssd(*args, chunk=64)
    np.testing.assert_allclose(y32, y64, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(h32, h64, rtol=5e-4, atol=5e-4)


def test_ssd_h0_continuation():
    """Scanning [first half] then [second half with h0] == one full scan,
    and both halves agree with the reference's."""
    args = _ssd_inputs(np.random.default_rng(5), 2, 128, 8, 4)
    x, dt, A, B, C, D = _t(*args)
    y_full, h_full = ops.ssd(x, dt, A, B, C, D, chunk=32)
    y1, h1 = ops.ssd(x[:, :64], dt[:, :64], A, B[:, :64], C[:, :64], D, chunk=32)
    y2, h2 = ops.ssd(x[:, 64:], dt[:, 64:], A, B[:, 64:], C[:, 64:], D, h0=h1,
                     chunk=32)
    np.testing.assert_allclose(torch.cat([y1, y2], 1), y_full, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(h2, h_full, rtol=5e-4, atol=5e-4)
    jx, jdt, jA, jB, jC, jD = map(jnp.asarray, args)
    _, jh1 = jops.ssd(jx[:, :64], jdt[:, :64], jA, jB[:, :64], jC[:, :64], jD,
                      chunk=32)
    jy2, jh2 = jops.ssd(jx[:, 64:], jdt[:, 64:], jA, jB[:, 64:], jC[:, 64:], jD,
                        h0=jh1, chunk=32)
    np.testing.assert_allclose(y2, np.asarray(jy2), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(h2, np.asarray(jh2), rtol=5e-4, atol=5e-4)


def test_ssd_decode_step_matches_reference_and_extends_scan():
    args = _ssd_inputs(np.random.default_rng(6), 2, 64, 8, 4)
    x, dt, A, B, C, D = _t(*args)
    _, h = ops.ssd(x[:, :32], dt[:, :32], A, B[:, :32], C[:, :32], D, chunk=32)
    step = (x[:, 32], dt[:, 32], A, B[:, 32], C[:, 32], D, h)
    y_step, h_step = ops.ssd_decode_step(*step)
    jy, jh = jops.ssd_decode_step(*(jnp.asarray(t.numpy()) for t in step))
    _close(y_step, jy, rtol=1e-6, atol_rel=1e-6)
    _close(h_step, jh, rtol=1e-6, atol_rel=1e-6)
    # One step past a 32-token scan is token 33 of the 33-token scan.
    seq_y, seq_h = ref.ssd_scan_batched(x[:, :33], dt[:, :33], A, B[:, :33],
                                        C[:, :33], D)
    np.testing.assert_allclose(y_step, seq_y[:, 32], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(h_step, seq_h, rtol=5e-4, atol=5e-4)


@jax.jit
def _jax_state_scan(G, S, h0):
    """The reference's cross-chunk stitch (`ops.py:40-48`, `52`)."""
    def combine(a, b):
        ga, sa = a
        gb, sb = b
        return ga * gb, gb[..., None, None] * sa + sb

    Gs, Ss = jax.lax.associative_scan(combine, (G, S), axis=1)
    h_in = jnp.concatenate([h0[:, None], Gs[:, :-1, None, None] * h0[:, None]
                            + Ss[:, :-1]], axis=1)
    return h_in, Gs[:, -1, None, None] * h0 + Ss[:, -1]


@pytest.mark.parametrize("G,Ch,N,P", [(1, 1, 4, 4), (2, 5, 8, 16),
                                      (3, 32, 16, 8), (1, 256, 4, 8)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_state_scan_matches_associative_scan(G, Ch, N, P, with_h0):
    rng = np.random.default_rng(Ch * N + P)
    Gd = np.exp(-rng.uniform(0.05, 2.0, (G, Ch))).astype(np.float32)
    S = rng.standard_normal((G, Ch, N, P)).astype(np.float32)
    h0 = (rng.standard_normal((G, N, P)).astype(np.float32) if with_h0
          else np.zeros((G, N, P), np.float32))
    h_in, h_fin = k.ssd_state_scan(*_t(Gd, S), *(_t(h0) if with_h0 else [None]))
    w_in, w_fin = _jax_state_scan(*map(jnp.asarray, (Gd, S, h0)))
    _close(h_in, w_in, rtol=1e-5, atol_rel=1e-6)
    _close(h_fin, w_fin, rtol=1e-5, atol_rel=1e-6)


def test_chunk_rule_and_wrapper_checks():
    x, dt, A, B, C, D = _t(*_ssd_inputs(np.random.default_rng(8), 1, 48, 8, 4))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd(x, dt, A, B, C, D, chunk=32)
    ops.ssd(x, dt, A, B, C, D, chunk=32, use_kernel=False)   # the oracle takes any L
    with pytest.raises(TypeError):
        ops.ssd(x, dt, A, B, C, D, chunk=16, interpret=True)
    a = _t(*_chunk_inputs(np.random.default_rng(9), 2, 2, 8, 4, 4))
    with pytest.raises(TypeError, match="float32"):
        k.ssd_chunk(a[0].double(), *a[1:])
    with pytest.raises(TypeError, match="bfloat16"):
        k.ssd_chunk(*(t.half() if i in (0, 3, 4) else t for i, t in enumerate(a)))
    with pytest.raises(TypeError, match="all"):          # one dtype for x, b, c
        k.ssd_chunk(a[0].bfloat16(), *a[1:])
    with pytest.raises(TypeError, match="float32"):      # dt stays float32
        k.ssd_chunk(a[0], a[1].bfloat16(), *a[2:])
    with pytest.raises(ValueError, match="shape"):
        k.ssd_chunk(a[0], a[1][:, :1].contiguous(), *a[2:])
    with pytest.raises(ValueError, match="contiguous"):
        k.ssd_chunk(a[0].transpose(2, 3).contiguous().transpose(2, 3), *a[1:])
    three = torch.cat([a[3], a[3][:1]])                  # 3 rows for G = 2
    with pytest.raises(ValueError, match="divide"):
        k.ssd_chunk(*a[:3], three, torch.cat([a[4], a[4][:1]]))
    with pytest.raises(ValueError, match="shape"):       # b and c must agree
        k.ssd_chunk(*a[:3], a[3][:1].contiguous(), a[4])
    k.ssd_chunk(*a[:3], a[3][:1].contiguous(), a[4][:1].contiguous())
    # The new footprint: 48 B, [Q] x 3 float32, bf16 planes of x, b and c
    # (hi and lo for float32 inputs). 40.8 KiB at the serve shape in bf16.
    assert k.chunk_smem_bytes(64, 64, 128, torch.bfloat16) == 48 + 768 + 16 * 64 * 40
    assert k.chunk_smem_bytes(64, 64, 128, torch.bfloat16) == 41776
    assert k.chunk_smem_bytes(64, 64, 128, torch.float32) == 82736
    assert k.chunk_smem_bytes(128, 128, 128, torch.float32) == 198192
    assert k.chunk_smem_bytes(1, 4, 4, torch.bfloat16) == 48 + 16 + 16 * 3
    # A chunk past one block's shared memory is staged in parts of the
    # largest multiple of 16 tokens that fits; only a shape where not even
    # 16 tokens fit is refused, naming the limit.
    assert k.part_tokens(64, 64, 128, torch.bfloat16) == 64       # one shot
    assert k.part_tokens(256, 64, 128, torch.float32) == 176
    assert k.part_tokens(256, 256, 256, torch.float32) == 64
    assert k.part_tokens(256, 256, 256, torch.bfloat16) == 144
    assert k.chunk_smem_bytes(256, 64, 128, torch.float32, 176) <= k.MAX_SMEM
    for dtype in (torch.float32, torch.bfloat16):
        big = [t.to(dtype) if i in (0, 3, 4) else t for i, t in enumerate(
            _t(*_chunk_inputs(np.random.default_rng(9), 1, 1, 256, 256, 256)))]
        assert k.chunk_smem_bytes(256, 256, 256, dtype) > k.MAX_SMEM
        got = k.ssd_chunk(*big)
        for g, w in zip(got, ref.ssd_chunk(*big)):
            assert torch.equal(g, w)
        wide = [t.to(dtype) if i in (0, 3, 4) else t for i, t in enumerate(
            _t(*_chunk_inputs(np.random.default_rng(9), 1, 1, 32, 4096, 4096)))]
        assert k.part_tokens(32, 4096, 4096, dtype) == 0
        with pytest.raises(ValueError, match=f"shared memory.*<= {k.MAX_SMEM}"):
            k.ssd_chunk(*wide)
    G, S = torch.ones((2, 3)), torch.zeros((2, 3, 4, 5))
    with pytest.raises(ValueError, match="shape"):
        k.ssd_state_scan(G, S, torch.zeros((2, 5, 4)))
    with pytest.raises(TypeError):
        k.ssd_state_scan(G.double(), S)
