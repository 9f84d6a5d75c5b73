"""Port XOR encode/decode ops vs the reference's Pallas kernel and ops.

On the CPU the port's wrappers run their plain PyTorch versions; each is
held *bitwise* against the reference: `xor_encode` against
`xor_encode_pallas` in interpret mode (as `tests/test_kernels.py` runs it),
and `xor_encode_columns` / `xor_strip_columns` / `xor_encode_slots`
against `repro.kernels.xor_code.ops` with `use_kernel=True`. Words cross
as uint32 numpy arrays viewed as int32 tensors.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from repro.kernels.xor_code import ops as r_ops
from repro.kernels.xor_code.xor_code import xor_encode_pallas
from repro_torch.core.bitcodec import np_words_to_t, t_words_to_np
from repro_torch.kernels.xor_code import ops as t_ops
from repro_torch.kernels.xor_code import xor_code as t_xc

RNG = np.random.default_rng(123)


def _words(shape) -> np.ndarray:
    return RNG.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("r,c,w", [(1, 10, 1), (2, 256, 1), (3, 511, 2),
                                   (4, 1000, 4), (8, 37, 8)])
def test_xor_encode_matches_pallas_interpret(r, c, w):
    import torch

    rows = _words((r, c, w))
    valid = RNG.random((r, c)) < 0.6
    want = np.asarray(xor_encode_pallas(jnp.array(rows), jnp.array(valid),
                                        interpret=True))
    got = t_ops.xor_encode(np_words_to_t(rows), torch.from_numpy(valid))
    np.testing.assert_array_equal(t_words_to_np(got), want)


@pytest.mark.parametrize("r", [2, 3, 5])
def test_xor_roundtrip_recovers_missing_row(r):
    import torch

    c, w = 300, 2
    rows = _words((r, c, w))
    valid = np.ones((r, c), dtype=bool)
    valid[:, 250:] = RNG.random((r, 50)) < 0.5
    coded = t_ops.xor_encode(np_words_to_t(rows), torch.from_numpy(valid))
    dec = t_ops.xor_decode(coded, np_words_to_t(rows[1:]),
                           torch.from_numpy(valid[1:]))
    np.testing.assert_array_equal(t_words_to_np(dec),
                                  np.where(valid[0][:, None], rows[0], 0))


@pytest.mark.parametrize("shape", [(0, 3), (1, 1), (130, 1), (257, 3),
                                   (64, 3, 4), (19, 2, 3)])
def test_encode_and_strip_columns_match_reference_ops(shape):
    slot = _words(shape)
    slot[RNG.random(shape[:2]) < 0.3] = 0               # empty slots
    want = np.asarray(r_ops.xor_encode_columns(slot, use_kernel=True))
    got = t_ops.xor_encode_columns(np_words_to_t(slot))
    np.testing.assert_array_equal(t_words_to_np(got), want)
    if shape[0]:
        # The reference's xor_strip_columns takes [C, r] only (its [C, r, B]
        # docstring notwithstanding), so a payload case is compared per b.
        if slot.ndim == 3:
            want_s = np.stack([np.asarray(r_ops.xor_strip_columns(
                slot[:, :, b], use_kernel=True)) for b in range(shape[2])], 2)
        else:
            want_s = np.asarray(r_ops.xor_strip_columns(slot, use_kernel=True))
        got_s = t_ops.xor_strip_columns(np_words_to_t(slot))
        np.testing.assert_array_equal(t_words_to_np(got_s), want_s)


@pytest.mark.parametrize("r,B", [(1, 1), (2, 1), (3, 4), (4, 2)])
def test_encode_slots_matches_reference_ops(r, B):
    L, W = 50, 40
    loc = _words((L + 1, B) if B > 1 else (L + 1,))
    loc[L] = 0                                           # sentinel word
    idx = RNG.integers(0, L + 1, size=(W, r)).astype(np.int32)
    shift = RNG.integers(0, 32, size=(W, r)).astype(np.uint32)
    mask = _words((W, r))
    want = np.asarray(r_ops.xor_encode_slots(
        jnp.asarray(loc), jnp.asarray(idx), jnp.asarray(shift),
        jnp.asarray(mask), use_kernel=True))
    got = t_ops.xor_encode_slots(np_words_to_t(loc), np_words_to_t(idx),
                                 np_words_to_t(shift), np_words_to_t(mask))
    np.testing.assert_array_equal(t_words_to_np(got), want)


def _loop_exchange(src, loc_e, t, swap):
    """Scalar-loop statement of what K1 and K2 compute (the kernels' own
    per-thread loops), in uint32 NumPy."""
    src = src.reshape(src.shape[0], -1)
    nnz, B = src.shape
    K, W, r = t["enc_l"].shape
    Lmax = loc_e.shape[1]

    def word(k, l, b):
        if l >= Lmax or loc_e[k, l] >= nnz:
            return np.uint32(0)
        v = src[loc_e[k, l], b]
        return v.byteswap() if swap else v

    buf = np.zeros((K, W + 1, B), np.uint32)
    for k, w, b in np.ndindex(K, W, B):
        for i in range(r):
            buf[k, w, b] ^= ((word(k, t["enc_l"][k, w, i], b)
                              << t["enc_shift"][k, w, i]) & t["enc_mask"][k, w, i])
    ptr = t["ptr"]
    out = np.zeros((ptr[-1], B), np.uint32)
    Dmax = t["dec_s"].shape[1]
    for k, d, b in np.ndindex(K, Dmax, B):
        if d >= ptr[k + 1] - ptr[k]:
            continue
        acc = np.uint32(0)
        for i in range(r):
            got = buf[t["dec_s"][k, d, i], t["dec_w"][k, d, i], b]
            strip = np.uint32(0)
            for u in range(r - 1):
                strip ^= ((word(k, t["strip_l"][k, d, i, u], b)
                           << t["strip_shift"][k, d, i, u])
                          & t["strip_mask"][k, d, i, u])
            acc |= ((got ^ strip) & t["dec_mask"][k, d, i]) >> t["dec_shift"][k, d, i]
        out[ptr[k] + d, b] = acc
    return buf, out


def _random_tables(r, B):
    """Random K1/K2 tables in the ranges the kernels accept (sentinels
    included): (src words, loc_e, {table name: array})."""
    K, W, Lmax, nnz, Dmax = 3, 9, 7, 20, 6
    src = _words((nnz, B) if B > 1 else (nnz,))
    loc_e = RNG.integers(0, nnz + 1, size=(K, Lmax)).astype(np.int32)
    t = dict(
        enc_l=RNG.integers(0, Lmax + 1, size=(K, W, r)),
        enc_shift=RNG.integers(0, 32, size=(K, W, r)).astype(np.uint32),
        enc_mask=_words((K, W, r)),
        dec_s=RNG.integers(0, K, size=(K, Dmax, r)),
        dec_w=RNG.integers(0, W + 1, size=(K, Dmax, r)),
        dec_mask=_words((K, Dmax, r)),
        dec_shift=RNG.integers(0, 32, size=(K, Dmax, r)).astype(np.uint32),
        strip_l=RNG.integers(0, Lmax + 1, size=(K, Dmax, r, r - 1)),
        strip_shift=RNG.integers(0, 32, size=(K, Dmax, r, r - 1)).astype(np.uint32),
        strip_mask=_words((K, Dmax, r, r - 1)),
        ptr=np.concatenate([[0], np.cumsum(RNG.integers(0, Dmax + 1, K))]))
    return src, loc_e, t


@pytest.mark.parametrize("r,B,swap", [(1, 1, True), (2, 1, True),
                                      (3, 2, False), (4, 3, True)])
def test_gather_encode_decode_plain_versions(r, B, swap):
    """The plain versions of K1/K2 (what the card kernels are held to) agree
    with a scalar loop over random tables, sentinels included."""
    import torch

    src, loc_e, t = _random_tables(r, B)
    want_buf, want = _loop_exchange(src, loc_e, t, swap)
    tt = {k: np_words_to_t(v.astype(np.uint32)) for k, v in t.items()}
    s, le = np_words_to_t(src), torch.from_numpy(loc_e)
    buf = t_xc.xor_encode_gather(s, le, tt["enc_l"], tt["enc_shift"],
                                 tt["enc_mask"], swap=swap)
    out = t_xc.xor_decode_gather(
        s, le, buf, tt["dec_s"], tt["dec_w"], tt["dec_mask"], tt["dec_shift"],
        tt["strip_l"], tt["strip_shift"], tt["strip_mask"], tt["ptr"],
        swap=swap)
    np.testing.assert_array_equal(t_words_to_np(buf).reshape(want_buf.shape),
                                  want_buf)
    np.testing.assert_array_equal(t_words_to_np(out).reshape(want.shape), want)


_ENC_TABLES = ("enc_l", "enc_shift", "enc_mask")
_DEC_TABLES = ("dec_s", "dec_w", "dec_mask", "dec_shift", "strip_l",
               "strip_shift", "strip_mask", "ptr")


@pytest.mark.parametrize("moved", ("src", "loc_e") + _ENC_TABLES + _DEC_TABLES)
def test_gather_wrappers_reject_a_device_mix(moved):
    """Every tensor argument of K1/K2's wrappers takes part in the device
    check: one argument on another device raises before any launch (on the
    card a stray host pointer would fault inside the kernel instead)."""
    import torch

    src, loc_e, t = _random_tables(3, 2)
    args = {k: np_words_to_t(v.astype(np.uint32)) for k, v in t.items()}
    args["src"], args["loc_e"] = np_words_to_t(src), torch.from_numpy(loc_e)
    buf = t_xc.xor_encode_gather(*(args[k] for k in ("src", "loc_e")
                                   + _ENC_TABLES))
    args[moved] = args[moved].to("meta")
    if moved in ("src", "loc_e") + _ENC_TABLES:
        with pytest.raises(ValueError, match="share one device"):
            t_xc.xor_encode_gather(*(args[k] for k in ("src", "loc_e")
                                     + _ENC_TABLES))
    if moved not in _ENC_TABLES:
        with pytest.raises(ValueError, match="share one device"):
            t_xc.xor_decode_gather(args["src"], args["loc_e"], buf,
                                   *(args[k] for k in _DEC_TABLES))
