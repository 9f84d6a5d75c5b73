"""Port XOR encode/decode ops vs the reference's Pallas kernel and ops.

On the CPU the port's wrappers run their plain PyTorch versions; each is
held *bitwise* against the reference: `xor_encode` against
`xor_encode_pallas` in interpret mode (as `tests/test_kernels.py` runs it),
and `xor_encode_columns` / `xor_strip_columns` / `xor_encode_slots`
against `repro.kernels.xor_code.ops` with `use_kernel=True`. The plain
versions of K1's general form and of the packed K1/K2 the coded Shuffle
runs are held against scalar loops over random tables. Words cross as
uint32 numpy arrays viewed as int32 tensors.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.xor_code import ops as r_ops
from repro.kernels.xor_code.xor_code import xor_encode_pallas
from repro_torch.core.bitcodec import np_words_to_t, t_words_to_np
from repro_torch.core.fused_shuffle import code_book
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


def _word(src, loc_e, k, l, b, swap):
    """Codec word at local index l of server k (zero for the sentinels)."""
    if l >= loc_e.shape[1] or loc_e[k, l] >= src.shape[0]:
        return np.uint32(0)
    v = src[loc_e[k, l], b]
    return v.byteswap() if swap else v


def _loop_encode(src, loc_e, t, swap):
    """Scalar-loop statement of K1 over general tables, in uint32 NumPy."""
    src = src.reshape(src.shape[0], -1)
    K, W, r = t["enc_l"].shape
    buf = np.zeros((K, W + 1, src.shape[1]), np.uint32)
    for k, w, b in np.ndindex(K, W, src.shape[1]):
        for i in range(r):
            buf[k, w, b] ^= ((_word(src, loc_e, k, t["enc_l"][k, w, i], b, swap)
                              << t["enc_shift"][k, w, i]) & t["enc_mask"][k, w, i])
    return buf


def _loop_decode(src, loc_e, buf, t, swap):
    """Scalar-loop statement of K2 over general tables: each segment is the
    sender's coded word, stripped of the other slots, masked and shifted
    back."""
    src = src.reshape(src.shape[0], -1)
    K, Dmax, r = t["dec_s"].shape
    B = src.shape[1]
    ptr = t["ptr"]
    out = np.zeros((ptr[-1], B), np.uint32)
    for k, d, b in np.ndindex(K, Dmax, B):
        if d >= ptr[k + 1] - ptr[k]:
            continue
        acc = np.uint32(0)
        for i in range(r):
            got = buf[t["dec_s"][k, d, i], t["dec_w"][k, d, i], b]
            strip = np.uint32(0)
            for u in range(r - 1):
                strip ^= ((_word(src, loc_e, k, t["strip_l"][k, d, i, u], b, swap)
                           << t["strip_shift"][k, d, i, u])
                          & t["strip_mask"][k, d, i, u])
            acc |= ((got ^ strip) & t["dec_mask"][k, d, i]) >> t["dec_shift"][k, d, i]
        out[ptr[k] + d, b] = acc
    return out


def _random_tables(r, B):
    """Random general K1 tables in the ranges the kernel accepts (sentinels
    included): (src words, loc_e, {table name: array})."""
    K, W, Lmax, nnz = 3, 9, 7, 20
    src = _words((nnz, B) if B > 1 else (nnz,))
    loc_e = RNG.integers(0, nnz + 1, size=(K, Lmax)).astype(np.int32)
    t = dict(
        enc_l=RNG.integers(0, Lmax + 1, size=(K, W, r)),
        enc_shift=RNG.integers(0, 32, size=(K, W, r)).astype(np.uint32),
        enc_mask=_words((K, W, r)))
    return src, loc_e, t


def _random_packed(r, B):
    """Random packed K1/K2 tables: entries with the zero sentinel nnz (and
    past it), codes over the whole book (segments, full word, empty) and
    past it, positions over every buffer column with the zero column W.
    Returns (src words, {table name: array}, W)."""
    K, W, nnz, Dmax = 3, 9, 20, 6
    src = _words((nnz, B) if B > 1 else (nnz,))
    code = lambda shape: RNG.integers(0, r + 3, size=shape).astype(np.uint8)  # noqa: E731
    t = dict(
        enc_e=RNG.integers(0, nnz + 2, size=(K, W, r)).astype(np.int32),
        enc_code=code((K, W, r)),
        dec_pos=RNG.integers(0, K * (W + 1), size=(K, Dmax, r)).astype(np.int32),
        dec_code=code((K, Dmax, r)),
        strip_e=RNG.integers(0, nnz + 2, size=(K, Dmax, r, r - 1)).astype(np.int32),
        strip_code=code((K, Dmax, r, r - 1)),
        book=code_book(r),
        ptr=np.concatenate([[0], np.cumsum(RNG.integers(0, Dmax + 1, K))]
                           ).astype(np.int32))
    return src, t, W


def _unpack_random(src, t, W):
    """The general tables that packed tables `t` stand for: loc_e the
    identity, codes (past the book: its last, empty) looked up, positions
    split into (sender, column)."""
    K = t["enc_e"].shape[0]
    nnz = src.shape[0]
    book = t["book"]

    def pairs(code):
        c = np.minimum(code, book.shape[1] - 1)
        return book[0][c], book[1][c]

    g = dict(enc_l=t["enc_e"], dec_s=t["dec_pos"] // (W + 1),
             dec_w=t["dec_pos"] % (W + 1), strip_l=t["strip_e"], ptr=t["ptr"])
    g["enc_shift"], g["enc_mask"] = pairs(t["enc_code"])
    g["dec_shift"], g["dec_mask"] = pairs(t["dec_code"])
    g["strip_shift"], g["strip_mask"] = pairs(t["strip_code"])
    return np.tile(np.arange(nnz, dtype=np.int32), (K, 1)), g


def _to_t(a):
    return (torch.from_numpy(a) if a.dtype == np.uint8
            else np_words_to_t(a.astype(np.uint32)))


@pytest.mark.parametrize("r,B,swap", [(1, 1, True), (2, 1, True),
                                      (3, 2, False), (4, 3, True),
                                      (5, 2, True), (33, 1, True)])
def test_gather_encode_decode_plain_versions(r, B, swap):
    """The plain versions of K1's general form and of the packed K1/K2
    (what the card kernels are held to) agree with a scalar loop over
    random tables, sentinels included."""
    src, loc_e, t = _random_tables(r, B)
    tt = {k: _to_t(v) for k, v in t.items()}
    buf = t_xc.xor_encode_gather(np_words_to_t(src), torch.from_numpy(loc_e),
                                 tt["enc_l"], tt["enc_shift"], tt["enc_mask"],
                                 swap=swap)
    want_buf = _loop_encode(src, loc_e, t, swap)
    np.testing.assert_array_equal(t_words_to_np(buf).reshape(want_buf.shape),
                                  want_buf)

    src, p, W = _random_packed(r, B)
    loc_e, g = _unpack_random(src, p, W)
    want_buf = _loop_encode(src, loc_e, g, swap)
    want = _loop_decode(src, loc_e, want_buf, g, swap)
    pt, s = {k: _to_t(v) for k, v in p.items()}, np_words_to_t(src)
    buf = t_xc.xor_encode_packed(s, pt["enc_e"], pt["enc_code"], pt["book"],
                                 swap=swap)
    out = t_xc.xor_decode_packed(s, buf, pt["dec_pos"], pt["dec_code"],
                                 pt["strip_e"], pt["strip_code"], pt["book"],
                                 pt["ptr"], swap=swap)
    np.testing.assert_array_equal(t_words_to_np(buf).reshape(want_buf.shape),
                                  want_buf)
    np.testing.assert_array_equal(t_words_to_np(out).reshape(want.shape), want)


@pytest.mark.parametrize("r,B", [(1, 1), (2, 1), (3, 2), (33, 1)])
def test_gather_encode_whole_words_is_shift_0_full_mask(r, B):
    """K1's general form without shift and mask tables (the dense
    exchange's form) is the same form with shift 0 and the full mask; a
    single missing table is refused."""
    src, loc_e, t = _random_tables(r, B)
    s, loc, l = np_words_to_t(src), torch.from_numpy(loc_e), _to_t(t["enc_l"])
    got = t_xc.xor_encode_gather(s, loc, l, None, None, swap=False)
    want = t_xc.xor_encode_gather(s, loc, l, torch.zeros_like(l),
                                  torch.full_like(l, -1), swap=False)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="both"):
        t_xc.xor_encode_gather(s, loc, l, torch.zeros_like(l), None)


def test_packed_kernels_refuse_r_past_64_on_every_device():
    """The packed K1/K2 take 1 <= r <= 64 (a book of r + 2 <= 66 codes);
    the limit is checked before the device branch, so the CPU refuses
    r = 65 with the card's message (tests/test_torch_cuda.py)."""
    src, p, W = _random_packed(65, 1)
    pt, s = {k: _to_t(v) for k, v in p.items()}, np_words_to_t(src)
    msg = r"^r = 65: the packed kernels take 1 <= r <= 64$"
    with pytest.raises(ValueError, match=msg):
        t_xc.xor_encode_packed(s, pt["enc_e"], pt["enc_code"], pt["book"])
    buf = torch.zeros((3, W + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=msg):
        t_xc.xor_decode_packed(s, buf, pt["dec_pos"], pt["dec_code"],
                               pt["strip_e"], pt["strip_code"], pt["book"],
                               pt["ptr"])
    assert t_xc.MAX_R == 64


_GENERAL = ("src", "loc_e", "enc_l", "enc_shift", "enc_mask")
_ENCODE = ("src", "enc_e", "enc_code", "book")
_DECODE = ("src", "buf", "dec_pos", "dec_code", "strip_e", "strip_code",
           "book", "ptr")
_MIX = ([("general", a) for a in _GENERAL] + [("encode", a) for a in _ENCODE]
        + [("decode", a) for a in _DECODE])


@pytest.mark.parametrize("kernel,moved", _MIX,
                         ids=[a if k == "general" else f"packed_{k}-{a}"
                              for k, a in _MIX])
def test_gather_wrappers_reject_a_device_mix(kernel, moved):
    """Every tensor argument of K1's general form and of the packed K1/K2
    takes part in the device check: one argument on another device raises
    before any launch (on the card a stray host pointer would fault inside
    the kernel instead)."""
    if kernel == "general":
        src, loc_e, t = _random_tables(3, 2)
        args = {k: _to_t(v) for k, v in t.items()}
        args["src"], args["loc_e"] = np_words_to_t(src), torch.from_numpy(loc_e)
        fn, names = t_xc.xor_encode_gather, _GENERAL
    else:
        src, p, _ = _random_packed(3, 2)
        args = {k: _to_t(v) for k, v in p.items()}
        args["src"] = np_words_to_t(src)
        args["buf"] = t_xc.xor_encode_packed(*(args[k] for k in _ENCODE))
        fn, names = ((t_xc.xor_encode_packed, _ENCODE) if kernel == "encode"
                     else (t_xc.xor_decode_packed, _DECODE))
    fn(*(args[k] for k in names))                   # all on one device: runs
    args[moved] = args[moved].to("meta")
    with pytest.raises(ValueError, match="share one device"):
        fn(*(args[k] for k in names))
