"""xor_code_roofline: the coded Shuffle's kernels, K1 (encode) and K2
(decode) of `repro_torch/kernels/xor_code`, as a share of their bound: the
bytes the algorithm moves (`harness.roofline.shuffle_bytes`) over the
card's HBM rate, against their summed device time in the traced
stretch."""
from harness import roofline

KERNELS = ("xor_encode_packed_kernel", "xor_decode_packed_kernel")


def read(ctx):
    tr, fig = ctx["trace"], ctx["figures"]
    if tr is None or fig is None or not ctx["iterations"]:
        return None
    return roofline.roofline_pct(roofline.shuffle_bytes(ctx["counts"]),
                                 ctx["iterations"],
                                 sum(tr.kernel_s(k) for k in KERNELS), fig)
