"""segment_reduce_roofline: the Reduce's kernel, K3 of
`repro_torch/kernels/segment_reduce`, as a share of its bound: the bytes
the row sums need (`harness.roofline.reduce_bytes`) over the card's HBM
rate, against its summed device time in the traced stretch."""
from harness import roofline

KERNEL = "csr_stream_kernel"


def read(ctx):
    tr, fig = ctx["trace"], ctx["figures"]
    if tr is None or fig is None or not ctx["iterations"]:
        return None
    return roofline.roofline_pct(roofline.reduce_bytes(ctx["counts"]),
                                 ctx["iterations"], tr.kernel_s(KERNEL), fig)
