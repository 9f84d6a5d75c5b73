"""segment_reduce_rank_roofline: the Reduce's kernel, K3 of
`repro_torch/kernels/segment_reduce`, on rank 0 of a cell whose ranks
each Reduce only their own rows, as a share of its bound: the bytes those
rows need (`harness.roofline.reduce_bytes` of the rank's rows and CSR
entries, read from the port's `reduce_rows` / `reduce_entries` gauges in
rank 0's process) over the card's HBM rate, against K3's summed device
time in rank 0's traced stretch. None without a trace or where the
program sets no such gauges."""
from harness import roofline

KERNEL = "csr_stream_kernel"


def rank_counts(counts: dict) -> dict | None:
    """`counts` with n and nnz replaced by the rows and entries this
    process's K3 reduces, or None where the registry holds neither."""
    from repro_torch.obs import get_registry

    reg = get_registry()
    rows, entries = reg.get("reduce_rows"), reg.get("reduce_entries")
    if rows is None or entries is None:
        return None
    return dict(counts, n=int(rows.value), nnz=int(entries.value))


def read(ctx):
    tr, fig = ctx["trace"], ctx["figures"]
    if tr is None or fig is None or not ctx["iterations"]:
        return None
    c = rank_counts(ctx["counts"])
    if c is None:
        return None
    return roofline.roofline_pct(roofline.reduce_bytes(c), ctx["iterations"],
                                 tr.kernel_s(KERNEL), fig)
