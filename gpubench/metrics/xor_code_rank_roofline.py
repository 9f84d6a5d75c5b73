"""xor_code_rank_roofline: the coded Shuffle's kernels, K1 (encode) and K2
(decode) of `repro_torch/kernels/xor_code`, on rank 0 of a cell whose
ranks each encode their own servers' buffers and decode their own
servers' deliveries, as a share of their bound: the bytes of the rank's
share (`rank_counts`; `harness.roofline.shuffle_bytes` of it) over the
card's HBM rate, against K1's and K2's summed device time in rank 0's
traced stretch. Summed over the ranks, the shares' bytes are the whole
Shuffle's. None without a trace or where the program sets no such
gauges."""
from harness import manifest, roofline

GAUGES = ("shuffle_rank_deliveries", "shuffle_rank_coded_deliveries",
          "shuffle_rank_coded_bits")


def rank_counts(counts: dict) -> dict | None:
    """`counts` with M, P, L and coded_bits replaced by this process's
    rank's share, read from the port's gauges: the M_p deliveries its
    servers receive, the P_p of them coded, L_p = M_p - P_p, and the coded
    bits its servers send; None where the registry holds none of them."""
    from repro_torch.obs import get_registry

    reg = get_registry()
    got = [reg.get(name) for name in GAUGES]
    if any(g is None for g in got):
        return None
    M, P, bits = (int(g.value) for g in got)
    return dict(counts, M=M, P=P, L=M - P, coded_bits=bits)


def read(ctx):
    tr, fig = ctx["trace"], ctx["figures"]
    if tr is None or fig is None or not ctx["iterations"]:
        return None
    c = rank_counts(ctx["counts"])
    if c is None:
        return None
    kernels = manifest.load(ctx["cell"].bench, "metrics",
                            "xor_code_roofline").KERNELS
    return roofline.roofline_pct(roofline.shuffle_bytes(c), ctx["iterations"],
                                 sum(tr.kernel_s(k) for k in kernels), fig)
