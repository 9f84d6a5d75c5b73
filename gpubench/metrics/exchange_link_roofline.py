"""exchange_link_roofline: the coded Shuffle's all-gather between the cards
as a share of the links' bound: the bytes rank 0 receives in it
(`wire_bytes`) over the card's NVLink rate in one direction
(`nvlink_bytes_per_s` of `harness/peaks.json`), against the device time
of rank 0's NCCL all-gather kernels that carried it in the traced
stretch.

Each iteration of the group route issues its all-gathers in one order,
the Shuffle's first, so the Shuffle's are every g-th of rank 0's
all-gather records, g being their count over the iterations. None
without a trace, where the program counts no wire bits, or where the
records do not divide evenly among the iterations."""
from harness import manifest

KERNEL = "AllGather"


def wire_bytes(bench):
    """Bytes rank 0 receives in one Shuffle's all-gather, from the port's
    counters (`metrics/wire_load.py`'s `wire_bits_per_round`), or None."""
    bits = manifest.load(bench, "metrics", "wire_load").wire_bits_per_round()
    return None if bits is None else bits / 8


def read(ctx):
    tr, fig, iters = ctx["trace"], ctx["figures"], ctx["iterations"]
    per_round = wire_bytes(ctx["cell"].bench)
    if tr is None or fig is None or not iters or per_round is None:
        return None
    records = sorted((s, e) for name, s, e in tr.device if KERNEL in name)
    if not records or len(records) % iters:
        return None
    shuffle = records[::len(records) // iters]
    device_s = sum(e - s for s, e in shuffle) / 1e6
    if device_s <= 0.0:
        return None
    bound_s = per_round * len(shuffle) / fig["nvlink_bytes_per_s"]
    return 100.0 * bound_s / device_s
