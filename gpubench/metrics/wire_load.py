"""wire_load: the coded Shuffle's load measured on the links, beside
`shuffle_load`'s count of the plan: the bits the ranks of the group
receive in the all-gathers of the coded buffers, summed over the ranks,
per Shuffle and payload column, over n^2 x 32.

Read from the port's metrics registry in rank 0's process:
`exchange_wire_bits` over `exchange_rounds`. The program grows both every
iteration by the same amounts, so their ratio is the growth of an
iteration over the window too. Every rank receives the same count (the
all-gather's parts are equal-shaped: K / P buffers of W + 1 words a
rank), so the sum over the P ranks is P times rank 0's. None where the
program keeps no such counters."""

T_BITS = 32


def wire_bits_per_round():
    """Bits this process's rank received in one Shuffle's all-gather, or
    None where the registry holds no exchange over a group."""
    from repro_torch.obs import get_registry

    reg = get_registry()
    bits, rounds = reg.get("exchange_wire_bits"), reg.get("exchange_rounds")
    if bits is None or rounds is None or not rounds.value:
        return None
    return bits.value / rounds.value


def read(ctx):
    per_round = wire_bits_per_round()
    if per_round is None:
        return None
    c = ctx["counts"]
    return (ctx["cell"].chips * per_round
            / (c["B"] * c["n"] * c["n"] * T_BITS))
