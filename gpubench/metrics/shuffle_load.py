"""shuffle_load: the paper's Definition-2 load of one iteration, the bits
the compiled Shuffle puts on the wire (`CompiledEngine.schedule_bits`:
coded multicasts plus unicast leftovers) over n^2 x 32. An exact count."""

T_BITS = 32


def read(ctx):
    c = ctx["counts"]
    return c["schedule_bits"] / (c["n"] * c["n"] * T_BITS)
