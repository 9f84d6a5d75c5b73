"""device_idle_pct.serve: the card's idle share over a traced stretch of
the open-loop query stream at the cell's rate, 100 (1 - busy / (last
record's end - first record's start)), from a complete profiler window."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else tr.idle_pct()
