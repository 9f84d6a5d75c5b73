"""device_idle_pct.job: the card's idle share over a traced stretch of
back-to-back jobs, 100 (1 - busy / (last record's end - first record's
start)), from a complete profiler window."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else tr.idle_pct()
