"""serve_mean_batch: queries per batched run over the window, from the
service's own counters (`ServeStats.queries` / `.batches`, their growth
across the window)."""


def read(ctx):
    return ctx["layer"].get("serve_mean_batch")
