"""session_build_s: the session's build in set-up (`engine.compile`, or
`GraphService`'s, with the exchange's or the plan executors' uploads),
the benchmark's clock around the call, ended by a synchronize."""


def read(ctx):
    return ctx["layer"].get("session_build_s")
