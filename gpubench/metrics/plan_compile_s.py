"""plan_compile_s: `compile_plan_csr`'s seconds in set-up, the
benchmark's clock around the call."""


def read(ctx):
    return ctx["layer"].get("plan_compile_s")
