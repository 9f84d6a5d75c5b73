"""host_issue_ms: the host's time to issue one iteration of a job, its
start's upload included: the benchmark's clock around
`CompiledEngine.run`, read before the synchronize, over 20 jobs each
begun on an idle card, divided by their iterations."""


def read(ctx):
    return ctx["layer"].get("host_issue_ms")
