"""Kernels launched in the traced part of the window over the decode steps
run in it (``ServerStats.decode_steps``): everything a batch launches,
encode included, per step."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or ctx.get("kind") != "serve":
        return None
    steps = ctx["counters"].delta("trace_start", "trace_end")["decode_steps"]
    return t["kernels"] / steps if steps else None
