"""Device-to-host reads of the decode engine per decode step: the
increments of the program's ``decode.host_syncs`` counter in the traced
window over the decode steps between the ``trace_start`` and
``trace_end`` marks (``ServerStats.decode_steps``). A count, which the
profiler does not change: it is read over the traced window alone, where
those marks fall at batch boundaries."""

from portbench import program_spans

program_spans.enable()


def read(ctx):
    got = program_spans.collect(ctx)
    if got is None or ctx.get("kind") != "serve":
        return None
    steps = ctx["counters"].delta("trace_start", "trace_end")["decode_steps"]
    syncs = sum(s.attrs["n"] for s in got["spans"]
                if s.name == "decode.host_syncs")
    return syncs / steps if steps else None
