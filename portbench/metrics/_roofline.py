"""What the ``<kernel>_roofline`` readers share: the least time the work
of every traced call could take, from its shapes, over the device time of
everything launched inside those calls, in %.

A roofline reader names the program function it reads (``WRAPS``: module
and attribute) and says what of a call's arguments its work depends on
(``shapes(*args, **kwargs)``) and what that work is (``work(*shapes)``:
operations and bytes). In the traced run the harness wraps that function
in a range of the attribute's name and records each call's shapes."""

from portbench import flops, trace


def share(ctx, name, work):
    t = ctx.get("trace")
    calls = ctx["spans"].calls.get(name) if t is not None else None
    if not calls:
        return None
    spent = trace.device_time_in(ctx["events"], name, t["lo"], t["hi"])
    if spent <= 0:
        return None
    pk = flops.peaks()
    least = sum(flops.bound_s(w["ops"], w["bytes"], pk)
                for w in (work(*c) for c in calls))
    return 100.0 * least / spent
