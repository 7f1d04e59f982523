"""The device's idle share in the traced window, in %: the time in which
no kernel, copy or set ran. It reads every ``device_idle.<cells>`` metric
(``device_idle.serve``, ``device_idle.serve_poisson``, ...), one name for
each end-to-end metric it moves."""


def read(ctx):
    t = ctx.get("trace")
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["trace_window_s"])
