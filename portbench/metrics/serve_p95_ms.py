"""The 95th percentile of the latency of every request due in the window,
each timed from when it was due (open loop); a request that failed or
never came back counts at the time the wait for it ended."""

import numpy as np

from portbench.loadgen import percentile


def read(ctx):
    if ctx.get("kind") != "serve" or not len(ctx["window"]):
        return None
    log, w = ctx["log"], ctx["window"]
    done = np.where(np.isnan(log.done[w]) | log.failed[w],
                    ctx["drained_at"], log.done[w])
    return percentile(list((done - log.due[w]) * 1e3), 95)
