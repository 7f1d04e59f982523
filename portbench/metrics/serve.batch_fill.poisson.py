"""Real rows per launched batch over the window (``ServerStats``
batched_rows over batches): how full the batcher's batches are at the
open loop's rate."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    d = ctx["counters"].delta("start", "end")
    return d["batched_rows"] / d["batches"] if d["batches"] else None
