"""The model operations of the window's batches over the window's seconds
times the card's bf16 peak, in %: each real row's encode and conditioning
and every decode step over its beams with the LM head, counted from the
configuration's shapes (``flops.serve_ops``) for the batches launched in
the window (``ServerStats``), at their mean steps a batch."""

from portbench import flops


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    d = ctx["counters"].delta("start", "end")
    if not d["batches"]:
        return None
    steps = round(d["decode_steps"] / d["batches"])
    ops = flops.serve_ops(ctx["cfg"], d["batched_rows"], steps)
    return 100.0 * ops / (d["t"] * flops.peaks()["bf16_flops"])
