"""The CE steps' model operations (forward and backward, 3 x the forward,
counted from the configuration's shapes: ``flops.train_ops``; AdamW left
out) over the window's seconds times the card's bf16 peak, in %."""

from portbench import flops


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    tr = ctx["traffic"]
    ops = ctx["steps"] * flops.train_ops(ctx["cfg"], tr["batch"],
                                         tr["caption_len"])
    return 100.0 * ops / (ctx["elapsed_s"] * flops.peaks()["bf16_flops"])
