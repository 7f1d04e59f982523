"""Kernels launched in the traced part of the window over the training
steps issued in it."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or ctx.get("kind") != "train" or not ctx["steps_traced"]:
        return None
    return t["kernels"] / ctx["steps_traced"]
