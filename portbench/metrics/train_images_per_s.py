"""Images of every CE step issued in the window over the seconds from the
window's start to the sync that ends it."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    return ctx["steps"] * ctx["traffic"]["batch"] / ctx["elapsed_s"]
