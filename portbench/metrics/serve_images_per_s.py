"""Captions completed in the window over the window's seconds (closed
loop: every completion inside the window counts)."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    return len(ctx["ok"]) / ctx["seconds"]
