"""The most device memory the allocator held during the window
(``max_memory_allocated`` after a reset at its start), in GiB."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["peak_window_bytes"]:
        return None
    return ctx["peak_window_bytes"] / 2 ** 30
