"""#5, all CLIP layers over a batch's tokens
(``models.encoders.encoder_stack``): its bound over its device time."""

from portbench.metrics._roofline import share

WRAPS = ("image_captioning_ml_project_tpu_torch.models.encoders",
         "encoder_stack")


def shapes(x, stack, **kw):
    """(B, S, H, L, F) of a call."""
    return (x.shape[0], x.shape[1], x.shape[2], stack["wqkv"].shape[0],
            stack["wfc"].shape[1])


def work(B, S, H, L, F):
    """All L layers over B images of S tokens: weights once, the stream
    in and out."""
    ops = B * L * (2 * S * (4 * H * H + 2 * H * F) + 4 * S * S * H)
    weights = L * ((4 * H * H + 2 * H * F) * 2 + (5 * H + F) * 2
                   + 4 * H * 4)
    return {"ops": ops, "bytes": weights + 2 * B * S * H * 2}


def read(ctx):
    return share(ctx, WRAPS[1], work)
