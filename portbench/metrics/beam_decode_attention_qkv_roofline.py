"""#2, one decoder layer's self-attention step with its projections (the
Transformer's folded route, ``models.decoders.beam_decode_attention_qkv``):
its bound over its device time."""

from portbench.metrics._roofline import share

WRAPS = ("image_captioning_ml_project_tpu_torch.models.decoders",
         "beam_decode_attention_qkv")


def shapes(x, wqkv, bqkv, wo, bo, kc, vc, pk, pv, anc, pos, **kw):
    """(Bk, B, H, P, pos) of a call."""
    B = x.shape[0] // kw["beam_size"]
    return (x.shape[0], B, x.shape[1], 0 if pk is None else pk.shape[1],
            int(pos))


def work(Bk, B, H, P, pos):
    """One layer's step over Bk rows: the QKV and out projections'
    weights once, the prefix K/V per image, each beam's suffix K/V at
    ``pos`` positions, the appended rows, the stream in and out."""
    ops = 2 * Bk * 4 * H * H + 4 * Bk * (P + pos + 1) * H
    weights = 4 * H * H * 2 + 4 * H * 2
    caches = 2 * 2 * H * (B * P + Bk * pos + Bk)
    return {"ops": ops, "bytes": weights + caches + 2 * Bk * H * 2}


def read(ctx):
    return share(ctx, WRAPS[1], work)
