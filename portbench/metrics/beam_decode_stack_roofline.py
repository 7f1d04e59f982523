"""#3, all GPT-2 layers of a decode step (``models.gpt2.beam_decode_stack``
as the decoder calls it): its bound over its device time."""

from portbench.flops import gpt2_layer_ops
from portbench.metrics._roofline import share

WRAPS = ("image_captioning_ml_project_tpu_torch.models.gpt2",
         "beam_decode_stack")


def shapes(x, stack, k, v, pk, pv, anc, pos, **kw):
    """(Bk, B, H, L, P, pos) of a call."""
    return (x.shape[0], pk.shape[1], x.shape[1], k.shape[0], pk.shape[2],
            int(pos))


def work(Bk, B, H, L, P, pos):
    """All L layers of one decode step over Bk = B*K rows. Bytes: the
    layers' weights once; each image's prefix K/V; each beam's suffix K/V
    at the ``pos`` positions its ancestry selects, counted as K distinct
    rows a position (every beam its own: the most the ancestry can
    select); the step's K/V rows appended; the stream in and out."""
    ops = L * gpt2_layer_ops(H, Bk, Bk * (P + pos + 1))
    weights = L * (12 * H * H * 2 + 9 * H * 2 + 4 * H * 4)
    caches = L * 2 * 2 * H * (B * P + Bk * pos + Bk)
    return {"ops": ops, "bytes": weights + caches + 2 * Bk * H * 2}


def read(ctx):
    return share(ctx, WRAPS[1], work)
