"""Exact top-k for beam search, with ``lax.top_k``'s tie order.

Counterpart of ``image_captioning_ml_project_tpu.ops.topk``. There the
blocked top-k is plain XLA (no Pallas kernel), so here it is plain torch.
``torch.topk`` does not promise which of two equal values comes first;
``lax.top_k`` puts the lower index first, and beam search's token identity
with the JAX package depends on it. :func:`top_k` therefore takes the head
of a stable descending sort.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG_INF = float("-inf")


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of the last axis, sorted descending; equal values resolve
    to the lowest index. Returns (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def fused_beam_top_k(logits: torch.Tensor, row_bias: torch.Tensor,
                     rows_per_group: int, k: int, *,
                     suppress_token: int = -1, suppress: bool = False,
                     block: int = 512,
                     block_max: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``row_bias[r] + logits[r, v]`` over each image's
    ``rows_per_group`` consecutive rows, with no vocab-sized intermediate.

    Since ``max_v(x + bias) == max_v(x) + bias``, the per-block maxima of
    the raw logits (``block_max``, e.g. from
    :func:`..ops.lse.lse_and_block_max`, or computed here) plus the row
    bias pick the k best blocks of each group; any block holding a top-k
    element is among them. Those k blocks are gathered and a final exact
    top-k runs over ``[B, k * block]``. ``suppress`` masks
    ``suppress_token`` to -inf (min-length EOS suppression). Returns
    (values f32 [B, k], indices int64 [B, k] flat in
    ``[0, rows_per_group * V)``), ties to the lowest flat index.
    """
    R, V = logits.shape
    Kg = rows_per_group
    B = R // Kg
    nblk = -(-V // block)
    if V < block:
        raise ValueError(f"fused_beam_top_k needs vocab >= block ({V} < "
                         f"{block})")
    if k > Kg * nblk:
        raise ValueError(f"fused_beam_top_k selects k blocks from "
                         f"rows_per_group*nblk candidates; k={k} > "
                         f"{Kg}*{nblk}")
    suppressing = suppress and suppress_token >= 0
    dev = logits.device

    if block_max is not None:
        bm = block_max.float()
        if suppressing:  # written below: a private copy, not the caller's
            bm = bm.clone()
    else:
        padded = torch.nn.functional.pad(
            logits.float(), (0, nblk * block - V), value=_NEG_INF)
        bm = padded.view(R, nblk, block).amax(-1)
    if suppressing:
        # the suppressed token only perturbs its own block's max
        eb = suppress_token // block
        lo, hi = eb * block, min(eb * block + block, V)
        seg = logits[:, lo:hi].float()
        seg[:, suppress_token - lo] = _NEG_INF
        bm[:, eb] = seg.amax(-1)

    bias = row_bias.float()
    bmg = (bm + bias[:, None]).reshape(B, Kg * nblk)
    _, top_blocks = top_k(bmg, k)
    # ascending block order: the final top-k then sees candidates in
    # ascending flat-index order, so exact ties pick the lowest index
    top_blocks = torch.sort(top_blocks, dim=-1).values
    kg_sel = top_blocks // nblk                                  # [B, k]
    blk_sel = top_blocks % nblk
    rows = torch.arange(B, device=dev)[:, None] * Kg + kg_sel    # [B, k]

    lanes = blk_sel[:, :, None] * block + torch.arange(block, device=dev)
    inside = lanes < V                                           # ragged tail
    gathered = logits[rows[:, :, None], lanes.clamp(max=V - 1)].float()
    dead = ~inside
    if suppressing:
        dead = dead | (lanes == suppress_token)
    gathered = gathered.masked_fill(dead, _NEG_INF)
    gathered = gathered + bias[rows][:, :, None]

    vals, local = top_k(gathered.reshape(B, k * block), k)
    which = local // block
    idx = (kg_sel.gather(1, which) * V + blk_sel.gather(1, which) * block
           + local % block)
    return vals, idx
