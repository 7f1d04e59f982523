"""One-pass row logsumexp and per-block maxima over vocab-sized logits: the
hand-written Triton kernel and its plain PyTorch version.

Counterpart of ``image_captioning_ml_project_tpu.ops.pallas_lse.
lse_and_block_max`` (the Pallas TPU kernel). The beam candidate step
(:func:`..ops.topk.fused_beam_top_k`) needs, per decode step, the f32 row
logsumexp and the f32 maxima of each ``block``-wide column block of the
``[R, V]`` logits. The kernel produces both in one read of the logits.

What bounds it on the card: device memory. The flagship step reads
``[320, 50257]`` bf16 logits (32 MB) and does a few flops per element. The
design: one program per row walks the vocab in ``block``-wide tiles, stores
each tile's max, and keeps a per-lane running (max, rescaled sum) so no
scalar is carried across the loop; the lanes are merged once at the end.
The ragged last tile is masked with -1e30, as the Pallas kernel masks it.

:func:`lse_and_block_max` dispatches on the tensor's device: a CPU tensor
takes :func:`lse_and_block_max_plain`, a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ._checks import check_no_grad

_NEG = -1e30  # mask value of the ragged last block (as in pallas_lse.py)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def lse_and_block_max_plain(logits: torch.Tensor, block: int = 512
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [R, V] -> (lse [R] f32, block_max [R, ceil(V/block)] f32)."""
    R, V = logits.shape
    nblk = -(-V // block)
    x = logits.float()
    padded = F.pad(x, (0, nblk * block - V), value=_NEG)
    return torch.logsumexp(x, dim=-1), padded.view(R, nblk, block).amax(-1)


@functools.cache
def _build_kernel():
    """Define the Triton kernel, once. Triton is imported here, not when
    the module is imported: the CPU test environment has none."""
    import triton
    import triton.language as tl

    @triton.jit
    def lse_block_max_kernel(x_ptr, lse_ptr, bm_ptr, V, stride_row, nblk,
                             BLOCK: tl.constexpr):
        row = tl.program_id(0)
        lanes = tl.arange(0, BLOCK)
        base = x_ptr + row.to(tl.int64) * stride_row
        m = tl.full([BLOCK], -1e30, tl.float32)
        s = tl.zeros([BLOCK], tl.float32)
        for blk in range(0, nblk):
            offs = blk * BLOCK + lanes
            x = tl.load(base + offs, mask=offs < V, other=-1e30)
            x = x.to(tl.float32)
            tl.store(bm_ptr + row * nblk + blk, tl.max(x, axis=0))
            m_new = tl.maximum(m, x)
            s = s * tl.exp(m - m_new) + tl.exp(x - m_new)
            m = m_new
        mx = tl.max(m, axis=0)
        total = tl.sum(s * tl.exp(m - mx), axis=0)
        tl.store(lse_ptr + row, mx + tl.log(total))

    return lse_block_max_kernel


def _launch(logits: torch.Tensor, block: int):
    if logits.dtype not in _DTYPES:
        raise TypeError(f"lse_and_block_max kernel takes {_DTYPES}, got "
                        f"{logits.dtype}")
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError(f"expected [R, V] logits with unit column stride, "
                         f"got shape {tuple(logits.shape)} strides "
                         f"{logits.stride()}")
    if block < 16 or block & (block - 1):
        raise ValueError(f"block must be a power of two >= 16, got {block}")
    R, V = logits.shape
    if R == 0 or V == 0:
        raise ValueError(f"empty logits {tuple(logits.shape)}")
    nblk = -(-V // block)
    lse = torch.empty(R, dtype=torch.float32, device=logits.device)
    bm = torch.empty((R, nblk), dtype=torch.float32, device=logits.device)
    with torch.cuda.device(logits.device):
        _build_kernel()[(R,)](logits, lse, bm, V, logits.stride(0), nblk,
                              BLOCK=block, num_warps=4, num_stages=4)
    lse_and_block_max.launches += 1
    return lse, bm


def lse_and_block_max(logits: torch.Tensor, block: int = 512
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [R, V] (float32/bfloat16/float16) -> (lse [R] f32,
    block_max [R, ceil(V/block)] f32), in one streaming pass on the card.

    A CPU tensor takes the plain version; a CUDA tensor launches the Triton
    kernel (counted in ``lse_and_block_max.launches``) or raises."""
    check_no_grad("lse_and_block_max", logits)
    if logits.device.type == "cuda":
        return _launch(logits, block)
    if logits.device.type == "cpu":
        return lse_and_block_max_plain(logits, block)
    raise ValueError(f"lse_and_block_max has no kernel for {logits.device}")


lse_and_block_max.launches = 0
