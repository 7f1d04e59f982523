"""Cross-attention decode step of the Transformer decoder: the hand-written
CUDA kernel and its plain PyTorch version.

Counterpart of ``image_captioning_ml_project_tpu.ops.pallas_cross.
fused_cross_attention`` (the Pallas TPU kernel). One decoder layer's
attention of all ``Bk = B * K`` beam rows over their image's memory: per
head, each row's query is scored against the image's memory keys (f32
products times ``scale``), masked positions take -1e9, the f32 softmax
over the memory axis is rounded to the value dtype and mixes the memory
values in f32; the mix is returned in the query dtype, before the output
projection. The memory is per image and shared by its K beams; the keys
are stored pre-transposed, as the JAX decoder stores them.

The JAX kernel needs an 8-aligned memory axis and a 128-lane width for the
TPU; here the memory keeps its real rows and the wrapper checks what the
Hopper kernel takes instead. :func:`cross_attention` dispatches on the
tensors' device: a CPU tensor takes :func:`cross_attention_plain`; a CUDA
tensor launches ``csrc/cross_attention.cu`` (see the note there for what
bounds it on the card and how the design answers) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import load_library
from ._checks import (DTYPES, check_dtype, check_no_grad, check_tensor,
                      current_stream)

_NEG_INF = -1e9
# cudaErrorInvalidValue: what the C entry returns where one block would need
# more shared memory than the card offers
_INVALID_VALUE = 1


def cross_attention_plain(q: torch.Tensor, mem_kt: torch.Tensor,
                          mem_v: torch.Tensor,
                          pad_mask: Optional[torch.Tensor], *,
                          num_heads: int, beam_size: int,
                          scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same numerics (those
    of the JAX package's ``reference_cross_attention``)."""
    Bk, H = q.shape
    B, _, Sm = mem_kt.shape
    NH, K = num_heads, beam_size
    hd = H // NH
    qh = q.reshape(B, K, NH, hd).float()
    kh = mem_kt.reshape(B, NH, hd, Sm).float()
    scores = torch.einsum("bknd,bnds->bkns", qh, kh) * scale
    if pad_mask is not None:
        scores = scores.masked_fill(pad_mask.bool()[:, None, None, :],
                                    _NEG_INF)
    w = torch.softmax(scores, dim=-1).to(mem_v.dtype).float()
    vh = mem_v.reshape(B, Sm, NH, hd).float()
    out = torch.einsum("bkns,bsnd->bknd", w, vh)
    return out.reshape(Bk, H).to(q.dtype)


def _check_shapes(q, mem_kt, mem_v, pad_mask, num_heads, beam_size):
    """Raise on shapes that do not fit together (on any device)."""
    if q.dim() != 2 or mem_kt.dim() != 3:
        raise ValueError(f"expected q [Bk, H] and mem_kt [B, H, Sm], got "
                         f"{tuple(q.shape)} and {tuple(mem_kt.shape)}")
    Bk, H = q.shape
    B, Hk, Sm = mem_kt.shape
    if beam_size < 1 or Bk != B * beam_size:
        raise ValueError(f"rows {Bk} != images {B} x beams {beam_size}")
    if num_heads < 1 or H % num_heads:
        raise ValueError(f"width {H} does not split into {num_heads} heads")
    if Hk != H or tuple(mem_v.shape) != (B, Sm, H):
        raise ValueError(f"memory must be mem_kt [B={B}, H={H}, Sm] and "
                         f"mem_v [B, Sm, H], got {tuple(mem_kt.shape)} and "
                         f"{tuple(mem_v.shape)}")
    if pad_mask is not None and tuple(pad_mask.shape) != (B, Sm):
        raise ValueError(f"pad_mask shape {tuple(pad_mask.shape)} != "
                         f"{(B, Sm)}")


def _check(q, mem_kt, mem_v, pad_mask, num_heads, beam_size):
    """Raise on anything the CUDA kernel does not take."""
    check_dtype("cross_attention", q)
    Bk, H = q.shape
    B, _, Sm = mem_kt.shape
    check_tensor("q", q, (Bk, H), q.dtype, q.device)
    check_tensor("mem_kt", mem_kt, (B, H, Sm), q.dtype, q.device)
    check_tensor("mem_v", mem_v, (B, Sm, H), q.dtype, q.device)
    if pad_mask is not None:
        check_tensor("pad_mask", pad_mask, (B, Sm), torch.bool, q.device)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The library's C entry point, built and typed once per process."""
    fn = load_library("cross_attention").cross_attention
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, mem_kt, mem_v, pad_mask, num_heads, beam_size, scale):
    _check(q, mem_kt, mem_v, pad_mask, num_heads, beam_size)
    fn = _kernel_fn()
    B, H, Sm = mem_kt.shape
    out = torch.empty_like(q)
    stream = current_stream(q.device)
    err = fn(DTYPES[q.dtype], q.device.index, out.data_ptr(), q.data_ptr(),
             mem_kt.data_ptr(), mem_v.data_ptr(),
             pad_mask.data_ptr() if pad_mask is not None else None, B,
             beam_size, Sm, H, num_heads, float(scale), stream)
    if err != 0:
        why = (f": one block would stage Sm={Sm} memory rows of a head and "
               f"K={beam_size} beams' scores, more shared memory than the "
               f"card offers" if err == _INVALID_VALUE else "")
        raise RuntimeError(f"cross_attention kernel launch failed: cudaError "
                           f"{err}{why}")
    cross_attention.launches += 1
    return out


def cross_attention(q: torch.Tensor, mem_kt: torch.Tensor,
                    mem_v: torch.Tensor, pad_mask: Optional[torch.Tensor], *,
                    num_heads: int, beam_size: int,
                    scale: float) -> torch.Tensor:
    """One cross-attention step over all beam rows.

    q [Bk, H] is the rows' cross queries (after ``q_proj``), with
    Bk = B * beam_size and row r belonging to image r // beam_size;
    mem_kt [B, H, Sm] the images' memory keys, pre-transposed; mem_v
    [B, Sm, H] their memory values; pad_mask [B, Sm] bool (True = masked)
    or None. Returns the attention mix [Bk, H] in q's dtype, before the
    output projection. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (counted in ``cross_attention.launches``) or
    raises.
    """
    _check_shapes(q, mem_kt, mem_v, pad_mask, num_heads, beam_size)
    check_no_grad("cross_attention", q, mem_kt, mem_v)
    if q.device.type == "cuda":
        return _launch(q, mem_kt, mem_v, pad_mask, num_heads, beam_size,
                       scale)
    if q.device.type == "cpu":
        return cross_attention_plain(q, mem_kt, mem_v, pad_mask,
                                     num_heads=num_heads,
                                     beam_size=beam_size, scale=scale)
    raise ValueError(f"cross_attention has no kernel for {q.device}")


cross_attention.launches = 0
