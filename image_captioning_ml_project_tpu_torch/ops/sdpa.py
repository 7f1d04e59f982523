"""Masked scaled-dot-product attention of the multi-head cross-attention
variant: the hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``image_captioning_ml_project_tpu.ops.pallas_attention.
fused_sdpa`` (the Pallas TPU kernel). Per head, each query row is scored
against its image's keys (f32 products times ``scale``), masked keys take
-1e9, the f32 softmax over the keys is returned as the weights, and,
rounded to the value dtype, mixes the values in f32; the mix is returned in
the query dtype. The keys and values are per image and shared by the
image's ``beam_size`` query rows; with ``beam_size=1`` this is exactly the
JAX function's layout.

The JAX kernel pads the query rows to 8 and the keys and head width to 128
lanes for the TPU, the padded keys masked, so that an image whose keys are
all masked spreads its weights over all 128 lanes; here the keys keep
their real rows and such an image gets weights 1/S, as the JAX package's
plain (``use_pallas=False``) path gives. The kernel reads q, k and v
through their strides (the head dimension must be contiguous), so the
heads-transposed views of the projections cost no copy, and it writes the
context in the ``[rows, Q, NH, hd]`` memory order the output projection
reads.

:func:`sdpa` dispatches on the tensors' device: a CPU tensor takes
:func:`sdpa_plain`; a CUDA tensor launches ``csrc/sdpa.cu`` or raises. The
C entry picks the kernel from the dtype and the shape alone: bf16 with a
head width a multiple of 16 up to 128, at most 64 keys and 64 query rows
an image (the served shapes) runs on the tensor cores, one warp per
(image, head) with the scores, softmax and mix in registers; float32 and
the other shapes run on the CUDA cores, the first version's kernel. The
route launched last is ``sdpa.last_route`` (``"tensor_cores"`` or
``"cuda_cores"``). ``csrc/sdpa.cu``'s header says what bounds each on the
card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import load_library
from ._checks import DTYPES, check_dtype, check_no_grad, current_stream

_NEG_INF = -1e9
# cudaErrorInvalidValue: what the C entry returns where one block would need
# more shared memory than the card offers
_INVALID_VALUE = 1
# the C entry's route codes
_ROUTES = ("cuda_cores", "tensor_cores")


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               key_padding_mask: Optional[torch.Tensor], *, scale: float,
               beam_size: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with the same numerics (those
    of the JAX package's ``_sdpa_kernel``)."""
    Bq, NH, Q, hd = q.shape
    B, _, S, _ = k.shape
    K = beam_size
    qh = q.reshape(B, K, NH, Q, hd).float()
    scores = torch.einsum("bknqd,bnsd->bknqs", qh, k.float()) * scale
    if key_padding_mask is not None:
        scores = scores.masked_fill(
            key_padding_mask.bool()[:, None, None, None, :], _NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bknqs,bnsd->bknqd", w.to(v.dtype).float(), v.float())
    return (ctx.reshape(Bq, NH, Q, hd).to(q.dtype),
            w.reshape(Bq, NH, Q, S))


def _check_shapes(q, k, v, key_padding_mask, beam_size):
    """Raise on shapes that do not fit together (on any device)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q [rows, NH, Q, hd] and k [B, NH, S, hd],"
                         f" got {tuple(q.shape)} and {tuple(k.shape)}")
    Bq, NH, Q, hd = q.shape
    B, NHk, S, hdk = k.shape
    if beam_size < 1 or Bq != B * beam_size:
        raise ValueError(f"rows {Bq} != images {B} x beams {beam_size}")
    if (NHk, hdk) != (NH, hd) or tuple(v.shape) != (B, NH, S, hd):
        raise ValueError(f"k and v must be [B={B}, NH={NH}, S, hd={hd}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if min(Q, S, hd) < 1:
        raise ValueError(f"empty attention: Q={Q}, S={S}, hd={hd}")
    if key_padding_mask is not None and \
            tuple(key_padding_mask.shape) != (B, S):
        raise ValueError(f"key_padding_mask shape "
                         f"{tuple(key_padding_mask.shape)} != {(B, S)}")


def _check(q, k, v, key_padding_mask):
    """Raise on anything the CUDA kernel does not take."""
    check_dtype("sdpa", q)
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                             f"{q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous, "
                             f"got strides {t.stride()}")
    if key_padding_mask is not None:
        m = key_padding_mask
        if m.device != q.device or m.dtype != torch.bool:
            raise ValueError(f"key_padding_mask is {m.dtype} on {m.device}; "
                             f"expected torch.bool on {q.device}")
        if not m.is_contiguous():
            raise ValueError("key_padding_mask must be contiguous")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The library's C entry point, built and typed once per process."""
    fn = load_library("sdpa").sdpa
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                      ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, key_padding_mask, scale, beam_size):
    _check(q, k, v, key_padding_mask)
    fn = _kernel_fn()
    Bq, NH, Q, hd = q.shape
    B, _, S, _ = k.shape
    # the context in [rows, Q, NH, hd] memory, returned as its
    # [rows, NH, Q, hd] view
    ctx = torch.empty((Bq, Q, NH, hd), dtype=q.dtype, device=q.device)
    w = torch.empty((Bq, NH, Q, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    stream = current_stream(q.device)
    route = ctypes.c_int(-1)
    err = fn(DTYPES[q.dtype], q.device.index, ctx.data_ptr(), w.data_ptr(),
             q.data_ptr(), k.data_ptr(), v.data_ptr(),
             key_padding_mask.data_ptr() if key_padding_mask is not None
             else None, B, beam_size, Q, S, NH, hd, strides, float(scale),
             stream, ctypes.byref(route))
    if err != 0:
        why = (f": one block would stage S={S} key and value rows of a head,"
               f" more shared memory than the card offers"
               if err == _INVALID_VALUE else "")
        raise RuntimeError(f"sdpa kernel launch failed: cudaError {err}{why}")
    sdpa.launches += 1
    sdpa.last_route = _ROUTES[route.value]
    return ctx.transpose(1, 2), w


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         key_padding_mask: Optional[torch.Tensor], *, scale: float,
         beam_size: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked multi-head attention over per-image keys and values.

    q [rows, NH, Q, hd], with rows = B * beam_size and row r belonging to
    image r // beam_size; k and v [B, NH, S, hd]; key_padding_mask [B, S]
    bool (True = padding) or None. Returns (context [rows, NH, Q, hd] in
    q's dtype, weights [rows, NH, Q, S] float32). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (counted in
    ``sdpa.launches``, its route in ``sdpa.last_route``) or raises.
    """
    _check_shapes(q, k, v, key_padding_mask, beam_size)
    check_no_grad("sdpa", q, k, v)
    if q.device.type == "cuda":
        return _launch(q, k, v, key_padding_mask, scale, beam_size)
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v, key_padding_mask, scale=scale,
                          beam_size=beam_size)
    raise ValueError(f"sdpa has no kernel for {q.device}")


sdpa.launches = 0
sdpa.last_route = None
