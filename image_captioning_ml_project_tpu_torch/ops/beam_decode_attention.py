"""Beam-decode attention step, split and folded-QKV: the hand-written CUDA
kernels and their plain PyTorch versions.

:func:`beam_decode_attention` is the counterpart of
``image_captioning_ml_project_tpu.ops.pallas_decode.
fused_beam_decode_attention`` (the Pallas TPU kernel). One GPT-2 layer's
decode-step attention over all ``Bk = B * K`` beam rows: per head, each
row's query is scored against its image's shared prefix keys, against the
suffix cache read through lazy beam ancestry (row r at position t < pos
reads image-local beam ``anc[r, t]``), and against the step's own key; the
f32 softmax weights are rounded to the value dtype and mix V in f32. The
step's K/V row is appended to the caches at ``pos`` in place.

:func:`beam_decode_attention_qkv` is the counterpart of
``fused_beam_decode_attention_qkv``: the same step with the layer's QKV
projection before it and its output projection after it, both with
``nn.Dense`` rounding (:func:`.numerics.dense`).

Each dispatches on the tensors' device: on a CPU tensor it runs its plain
version; on a CUDA tensor it launches ``csrc/beam_decode_attention.cu`` or
``csrc/beam_decode_attention_qkv.cu`` (see the notes there and in
``csrc/beam_attention.cuh`` for what bounds them on the card and how the
designs answer) or raises. Inference only: both raise when autograd would
need a gradient through them.

On the card an ancestry entry outside ``[0, beam_size)`` is a caller's
fault that the kernel reports without a host sync: it sets a per-device
error word and leaves that position out of the row's attention.
:func:`ancestry_fault` reads the word, :func:`reset_ancestry_fault`
clears it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import load_library
from ._checks import (DTYPES, check_dtype, check_no_grad, check_tensor,
                      check_widths, current_stream, error_word)
from .numerics import dense

_SMEM_LIMIT = 232448  # the dynamic shared memory one block may opt in to
# cudaErrorInvalidValue: what the C entries return, before the attention's
# launch, where no block of it fits the card's shared memory
_INVALID_VALUE = 1
ANC_ERROR = "beam_attention ancestry"  # the error word's name


def ancestry_fault(device) -> bool:
    """Whether a beam-attention launch on ``device`` (split, folded or
    whole-stack) met an ancestry entry outside ``[0, beam_size)`` since the
    last :func:`reset_ancestry_fault`. Reads the device word: a host
    sync."""
    return bool(error_word(ANC_ERROR, device).item())


def reset_ancestry_fault(device) -> None:
    error_word(ANC_ERROR, device).zero_()


def launch_error(kernel: str, err: int, S: int, P: int) -> Exception:
    """The exception for the C entry's nonzero return ``err``."""
    if err == _INVALID_VALUE:
        return ValueError(f"{kernel}: S={S}, P={P} need more shared memory "
                          f"per block than the card's {_SMEM_LIMIT} bytes")
    return RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")


def beam_decode_attention_plain(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        k_cache: torch.Tensor, v_cache: torch.Tensor,
        prefix_k: Optional[torch.Tensor], prefix_v: Optional[torch.Tensor],
        anc_local: Optional[torch.Tensor], pos: int, *, num_heads: int,
        beam_size: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with the same numerics: f32
    score products and softmax over [suffix; prefix; self], weights rounded
    to the value dtype, f32 mix, output in the query dtype. Appends in place
    and returns ``(out [Bk, H], k_cache, v_cache)``."""
    Bk, H = q.shape
    S = k_cache.shape[1]
    NH = num_heads
    hd = H // NH
    K = beam_size
    B = Bk // K
    dt = v_cache.dtype
    if anc_local is None:
        anc_local = torch.zeros((Bk, S), dtype=torch.long, device=q.device)
    base = (torch.arange(Bk, device=q.device) // K * K)[:, None]
    rows = base + anc_local.long()                              # [Bk, S]
    cols = torch.arange(S, device=q.device)[None, :]
    k_sel = k_cache[rows, cols].float().view(Bk, S, NH, hd)
    v_sel = v_cache[rows, cols].float().view(Bk, S, NH, hd)

    qf = q.float().view(Bk, NH, hd)
    s_suf = (qf[:, None] * k_sel).sum(-1).transpose(1, 2) * scale  # [Bk,NH,S]
    valid = torch.arange(S, device=q.device) < pos
    s_suf = s_suf.masked_fill(~valid, float("-inf"))
    s_self = (qf * k_new.float().view(Bk, NH, hd)).sum(-1) * scale  # [Bk,NH]
    parts = [s_suf]
    if prefix_k is not None:
        P = prefix_k.shape[1]
        pk = prefix_k.float().view(B, 1, P, NH, hd)
        s_pre = (qf.view(B, K, 1, NH, hd) * pk).sum(-1)            # [B,K,P,NH]
        parts.append(s_pre.reshape(Bk, P, NH).transpose(1, 2) * scale)
    parts.append(s_self[:, :, None])
    w = torch.softmax(torch.cat(parts, dim=-1), dim=-1).to(dt).float()

    out = (w[:, :, :S, None] * v_sel.transpose(1, 2)).sum(2)      # [Bk,NH,hd]
    if prefix_k is not None:
        pv = prefix_v.float().view(B, 1, P, NH, hd).transpose(2, 3)
        w_pre = w[:, :, S:S + P].reshape(B, K, NH, P, 1)
        out = out + (w_pre * pv).sum(3).reshape(Bk, NH, hd)
    out = out + w[:, :, -1:] * v_new.float().view(Bk, NH, hd)
    k_cache[:, pos] = k_new
    v_cache[:, pos] = v_new
    return out.reshape(Bk, H).to(q.dtype), k_cache, v_cache


def _check_caches(x, k_cache, v_cache, prefix_k, prefix_v, anc_local, pos,
                  num_heads, beam_size):
    """Raise on caches, prefix, ancestry or ``pos`` that the attention
    kernel does not take, for rows x [Bk, H]; returns the prefix length."""
    if x.dim() != 2 or k_cache.dim() != 3:
        raise ValueError(f"expected rows [Bk, H] and caches [Bk, S, H], got "
                         f"{tuple(x.shape)} and {tuple(k_cache.shape)}")
    Bk, H = x.shape
    S = k_cache.shape[1]
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        check_tensor(name, t, (Bk, S, H), x.dtype, x.device)
    if beam_size < 1 or Bk % beam_size:
        raise ValueError(f"Bk={Bk} rows are not whole beams of {beam_size}")
    if num_heads < 1 or H % num_heads:
        raise ValueError(f"width {H} does not split into {num_heads} heads")
    P = 0
    if (prefix_k is None) != (prefix_v is None):
        raise ValueError("give both prefix tensors or neither")
    if prefix_k is not None:
        B = Bk // beam_size
        if prefix_k.dim() != 3 or prefix_k.shape[0] != B \
                or prefix_k.shape[2] != H or prefix_v.shape != prefix_k.shape:
            raise ValueError(f"prefix K/V must be [B={B}, P, H={H}], got "
                             f"{tuple(prefix_k.shape)} and "
                             f"{tuple(prefix_v.shape)}")
        P = prefix_k.shape[1]
        for name, t in (("prefix_k", prefix_k), ("prefix_v", prefix_v)):
            check_tensor(name, t, (B, P, H), x.dtype, x.device)
    if anc_local is not None:
        if (anc_local.dtype != torch.int32 or anc_local.shape != (Bk, S)
                or anc_local.device != x.device
                or not anc_local.is_contiguous()):
            raise ValueError(f"anc_local must be a contiguous int32 [Bk={Bk},"
                             f" S={S}] tensor on {x.device}")
    if not 0 <= pos < S:
        raise ValueError(f"pos={pos} outside the cache's {S} positions")
    # a block holds more than an f32 score and two int ancestry entries per
    # position of one beam; the kernel's plan (csrc/beam_attention.cuh)
    # decides the rest on the card
    if 12 * (S + P) > _SMEM_LIMIT:
        raise ValueError(f"S={S}, P={P} need more than {12 * (S + P)} bytes "
                         f"of shared memory per block, above the card's "
                         f"{_SMEM_LIMIT}")
    return P


def _check(q, k_new, v_new, k_cache, v_cache, prefix_k, prefix_v,
           anc_local, pos, num_heads, beam_size):
    """Raise on anything the split CUDA kernel does not take; returns the
    prefix length."""
    check_dtype("beam_decode_attention", q)
    if q.dim() != 2:
        raise ValueError(f"expected q [Bk, H], got {tuple(q.shape)}")
    check_tensor("q", q, q.shape, q.dtype, q.device)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)}")
        check_tensor(name, t, q.shape, q.dtype, q.device)
    return _check_caches(q, k_cache, v_cache, prefix_k, prefix_v, anc_local,
                         pos, num_heads, beam_size)


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The library's C entry point, built and typed once per process."""
    fn = load_library("beam_decode_attention").beam_decode_attention
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k_new, v_new, k_cache, v_cache, prefix_k, prefix_v,
            anc_local, pos, num_heads, beam_size, scale):
    P = _check(q, k_new, v_new, k_cache, v_cache, prefix_k, prefix_v,
               anc_local, pos, num_heads, beam_size)
    fn = _kernel_fn()
    Bk, H = q.shape
    out = torch.empty_like(q)
    stream = current_stream(q.device)
    err = fn(DTYPES[q.dtype], q.device.index, out.data_ptr(), q.data_ptr(),
             k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), _ptr(prefix_k), _ptr(prefix_v),
             _ptr(anc_local), error_word(ANC_ERROR, q.device).data_ptr(), Bk,
             beam_size, k_cache.shape[1], P, H, num_heads, int(pos),
             float(scale), stream)
    if err != 0:
        raise launch_error("beam_decode_attention", err, k_cache.shape[1], P)
    beam_decode_attention.launches += 1
    return out, k_cache, v_cache


def beam_decode_attention(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        k_cache: torch.Tensor, v_cache: torch.Tensor,
        prefix_k: Optional[torch.Tensor], prefix_v: Optional[torch.Tensor],
        anc_local: Optional[torch.Tensor], pos: int, *, num_heads: int,
        beam_size: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode-attention step over all beam rows.

    q/k_new/v_new [Bk, H]; k_cache/v_cache [Bk, S, H], appended at suffix
    position ``pos`` in place; prefix_k/prefix_v [B, P, H] with
    B = Bk // beam_size, or both None for the prefix-free mode; anc_local
    [Bk, S] int32 in [0, beam_size), None meaning all zeros.

    Returns ``(out [Bk, H], k_cache, v_cache)``; the caches are the inputs,
    updated. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (counted in ``beam_decode_attention.launches``) or raises.
    """
    args = (q, k_new, v_new, k_cache, v_cache, prefix_k, prefix_v,
            anc_local, pos)
    check_no_grad("beam_decode_attention", *args[:7])
    if q.device.type == "cuda":
        return _launch(*args, num_heads, beam_size, scale)
    if q.device.type == "cpu":
        return beam_decode_attention_plain(
            *args, num_heads=num_heads, beam_size=beam_size, scale=scale)
    raise ValueError(f"beam_decode_attention has no kernel for {q.device}")


beam_decode_attention.launches = 0


# -- folded QKV: projections inside the kernel -------------------------------


def beam_decode_attention_qkv_plain(
        x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
        wo: torch.Tensor, bo: torch.Tensor, k_cache: torch.Tensor,
        v_cache: torch.Tensor, prefix_k: Optional[torch.Tensor],
        prefix_v: Optional[torch.Tensor], anc_local: Optional[torch.Tensor],
        pos: int, *, num_heads: int, beam_size: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the folded kernel: ``nn.Dense`` QKV
    projection, :func:`beam_decode_attention_plain`, ``nn.Dense`` output
    projection. Appends in place; returns ``(out [Bk, H], k_cache,
    v_cache)``."""
    H = x.shape[1]
    q, k_new, v_new = (t.contiguous()
                       for t in dense(x, wqkv, bqkv).split(H, dim=-1))
    att, _, _ = beam_decode_attention_plain(
        q, k_new, v_new, k_cache, v_cache, prefix_k, prefix_v, anc_local,
        pos, num_heads=num_heads, beam_size=beam_size, scale=scale)
    return dense(att, wo, bo), k_cache, v_cache


def _check_qkv(x, wqkv, bqkv, wo, bo, k_cache, v_cache, prefix_k, prefix_v,
               anc_local, pos, num_heads, beam_size):
    """Raise on anything the folded CUDA kernel does not take; returns the
    prefix length."""
    check_dtype("beam_decode_attention_qkv", x)
    if x.dim() != 2:
        raise ValueError(f"expected x [Bk, H], got {tuple(x.shape)}")
    H = x.shape[1]
    check_widths("beam_decode_attention_qkv", H, num_heads)
    check_tensor("x", x, x.shape, x.dtype, x.device, aligned=True)
    for name, t, shape in (("wqkv", wqkv, (3 * H, H)),
                           ("bqkv", bqkv, (3 * H,)), ("wo", wo, (H, H)),
                           ("bo", bo, (H,))):
        check_tensor(name, t, shape, x.dtype, x.device, aligned=True)
    return _check_caches(x, k_cache, v_cache, prefix_k, prefix_v, anc_local,
                         pos, num_heads, beam_size)


@functools.lru_cache(maxsize=None)
def _qkv_kernel_fn():
    fn = load_library("beam_decode_attention_qkv").beam_decode_attention_qkv
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 14
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_qkv(x, wqkv, bqkv, wo, bo, k_cache, v_cache, prefix_k, prefix_v,
                anc_local, pos, num_heads, beam_size, scale):
    P = _check_qkv(x, wqkv, bqkv, wo, bo, k_cache, v_cache, prefix_k,
                   prefix_v, anc_local, pos, num_heads, beam_size)
    fn = _qkv_kernel_fn()
    Bk, H = x.shape
    out = torch.empty_like(x)
    qkv = torch.empty((Bk, 3 * H), dtype=x.dtype, device=x.device)
    att = torch.empty_like(x)
    stream = current_stream(x.device)
    err = fn(DTYPES[x.dtype], x.device.index, out.data_ptr(),
             qkv.data_ptr(), att.data_ptr(), x.data_ptr(), wqkv.data_ptr(),
             bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
             k_cache.data_ptr(), v_cache.data_ptr(), _ptr(prefix_k),
             _ptr(prefix_v), _ptr(anc_local),
             error_word(ANC_ERROR, x.device).data_ptr(), Bk, beam_size,
             k_cache.shape[1], P, H, num_heads, int(pos), float(scale),
             stream)
    if err != 0:
        raise launch_error("beam_decode_attention_qkv", err, k_cache.shape[1],
                           P)
    beam_decode_attention_qkv.launches += 1
    return out, k_cache, v_cache


def beam_decode_attention_qkv(
        x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
        wo: torch.Tensor, bo: torch.Tensor, k_cache: torch.Tensor,
        v_cache: torch.Tensor, prefix_k: Optional[torch.Tensor],
        prefix_v: Optional[torch.Tensor], anc_local: Optional[torch.Tensor],
        pos: int, *, num_heads: int, beam_size: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's decode-step attention block with its projections.

    x [Bk, H] is the layer's (normalised) input rows; wqkv [3H, H], bqkv
    [3H], wo [H, H], bo [H] are the QKV and output projections in the
    ``nn.Linear`` layout; the caches, prefix, ancestry and ``pos`` are as
    for :func:`beam_decode_attention`. Returns ``(out [Bk, H], k_cache,
    v_cache)``: the projected attention output, before the residual. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``beam_decode_attention_qkv.launches``) or raises.
    """
    args = (x, wqkv, bqkv, wo, bo, k_cache, v_cache, prefix_k, prefix_v,
            anc_local, pos)
    check_no_grad("beam_decode_attention_qkv", *args[:9])
    if x.device.type == "cuda":
        return _launch_qkv(*args, num_heads, beam_size, scale)
    if x.device.type == "cpu":
        return beam_decode_attention_qkv_plain(
            *args, num_heads=num_heads, beam_size=beam_size, scale=scale)
    raise ValueError(f"beam_decode_attention_qkv has no kernel for "
                     f"{x.device}")


beam_decode_attention_qkv.launches = 0
