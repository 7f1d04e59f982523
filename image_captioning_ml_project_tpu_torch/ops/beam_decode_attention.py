"""Beam-decode attention step: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``image_captioning_ml_project_tpu.ops.pallas_decode.
fused_beam_decode_attention`` (the Pallas TPU kernel). One GPT-2 layer's
decode-step attention over all ``Bk = B * K`` beam rows: per head, each
row's query is scored against its image's shared prefix keys, against the
suffix cache read through lazy beam ancestry (row r at position t < pos
reads image-local beam ``anc[r, t]``), and against the step's own key; the
f32 softmax weights are rounded to the value dtype and mix V in f32. The
step's K/V row is appended to the caches at ``pos`` in place.

:func:`beam_decode_attention` dispatches on the tensors' device: on a CPU
tensor it runs :func:`beam_decode_attention_plain`; on a CUDA tensor it
launches ``csrc/beam_decode_attention.cu`` (see the note there for what
bounds it on the card and how the design answers) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024  # default dynamic shared memory of one block


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


def _check(q, k_new, v_new, k_cache, v_cache, prefix_k, prefix_v,
           anc_local, pos, num_heads, beam_size):
    """Raise on anything the CUDA kernel does not take."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"beam_decode_attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if q.dim() != 2 or k_cache.dim() != 3:
        raise ValueError(f"expected q [Bk, H] and caches [Bk, S, H], got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    Bk, H = q.shape
    S = k_cache.shape[1]
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "k_cache": k_cache,
               "v_cache": v_cache}
    if prefix_k is not None or prefix_v is not None:
        tensors.update(prefix_k=prefix_k, prefix_v=prefix_v)
    for name, t in tensors.items():
        if t is None:
            raise ValueError(f"{name} is None: give both prefix tensors or "
                             f"neither")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                             f"{q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("k_new", "v_new"):
        if tensors[name].shape != q.shape:
            raise ValueError(f"{name} shape {tuple(tensors[name].shape)} != "
                             f"q shape {tuple(q.shape)}")
    for name in ("k_cache", "v_cache"):
        if tensors[name].shape != (Bk, S, H):
            raise ValueError(f"{name} shape {tuple(tensors[name].shape)} != "
                             f"{(Bk, S, H)}")
    if beam_size < 1 or Bk % beam_size:
        raise ValueError(f"Bk={Bk} rows are not whole beams of {beam_size}")
    if num_heads < 1 or H % num_heads:
        raise ValueError(f"width {H} does not split into {num_heads} heads")
    P = 0
    if prefix_k is not None:
        B = Bk // beam_size
        if prefix_k.dim() != 3 or prefix_k.shape[0] != B \
                or prefix_k.shape[2] != H or prefix_v.shape != prefix_k.shape:
            raise ValueError(f"prefix K/V must be [B={B}, P, H={H}], got "
                             f"{tuple(prefix_k.shape)} and "
                             f"{tuple(prefix_v.shape)}")
        P = prefix_k.shape[1]
    if anc_local is not None:
        if (anc_local.dtype != torch.int32 or anc_local.shape != (Bk, S)
                or anc_local.device != q.device
                or not anc_local.is_contiguous()):
            raise ValueError(f"anc_local must be a contiguous int32 [Bk={Bk},"
                             f" S={S}] tensor on {q.device}")
    if not 0 <= pos < S:
        raise ValueError(f"pos={pos} outside the cache's {S} positions")
    smem = 4 * (H // num_heads + S + P + 1 + 4) + 4 * S
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S={S}, P={P} need {smem} bytes of shared memory "
                         f"per block, above the kernel's {_SMEM_LIMIT}")
    return P


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The library's C entry point, built and typed once per process."""
    fn = load_library("beam_decode_attention").beam_decode_attention
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPES[q.dtype], q.device.index, out.data_ptr(), q.data_ptr(),
             k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(),
             prefix_k.data_ptr() if prefix_k is not None else None,
             prefix_v.data_ptr() if prefix_v is not None else None,
             anc_local.data_ptr() if anc_local is not None else None,
             Bk, beam_size, k_cache.shape[1], P, H, num_heads, int(pos),
             float(scale), stream)
    if err != 0:
        raise RuntimeError(f"beam_decode_attention kernel launch failed: "
                           f"cudaError {err}")
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
    if q.device.type == "cuda":
        return _launch(*args, num_heads, beam_size, scale)
    if q.device.type == "cpu":
        return beam_decode_attention_plain(
            *args, num_heads=num_heads, beam_size=beam_size, scale=scale)
    raise ValueError(f"beam_decode_attention has no kernel for {q.device}")


beam_decode_attention.launches = 0
