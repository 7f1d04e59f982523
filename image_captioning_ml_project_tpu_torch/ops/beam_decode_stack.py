"""Whole-stack GPT-2 decode step: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``image_captioning_ml_project_tpu.ops.pallas_decode.
fused_beam_decode_stack`` (the Pallas TPU kernel). All L decoder layers of
one beam-decode step over ``Bk = B * K`` rows: per layer, LN1 -> QKV ->
beam attention (:mod:`.beam_decode_attention`) -> output projection ->
residual -> LN2 -> c_fc -> gelu_new -> c_proj -> residual, with the JAX
package's rounding (:mod:`.numerics`). Each layer's K/V row is appended at
``pos`` of the layer-stacked caches ``[L, Bk, S, H]`` in place. Returns the
last layer's residual stream, before ``ln_f``.

:func:`beam_decode_stack` dispatches on the tensors' device: a CPU tensor
takes :func:`beam_decode_stack_plain`; a CUDA tensor launches
``csrc/beam_decode_stack.cu`` (one host call: seven launches per layer;
see the note there) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ._build import load_library
from ._checks import (DTYPES, STACK_KEYS, check_dtype, check_no_grad,
                      check_stack, check_tensor, check_widths,
                      current_stream, error_word, scratch_buffer)
from .beam_decode_attention import (ANC_ERROR, _check_caches,
                                    beam_decode_attention_plain,
                                    launch_error)
from .numerics import dense, gelu_new, layer_norm


def beam_decode_stack_plain(
        x: torch.Tensor, stack: Dict[str, torch.Tensor],
        k_caches: torch.Tensor, v_caches: torch.Tensor,
        prefix_k: torch.Tensor, prefix_v: torch.Tensor,
        anc_local: Optional[torch.Tensor], pos: int, *, num_heads: int,
        beam_size: int, scale: float, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, layer by layer with the same
    numerics. Appends in place; returns ``(hidden [Bk, H], k_caches,
    v_caches)``."""
    H = x.shape[1]
    w = stack
    for li in range(k_caches.shape[0]):
        h = layer_norm(x, w["g1"][li], w["b1"][li], eps)
        q, k_new, v_new = (t.contiguous() for t in dense(
            h, w["wqkv"][li], w["bqkv"][li]).split(H, dim=-1))
        att, _, _ = beam_decode_attention_plain(
            q, k_new, v_new, k_caches[li], v_caches[li], prefix_k[li],
            prefix_v[li], anc_local, pos, num_heads=num_heads,
            beam_size=beam_size, scale=scale)
        x = x + dense(att, w["wo"][li], w["bo"][li])
        h = layer_norm(x, w["g2"][li], w["b2"][li], eps)
        u = gelu_new(dense(h, w["wfc"][li], w["bfc"][li]))
        x = x + dense(u, w["wpj"][li], w["bpj"][li])
    return x, k_caches, v_caches


def _check(x, stack, k_caches, v_caches, prefix_k, prefix_v, anc_local, pos,
           num_heads, beam_size):
    """Raise on anything the CUDA kernel does not take; returns the prefix
    length."""
    check_dtype("beam_decode_stack", x)
    if x.dim() != 2 or k_caches.dim() != 4 or prefix_k.dim() != 4:
        raise ValueError(f"expected x [Bk, H], caches [L, Bk, S, H] and "
                         f"prefix [L, B, P, H], got {tuple(x.shape)}, "
                         f"{tuple(k_caches.shape)}, {tuple(prefix_k.shape)}")
    Bk, H = x.shape
    L = k_caches.shape[0]
    check_widths("beam_decode_stack", H, num_heads)
    check_tensor("x", x, (Bk, H), x.dtype, x.device, aligned=True)
    check_stack(stack, L, H, 4 * H, x.dtype, x.device)
    for name, t in (("k_caches", k_caches), ("v_caches", v_caches)):
        check_tensor(name, t, k_caches.shape, x.dtype, x.device)
    for name, t in (("prefix_k", prefix_k), ("prefix_v", prefix_v)):
        if t.shape[0] != L:
            raise ValueError(f"{name} holds {t.shape[0]} layers, the caches "
                             f"{L}")
        check_tensor(name, t, prefix_k.shape, x.dtype, x.device)
    # one layer's slices are what the attention takes
    return _check_caches(x, k_caches[0], v_caches[0], prefix_k[0],
                         prefix_v[0], anc_local, pos, num_heads, beam_size)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The library's C entry point, built and typed once per process."""
    fn = load_library("beam_decode_stack").beam_decode_stack
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 21
                   + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x, stack, k_caches, v_caches, prefix_k, prefix_v, anc_local,
            pos, num_heads, beam_size, scale, eps):
    P = _check(x, stack, k_caches, v_caches, prefix_k, prefix_v, anc_local,
               pos, num_heads, beam_size)
    fn = _kernel_fn()
    Bk, H = x.shape
    L, _, S, _ = k_caches.shape
    out = torch.empty_like(x)
    stream = current_stream(x.device)
    scratch = scratch_buffer("beam_decode_stack", (Bk, 10 * H), x.dtype,
                             x.device, stream)
    err = fn(DTYPES[x.dtype], x.device.index, out.data_ptr(),
             scratch.data_ptr(), x.data_ptr(),
             *(stack[k].data_ptr() for k in STACK_KEYS),
             k_caches.data_ptr(), v_caches.data_ptr(), prefix_k.data_ptr(),
             prefix_v.data_ptr(),
             anc_local.data_ptr() if anc_local is not None else None,
             error_word(ANC_ERROR, x.device).data_ptr(), L, Bk, beam_size, S,
             P, H, num_heads, int(pos), float(scale), float(eps), stream)
    if err != 0:
        raise launch_error("beam_decode_stack", err, S, P)
    beam_decode_stack.launches += 1
    return out, k_caches, v_caches


def beam_decode_stack(
        x: torch.Tensor, stack: Dict[str, torch.Tensor],
        k_caches: torch.Tensor, v_caches: torch.Tensor,
        prefix_k: torch.Tensor, prefix_v: torch.Tensor,
        anc_local: Optional[torch.Tensor], pos: int, *, num_heads: int,
        beam_size: int, scale: float, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All decoder layers of one decode step.

    x [Bk, H] is the post-embedding residual stream; ``stack`` holds the
    layer-stacked weights (:func:`..params.stack_layer_weights`: wqkv
    [L, 3H, H], bqkv [L, 3H], wo [L, H, H], bo [L, H], the LayerNorm
    scales and biases g1, b1, g2, b2 [L, H] in float32, wfc [L, 4H, H],
    bfc [L, 4H], wpj [L, H, 4H], bpj [L, H]); k_caches/v_caches
    [L, Bk, S, H] are appended at ``pos`` in place; prefix_k/prefix_v
    [L, B, P, H]; anc_local [Bk, S] int32 or None.

    Returns ``(hidden [Bk, H], k_caches, v_caches)``: the last layer's
    residual stream, before ``ln_f``. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (counted once per call in
    ``beam_decode_stack.launches``) or raises.
    """
    args = (x, stack, k_caches, v_caches, prefix_k, prefix_v, anc_local,
            pos)
    check_no_grad("beam_decode_stack", x, k_caches, v_caches, prefix_k,
                  prefix_v, *stack.values())
    if x.device.type == "cuda":
        return _launch(*args, num_heads, beam_size, scale, eps)
    if x.device.type == "cpu":
        return beam_decode_stack_plain(*args, num_heads=num_heads,
                                       beam_size=beam_size, scale=scale,
                                       eps=eps)
    raise ValueError(f"beam_decode_stack has no kernel for {x.device}")


beam_decode_stack.launches = 0
