"""Additive (Bahdanau) attention scores of the soft cross-attention variant:
the hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``image_captioning_ml_project_tpu.ops.pallas_attention.
fused_additive_scores`` (the Pallas TPU kernel): the masked scores
``energy(tanh(q_proj + k_proj)) / temperature`` of every query row against
its image's projected keys, in float32, without the ``[rows, Q, S, H]``
broadcast sum ever reaching device memory. The softmax is left to the
caller, as there.

The order of operations is the JAX function's, which is not its XLA
path's ``(dot + b) / temperature``: the f32 dot with the energy vector,
then ``/ temperature``, then -1e9 on masked keys, then ``+ energy_b /
temperature`` (the bias divided in its own dtype) on every score. The JAX
function and the plain version add the bias outside the kernel; the CUDA
kernel adds it itself, in the same order. The dtype flow is the Pallas
kernel's: the sum ``q_proj + k_proj`` and its tanh are each rounded to the
input dtype (bf16 at bf16), the products with the energy vector are summed
in f32. In float32 every rounding is the identity.

The projected keys are per image and shared by the image's ``beam_size``
query rows; with ``beam_size=1`` this is exactly the JAX function's
layout. The TPU paddings (query rows to 8, keys and width to 128 lanes) are
left out. :func:`additive_scores` dispatches on the tensors' device: a CPU
tensor takes :func:`additive_scores_plain`; a CUDA tensor launches
``csrc/additive_scores.cu`` (see the note there for what bounds it on the
card and how the design answers) or raises.
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


def additive_scores_plain(q_proj: torch.Tensor, k_proj: torch.Tensor,
                          energy_w: torch.Tensor,
                          key_padding_mask: Optional[torch.Tensor], *,
                          temperature: float,
                          beam_size: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the energy bias not added),
    with the same numerics. It materialises the broadcast sum."""
    Bq, Q, H = q_proj.shape
    B, S, _ = k_proj.shape
    t = torch.tanh(q_proj.reshape(B, beam_size * Q, 1, H)
                   + k_proj[:, None, :, :])
    scores = torch.matmul(t.float(), energy_w.reshape(H).float())
    scores = scores / temperature
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask.bool()[:, None, :],
                                    _NEG_INF)
    return scores.reshape(Bq, Q, S)


def _check_shapes(q_proj, k_proj, energy_w, energy_b, key_padding_mask,
                  beam_size):
    """Raise on dtypes and shapes that do not fit together (on any device,
    before any launch)."""
    check_dtype("additive_scores", q_proj)
    if q_proj.dim() != 3 or k_proj.dim() != 3:
        raise ValueError(f"expected q_proj [rows, Q, H] and k_proj [B, S, H],"
                         f" got {tuple(q_proj.shape)} and "
                         f"{tuple(k_proj.shape)}")
    Bq, Q, H = q_proj.shape
    B, S, Hk = k_proj.shape
    if beam_size < 1 or Bq != B * beam_size:
        raise ValueError(f"rows {Bq} != images {B} x beams {beam_size}")
    if Hk != H or energy_w.numel() != H or energy_b.numel() != 1:
        raise ValueError(f"widths differ: q_proj {H}, k_proj {Hk}, energy_w "
                         f"{tuple(energy_w.shape)}, energy_b "
                         f"{tuple(energy_b.shape)}")
    if min(Q, S, H) < 1:
        raise ValueError(f"empty scores: Q={Q}, S={S}, H={H}")
    if key_padding_mask is not None and \
            tuple(key_padding_mask.shape) != (B, S):
        raise ValueError(f"key_padding_mask shape "
                         f"{tuple(key_padding_mask.shape)} != {(B, S)}")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The library's C entry point, built and typed once per process."""
    fn = load_library("additive_scores").additive_scores
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q_proj, k_proj, energy_w, energy_b, key_padding_mask,
            temperature, beam_size):
    Bq, Q, H = q_proj.shape
    B, S, _ = k_proj.shape
    dev, dt = q_proj.device, q_proj.dtype
    if H * q_proj.element_size() % 16:
        raise ValueError(f"additive_scores kernel reads rows in 16-byte "
                         f"chunks: width {H} in {dt} is not a whole number "
                         f"of them")
    check_tensor("q_proj", q_proj, (Bq, Q, H), dt, dev, aligned=True)
    check_tensor("k_proj", k_proj, (B, S, H), dt, dev, aligned=True)
    check_tensor("energy_w", energy_w, tuple(energy_w.shape), dt, dev,
                 aligned=True)
    check_tensor("energy_b", energy_b, tuple(energy_b.shape), dt, dev)
    if key_padding_mask is not None:
        check_tensor("key_padding_mask", key_padding_mask, (B, S),
                     torch.bool, dev)
    out = torch.empty((Bq, Q, S), dtype=torch.float32, device=dev)
    stream = current_stream(dev)
    err = _kernel_fn()(
        DTYPES[dt], dev.index, out.data_ptr(), q_proj.data_ptr(),
        k_proj.data_ptr(), energy_w.data_ptr(), energy_b.data_ptr(),
        key_padding_mask.data_ptr() if key_padding_mask is not None
        else None, B, beam_size, Q, S, H, float(temperature), stream)
    if err != 0:
        raise RuntimeError(f"additive_scores kernel launch failed: cudaError "
                           f"{err} (width {H})")
    additive_scores.launches += 1
    return out


def additive_scores(q_proj: torch.Tensor, k_proj: torch.Tensor,
                    energy_w: torch.Tensor, energy_b: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor], *,
                    temperature: float, beam_size: int = 1) -> torch.Tensor:
    """Masked additive-attention scores over per-image keys.

    q_proj [rows, Q, H], with rows = B * beam_size and row r belonging to
    image r // beam_size; k_proj [B, S, H]; energy_w the H weights of the
    energy projection (any shape of H elements) and energy_b its bias (one
    element); key_padding_mask [B, S] bool (True = padding) or None.
    Returns the scores [rows, Q, S] in float32. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (counted in
    ``additive_scores.launches``) or raises.
    """
    _check_shapes(q_proj, k_proj, energy_w, energy_b, key_padding_mask,
                  beam_size)
    check_no_grad("additive_scores", q_proj, k_proj, energy_w, energy_b)
    if q_proj.device.type == "cuda":
        return _launch(q_proj, k_proj, energy_w, energy_b, key_padding_mask,
                       temperature, beam_size)
    if q_proj.device.type != "cpu":
        raise ValueError(f"additive_scores has no kernel for "
                         f"{q_proj.device}")
    scores = additive_scores_plain(q_proj, k_proj, energy_w,
                                   key_padding_mask, temperature=temperature,
                                   beam_size=beam_size)
    # the bias is the same for every (row, key): added after the scores,
    # divided by the temperature in its own dtype, as the JAX function does
    # (the kernel adds it in the same order)
    return scores + energy_b.reshape(()) / temperature


additive_scores.launches = 0
