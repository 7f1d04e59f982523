"""Every kernel wrapper of the port is inference only: none has a backward
(the JAX package's Pallas kernels have no VJP either). Each raises before
it dispatches when autograd would need a gradient through it, on any
device, and runs under ``torch.no_grad()``."""

import pytest
import torch

from image_captioning_ml_project_tpu_torch.ops import additive_scores as adds
from image_captioning_ml_project_tpu_torch.ops import beam_decode_attention \
    as bda
from image_captioning_ml_project_tpu_torch.ops import beam_decode_stack as bds
from image_captioning_ml_project_tpu_torch.ops import cross_attention as ca
from image_captioning_ml_project_tpu_torch.ops import dense_layer as dl
from image_captioning_ml_project_tpu_torch.ops import encoder_stack as es
from image_captioning_ml_project_tpu_torch.ops import lse
from image_captioning_ml_project_tpu_torch.ops import sdpa
from image_captioning_ml_project_tpu_torch.ops._checks import (LN_KEYS,
                                                                stack_shapes)

B, K, S, P, NH, H = 2, 3, 5, 2, 2, 16
Bk = B * K


def _randn(*shape):
    return torch.randn(shape, generator=_randn.g)


_randn.g = torch.Generator().manual_seed(0)


def _stack(L=1):
    return {k: (_randn(*s) * 0.1 + (1.0 if k[0] == "g" else 0.0)
                if k in LN_KEYS else _randn(*s) * 0.1)
            for k, s in stack_shapes(L, H, 4 * H).items()}


# (wrapper, a call of it on fresh CPU inputs whose first tensor is `x`)
_CALLS = {
    "beam_decode_attention": lambda x: bda.beam_decode_attention(
        x, _randn(Bk, H), _randn(Bk, H), _randn(Bk, S, H), _randn(Bk, S, H),
        None, None, None, 2, num_heads=NH, beam_size=K, scale=0.25),
    "beam_decode_attention_qkv": lambda x: bda.beam_decode_attention_qkv(
        x, _randn(3 * H, H), _randn(3 * H), _randn(H, H), _randn(H),
        _randn(Bk, S, H), _randn(Bk, S, H), _randn(B, P, H),
        _randn(B, P, H), None, 2, num_heads=NH, beam_size=K, scale=0.25),
    "beam_decode_stack": lambda x: bds.beam_decode_stack(
        x, _stack(), _randn(1, Bk, S, H), _randn(1, Bk, S, H),
        _randn(1, B, P, H), _randn(1, B, P, H), None, 2, num_heads=NH,
        beam_size=K, scale=0.25),
    "encoder_stack": lambda x: es.encoder_stack(
        x.view(B, K, H), _stack(), num_heads=NH),
    "cross_attention": lambda x: ca.cross_attention(
        x, _randn(B, H, 7), _randn(B, 7, H), None, num_heads=NH,
        beam_size=K, scale=0.25),
    "sdpa": lambda x: sdpa.sdpa(
        x.view(Bk, NH, 1, H // NH), _randn(B, NH, 7, H // NH),
        _randn(B, NH, 7, H // NH), None, scale=0.25, beam_size=K),
    "additive_scores": lambda x: adds.additive_scores(
        x.view(Bk, 1, H), _randn(B, 7, H), _randn(H), _randn(1), None,
        temperature=1.0, beam_size=K),
    "dense_layer": lambda x: dl.dense_layer(x, _randn(8, H), _randn(8)),
    "lse_and_block_max": lambda x: lse.lse_and_block_max(x),
}


@pytest.mark.parametrize("name", sorted(_CALLS))
def test_wrapper_refuses_a_gradient_and_runs_without_one(name):
    call = _CALLS[name]
    x = _randn(Bk, H).requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{name} is inference only"):
        call(x)
    with torch.no_grad():
        out = call(x)
    first = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(first).all()
