"""Whole-stack CLIP encoder (port: ops/encoder_stack.py) against the JAX
package's Pallas kernel ``fused_encoder_stack`` in interpret mode, run as
the JAX package runs it (token axis padded to 16 rows, padded keys
masked), and the wrapper's checks. The kernel itself is held against this
plain version on the card in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.ops.pallas_encoder import (
    fused_encoder_stack)
from image_captioning_ml_project_tpu_torch.ops import encoder_stack as es

torch.set_num_threads(1)

B, L, H, NH, F = 3, 2, 64, 4, 256
MATRICES = ("wqkv", "wo", "wfc", "wpj")


def _inputs(seed, T):
    rs = np.random.RandomState(seed)
    shapes = {"wqkv": (H, 3 * H), "bqkv": (3 * H,), "wo": (H, H),
              "bo": (H,), "g1": (H,), "b1": (H,), "g2": (H,), "b2": (H,),
              "wfc": (H, F), "bfc": (F,), "wpj": (F, H), "bpj": (H,)}
    stack = {k: (rs.randn(L, *shp) * (0.05 if k[0] == "w" else 0.02))
             .astype(np.float32) for k, shp in shapes.items()}
    stack["g1"] += 1.0
    stack["g2"] += 1.0
    return stack, rs.randn(B, T, H).astype(np.float32)


def _port_stack(stack):
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(0, 2, 1) if k in MATRICES else v))
        for k, v in stack.items()}


@pytest.mark.parametrize("T", [5, 16, 50])
def test_plain_matches_pallas_kernel(T):
    """Unpadded plain version against the Pallas kernel on the token axis
    padded to 16 rows (padded rows dropped): f32 to atol 1e-5."""
    stack, x = _inputs(T, T)
    tpad = -(-T // 16) * 16
    xp = np.pad(x, ((0, 0), (0, tpad - T), (0, 0)))
    want = fused_encoder_stack(jnp.asarray(xp),
                               {k: jnp.asarray(v) for k, v in stack.items()},
                               T, num_heads=NH, interpret=True)[:, :T]
    with torch.inference_mode():
        got = es.encoder_stack(torch.from_numpy(x), _port_stack(stack),
                               num_heads=NH)
    assert got.shape == (B, T, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_raises_when_autograd_would_need_its_gradient():
    stack, x = _inputs(0, 5)
    w = _port_stack(stack)
    xt = torch.from_numpy(x).requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference only"):
        es.encoder_stack(xt, w, num_heads=NH)
    with torch.no_grad():
        es.encoder_stack(xt, w, num_heads=NH)


@pytest.mark.parametrize("change, match", [
    (lambda x, w: (x.half(), w), "float32 or bfloat16"),
    (lambda x, w: (x[0], w), "expected x"),
    (lambda x, w: (x, dict(w, wpj=w["wpj"][:1])), "wpj shape"),
    (lambda x, w: (x, dict(w, b2=w["b2"].to(torch.bfloat16))), "b2 is"),
    (lambda x, w: (x.transpose(0, 1).contiguous().transpose(0, 1), w),
     "contiguous"),
    (lambda x, w: (torch.zeros(1, 600, H), w), "shared memory"),
])
def test_kernel_checks_raise_on_what_it_does_not_take(change, match):
    stack, x = _inputs(1, 5)
    xt, w = change(torch.from_numpy(x), _port_stack(stack))
    with pytest.raises((TypeError, ValueError), match=match):
        es._check(xt, w, NH)


def test_kernel_checks_accept_served_layout():
    stack, x = _inputs(2, 50)
    w = {k: (v if k in ("g1", "b1", "g2", "b2") else v.to(torch.bfloat16))
         for k, v in _port_stack(stack).items()}
    assert es._check(torch.from_numpy(x).to(torch.bfloat16), w, NH) == (L, F)


def test_cpu_tensor_takes_plain_version_without_counting():
    stack, x = _inputs(4, 7)
    before = es.encoder_stack.launches
    with torch.inference_mode():
        got = es.encoder_stack(torch.from_numpy(x), _port_stack(stack),
                               num_heads=NH)
        want = es.encoder_stack_plain(torch.from_numpy(x),
                                      _port_stack(stack), num_heads=NH)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert es.encoder_stack.launches == before
