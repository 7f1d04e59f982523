"""Cross-attention decode step (port: ops/cross_attention.py) against the
JAX package's Pallas kernel ``fused_cross_attention`` in interpret mode and
its oracle ``reference_cross_attention``, on the same inputs made with
numpy from a seed; and the wrapper's shape and error contracts.

The port's memory keeps its real rows; the JAX kernel needs an 8-aligned
memory axis, so where Sm is not a multiple of 8 it gets the memory padded
with zero rows and the padded rows masked, as the JAX decoder's
``init_memory_cache`` pads them. A masked key adds an exact 0 to the f32
softmax, so the padding changes nothing.

Tolerances: float32 1e-5 (the scores and the mix are summed in another
order); bfloat16 two bf16 ulps of the output's largest magnitude (a
softmax weight within an f32 rounding of a bf16 boundary rounds the other
way, which moves the f32 mix by under an ulp of the output)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.ops.pallas_cross import (
    fused_cross_attention, reference_cross_attention)
from image_captioning_ml_project_tpu_torch.ops import cross_attention as port
from torch_port_helpers import bf16_ulp

torch.set_num_threads(1)


def _inputs(B, K, H, Sm, masked, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B * K, H).astype(np.float32)
    mkt = rs.randn(B, H, Sm).astype(np.float32)
    mv = rs.randn(B, Sm, H).astype(np.float32)
    if masked == "random":
        mask = rs.rand(B, Sm) < 0.25
        mask[:, 0] = False  # never mask a whole row
    elif masked == "interior":  # a region mask: a run inside the row
        mask = np.zeros((B, Sm), bool)
        mask[B - 1, Sm // 4:Sm // 2 + 1] = True
    else:
        mask = None
    return q, mkt, mv, mask


def _padded(mkt, mv, mask):
    """Memory and mask padded to an 8-aligned memory axis, pad rows
    masked (what the JAX decoder hands its kernel)."""
    B, _, Sm = mkt.shape
    pad = -Sm % 8
    mask = np.zeros((B, Sm), bool) if mask is None else mask
    return (np.pad(mkt, ((0, 0), (0, 0), (0, pad))),
            np.pad(mv, ((0, 0), (0, pad), (0, 0))),
            np.pad(mask, ((0, 0), (0, pad)), constant_values=True))


def _port(q, mkt, mv, mask, dt, **kw):
    t = [torch.from_numpy(a).to(dt) for a in (q, mkt, mv)]
    m = None if mask is None else torch.from_numpy(mask)
    return port.cross_attention(*t, m, **kw).float().numpy()


@pytest.mark.parametrize("B,K,NH,H,Sm,masked", [
    (4, 5, 4, 128, 48, "random"),     # 8-aligned memory
    (4, 5, 4, 128, 48, None),         # no padding mask
    (2, 1, 2, 64, 13, "random"),      # greedy (K=1), Sm not 8-aligned
    (3, 5, 4, 128, 21, "interior"),   # interior masked run, Sm unaligned
    (2, 5, 12, 768, 196, "random"),   # the served widths and memory
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_and_oracle(B, K, NH, H, Sm, masked, dtype):
    q, mkt, mv, mask = _inputs(B, K, H, Sm, masked, seed=B * 100 + Sm)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    kw = dict(num_heads=NH, beam_size=K, scale=1.0 / (H // NH) ** 0.5)
    got = _port(q, mkt, mv, mask, getattr(torch, dtype), **kw)

    pk, pv, pm = _padded(mkt, mv, mask)
    kernel = fused_cross_attention(
        jnp.asarray(q, jdt), jnp.asarray(pk, jdt), jnp.asarray(pv, jdt),
        jnp.asarray(pm), interpret=True, **kw)
    oracle = reference_cross_attention(
        jnp.asarray(q, jdt), jnp.asarray(mkt, jdt), jnp.asarray(mv, jdt),
        None if mask is None else jnp.asarray(mask), **kw)
    assert got.shape == (B * K, H)
    for want in (kernel, oracle):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            assert np.abs(got - want).max() <= 2 * bf16_ulp(want)


def test_masked_keys_add_nothing():
    """Masking a key equals dropping its memory row."""
    q, mkt, mv, _ = _inputs(2, 3, 32, 9, None, seed=1)
    mask = np.zeros((2, 9), bool)
    mask[:, 4] = True
    kw = dict(num_heads=4, beam_size=3, scale=0.25)
    got = _port(q, mkt, mv, mask, torch.float32, **kw)
    keep = [j for j in range(9) if j != 4]
    want = _port(q, mkt[:, :, keep], mv[:, keep], None, torch.float32, **kw)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _args(B=2, K=3, H=16, Sm=5):
    return (torch.zeros(B * K, H), torch.zeros(B, H, Sm),
            torch.zeros(B, Sm, H), torch.zeros(B, Sm, dtype=torch.bool))


@pytest.mark.parametrize("change,match", [
    (lambda a: (a[0][:5],) + a[1:], "rows 5 != images 2 x beams 3"),
    (lambda a: (a[0], a[1], a[2][:, :4], a[3]), "memory must be"),
    (lambda a: (a[0], a[1][:, :8], a[2], a[3]), "memory must be"),
    (lambda a: a[:3] + (a[3][:, :4],), "pad_mask shape"),
    (lambda a: (a[0][0],) + a[1:], "expected q"),
])
def test_wrapper_raises_on_shapes_that_do_not_fit(change, match):
    with pytest.raises(ValueError, match=match):
        port.cross_attention(*change(_args()), num_heads=4, beam_size=3,
                             scale=1.0)


def test_wrapper_contracts():
    q, mkt, mv, mask = _args()
    with pytest.raises(ValueError, match="does not split into 3 heads"):
        port.cross_attention(q, mkt, mv, mask, num_heads=3, beam_size=3,
                             scale=1.0)
    with pytest.raises(ValueError, match="no kernel for meta"):
        port.cross_attention(*(t.to("meta") for t in (q, mkt, mv, mask)),
                             num_heads=4, beam_size=3, scale=1.0)
    before = port.cross_attention.launches
    out = port.cross_attention(q, mkt, mv, None, num_heads=4, beam_size=3,
                               scale=1.0)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert port.cross_attention.launches == before  # the CPU launches none


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 5, 8])
@pytest.mark.parametrize("Sm", [1, 49, 196, 197])
def test_kernel_checks_accept_served_and_ragged_memories(Sm, K, dtype):
    """The served widths (12 heads of 64, 64 images) over one memory row,
    the ResNet's 49, the ViT-B/16's 196 and a ragged 197, masked."""
    B, NH, H = 64, 12, 768
    m = lambda *s: torch.empty(*s, dtype=dtype, device="meta")  # noqa: E731
    q, mkt, mv = m(B * K, H), m(B, H, Sm), m(B, Sm, H)
    mask = torch.empty((B, Sm), dtype=torch.bool, device="meta")
    port._check_shapes(q, mkt, mv, mask, NH, K)
    port._check(q, mkt, mv, mask, NH, K)
