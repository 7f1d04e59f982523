"""The attention zoo (port: models/attention.py) and its two kernels' plain
versions (port: ops/sdpa.py, ops/additive_scores.py) against the JAX
package, on the same inputs made with numpy from a seed.

* The plain SDPA and additive scores against the JAX package's Pallas
  kernels ``fused_sdpa`` and ``fused_additive_scores`` in interpret mode:
  with and without a mask, key rows not a multiple of 8, widths not a
  multiple of 128, Q of 1 and 5, and per-image keys shared by 1, 3 or 5
  beam rows (the JAX kernels get the keys tiled over the beams, their own
  layout).
* An image whose keys are all masked: the port's SDPA and multi-head
  module give weights 1/S over its keys, as the JAX package's XLA path
  (``use_pallas=False``) does; JAX's Pallas kernel, whose padded keys
  join that softmax, puts S / 128 of weight on them, which the port does
  not copy.
* Each variant (soft, multi-head, adaptive, AoA; the adaptive and AoA
  variants on both cores) with ``use_pallas`` off and on, 2-D and 3-D
  queries, against the flax module with the same weights, bridged by
  ``params.from_flax``'s attention rules; and with the keys per image and
  the queries per beam, against the flax module on tiled keys.

Tolerances: float32 1e-5 (sums in another order; the JAX kernels' TPU
paddings add exact zeros); bfloat16 kernel contexts two bf16 ulps of the
largest magnitude (a weight within an f32 rounding of a bf16 boundary
rounds the other way)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.config import (AttentionConfig,
                                                     AttentionType)
from image_captioning_ml_project_tpu.models.attention import (
    build_attention as jax_build_attention)
from image_captioning_ml_project_tpu.ops.pallas_attention import (
    fused_additive_scores, fused_sdpa)
from image_captioning_ml_project_tpu_torch import config as port_config
from image_captioning_ml_project_tpu_torch import params as port_params
from image_captioning_ml_project_tpu_torch.models.attention import (
    build_attention)
from image_captioning_ml_project_tpu_torch.ops import additive_scores as adds
from image_captioning_ml_project_tpu_torch.ops import sdpa as port_sdpa
from torch_port_helpers import bf16_ulp

torch.set_num_threads(1)


def _mask(rs, B, S):
    mask = rs.rand(B, S) < 0.3
    mask[:, 0] = False  # never a whole row
    return mask


# (images, beams, Q, S, NH, hd, masked)
_SDPA_CASES = [
    (2, 1, 1, 13, 2, 24, True),    # S and hd unaligned, one query
    (2, 1, 5, 16, 4, 8, False),    # Q = 5, no mask
    (2, 3, 1, 13, 2, 24, True),    # per-image keys, 3 beams
    (1, 3, 5, 7, 1, 40, True),     # 3 beams x 5 queries, one head
    (2, 5, 1, 49, 2, 16, True),    # the served 5 beams x 1 query, 7x7 keys
]


@pytest.mark.parametrize("B,K,Q,S,NH,hd,masked", _SDPA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_plain_matches_jax_kernel(B, K, Q, S, NH, hd, masked, dtype):
    rs = np.random.RandomState(B * 100 + K * 10 + Q + S)
    q = rs.randn(B * K, NH, Q, hd).astype(np.float32)
    k = rs.randn(B, NH, S, hd).astype(np.float32)
    v = rs.randn(B, NH, S, hd).astype(np.float32)
    mask = _mask(rs, B, S) if masked else None
    scale = hd ** -0.5
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ctx, w = port_sdpa.sdpa(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), scale=scale,
        beam_size=K)
    tile = (lambda a: None if a is None else np.repeat(a, K, axis=0))
    want_ctx, want_w = fused_sdpa(
        jnp.asarray(q, jdt), jnp.asarray(tile(k), jdt),
        jnp.asarray(tile(v), jdt),
        None if mask is None else jnp.asarray(tile(mask)), scale)
    assert ctx.shape == (B * K, NH, Q, hd) and ctx.dtype == tdt
    assert w.shape == (B * K, NH, Q, S) and w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=1e-5,
                               rtol=1e-5)
    got, want = ctx.float().numpy(), np.asarray(want_ctx.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2 * bf16_ulp(want)


# (images, beams, Q, S, H, masked)
_ADDITIVE_CASES = [
    (2, 1, 1, 13, 24, True),
    (2, 1, 5, 16, 40, False),
    (2, 3, 1, 13, 24, True),
    (1, 3, 5, 7, 136, True),
]


@pytest.mark.parametrize("B,K,Q,S,H,masked", _ADDITIVE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_additive_scores_plain_matches_jax_kernel(B, K, Q, S, H, masked,
                                                  dtype):
    """f32: 1e-5 of the largest unmasked score. bf16: the plain version
    rounds the sum and the tanh to bf16, as the Pallas kernel is written;
    XLA on the CPU may keep either in f32 (it allows excess precision), so
    each tanh term may differ by its bf16 rounding (under 2^-8 for
    |tanh| < 1) plus the sum's rounding carried through the tanh (under
    2^-9): 2^-7 per term, weighted by its energy weight."""
    rs = np.random.RandomState(B * 100 + K * 10 + Q + H)
    qp = (rs.randn(B * K, Q, H) * 0.5).astype(np.float32)
    kp = (rs.randn(B, S, H) * 0.5).astype(np.float32)
    ew = (rs.randn(H, 1) * 0.2).astype(np.float32)
    eb = rs.randn(1).astype(np.float32)
    mask = _mask(rs, B, S) if masked else None
    temperature = 0.7
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = adds.additive_scores(
        *(torch.from_numpy(a).to(tdt) for a in (qp, kp, ew, eb)),
        None if mask is None else torch.from_numpy(mask),
        temperature=temperature, beam_size=K).numpy()
    want = np.asarray(fused_additive_scores(
        jnp.asarray(qp, jdt), jnp.asarray(np.repeat(kp, K, axis=0), jdt),
        jnp.asarray(ew, jdt), jnp.asarray(eb, jdt),
        None if mask is None else jnp.asarray(np.repeat(mask, K, axis=0)),
        temperature))
    assert got.shape == (B * K, Q, S) and got.dtype == np.float32
    keep = want > -1e8
    np.testing.assert_array_equal(got[~keep], want[~keep])
    err = np.abs(got - want)[keep].max()
    tol = 1e-5 * np.abs(want[keep]).max()
    if dtype == "bfloat16":
        tol += np.abs(ew).sum() * 2.0 ** -7 / temperature
    assert err <= tol


def _xla_sdpa(q, k, v, mask, scale):
    """The JAX package's ``use_pallas=False`` arithmetic
    (``models/attention.py`` ``MultiHeadAttention``) on [B, NH, T, hd]
    arrays."""
    scores = jnp.einsum("bhqd,bhsd->bhqs", q, k,
                        preferred_element_type=jnp.float32) * scale
    scores = jnp.where(mask[:, None, None, :], -1e9, scores)
    w = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhqs,bhsd->bhqd", w.astype(v.dtype), v), w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_all_masked_image_matches_the_xla_path(dtype):
    """Image 0 has every key masked, image 1 a random mask, 3 beams each:
    the port's SDPA gives image 0 weights 1/S over its S real keys (the
    context the mean of its values), as the JAX package's XLA path does.
    JAX's Pallas ``fused_sdpa`` pads the keys to 128 masked lanes, so its
    softmax there runs over 128 lanes and the S real weights sum to
    S / 128: a quirk of the reference, which the port does not copy.
    Image 1 agrees with both."""
    B, K, Q, S, NH, hd = 2, 3, 1, 13, 2, 16
    rs = np.random.RandomState(21)
    q = rs.randn(B * K, NH, Q, hd).astype(np.float32)
    k = rs.randn(B, NH, S, hd).astype(np.float32)
    v = rs.randn(B, NH, S, hd).astype(np.float32)
    mask = _mask(rs, B, S)
    mask[0] = True
    scale = hd ** -0.5
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ctx, w = port_sdpa.sdpa(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                            torch.from_numpy(mask), scale=scale, beam_size=K)
    tile = (lambda a: np.repeat(a, K, axis=0))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, tile(k), tile(v)))
    want_ctx, want_w = _xla_sdpa(jq, jk, jv, jnp.asarray(tile(mask)), scale)
    np.testing.assert_allclose(w[:K].numpy(), 1.0 / S, atol=1e-7, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=1e-5,
                               rtol=1e-5)
    got, want = ctx.float().numpy(), np.asarray(want_ctx.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2 * bf16_ulp(want)
    pallas_ctx, pallas_w = fused_sdpa(jq, jk, jv,
                                      jnp.asarray(tile(mask)), scale)
    pallas_w = np.asarray(pallas_w)
    np.testing.assert_allclose(pallas_w[:K].sum(-1), S / 128, rtol=1e-5)
    np.testing.assert_allclose(pallas_w[K:], w[K:].numpy(), atol=1e-5,
                               rtol=1e-5)
    assert np.abs(np.asarray(pallas_ctx[:K].astype(jnp.float32))
                  - got[:K]).max() > 0.1


def test_masked_keys_add_nothing_to_the_context():
    """Masking a key equals dropping its row."""
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(*s).astype(np.float32))
               for s in ((2, 2, 1, 8), (2, 2, 9, 8), (2, 2, 9, 8)))
    mask = torch.zeros((2, 9), dtype=torch.bool)
    mask[:, 4] = True
    keep = [j for j in range(9) if j != 4]
    got = port_sdpa.sdpa(q, k, v, mask, scale=0.3)[0]
    want = port_sdpa.sdpa(q, k[:, :, keep], v[:, :, keep], None,
                          scale=0.3)[0]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("change,match", [
    (lambda a: (a[0][:5],) + a[1:], "rows 5 != images 2 x beams 3"),
    (lambda a: (a[0], a[1], a[2][:, :, :4], a[3]), "k and v must be"),
    (lambda a: (a[0], a[1][:, :1], a[2], a[3]), "k and v must be"),
    (lambda a: a[:3] + (a[3][:, :4],), "key_padding_mask shape"),
    (lambda a: (a[0][0],) + a[1:], "expected q"),
])
def test_sdpa_wrapper_raises_on_shapes_that_do_not_fit(change, match):
    args = (torch.zeros(6, 2, 1, 8), torch.zeros(2, 2, 5, 8),
            torch.zeros(2, 2, 5, 8), torch.zeros(2, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match=match):
        port_sdpa.sdpa(*change(args), scale=1.0, beam_size=3)


@pytest.mark.parametrize("change,match", [
    (lambda a: (a[0][:5],) + a[1:], "rows 5 != images 2 x beams 3"),
    (lambda a: (a[0], a[1][:, :, :4]) + a[2:], "widths differ"),
    (lambda a: a[:2] + (a[2][:, :4],) + a[3:], "widths differ"),
    (lambda a: a[:4] + (a[4][:, :4],), "key_padding_mask shape"),
    (lambda a: (a[0][0],) + a[1:], "expected q_proj"),
])
def test_additive_wrapper_raises_on_shapes_that_do_not_fit(change, match):
    args = (torch.zeros(6, 1, 8), torch.zeros(2, 5, 8), torch.zeros(1, 8),
            torch.zeros(1), torch.zeros(2, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match=match):
        adds.additive_scores(*change(args), temperature=1.0, beam_size=3)


@pytest.mark.parametrize("change,error,match", [
    (lambda a: tuple(t.half() for t in a[:4]) + a[4:], TypeError,
     "float32 or bfloat16"),
    (lambda a: tuple(t.double() for t in a[:4]) + a[4:], TypeError,
     "float32 or bfloat16"),
    (lambda a: (a[0][:, :0],) + a[1:], ValueError, "empty scores"),
    (lambda a: (a[0], a[1][:, :0]) + a[2:4] + (a[4][:, :0],), ValueError,
     "empty scores"),
], ids=["float16", "float64", "no queries", "no keys"])
def test_additive_wrapper_raises_before_any_launch(change, error, match):
    """Dtypes and empty inputs raise on any device, before the
    dispatch."""
    args = (torch.zeros(6, 1, 8), torch.zeros(2, 5, 8), torch.zeros(1, 8),
            torch.zeros(1), torch.zeros(2, 5, dtype=torch.bool))
    before = adds.additive_scores.launches
    with pytest.raises(error, match=match):
        adds.additive_scores(*change(args), temperature=1.0, beam_size=3)
    assert adds.additive_scores.launches == before


def test_wrappers_dispatch_on_the_device():
    q, k = torch.zeros(2, 1, 1, 8), torch.zeros(2, 1, 3, 8)
    with pytest.raises(ValueError, match="no kernel for meta"):
        port_sdpa.sdpa(q.to("meta"), k.to("meta"), k.to("meta"), None,
                       scale=1.0)
    qp, kp, w, b = (torch.zeros(2, 1, 8), torch.zeros(2, 3, 8),
                    torch.zeros(8), torch.zeros(1))
    with pytest.raises(ValueError, match="no kernel for meta"):
        adds.additive_scores(*(t.to("meta") for t in (qp, kp, w, b)), None,
                             temperature=1.0)
    before = (port_sdpa.sdpa.launches, adds.additive_scores.launches)
    port_sdpa.sdpa(q, k, k, None, scale=1.0)
    adds.additive_scores(qp, kp, w, b, None, temperature=1.0)
    assert (port_sdpa.sdpa.launches,
            adds.additive_scores.launches) == before  # the CPU launches none


# ---------------------------------------------------------------------------
# The variants against the flax modules
# ---------------------------------------------------------------------------

HID = 32  # the attention width


def _dims(attention):
    """(query width, memory width): distinct where the variant allows it;
    the adaptive sentinel mixes query-, memory- and attention-wide vectors,
    so there all three agree."""
    return (HID, HID) if attention == "adaptive" else (24, 20)


def _configs(attention, heads, use_pallas):
    kw = dict(attention_type=attention, num_heads=heads, hidden_dim=HID,
              temperature=0.8, use_pallas=use_pallas)
    return (AttentionConfig(**dict(kw, attention_type=AttentionType(
                attention))),
            port_config.AttentionConfig(**dict(
                kw, attention_type=port_config.AttentionType(attention))))


def _modules(attention, heads, use_pallas, seed):
    """The flax module and its params, and the port's module with the same
    weights. Adaptive needs the sentinel states, whose width is the
    query's."""
    jcfg, pcfg = _configs(attention, heads, use_pallas)
    jmod = jax_build_attention(jcfg)
    QD, MD = _dims(attention)
    rs = np.random.RandomState(seed)
    q, kv = rs.randn(2, QD), rs.randn(2, 5, MD)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(q),
                       jnp.asarray(kv), jnp.asarray(kv),
                       memory_state=jnp.asarray(q),
                       cell_state=jnp.asarray(q))
    br = port_params._Bridge(port_params._flatten(params["params"]))
    # pre-fix both sides with a name, as from_flax finds the attention
    br.flat = {f"a/{k}": v for k, v in br.flat.items()}
    port_params._attention(br, "a", "a")
    assert not br.flat
    pmod = build_attention(pcfg, query_dim=QD, memory_dim=MD)
    pmod.load_state_dict({k[2:]: v for k, v in br.out.items()}, strict=True)
    return jmod, params, pmod.eval()


_VARIANTS = [("soft", 1), ("multi_head", 4), ("adaptive", 1),
             ("adaptive", 4), ("aoa", 1), ("aoa", 4)]


@pytest.mark.parametrize("attention,heads", _VARIANTS)
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "kernel"])
@pytest.mark.parametrize("query_dims", [2, 3])
def test_variant_matches_jax(attention, heads, use_pallas, query_dims):
    """f32, 2 batch rows, 7 keys (the last two masked in row 1), 3 queries
    for 3-D queries."""
    jmod, params, pmod = _modules(attention, heads, use_pallas, seed=1)
    QD, MD = _dims(attention)
    rs = np.random.RandomState(7)
    qshape = (2, QD) if query_dims == 2 else (2, 3, QD)
    q = rs.randn(*qshape).astype(np.float32)
    kv = rs.randn(2, 7, MD).astype(np.float32)
    states = rs.randn(2, 2, QD).astype(np.float32)
    mask = np.zeros((2, 7), bool)
    mask[1, 5:] = True
    want_ctx, want_w = jmod.apply(
        params, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
        key_padding_mask=jnp.asarray(mask),
        memory_state=jnp.asarray(states[0]), cell_state=jnp.asarray(states[1]))
    t = torch.from_numpy
    with torch.inference_mode():
        ctx, w = pmod(t(q), t(kv), t(kv), key_padding_mask=t(mask),
                      memory_state=t(states[0]), cell_state=t(states[1]))
    assert ctx.shape == want_ctx.shape and w.shape == want_w.shape
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("attention,heads", [("soft", 1), ("multi_head", 4)])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "kernel"])
def test_per_image_memory_matches_jax_on_tiled_keys(attention, heads,
                                                    use_pallas):
    """Keys and values per image, queries per beam (3 beams of 2 images):
    the port's ``project_memory`` + ``attend`` against the flax module on
    keys, values and mask tiled over the beams."""
    jmod, params, pmod = _modules(attention, heads, use_pallas, seed=2)
    QD, MD = _dims(attention)
    rs = np.random.RandomState(8)
    K = 3
    q = rs.randn(2 * K, QD).astype(np.float32)
    kv = rs.randn(2, 6, MD).astype(np.float32)
    mask = np.zeros((2, 6), bool)
    mask[0, 4:] = True
    tile = (lambda a: jnp.asarray(np.repeat(a, K, axis=0)))
    want_ctx, want_w = jmod.apply(params, jnp.asarray(q), tile(kv), tile(kv),
                                  key_padding_mask=tile(mask))
    t = torch.from_numpy
    with torch.inference_mode():
        memory = pmod.project_memory(t(kv), t(kv))
        ctx, w = pmod.attend(t(q), memory, t(mask))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=1e-5,
                               rtol=1e-5)


def test_multi_head_all_masked_image_matches_the_xla_path():
    """The multi-head module through the SDPA kernel's path
    (``use_pallas=True``) on an image whose keys are all masked: the
    head-averaged weights are 1/S and context and weights equal the flax
    module's with ``use_pallas=False``; the flax module with
    ``use_pallas=True`` (the Pallas kernel, interpret mode) puts S / 128
    of weight on them instead."""
    _, params, pmod = _modules("multi_head", 4, True, seed=3)
    xla = jax_build_attention(_configs("multi_head", 4, False)[0])
    pallas = jax_build_attention(_configs("multi_head", 4, True)[0])
    QD, MD = _dims("multi_head")
    rs = np.random.RandomState(9)
    S = 7
    q = rs.randn(2, QD).astype(np.float32)
    kv = rs.randn(2, S, MD).astype(np.float32)
    mask = np.zeros((2, S), bool)
    mask[0] = True
    mask[1, 5:] = True
    args = (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    want_ctx, want_w = xla.apply(params, *args,
                                 key_padding_mask=jnp.asarray(mask))
    t = torch.from_numpy
    with torch.inference_mode():
        ctx, w = pmod(t(q), t(kv), t(kv), key_padding_mask=t(mask))
    np.testing.assert_allclose(w[0].numpy(), 1.0 / S, atol=1e-7, rtol=0)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=1e-5,
                               rtol=1e-5)
    _, pallas_w = pallas.apply(params, *args,
                               key_padding_mask=jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(pallas_w)[0].sum(), S / 128,
                               rtol=1e-5)


@pytest.mark.parametrize("attention,heads", _VARIANTS)
def test_soft_context_keeps_the_value_dtype(attention, heads):
    """bf16 weights, bf16 inputs, kernel path: the context comes back in
    bf16 (the JAX soft path's f32 promotion is repaired), the soft
    weights in f32 as the kernel's softmax gives them."""
    _, pcfg = _configs(attention, heads, True)
    QD, MD = _dims(attention)
    pmod = build_attention(pcfg, query_dim=QD, memory_dim=MD).to(
        torch.bfloat16).eval()
    q = torch.randn(4, QD, dtype=torch.bfloat16)
    kv = torch.randn(2, 5, MD, dtype=torch.bfloat16)
    with torch.inference_mode():
        ctx, _ = pmod(q, kv, kv, memory_state=q, cell_state=q)
    assert ctx.dtype == torch.bfloat16 and ctx.shape == (4, pmod.context_dim)


def test_rows_that_do_not_split_over_the_images_raise():
    _, pcfg = _configs("soft", 1, False)
    QD, MD = _dims("soft")
    pmod = build_attention(pcfg, query_dim=QD, memory_dim=MD)
    with pytest.raises(ValueError, match="do not split over 2 images"):
        pmod(torch.zeros(3, QD), torch.zeros(2, 5, MD),
             torch.zeros(2, 5, MD))
    with pytest.raises(ValueError, match="Unsupported attention type"):
        build_attention(port_config.AttentionConfig(
            attention_type=port_config.AttentionType.OBJECT), QD, MD)
