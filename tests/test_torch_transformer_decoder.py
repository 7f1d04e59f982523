"""Transformer decoder (port: models/decoders.py) against the JAX package
on the same weights: teacher-forced logits, and ``init_cache`` plus four
``step``s under a non-trivial beam ancestry and a memory mask with masked
positions, on both port configurations (fold, the default, and split under
``ICT_DECODE_FOLD=0``) against JAX's XLA step path, and on both against
JAX's Pallas kernels in interpret mode at width 128 (where JAX's fused
cross-attention engages). Logits to atol 1e-4 at f32 (2 layers: the sums
in another order), caches and memory K/V to 1e-5. Also the memory layout
and that the switch routes the port's decode through the kernels the JAX
package's Pallas decode uses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_captioning_ml_project_tpu.models.decoders as jax_dec
import image_captioning_ml_project_tpu.ops.pallas_decode as jax_pd
import image_captioning_ml_project_tpu_torch.models.decoders as port_dec
from image_captioning_ml_project_tpu.inference.decoding import (
    _tile_state as jax_tile_state)
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    _tile_state)
from torch_port_helpers import both_models, images_uint8, jax_images

torch.set_num_threads(1)

B, K, L, SM, V = 2, 3, 8, 7, 1000


def _models(seed, **kw):
    return both_models(seed, encoder="vit", decoder="transformer", **kw)


def _features(seed, feature_dim=64):
    """Encoder features with an interior masked memory position and a
    masked tail, as numpy arrays."""
    rs = np.random.RandomState(seed)
    mask = np.ones((B, SM), bool)
    mask[0, 2] = False
    mask[1, 5:] = False
    return {"features": rs.randn(B, SM, feature_dim).astype(np.float32),
            "pooled_features": rs.randn(B, feature_dim).astype(np.float32),
            "attention_mask": mask}


def _jax(feats):
    return {k: jnp.asarray(v) for k, v in feats.items()}


def _torch(feats):
    return {k: torch.from_numpy(v) for k, v in feats.items()}


def test_teacher_forced_logits_match_jax():
    cfg, model, variables, port = _models(1)
    imgs = images_uint8(2)
    caps = np.random.RandomState(3).randint(3, V, (B, 7))
    caps[0, 5:] = cfg.model.pad_token_id  # caption pads are masked keys
    want = jax.jit(model.apply)(variables, jax_images(imgs),
                                jnp.asarray(caps))
    feats = _features(4)
    want_dec = model.apply(variables, _jax(feats), jnp.asarray(caps),
                           method=lambda m, f, c: m.decoder(f, c))
    with torch.inference_mode():
        got = port(torch.from_numpy(imgs), torch.from_numpy(caps))
        got_dec = port.decoder(_torch(feats), torch.from_numpy(caps))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_dec["logits"].numpy(),
                               np.asarray(want_dec["logits"]), atol=1e-4,
                               rtol=0)


def _steps_match(model, variables, port, feats, seed):
    """init_cache on the same features, tile, a random ancestry, four steps
    in both packages: logits to 1e-4; returns the final states."""
    rs = np.random.RandomState(seed)
    anc = (np.arange(B * K)[:, None] // K * K
           + rs.randint(0, K, (B * K, L))).astype(np.int32)
    tokens = rs.randint(3, V, (4, B * K))
    jstate = model.apply(variables, _jax(feats), L,
                         method=lambda m, f, n: m.decoder.init_cache(f, n))
    jstate = jax_tile_state(jstate, K)
    jstate = dict(jstate, lazy=dict(jstate["lazy"],
                                    ancestry=jnp.asarray(anc)))
    step = jax.jit(lambda s, t: model.apply(variables, s, t,
                                            method=model.step))
    with torch.inference_mode():
        tstate = _tile_state(port.decoder.init_cache(_torch(feats), L), K)
        tstate["lazy"]["ancestry"] = torch.from_numpy(anc)
        for toks in tokens:
            want, jstate = step(jstate, jnp.asarray(toks))
            got, tstate = port.step(tstate, torch.from_numpy(toks))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)
    assert tstate["pos"] == int(jstate["pos"]) == 4
    return jstate, tstate


@pytest.mark.parametrize("fold", ["1", "0"], ids=["fold", "split"])
def test_init_cache_and_steps_under_ancestry_match_jax_xla(fold,
                                                           monkeypatch):
    monkeypatch.setenv("ICT_DECODE_FOLD", fold)
    _, model, variables, port = _models(2)
    jstate, tstate = _steps_match(model, variables, port, _features(5), 6)
    assert tstate["shared"]["fold"] is (fold == "1")
    for jl, tl in zip(jstate["lazy"]["layers"], tstate["lazy"]["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(tl[key].numpy(),
                                       np.asarray(jl[key])[:, :L],
                                       atol=1e-5, rtol=0)
    # the memory keeps its SM real rows; JAX's is 8-row padded
    for jm, tm in zip(jstate["shared"]["layers"], tstate["shared"]["layers"]):
        np.testing.assert_allclose(tm["mem_k"].numpy(),
                                   np.asarray(jm["mem_k"])[:, :, :SM],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(tm["mem_v"].numpy(),
                                   np.asarray(jm["mem_v"])[:, :SM],
                                   atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tstate["shared"]["mem_pad"].numpy(),
                                  np.asarray(jstate["shared"]["mem_pad"])
                                  [:, :SM])


@pytest.mark.parametrize("fold", ["1", "0"], ids=["fold", "split"])
def test_steps_match_jax_pallas_kernels(fold, monkeypatch):
    """Width 128: the JAX package's Pallas decode (folded-QKV or split
    self-attention kernel, and its fused cross-attention kernel) in
    interpret mode, on the same switch."""
    monkeypatch.setenv("ICT_DECODE_FOLD", fold)
    _, model, variables, port = _models(3, width=128,
                                        decode_kernel="pallas")
    _steps_match(model, variables, port, _features(7), 8)


def test_memory_is_per_image_and_caches_exactly_max_length():
    port = _models(2)[3]
    with torch.inference_mode():
        state = port.decoder.init_cache(_torch(_features(5)), 11)
    H = 64
    assert state["pos"] == 0
    assert state["lazy"]["layers"][0]["k"].shape == (B, 11, H)
    mem = state["shared"]["layers"][0]
    assert mem["mem_k"].shape == (B, H, SM) and mem["mem_k"].is_contiguous()
    assert mem["mem_v"].shape == (B, SM, H)
    tiled = _tile_state(state, K)
    assert tiled["shared"] is state["shared"]
    assert tiled["lazy"]["layers"][0]["v"].shape == (B * K, 11, H)


# the JAX kernel each port wrapper stands for
_ROUTES = {"beam_decode_attention_qkv": "fused_beam_decode_attention_qkv",
           "beam_decode_attention": "fused_beam_decode_attention",
           "cross_attention": "fused_cross_attention"}


def _spy(monkeypatch, module, names, calls):
    for name in names:
        real = getattr(module, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("stack,fold,want", [
    ("1", "1", "beam_decode_attention_qkv"),
    ("0", "1", "beam_decode_attention_qkv"),
    ("1", "0", "beam_decode_attention"),
    ("0", "0", "beam_decode_attention"),
])
def test_switch_routes_the_decode_as_in_jax(stack, fold, want, monkeypatch):
    """One decode step per setting: ``ICT_DECODE_FOLD`` picks the
    self-attention kernel in both packages (``ICT_DECODE_STACK`` means
    nothing to this decoder), and each layer runs its self-attention kernel
    and then the cross-attention kernel."""
    monkeypatch.setenv("ICT_DECODE_STACK", stack)
    monkeypatch.setenv("ICT_DECODE_FOLD", fold)
    _, model, variables, port = _models(3, width=128,
                                        decode_kernel="pallas")
    jcalls, tcalls = [], []
    _spy(monkeypatch, jax_dec, ("fused_beam_decode_attention",
                                "fused_cross_attention"), jcalls)
    _spy(monkeypatch, jax_pd, ("fused_beam_decode_attention_qkv",), jcalls)
    _spy(monkeypatch, port_dec, _ROUTES, tcalls)
    feats = _features(9)
    toks = np.arange(B * K) + 3
    jstate = jax_tile_state(model.apply(
        variables, _jax(feats), L,
        method=lambda m, f, n: m.decoder.init_cache(f, n)), K)
    model.apply(variables, jstate, jnp.asarray(toks), method=model.step)
    with torch.inference_mode():
        tstate = _tile_state(port.decoder.init_cache(_torch(feats), L), K)
        port.step(tstate, torch.from_numpy(toks))
    assert tcalls == [want, "cross_attention"] * 2
    assert jcalls == [_ROUTES[want], "fused_cross_attention"] * 2
