"""GPT-2 decoder (port: models/gpt2.py) against the JAX package on the same
weights: teacher-forced logits, and ``init_cache`` plus four ``step``s
under a non-trivial beam ancestry on each decode path (split against both
JAX step paths, XLA and the Pallas kernel; stack and fold against the JAX
package's Pallas kernels in interpret mode with the same switches), to
atol 1e-4 at f32. Also the stacked cache layout, ``_tile_state`` against
JAX's, and that the switches route the port's decode through the same
kernels as the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_captioning_ml_project_tpu.models.gpt2 as jax_gpt2
import image_captioning_ml_project_tpu_torch.models.gpt2 as port_gpt2
from image_captioning_ml_project_tpu.inference.decoding import (
    _tile_state as jax_tile_state)
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    _tile_state)
from torch_port_helpers import both_models, images_uint8, jax_images

torch.set_num_threads(1)

B, K, L = 2, 3, 8


def test_teacher_forced_logits_match_jax():
    cfg, model, variables, port = both_models(1)
    imgs = images_uint8(2)
    caps = np.random.RandomState(3).randint(3, 1000, (B, 7))
    caps[0, 5:] = cfg.model.pad_token_id  # caption pads are masked keys
    want = jax.jit(model.apply)(variables, jax_images(imgs),
                                jnp.asarray(caps))
    with torch.inference_mode():
        got = port(torch.from_numpy(imgs), torch.from_numpy(caps))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_init_cache_and_steps_under_ancestry_match_jax(kernel, monkeypatch):
    monkeypatch.setenv("ICT_DECODE_STACK", "0")
    monkeypatch.setenv("ICT_DECODE_FOLD", "0")
    _, model, variables, port = both_models(2, decode_kernel=kernel)
    imgs = images_uint8(4)
    rs = np.random.RandomState(5)
    # global beam rows of each slot's own image, as beam search keeps them
    anc = (np.arange(B * K)[:, None] // K * K
           + rs.randint(0, K, (B * K, L))).astype(np.int32)
    tokens = rs.randint(3, 1000, (4, B * K))

    jstate = model.apply(variables, jax_images(imgs), L,
                         method=model.init_cache)
    jstate = jax_tile_state(jstate, K)
    jstate = dict(jstate, lazy=dict(jstate["lazy"],
                                    ancestry=jnp.asarray(anc)))
    step = jax.jit(lambda s, t: model.apply(variables, s, t,
                                            method=model.step))
    with torch.inference_mode():
        tstate = _tile_state(port.init_cache(torch.from_numpy(imgs), L), K)
        tstate["lazy"]["ancestry"] = torch.from_numpy(anc)
        for toks in tokens:
            want, jstate = step(jstate, jnp.asarray(toks))
            got, tstate = port.step(tstate, torch.from_numpy(toks))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)
    assert tstate["pos"] == int(jstate["pos"]) == 4
    for jl, tl, jp, tp in zip(jstate["lazy"]["layers"],
                              tstate["lazy"]["layers"],
                              jstate["shared"]["layers"],
                              tstate["shared"]["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(tl[key].numpy(),
                                       np.asarray(jl[key])[:, :L],
                                       atol=1e-5, rtol=0)
        for key in ("pk", "pv"):
            np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                       atol=1e-5, rtol=0)


def test_suffix_cache_holds_exactly_max_length_positions(monkeypatch):
    port = both_models(1)[3]
    images = torch.from_numpy(images_uint8(0))
    with torch.inference_mode():
        state = port.init_cache(images, 11)      # default: the stack path
        assert state["pos"] == 0
        assert state["lazy"]["stacked"]["k"].shape == (2, B, 11, 64)
        assert state["shared"]["pk"].shape == (2, B, 3, 64)
        monkeypatch.setenv("ICT_DECODE_STACK", "0")
        state = port.init_cache(images, 11)      # per-layer caches
    assert state["pos"] == 0
    assert state["lazy"]["layers"][0]["k"].shape == (B, 11, 64)
    assert state["shared"]["layers"][0]["pk"].shape == (B, 3, 64)


def _switch(monkeypatch, stack, fold):
    monkeypatch.setenv("ICT_DECODE_STACK", stack)
    monkeypatch.setenv("ICT_DECODE_FOLD", fold)


@pytest.mark.parametrize("path", ["stack", "fold"])
def test_stack_and_fold_steps_under_ancestry_match_jax(path, monkeypatch):
    """The port's stack and fold paths against the JAX package's Pallas
    whole-stack and folded-QKV kernels (interpret mode), chosen by the same
    switches: logits of four steps to 1e-4, caches to 1e-5."""
    _switch(monkeypatch, "1" if path == "stack" else "0", "1")
    _, model, variables, port = both_models(2, decode_kernel="pallas")
    imgs = images_uint8(4)
    rs = np.random.RandomState(6)
    anc = (np.arange(B * K)[:, None] // K * K
           + rs.randint(0, K, (B * K, L))).astype(np.int32)
    tokens = rs.randint(3, 1000, (4, B * K))

    jstate = jax_tile_state(model.apply(variables, jax_images(imgs), L,
                                        method=model.init_cache), K)
    jstate = dict(jstate, lazy=dict(jstate["lazy"],
                                    ancestry=jnp.asarray(anc)))
    assert ("stacked" in jstate["lazy"]) == (path == "stack")
    step = jax.jit(lambda s, t: model.apply(variables, s, t,
                                            method=model.step))
    with torch.inference_mode():
        tstate = _tile_state(port.init_cache(torch.from_numpy(imgs), L), K)
        tstate["lazy"]["ancestry"] = torch.from_numpy(anc)
        for toks in tokens:
            want, jstate = step(jstate, jnp.asarray(toks))
            got, tstate = port.step(tstate, torch.from_numpy(toks))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)
    assert tstate["pos"] == int(jstate["pos"]) == 4
    if path == "stack":
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tstate["lazy"]["stacked"][key].numpy(),
                np.asarray(jstate["lazy"]["stacked"][key])[:, :, :L],
                atol=1e-5, rtol=0)
        for key in ("pk", "pv"):
            np.testing.assert_allclose(tstate["shared"][key].numpy(),
                                       np.asarray(jstate["shared"][key]),
                                       atol=1e-5, rtol=0)
        return
    for jl, tl in zip(jstate["lazy"]["layers"], tstate["lazy"]["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(tl[key].numpy(),
                                       np.asarray(jl[key])[:, :L],
                                       atol=1e-5, rtol=0)


def test_stacked_layout_and_tiling_match_jax(monkeypatch):
    """init_cache's stacked layout has JAX's axes (the port's suffix axis
    holds exactly max_length positions, JAX's is 8-aligned), and
    ``_tile_state`` tiles ``lazy["stacked"]`` on axis 1 and the rest on
    axis 0, as JAX's does."""
    _switch(monkeypatch, "1", "1")
    _, model, variables, port = both_models(2, decode_kernel="pallas")
    imgs = images_uint8(4)
    jstate = model.apply(variables, jax_images(imgs), 11,
                         method=model.init_cache)
    with torch.inference_mode():
        tstate = port.init_cache(torch.from_numpy(imgs), 11)
    jk, tk = jstate["lazy"]["stacked"]["k"], tstate["lazy"]["stacked"]["k"]
    assert tk.shape == jk.shape[:2] + (11,) + jk.shape[3:]
    assert tstate["shared"]["pk"].shape == jstate["shared"]["pk"].shape
    assert set(tstate["shared"]["stack"]) == set(jstate["shared"]["stack"])

    arr = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    pk = np.ones((5, 3, 2), np.float32)

    def state(conv):
        return {"lazy": {"stacked": {"k": conv(arr)}, "rows": conv(arr[0])},
                "shared": {"pk": conv(pk)}, "tokens": conv(np.arange(3))}

    want = jax_tile_state(state(jnp.asarray), 2)
    got = _tile_state(state(torch.from_numpy), 2)
    np.testing.assert_array_equal(got["lazy"]["stacked"]["k"].numpy(),
                                  np.asarray(want["lazy"]["stacked"]["k"]))
    np.testing.assert_array_equal(got["lazy"]["rows"].numpy(),
                                  np.asarray(want["lazy"]["rows"]))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert got["shared"]["pk"].shape == (5, 3, 2)


# the JAX kernel each port wrapper stands for
_ROUTES = {"beam_decode_stack": "fused_beam_decode_stack",
           "beam_decode_attention_qkv": "fused_beam_decode_attention_qkv",
           "beam_decode_attention": "fused_beam_decode_attention"}


def _spy(monkeypatch, module, names, calls):
    for name in names:
        real = getattr(module, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("stack,fold,want", [
    ("1", "1", "beam_decode_stack"),
    ("1", "0", "beam_decode_stack"),
    ("0", "1", "beam_decode_attention_qkv"),
    ("0", "0", "beam_decode_attention"),
])
def test_switches_route_the_decode_as_in_jax(stack, fold, want, monkeypatch):
    """Spy on the kernel entries of both packages: one decode step under
    each setting of ICT_DECODE_STACK / ICT_DECODE_FOLD reaches the same
    kernel in the port as in the JAX package (Pallas decode), once per
    step for the stack, once per layer otherwise."""
    _switch(monkeypatch, stack, fold)
    _, model, variables, port = both_models(2, decode_kernel="pallas")
    imgs = images_uint8(4)
    jcalls, tcalls = [], []
    _spy(monkeypatch, jax_gpt2, _ROUTES.values(), jcalls)
    _spy(monkeypatch, port_gpt2, _ROUTES, tcalls)
    toks = np.arange(B * K) + 3
    jstate = jax_tile_state(model.apply(variables, jax_images(imgs), L,
                                        method=model.init_cache), K)
    model.apply(variables, jstate, jnp.asarray(toks), method=model.step)
    with torch.inference_mode():
        tstate = _tile_state(port.init_cache(torch.from_numpy(imgs), L), K)
        port.step(tstate, torch.from_numpy(toks))
    layers = 1 if want == "beam_decode_stack" else 2
    assert tcalls == [want] * layers
    assert jcalls == [_ROUTES[want]] * layers
