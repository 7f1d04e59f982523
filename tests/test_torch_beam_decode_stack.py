"""Whole-stack GPT-2 decode step (port: ops/beam_decode_stack.py) against
the JAX package's Pallas kernel ``fused_beam_decode_stack`` in interpret
mode, and the wrapper's checks of what the CUDA kernel takes. The kernel
itself is held against this plain version on the card in
test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.ops.pallas_decode import (
    STACK_WEIGHT_KEYS, fused_beam_decode_stack)
from image_captioning_ml_project_tpu_torch.ops import beam_decode_stack \
    as bds
from image_captioning_ml_project_tpu_torch.ops._checks import STACK_KEYS

torch.set_num_threads(1)

L, S, P, NH, H = 2, 8, 3, 4, 64
SCALE = 1.0 / (H // NH) ** 0.5
MATRICES = ("wqkv", "wo", "wfc", "wpj")


def _inputs(seed, B, K, anc_random):
    """Flax-layout stacked weights (matrices [L, in, out], as the JAX
    package's ``_stacked_weights``), caches, prefix and ancestry."""
    rs = np.random.RandomState(seed)
    Bk = B * K
    shapes = {"wqkv": (H, 3 * H), "bqkv": (3 * H,), "wo": (H, H),
              "bo": (H,), "g1": (H,), "b1": (H,), "g2": (H,), "b2": (H,),
              "wfc": (H, 4 * H), "bfc": (4 * H,), "wpj": (4 * H, H),
              "bpj": (H,)}
    stack = {k: (rs.randn(L, *shp) * (0.05 if k[0] == "w" else 0.02))
             .astype(np.float32) for k, shp in shapes.items()}
    stack["g1"] += 1.0
    stack["g2"] += 1.0
    arrs = {"x": rs.randn(Bk, H), "k": rs.randn(L, Bk, S, H),
            "v": rs.randn(L, Bk, S, H), "pk": rs.randn(L, B, P, H) * 0.3,
            "pv": rs.randn(L, B, P, H) * 0.3}
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    anc = (rs.randint(0, K, (Bk, S)).astype(np.int32) if anc_random
           else None)
    return stack, arrs, anc


def _port_stack(stack):
    """The flax-layout stack in the port's layout: matrices transposed to
    the nn.Linear layout [L, out, in]."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(0, 2, 1) if k in MATRICES else v))
        for k, v in stack.items()}


def _port(stack, arrs, anc, pos, K, fn=bds.beam_decode_stack):
    t = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    out = fn(t["x"], _port_stack(stack), t["k"], t["v"], t["pk"], t["pv"],
             None if anc is None else torch.from_numpy(anc), pos,
             num_heads=NH, beam_size=K, scale=SCALE)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("B,K,pos,anc_random", [
    (2, 3, 0, True),     # first step: the suffix is fully masked
    (2, 3, 5, True),     # mid-decode under a random ancestry
    (2, 3, S - 1, True),  # last position
    (3, 1, 3, False),    # greedy: K = 1, no ancestry
])
def test_plain_matches_pallas_kernel(B, K, pos, anc_random):
    """The whole-stack plain version against the Pallas kernel (interpret
    mode) on the same weights: f32 hidden output and every layer's
    appended caches to atol 1e-5."""
    stack, arrs, anc = _inputs(pos * 10 + K, B, K, anc_random)
    assert set(STACK_KEYS) == set(STACK_WEIGHT_KEYS)
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    want = fused_beam_decode_stack(
        j["x"], {k: jnp.asarray(v) for k, v in stack.items()}, j["k"],
        j["v"], j["pk"], j["pv"], None if anc is None else jnp.asarray(anc),
        jnp.asarray(pos), num_heads=NH, beam_size=K, scale=SCALE,
        interpret=True)
    got = _port(stack, arrs, anc, pos, K)
    for g, w, name in zip(got, want, ("hidden", "k_caches", "v_caches")):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0,
                                   err_msg=name)
    # nothing but position `pos` of each layer's caches was written
    rest = [t for t in range(S) if t != pos]
    np.testing.assert_array_equal(got[1][:, :, rest], arrs["k"][:, :, rest])
    np.testing.assert_array_equal(got[2][:, :, rest], arrs["v"][:, :, rest])


def _args(dtype=torch.float32, B=2, K=3):
    stack, arrs, anc = _inputs(0, B, K, True)
    t = {k: torch.from_numpy(v).to(dtype) for k, v in arrs.items()}
    w = {k: (v if k in ("g1", "b1", "g2", "b2") else v.to(dtype))
         for k, v in _port_stack(stack).items()}
    return dict(x=t["x"], stack=w, k_caches=t["k"], v_caches=t["v"],
                prefix_k=t["pk"], prefix_v=t["pv"],
                anc_local=torch.from_numpy(anc), pos=2, num_heads=NH,
                beam_size=K)


def _drop(key):
    def change(a):
        a["stack"] = {k: v for k, v in a["stack"].items() if k != key}
    return change


def _set(key, fn):
    def change(a):
        a["stack"] = dict(a["stack"], **{key: fn(a["stack"][key])})
    return change


@pytest.mark.parametrize("change, match", [
    (lambda a: a.update(x=a["x"].half()), "float32 or bfloat16"),
    (_drop("bpj"), "keys"),
    (_set("wfc", lambda w: w.transpose(1, 2).contiguous()), "wfc shape"),
    (_set("g1", lambda g: g.to(torch.bfloat16)), "g1 is"),
    (_set("wo", lambda w: w.to(torch.bfloat16)), "wo is"),
    (lambda a: a.update(prefix_k=a["prefix_k"][:1],
                        prefix_v=a["prefix_v"][:1]), "layers"),
    (lambda a: a.update(v_caches=a["v_caches"][:, :, :4].contiguous()),
     "v_caches shape"),
    (lambda a: a.update(pos=S), "pos"),
    (lambda a: a.update(beam_size=4), "whole beams"),
    (lambda a: a.update(num_heads=5), "heads"),
])
def test_kernel_checks_raise_on_what_it_does_not_take(change, match):
    args = _args()
    change(args)
    with pytest.raises((TypeError, ValueError), match=match):
        bds._check(**args)


def test_kernel_checks_accept_served_layout():
    assert bds._check(**_args(torch.bfloat16)) == P
    assert bds._check(**_args(torch.float32, B=3, K=1)) == P


def test_cpu_tensor_takes_plain_version_without_counting():
    stack, arrs, anc = _inputs(3, 2, 3, True)
    before = bds.beam_decode_stack.launches
    got = _port(stack, arrs, anc, 4, 3)
    want = _port(stack, arrs, anc, 4, 3, fn=bds.beam_decode_stack_plain)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert bds.beam_decode_stack.launches == before
