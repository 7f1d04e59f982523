"""Beam-decode attention (port: ops/beam_decode_attention.py) against the
JAX package's Pallas kernel in interpret mode and its pure-jnp oracle, and
the wrapper's checks of what the CUDA kernel takes. The kernel itself is
held against this plain version on the card in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.ops.pallas_decode import (
    fused_beam_decode_attention, reference_beam_decode_attention)
from image_captioning_ml_project_tpu_torch.ops import beam_decode_attention \
    as bda
from torch_port_helpers import bf16_ulp

torch.set_num_threads(1)

B, K, S, P, NH, H = 2, 3, 8, 3, 4, 64
SCALE = 1.0 / (H // NH) ** 0.5


def _inputs(seed, anc_random, prefix):
    rs = np.random.RandomState(seed)
    Bk = B * K
    arrs = {"q": rs.randn(Bk, H), "k_new": rs.randn(Bk, H),
            "v_new": rs.randn(Bk, H), "k_cache": rs.randn(Bk, S, H),
            "v_cache": rs.randn(Bk, S, H)}
    if prefix:
        arrs.update(prefix_k=rs.randn(B, P, H), prefix_v=rs.randn(B, P, H))
    anc = rs.randint(0, K, (Bk, S)).astype(np.int32) if anc_random else None
    return {k: v.astype(np.float32) for k, v in arrs.items()}, anc


def _jax(fn, arrs, anc, pos, dt, **kw):
    j = {k: jnp.asarray(v).astype(dt) for k, v in arrs.items()}
    out = fn(j["q"], j["k_new"], j["v_new"], j["k_cache"], j["v_cache"],
             j.get("prefix_k"), j.get("prefix_v"),
             None if anc is None else jnp.asarray(anc), jnp.asarray(pos),
             num_heads=NH, beam_size=K, scale=SCALE, **kw)
    return [np.asarray(x.astype(jnp.float32)) for x in out]


def _port(arrs, anc, pos, dt):
    t = {k: torch.from_numpy(v).to(dt) for k, v in arrs.items()}
    a = None if anc is None else torch.from_numpy(anc)
    out = bda.beam_decode_attention(
        t["q"], t["k_new"], t["v_new"], t["k_cache"], t["v_cache"],
        t.get("prefix_k"), t.get("prefix_v"), a, pos, num_heads=NH,
        beam_size=K, scale=SCALE)
    return [x.float().cpu().numpy() for x in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "no_prefix"])
@pytest.mark.parametrize("anc_random", [True, False], ids=["anc", "anc_none"])
@pytest.mark.parametrize("pos", [0, 3, S - 1])
def test_plain_matches_pallas_kernel_and_oracle(pos, anc_random, prefix,
                                                dtype):
    """Outputs and updated caches agree with the Pallas kernel (interpret
    mode) and with the oracle: f32 to atol/rtol 1e-5, bf16 to one bf16 ulp
    of the output's magnitude; the appended caches exactly."""
    arrs, anc = _inputs(pos * 10 + anc_random * 2 + prefix, anc_random,
                        prefix)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    got = _port(arrs, anc, pos, getattr(torch, dtype))
    kernel = _jax(fused_beam_decode_attention, arrs, anc, pos, jdt,
                  interpret=True)
    oracle = _jax(reference_beam_decode_attention, arrs, anc, pos, jdt)
    for want, name in ((kernel, "pallas kernel"), (oracle, "oracle")):
        if dtype == "float32":
            np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5,
                                       err_msg=name)
        else:
            err = np.abs(got[0] - want[0]).max()
            assert err <= bf16_ulp(want[0]), (name, err)
        np.testing.assert_array_equal(got[1], want[1], err_msg=name)
        np.testing.assert_array_equal(got[2], want[2], err_msg=name)


def _torch_args(dtype=torch.float32, Bk=B * K):
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    return dict(q=z(Bk, H), k_new=z(Bk, H), v_new=z(Bk, H),
                k_cache=z(Bk, S, H), v_cache=z(Bk, S, H),
                prefix_k=z(B, P, H), prefix_v=z(B, P, H),
                anc_local=torch.zeros((Bk, S), dtype=torch.int32), pos=2,
                num_heads=NH, beam_size=K)


@pytest.mark.parametrize("change, match", [
    (lambda a: a.update(q=a["q"].half(), k_new=a["k_new"].half()), "float32"),
    (lambda a: a.update(k_cache=a["k_cache"].transpose(0, 1).contiguous()
                        .transpose(0, 1)), "contiguous"),
    (lambda a: a.update(v_new=a["v_new"][:-1]), "shape"),
    (lambda a: a.update(pos=S), "pos"),
    (lambda a: a.update(anc_local=a["anc_local"].long()), "int32"),
    (lambda a: a.update(prefix_v=None), "both prefix"),
    (lambda a: a.update(prefix_k=a["prefix_k"][:1],
                        prefix_v=a["prefix_v"][:1]), "prefix K/V"),
    (lambda a: a.update(beam_size=4), "whole beams"),
    (lambda a: a.update(num_heads=5), "heads"),
    (lambda a: a.update(k_cache=torch.zeros(B * K, 12000, H),
                        v_cache=torch.zeros(B * K, 12000, H),
                        anc_local=torch.zeros((B * K, 12000),
                                              dtype=torch.int32)),
     "shared memory"),
])
def test_kernel_checks_raise_on_what_it_does_not_take(change, match):
    args = _torch_args()
    change(args)
    with pytest.raises((TypeError, ValueError), match=match):
        bda._check(**args)


def test_kernel_checks_accept_served_shapes():
    args = _torch_args(torch.bfloat16)
    assert bda._check(**args) == P
    args.update(prefix_k=None, prefix_v=None, anc_local=None)
    assert bda._check(**args) == 0


def test_cpu_tensor_takes_plain_version_without_counting():
    arrs, anc = _inputs(0, True, True)
    before = bda.beam_decode_attention.launches
    got = _port(arrs, anc, 4, torch.float32)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    want = bda.beam_decode_attention_plain(
        t["q"], t["k_new"], t["v_new"], t["k_cache"], t["v_cache"],
        t["prefix_k"], t["prefix_v"], torch.from_numpy(anc), 4,
        num_heads=NH, beam_size=K, scale=SCALE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert bda.beam_decode_attention.launches == before
