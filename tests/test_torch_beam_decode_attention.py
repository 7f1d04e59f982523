"""Beam-decode attention, split and folded-QKV (port:
ops/beam_decode_attention.py) against the JAX package's Pallas kernels in
interpret mode (and the split kernel's pure-jnp oracle), and the wrappers'
checks of what the CUDA kernels take. The kernels themselves are held
against these plain versions on the card in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.ops.pallas_decode import (
    fused_beam_decode_attention, fused_beam_decode_attention_qkv,
    reference_beam_decode_attention)
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
    (lambda a: a.update(k_cache=torch.zeros(B * K, 40000, H),
                        v_cache=torch.zeros(B * K, 40000, H),
                        anc_local=torch.zeros((B * K, 40000),
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


# The first kernel's wrapper took every shape whose block fit in 48 KB of
# shared memory: 4 (hd + S + P + 5) + 4 S bytes. The redesigned kernel must
# take each of them (it streams positions in chunks and cuts its blocks to
# what fits).
_FIRST_LIMIT = 48 * 1024


def _first_kernel_smem(S, P, hd):
    return 4 * (hd + S + P + 5) + 4 * S


def _meta_args(B, K, S, P, NH, H, dtype):
    Bk = B * K
    m = lambda *s: torch.empty(*s, dtype=dtype, device="meta")  # noqa: E731
    return dict(k_cache=m(Bk, S, H), v_cache=m(Bk, S, H),
                prefix_k=m(B, P, H) if P else None,
                prefix_v=m(B, P, H) if P else None,
                anc_local=torch.empty((Bk, S), dtype=torch.int32,
                                      device="meta"),
                num_heads=NH, beam_size=K), m(Bk, H)


def _accepts_at_every_pos(B, K, S, P, NH, H, dtype):
    assert _first_kernel_smem(S, P, H // NH) <= _FIRST_LIMIT
    args, row = _meta_args(B, K, S, P, NH, H, dtype)
    m = lambda *s: torch.empty(*s, dtype=dtype, device="meta")  # noqa: E731
    for pos in (0, S - 1):
        assert bda._check(row, row, row, pos=pos, **args) == P
        assert bda._check_qkv(row, m(3 * H, H), m(3 * H), m(H, H), m(H),
                              pos=pos, **args) == P


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 5, 8])
@pytest.mark.parametrize("P", [0, 10, 64])
@pytest.mark.parametrize("length", ["served", "first_kernel_limit"])
def test_kernel_checks_accept_every_shape_the_first_kernel_took(
        length, P, K, dtype):
    """The served widths (12 heads of 64) at the served cache length and at
    the longest cache the first kernel's 48 KB block held."""
    hd = 64
    S = 20 if length == "served" else \
        (_FIRST_LIMIT - 4 * (hd + P + 5)) // 8
    _accepts_at_every_pos(64, K, S, P, 12, 768, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("NH,H", [(8, 768), (1, 768), (4, 64), (2, 48),
                                  (1, 4096)])
def test_kernel_checks_accept_other_head_widths(NH, H, dtype):
    """Heads of 96 (the JAX default GPT-2), 768, 16, 24 and 4096 values at
    the longest cache the first kernel held behind a 10-row prefix."""
    S = (_FIRST_LIMIT - 4 * (H // NH + 10 + 5)) // 8
    _accepts_at_every_pos(2, 5, S, 10, NH, H, dtype)


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


# -- folded QKV ---------------------------------------------------------------


def _qkv_inputs(seed, anc_random):
    """Rows, flax-layout projections [in, out] (GPT-2's initial scale) and
    caches; the port takes the projections transposed."""
    rs = np.random.RandomState(seed)
    arrs, anc = _inputs(seed, anc_random, prefix=True)
    arrs = {k: arrs[k] for k in ("k_cache", "v_cache", "prefix_k",
                                 "prefix_v")}
    arrs.update(x=rs.randn(B * K, H), wqkv=rs.randn(H, 3 * H) * 0.05,
                bqkv=rs.randn(3 * H) * 0.02, wo=rs.randn(H, H) * 0.05,
                bo=rs.randn(H) * 0.02)
    return {k: v.astype(np.float32) for k, v in arrs.items()}, anc


def _port_qkv(arrs, anc, pos, fn=bda.beam_decode_attention_qkv):
    t = {k: torch.from_numpy(np.ascontiguousarray(
        v.T if k in ("wqkv", "wo") else v)) for k, v in arrs.items()}
    out = fn(t["x"], t["wqkv"], t["bqkv"], t["wo"], t["bo"], t["k_cache"],
             t["v_cache"], t["prefix_k"], t["prefix_v"],
             None if anc is None else torch.from_numpy(anc), pos,
             num_heads=NH, beam_size=K, scale=SCALE)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("anc_random", [True, False], ids=["anc", "anc_none"])
@pytest.mark.parametrize("pos", [0, 3, S - 1])
def test_qkv_plain_matches_pallas_kernel(pos, anc_random):
    """The folded kernel's plain version against the Pallas folded kernel
    (interpret mode): f32 output and appended caches to atol 1e-5."""
    arrs, anc = _qkv_inputs(100 + pos * 2 + anc_random, anc_random)
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    want = fused_beam_decode_attention_qkv(
        j["x"], j["wqkv"], j["bqkv"], j["wo"], j["bo"], j["k_cache"],
        j["v_cache"], j["prefix_k"], j["prefix_v"],
        None if anc is None else jnp.asarray(anc), jnp.asarray(pos),
        num_heads=NH, beam_size=K, scale=SCALE, interpret=True)
    got = _port_qkv(arrs, anc, pos)
    for g, w, name in zip(got, want, ("out", "k_cache", "v_cache")):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0,
                                   err_msg=name)


def _qkv_args(dtype=torch.float32):
    a = _torch_args(dtype)
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    x = a.pop("q")
    a.pop("k_new")
    a.pop("v_new")
    return dict(x=x, wqkv=z(3 * H, H), bqkv=z(3 * H), wo=z(H, H), bo=z(H),
                **a)


@pytest.mark.parametrize("change, match", [
    (lambda a: a.update(x=a["x"].half()), "float32"),
    (lambda a: a.update(wqkv=a["wqkv"].T.contiguous()), "wqkv shape"),
    (lambda a: a.update(bo=a["bo"].to(torch.bfloat16)), "bo is"),
    (lambda a: a.update(wo=a["wo"].T), "contiguous"),
    (lambda a: a.update(x=torch.zeros(B * K, 36), wqkv=torch.zeros(108, 36),
                        bqkv=torch.zeros(108), wo=torch.zeros(36, 36),
                        bo=torch.zeros(36), num_heads=4), "multiple of 8"),
    (lambda a: a.update(pos=-1), "pos"),
    (lambda a: a.update(prefix_k=None), "both prefix"),
])
def test_qkv_checks_raise_on_what_it_does_not_take(change, match):
    args = _qkv_args()
    change(args)
    with pytest.raises((TypeError, ValueError), match=match):
        bda._check_qkv(**args)


def test_qkv_checks_accept_served_shapes():
    assert bda._check_qkv(**_qkv_args(torch.bfloat16)) == P


def test_qkv_cpu_tensor_takes_plain_version_without_counting():
    arrs, anc = _qkv_inputs(7, True)
    before = bda.beam_decode_attention_qkv.launches
    got = _port_qkv(arrs, anc, 4)
    want = _port_qkv(arrs, anc, 4, fn=bda.beam_decode_attention_qkv_plain)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert bda.beam_decode_attention_qkv.launches == before
