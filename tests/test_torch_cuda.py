"""The port's hand-written kernels on the card, against their plain PyTorch
versions: beam-decode attention, folded-QKV attention, the whole-stack
GPT-2 decode step, the whole-stack CLIP encoder, the Dense GEMM they share
by itself, the Transformer decoder's
cross-attention step (at the Q-Former's, BUTD's and Swin's memory lengths
too), the attention variants' SDPA and additive scores,
and LSE/block-max (all CUDA C++); then a tiny model's decode on the
card against the same decode on the CPU, on each decode configuration of
CLIP + GPT-2 and of ViT + Transformer, and for ResNet + LSTM with each
attention variant.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere. The
file imports neither JAX nor the repository's conftest helpers, so it runs
on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu_torch.config import (AttentionType,
                                                          DecoderType)
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    beam_search)
from image_captioning_ml_project_tpu_torch.main import (flagship_config,
                                                        lstm_config,
                                                        transformer_config)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from image_captioning_ml_project_tpu_torch.ops import beam_decode_attention \
    as bda
from image_captioning_ml_project_tpu_torch.ops import beam_decode_stack as bds
from image_captioning_ml_project_tpu_torch.ops import cross_attention as ca
from image_captioning_ml_project_tpu_torch.ops import dense_layer as dl
from image_captioning_ml_project_tpu_torch.ops import encoder_stack as es
from image_captioning_ml_project_tpu_torch.ops import additive_scores as adds
from image_captioning_ml_project_tpu_torch.ops import lse as port_lse
from image_captioning_ml_project_tpu_torch.ops import sdpa as port_sdpa
from image_captioning_ml_project_tpu_torch.ops._checks import (LN_KEYS,
                                                                stack_shapes)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The first CUDA device, TF32 off; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the plain versions' bf16 GEMMs round once, from f32 sums
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda:0")


def _bf16_ulp(ref):
    return 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)


def _attention_inputs(B, K, S, P, H, seed):
    g = torch.Generator().manual_seed(seed)
    Bk = B * K
    t = {"q": (Bk, H), "k_new": (Bk, H), "v_new": (Bk, H),
         "k_cache": (Bk, S, H), "v_cache": (Bk, S, H)}
    if P:
        t.update(prefix_k=(B, P, H), prefix_v=(B, P, H))
    out = {k: torch.randn(s, generator=g) for k, s in t.items()}
    out["anc_local"] = torch.randint(0, K, (Bk, S), generator=g,
                                     dtype=torch.int32)
    return out


def _attention(inputs, dtype, device, pos, NH, K, anc=True, plain=False):
    t = {k: (v.to(device) if k == "anc_local" else v.to(device, dtype))
         for k, v in inputs.items()}
    fn = bda.beam_decode_attention_plain if plain else bda.beam_decode_attention
    out, kc, vc = fn(t["q"], t["k_new"], t["v_new"], t["k_cache"],
                     t["v_cache"], t.get("prefix_k"), t.get("prefix_v"),
                     t["anc_local"] if anc else None, pos, num_heads=NH,
                     beam_size=K, scale=(t["q"].shape[1] // NH) ** -0.5)
    torch.cuda.synchronize()
    return out.float().cpu(), kc.float().cpu(), vc.float().cpu()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,S,P,NH,H,pos,anc", [
    (64, 5, 20, 10, 12, 768, 19, True),   # served shapes, last step
    (64, 5, 20, 10, 12, 768, 0, True),    # first step
    (64, 5, 20, 0, 12, 768, 19, True),    # Transformer decoder: no prefix
    (64, 5, 20, 0, 12, 768, 7, True),
    (64, 5, 20, 0, 12, 768, 0, True),
    (4, 3, 9, 0, 4, 64, 5, True),         # prefix-free, odd cache length
    (3, 1, 7, 2, 2, 48, 3, False),        # K=1, no ancestry, head dim 24
    (2, 2, 300, 5, 1, 320, 299, True),    # one head wider than the block
])
def test_attention_kernel_matches_plain(dev, dtype, B, K, S, P, NH, H, pos,
                                        anc):
    inputs = _attention_inputs(B, K, S, P, H, seed=S + pos)
    before = bda.beam_decode_attention.launches
    got = _attention(inputs, dtype, dev, pos, NH, K, anc)
    assert bda.beam_decode_attention.launches == before + 1
    want = _attention(inputs, dtype, dev, pos, NH, K, anc, plain=True)
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
    else:
        assert (got[0] - want[0]).abs().max() <= 2 * _bf16_ulp(want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("anc", ["random", "equal"])
@pytest.mark.parametrize("B,K,S,P,NH,H,pos", [
    (1, 5, 20, 10, 12, 768, 19),   # bucket 1: an image's beams split
    (1, 5, 20, 10, 12, 768, 0),
    (8, 5, 20, 0, 12, 768, 19),    # bucket 8, prefix-free
    (1, 1, 20, 10, 12, 768, 19),   # K = 1
    (2, 8, 20, 10, 12, 768, 19),   # K = 8
    (3, 8, 70, 64, 12, 768, 69),   # more positions than one chunk holds
    (2, 3, 6000, 0, 12, 768, 5999),  # near the first kernel's longest cache
])
def test_attention_kernel_matches_plain_at_the_edges(dev, dtype, anc, B, K,
                                                     S, P, NH, H, pos):
    """Batch 1 and 8, one and eight beams, the first and last positions,
    long caches; random ancestry and one where every beam follows the same
    one (every row of the image shared)."""
    inputs = _attention_inputs(B, K, S, P, H, seed=B * S + K + pos)
    if anc == "equal":
        inputs["anc_local"].fill_(K - 1)
    got = _attention(inputs, dtype, dev, pos, NH, K)
    want = _attention(inputs, dtype, dev, pos, NH, K, plain=True)
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
    else:
        assert (got[0] - want[0]).abs().max() <= 2 * _bf16_ulp(want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def _attention_without(inputs, r, skip, pos, NH, K):
    """Row ``r``'s f32 attention over its suffix positions < ``pos`` but
    ``skip``, its image's prefix and its own key: what the kernel gives a
    row whose ancestry entry at ``skip`` is out of range."""
    H = inputs["q"].shape[1]
    hd, b = H // NH, r // K
    anc = inputs["anc_local"]
    rows = [(b * K + int(anc[r, t]), t) for t in range(pos) if t != skip]
    ks = [inputs["k_cache"][i, t] for i, t in rows]
    vs = [inputs["v_cache"][i, t] for i, t in rows]
    if "prefix_k" in inputs:
        ks += list(inputs["prefix_k"][b])
        vs += list(inputs["prefix_v"][b])
    k = torch.stack(ks + [inputs["k_new"][r]]).view(-1, NH, hd)
    v = torch.stack(vs + [inputs["v_new"][r]]).view(-1, NH, hd)
    s = torch.einsum("nd,jnd->nj", inputs["q"][r].view(NH, hd), k) * hd ** -0.5
    return torch.einsum("nj,jnd->nd", torch.softmax(s, -1), v).reshape(H)


def test_attention_kernel_reports_an_ancestry_out_of_range(dev):
    """An entry of K (outside [0, K)) sets the device's error word and its
    position is left out of that row's attention; every other row and the
    caches come out bit for bit as with valid entries. Valid entries leave
    the word clear."""
    B, K, S, P, NH, H, pos = 2, 3, 9, 2, 4, 64, 6
    r, skip = 4, 3
    inputs = _attention_inputs(B, K, S, P, H, seed=11)
    bda.reset_ancestry_fault(dev)
    valid = _attention(inputs, torch.float32, dev, pos, NH, K)
    assert not bda.ancestry_fault(dev)
    want = _attention(inputs, torch.float32, dev, pos, NH, K, plain=True)
    torch.testing.assert_close(valid[0], want[0], atol=1e-5, rtol=1e-5)
    faulted = dict(inputs, anc_local=inputs["anc_local"].clone())
    faulted["anc_local"][r, skip] = K
    got = _attention(faulted, torch.float32, dev, pos, NH, K)
    assert bda.ancestry_fault(dev)
    others = [i for i in range(B * K) if i != r]
    assert torch.equal(got[0][others], valid[0][others])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(
        got[0][r], _attention_without(inputs, r, skip, pos, NH, K),
        atol=1e-5, rtol=1e-5)
    bda.reset_ancestry_fault(dev)
    assert not bda.ancestry_fault(dev)


# One beam, one head of 64, bf16: the kernel's smallest block (one position
# a chunk; `attn_layout` in csrc/beam_attention.cuh) holds pos + P + 1 =
# 19145 positions in 232,432 of the card's 232,448 bytes of shared memory,
# and one position more needs 232,464.
_LIMIT_S, _LIMIT_NTOK = 19146, 19145


@pytest.mark.parametrize("kernel", ["split", "folded", "stack"])
def test_attention_kernels_at_the_shared_memory_limit(dev, kernel):
    """At the last position the kernel's block holds, each of #1, #2 and #3
    runs and matches its plain version; one position later the C entry
    refuses before any launch and the wrapper raises ValueError, with the
    caches and the launch count untouched."""
    B, K, S, P, NH, H = 1, 1, _LIMIT_S, 2, 1, 64
    dt = torch.bfloat16
    t = {k: (v.to(dev) if k == "anc_local" else v.to(dev, dt))
         for k, v in _attention_inputs(B, K, S, P, H, seed=7).items()}
    w = {k: v.to(dev) for k, v in _stack_weights(1, H, 4 * H, dt,
                                                 seed=3).items()}
    kw = dict(num_heads=NH, beam_size=K, scale=H ** -0.5)
    fns, counter, ulps, cache_ulps = {
        "split": ((bda.beam_decode_attention,
                   bda.beam_decode_attention_plain),
                  bda.beam_decode_attention, 2, 0),
        "folded": ((bda.beam_decode_attention_qkv,
                    bda.beam_decode_attention_qkv_plain),
                   bda.beam_decode_attention_qkv, 4, 1),
        "stack": ((bds.beam_decode_stack, bds.beam_decode_stack_plain),
                  bds.beam_decode_stack, 8, 8)}[kernel]

    def run(fn, pos, kc, vc):
        if kernel == "split":
            return fn(t["q"], t["k_new"], t["v_new"], kc, vc, t["prefix_k"],
                      t["prefix_v"], t["anc_local"], pos, **kw)[0]
        if kernel == "folded":
            return fn(t["q"], *(w[k][0] for k in ("wqkv", "bqkv", "wo",
                                                  "bo")),
                      kc, vc, t["prefix_k"], t["prefix_v"], t["anc_local"],
                      pos, **kw)[0]
        return fn(t["q"], w, kc[None], vc[None], t["prefix_k"][None],
                  t["prefix_v"][None], t["anc_local"], pos, **kw)[0]

    pos = _LIMIT_NTOK - P - 1
    out = []
    for fn in fns:
        kc, vc = t["k_cache"].clone(), t["v_cache"].clone()
        out.append((run(fn, pos, kc, vc), kc, vc))
        torch.cuda.synchronize()
    (got, kc1, vc1), (want, kc2, vc2) = out
    _close(got, want, dt, None, ulps)
    for a, b, before in ((kc1, kc2, t["k_cache"]), (vc1, vc2, t["v_cache"])):
        _untouched_but_pos(a, before, pos)
        _untouched_but_pos(b, before, pos)
        if cache_ulps:
            _close(a[:, pos], b[:, pos], dt, None, cache_ulps)
        else:
            assert torch.equal(a, b)
    kc, vc = t["k_cache"].clone(), t["v_cache"].clone()
    before = counter.launches
    with pytest.raises(ValueError, match="shared memory"):
        run(fns[0], pos + 1, kc, vc)
    torch.cuda.synchronize()
    assert counter.launches == before
    assert torch.equal(kc, t["k_cache"]) and torch.equal(vc, t["v_cache"])


def test_attention_kernel_raises_on_what_it_does_not_take(dev):
    inputs = _attention_inputs(2, 2, 4, 1, 8, seed=0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _attention(inputs, torch.float16, dev, 1, 2, 2)
    t = {k: v.to(dev) for k, v in inputs.items()}
    with pytest.raises(ValueError, match="expected"):
        bda.beam_decode_attention(
            t["q"], t["k_new"], t["v_new"], t["k_cache"].cpu(), t["v_cache"],
            t["prefix_k"], t["prefix_v"], t["anc_local"], 1, num_heads=2,
            beam_size=2, scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("R,V", [(320, 50257), (320, 30000), (6, 1000),
                                 (3, 4097), (320, 10000), (40, 50257),
                                 (40, 30000), (40, 10000), (5, 50257),
                                 (5, 30000), (5, 10000)])
def test_lse_kernel_matches_plain(dev, dtype, R, V):
    """R = 5 / 40 / 320 are the candidate step's rows at batch 1 / 8 / 64;
    V the LSTM's, the Transformer decoder's and GPT-2's vocabularies (and
    two odd ones). Block maxima bit-identical, the LSE within rtol 1e-5."""
    g = torch.Generator().manual_seed(V)
    x = (torch.randn((R, V), generator=g) * 3).to(dtype)
    before = port_lse.lse_and_block_max.launches
    lse, bm = port_lse.lse_and_block_max(x.to(dev))
    assert port_lse.lse_and_block_max.launches == before + 1
    want_lse, want_bm = port_lse.lse_and_block_max_plain(x)
    torch.testing.assert_close(lse.cpu(), want_lse, rtol=1e-5, atol=0)
    assert torch.equal(bm.cpu(), want_bm)


def test_lse_kernel_reads_a_row_strided_view(dev):
    x = torch.randn((8, 1500), device=dev)
    view = x[:, :1300]
    lse, bm = port_lse.lse_and_block_max(view)
    want_lse, want_bm = port_lse.lse_and_block_max_plain(view.cpu())
    torch.testing.assert_close(lse.cpu(), want_lse, rtol=1e-5, atol=0)
    assert torch.equal(bm.cpu(), want_bm)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("R,V", [(320, 50257), (5, 10000), (7, 600)])
def test_lse_kernel_reads_misaligned_rows(dev, dtype, R, V):
    """A view whose row stride is odd and whose first column is not the
    allocation's: every row starts at another offset from a 16-byte
    boundary, and the 512-blocks straddle the kernel's vectors."""
    g = torch.Generator().manual_seed(R + V)
    width = V + 1 + V % 2  # odd
    x = (torch.randn((R, width), generator=g) * 3).to(dtype).to(dev)
    view = x[:, 1:V + 1]
    assert view.stride(0) % 2 == 1
    lse, bm = port_lse.lse_and_block_max(view)
    want_lse, want_bm = port_lse.lse_and_block_max_plain(view.cpu())
    torch.testing.assert_close(lse.cpu(), want_lse, rtol=1e-5, atol=0)
    assert torch.equal(bm.cpu(), want_bm)


def test_lse_kernel_runs_are_bit_identical(dev):
    """The rows' partials merge in a fixed order, whichever block of a row
    ends last."""
    g = torch.Generator().manual_seed(11)
    for R in (5, 40, 320):
        x = (torch.randn((R, 50257), generator=g) * 3).bfloat16().to(dev)
        first = port_lse.lse_and_block_max(x)
        for _ in range(3):
            again = port_lse.lse_and_block_max(x)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_lse_kernel_keeps_minus_inf_and_the_ragged_padding(dev):
    """Rows of -inf (a suppressed vocabulary) give -inf, as
    ``torch.logsumexp`` does; the ragged block's maximum takes the -1e30
    padding where every real column lies below it."""
    x = torch.randn((4, 1100), device=dev)
    x[1] = float("-inf")
    x[2, 1024:] = -3e30
    lse, bm = port_lse.lse_and_block_max(x)
    want_lse, want_bm = port_lse.lse_and_block_max_plain(x.cpu())
    torch.testing.assert_close(lse.cpu(), want_lse, rtol=1e-5, atol=0)
    assert float(lse[1]) == float("-inf")
    assert torch.equal(bm.cpu(), want_bm)
    assert float(bm[2, 2]) == float(torch.tensor(-1e30))  # in float32


def test_lse_kernel_raises_on_what_it_does_not_take(dev):
    before = port_lse.lse_and_block_max.launches
    with pytest.raises(TypeError, match="takes"):
        port_lse.lse_and_block_max(torch.zeros((3, 600), device=dev,
                                               dtype=torch.float64))
    with pytest.raises(ValueError, match="unit column stride"):
        port_lse.lse_and_block_max(torch.zeros((600, 3), device=dev).t())
    with pytest.raises(ValueError, match="empty logits"):
        port_lse.lse_and_block_max(torch.zeros((0, 600), device=dev))
    assert port_lse.lse_and_block_max.launches == before


def _stack_weights(L, H, F, dtype, seed):
    """Layer-stacked weights at GPT-2's initial scale (LayerNorm f32)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in stack_shapes(L, H, F).items():
        t = torch.randn(shape, generator=g)
        out[name] = (t * 0.1 + (1.0 if name[0] == "g" else 0.0)
                     if name in LN_KEYS else (t * 0.02).to(dtype))
    return out


def _close(got, want, dtype, f32_rel, bf16_ulps):
    """float32: within ``f32_rel`` of the largest magnitude (the GEMMs sum
    in another order than cuBLAS); bfloat16: within ``bf16_ulps`` bf16 ulps
    of it (an f32 sum that lands near a rounding boundary rounds the other
    way, and the layers carry that on)."""
    err = float((got.float() - want.float()).abs().max())
    mag = float(want.float().abs().max())
    tol = f32_rel * mag if dtype == torch.float32 \
        else bf16_ulps * _bf16_ulp(want.float())
    assert err <= tol, (err, tol)


def _untouched_but_pos(got, before, pos):
    rest = [t for t in range(got.shape[-2]) if t != pos]
    assert torch.equal(got[..., rest, :], before[..., rest, :])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,S,P,NH,H,pos,anc", [
    (64, 5, 20, 10, 12, 768, 19, True),   # served shapes, last step
    (64, 5, 20, 10, 12, 768, 0, True),    # first step
    (64, 5, 20, 0, 12, 768, 19, True),    # Transformer decoder: no prefix
    (64, 5, 20, 0, 12, 768, 7, True),
    (64, 5, 20, 0, 12, 768, 0, True),
    (3, 1, 7, 2, 2, 48, 3, False),        # K=1, no ancestry, ragged tiles
])
def test_attention_qkv_kernel_matches_plain(dev, dtype, B, K, S, P, NH, H,
                                            pos, anc):
    inputs = _attention_inputs(B, K, S, P, H, seed=S + pos + 1)
    w = _stack_weights(1, H, 4 * H, dtype, seed=H)
    t = {k: (v.to(dev) if k == "anc_local" else v.to(dev, dtype))
         for k, v in inputs.items()}
    ws = [w[k][0].to(dev) for k in ("wqkv", "bqkv", "wo", "bo")]
    out = {}
    for fn in (bda.beam_decode_attention_qkv,
               bda.beam_decode_attention_qkv_plain):
        kc, vc = t["k_cache"].clone(), t["v_cache"].clone()
        before = bda.beam_decode_attention_qkv.launches
        o, kc, vc = fn(t["q"], *ws, kc, vc, t.get("prefix_k"),
                       t.get("prefix_v"),
                       t["anc_local"] if anc else None, pos, num_heads=NH,
                       beam_size=K, scale=(H // NH) ** -0.5)
        torch.cuda.synchronize()
        launched = bda.beam_decode_attention_qkv.launches - before
        assert launched == (fn is bda.beam_decode_attention_qkv)
        _untouched_but_pos(kc, t["k_cache"], pos)
        _untouched_but_pos(vc, t["v_cache"], pos)
        out[fn] = (o, kc[:, pos], vc[:, pos])
    got, want = out.values()
    _close(got[0], want[0], dtype, 1e-5, 4)
    for g, w_ in zip(got[1:], want[1:]):
        _close(g, w_, dtype, 1e-5, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,K,S,P,NH,H,pos,anc", [
    (12, 64, 5, 20, 10, 12, 768, 19, True),   # served shapes
    (6, 64, 5, 20, 10, 8, 768, 19, True),     # JAX default: head dim 96
    (2, 4, 3, 9, 2, 4, 64, 0, True),          # first step, small
    (3, 3, 1, 7, 3, 2, 48, 5, False),         # K=1, no ancestry
    (1, 1, 5, 20, 10, 12, 768, 7, True),      # bucket 1 at full width: 5 rows
    (1, 8, 5, 20, 10, 12, 768, 7, True),      # bucket 8: 40 rows
])
def test_stack_kernel_matches_plain(dev, dtype, L, B, K, S, P, NH, H, pos,
                                    anc):
    g = torch.Generator().manual_seed(L * 100 + pos)
    Bk = B * K
    x = torch.randn((Bk, H), generator=g).to(dev, dtype)
    caches = [torch.randn((L, Bk, S, H), generator=g).to(dev, dtype)
              for _ in range(2)]
    pk, pv = (torch.randn((L, B, P, H), generator=g).to(dev, dtype)
              for _ in range(2))
    a = torch.randint(0, K, (Bk, S), generator=g, dtype=torch.int32).to(dev)
    w = {k: v.to(dev) for k, v in _stack_weights(L, H, 4 * H, dtype,
                                                 seed=H).items()}
    out = []
    for fn in (bds.beam_decode_stack, bds.beam_decode_stack_plain):
        kc, vc = caches[0].clone(), caches[1].clone()
        before = bds.beam_decode_stack.launches
        o, kc, vc = fn(x, w, kc, vc, pk, pv, a if anc else None, pos,
                       num_heads=NH, beam_size=K, scale=(H // NH) ** -0.5)
        torch.cuda.synchronize()
        assert bds.beam_decode_stack.launches - before == (
            fn is bds.beam_decode_stack)
        _untouched_but_pos(kc, caches[0], pos)
        _untouched_but_pos(vc, caches[1], pos)
        out.append((o, kc[..., pos, :], vc[..., pos, :]))
    for got, want in zip(*out):
        _close(got, want, dtype, 1e-4, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,T,NH,H", [
    (12, 64, 50, 12, 768),  # served: CLIP ViT-B/32 at 224x224
    (2, 3, 7, 4, 64),       # few tokens, ragged tiles
    (1, 2, 80, 2, 128),     # attention above 48 KB of shared memory
    (1, 1, 50, 12, 768),    # bucket 1 at full width: 50 rows
    (1, 8, 50, 12, 768),    # bucket 8: 400 rows
    (1, 2, 64, 2, 128),     # heads of 64: a full tensor-core token tile
    (1, 3, 33, 2, 128),     # and a ragged one
])
def test_encoder_kernel_matches_plain(dev, dtype, L, B, T, NH, H):
    g = torch.Generator().manual_seed(T)
    x = torch.randn((B, T, H), generator=g).to(dev, dtype)
    w = {k: v.to(dev) for k, v in _stack_weights(L, H, 4 * H, dtype,
                                                 seed=T).items()}
    before = es.encoder_stack.launches
    with torch.inference_mode():
        got = es.encoder_stack(x, w, num_heads=NH)
        want = es.encoder_stack_plain(x, w, num_heads=NH)
    torch.cuda.synchronize()
    assert es.encoder_stack.launches == before + 1
    _close(got, want, dtype, 1e-4, 8)


def test_remat_model_launches_the_encoder_kernel(dev):
    """``remat`` is a training option: a remat flagship built by
    ``load_model`` still encodes through the encoder kernel, as the same
    model without remat does (f32, within 1e-4)."""
    out = []
    for remat in (True, False):
        c = flagship_config()
        e = c.model.encoder
        e.num_layers, e.remat, c.model.dtype = 2, remat, "float32"
        c.model.decoder.num_layers = 1
        model = load_model(c, dev)
        images = torch.from_numpy(np.random.RandomState(0).randint(
            0, 256, (2, 224, 224, 3)).astype(np.uint8)).to(dev)
        before = es.encoder_stack.launches
        with torch.inference_mode():
            out.append(model.encode(images)["features"].cpu())
        assert es.encoder_stack.launches == before + 1, remat
    torch.testing.assert_close(out[0], out[1], atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_kernel_from_two_threads(dev, dtype):
    """The serving batcher and, for the CLIP reranker's vision tower, the
    completer thread launch the encoder kernel on the same stream: each
    thread keeps its own scratch, so two threads launching together give
    what each gives alone, bit for bit, and every launch is counted."""
    import threading

    H, NH, T, L = 768, 12, 50, 2
    w = {k: v.to(dev) for k, v in _stack_weights(L, H, 4 * H, dtype,
                                                 seed=3).items()}
    g = torch.Generator().manual_seed(4)
    xs = [torch.randn((B, T, H), generator=g).to(dev, dtype) for B in (8, 5)]
    with torch.inference_mode():
        alone = [es.encoder_stack(x, w, num_heads=NH) for x in xs]
    torch.cuda.synchronize()
    before = es.encoder_stack.launches
    got = [[], []]

    def launch(i):
        with torch.inference_mode():
            for _ in range(20):
                got[i].append(es.encoder_stack(xs[i], w, num_heads=NH))

    threads = [threading.Thread(target=launch, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    torch.cuda.synchronize()
    assert es.encoder_stack.launches == before + 40
    for i in (0, 1):
        assert len(got[i]) == 20
        assert all(torch.equal(out, alone[i]) for out in got[i])


# the Dense GEMM (csrc/common.cuh) at every (M, N, K) the two whole-stack
# kernels give it (encoder rows 50 / 400 / 3200, decoder rows 5 / 40 / 320
# for buckets 1 / 8 / 64; QKV, output projection, MLP in and out at width
# 768) and at ragged ones
_DENSE_SHAPES = [(M, N, K) for M in (5, 40, 320, 50, 400, 3200)
                 for N, K in ((2304, 768), (768, 768), (3072, 768),
                              (768, 3072))]
_DENSE_SHAPES += [(1, 72, 776), (63, 72, 776), (65, 768, 776),
                  (321, 72, 768), (321, 2304, 776)]


@pytest.mark.parametrize("epilogue", list(dl.EPILOGUES))
@pytest.mark.parametrize("M,N,K", _DENSE_SHAPES)
def test_dense_gemm_matches_plain(dev, M, N, K, epilogue):
    """bf16 within 2 ulps of the largest output; two runs on the same
    inputs bit-identical (the split over K adds in a fixed order)."""
    g = torch.Generator().manual_seed(M + N + K)
    x = torch.randn((M, K), generator=g).to(dev, torch.bfloat16)
    w = (torch.randn((N, K), generator=g) * 0.02).to(dev, torch.bfloat16)
    b = (torch.randn((N,), generator=g) * 0.02).to(dev, torch.bfloat16)
    r = torch.randn((M, N), generator=g).to(dev, torch.bfloat16) \
        if epilogue == "residual" else None
    got = dl.dense_layer(x, w, b, r, epilogue)
    again = dl.dense_layer(x, w, b, r, epilogue)
    want = dl.dense_layer_plain(x, w, b, r, epilogue)
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16, 0.0, 2)
    assert torch.equal(got, again)


def test_dense_gemm_float32_matches_plain(dev):
    g = torch.Generator().manual_seed(5)
    x, w = (torch.randn(s, generator=g).to(dev) for s in ((65, 72), (40, 72)))
    b = torch.randn((40,), generator=g).to(dev)
    got = dl.dense_layer(x, w, b, epilogue="gelu_new")
    _close(got, dl.dense_layer_plain(x, w, b, epilogue="gelu_new"),
           torch.float32, 1e-5, 0)


def test_fused_kernels_raise_on_what_they_do_not_take(dev):
    x = torch.zeros((6, 36), device=dev)
    w = {k: v.to(dev) for k, v in _stack_weights(1, 36, 144, torch.float32,
                                                 seed=0).items()}
    caches = torch.zeros((1, 6, 4, 36), device=dev)
    prefix = torch.zeros((1, 2, 1, 36), device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        bds.beam_decode_stack(x, w, caches, caches.clone(), prefix,
                              prefix.clone(), None, 0, num_heads=4,
                              beam_size=3, scale=1.0)
    with pytest.raises(ValueError, match="expected"):
        es.encoder_stack(torch.zeros((2, 5, 64), device=dev),
                         {k: v.cpu() for k, v in _stack_weights(
                             1, 64, 256, torch.float32, seed=0).items()},
                         num_heads=4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bda.beam_decode_attention_qkv(
            x.half(), *(w[k][0].half() for k in ("wqkv", "bqkv", "wo", "bo")),
            caches[0].half(), caches[0].half(), None, None, None, 0,
            num_heads=4, beam_size=3, scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,NH,H,Sm,masked", [
    (64, 5, 12, 768, 196, True),   # served shapes (f32: 100 KB of smem)
    (64, 5, 12, 768, 196, False),  # no mask
    (3, 1, 2, 40, 13, True),       # K=1; rows too short for 16-byte copies
    (2, 7, 4, 256, 33, True),      # more beams than warps hold at once
    (1, 5, 12, 768, 196, True),    # bucket 1
    (8, 5, 12, 768, 196, True),    # bucket 8
    (2, 8, 12, 768, 197, True),    # eight beams, a ragged memory
    (3, 5, 12, 768, 1, False),     # one memory row
])
def test_cross_attention_kernel_matches_plain(dev, dtype, B, K, NH, H, Sm,
                                              masked):
    """f32 within 1e-5 (another summation order); bf16 within 2 ulps of the
    output's largest magnitude (a weight near a bf16 rounding boundary
    rounds the other way)."""
    g = torch.Generator().manual_seed(B * Sm + K)
    q = torch.randn((B * K, H), generator=g).to(dev, dtype)
    mkt = torch.randn((B, H, Sm), generator=g).to(dev, dtype)
    mv = torch.randn((B, Sm, H), generator=g).to(dev, dtype)
    mask = None
    if masked:
        mask = (torch.rand((B, Sm), generator=g) < 0.25).to(dev)
        mask[:, 0] = False
    kw = dict(num_heads=NH, beam_size=K, scale=(H // NH) ** -0.5)
    before = ca.cross_attention.launches
    got = ca.cross_attention(q, mkt, mv, mask, **kw)
    torch.cuda.synchronize()
    assert ca.cross_attention.launches == before + 1
    want = ca.cross_attention_plain(q, mkt, mv, mask, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert float((got.float() - want.float()).abs().max()) <= \
            2 * _bf16_ulp(want.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sm,masked", [(32, False), (36, True), (49, False),
                                       (48, False)],
                         ids=["qformer", "butd", "swin", "tensor-core-48"])
def test_cross_attention_kernel_at_the_families_memory_lengths(dev, dtype,
                                                               Sm, masked):
    """The Q-Former's 32 queries, BUTD's 36 regions with each image's
    tail past 20 to 36 valid ones masked, Swin-B's 49 final tokens (the
    CUDA-core route in bf16: not a multiple of 4) and 48 (the tensor-core
    route), at 64 images x 5 beams, 12 heads, width 768: f32 within 1e-5,
    bf16 within 2 ulps of the output's largest magnitude."""
    B, K, NH, H = 64, 5, 12, 768
    g = torch.Generator().manual_seed(Sm)
    q = torch.randn((B * K, H), generator=g).to(dev, dtype)
    mkt = torch.randn((B, H, Sm), generator=g).to(dev, dtype)
    mv = torch.randn((B, Sm, H), generator=g).to(dev, dtype)
    mask = None
    if masked:
        counts = torch.randint(20, Sm + 1, (B, 1), generator=g)
        mask = (torch.arange(Sm)[None] >= counts).to(dev)
    kw = dict(num_heads=NH, beam_size=K, scale=(H // NH) ** -0.5)
    got = ca.cross_attention(q, mkt, mv, mask, **kw)
    want = ca.cross_attention_plain(q, mkt, mv, mask, **kw)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert float((got.float() - want.float()).abs().max()) <= \
            2 * _bf16_ulp(want.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_kernel_with_all_but_one_row_masked(dev, dtype):
    """Every memory row masked but one: the weights are one-hot there."""
    B, K, NH, H, Sm = 4, 5, 12, 768, 196
    g = torch.Generator().manual_seed(3)
    q = torch.randn((B * K, H), generator=g).to(dev, dtype)
    mkt = torch.randn((B, H, Sm), generator=g).to(dev, dtype)
    mv = torch.randn((B, Sm, H), generator=g).to(dev, dtype)
    mask = torch.ones((B, Sm), dtype=torch.bool)
    mask[torch.arange(B), torch.tensor([0, 57, 130, 195])] = False
    mask = mask.to(dev)
    kw = dict(num_heads=NH, beam_size=K, scale=(H // NH) ** -0.5)
    got = ca.cross_attention(q, mkt, mv, mask, **kw)
    want = ca.cross_attention_plain(q, mkt, mv, mask, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_cross_attention_kernel_raises_on_what_it_does_not_take(dev):
    q = torch.zeros((6, 64), device=dev)
    mkt, mv = torch.zeros((2, 64, 5), device=dev), torch.zeros((2, 5, 64),
                                                               device=dev)
    kw = dict(num_heads=4, beam_size=3, scale=1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ca.cross_attention(q.half(), mkt.half(), mv.half(), None, **kw)
    with pytest.raises(ValueError, match="pad_mask is torch.int32"):
        ca.cross_attention(q, mkt, mv, torch.zeros((2, 5), device=dev,
                                                   dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="mem_v is"):
        ca.cross_attention(q, mkt, mv.cpu(), None, **kw)
    with pytest.raises(RuntimeError, match="shared memory"):
        # the K x Sm f32 scores alone are above 227 KB
        big = torch.zeros((2, 64, 20000), device=dev)
        ca.cross_attention(q, big, big.transpose(1, 2).contiguous(), None,
                           **kw)


def _sdpa_inputs(B, K, Q, S, NH, hd, masked, seed):
    """q [B*K, Q, NH*hd], k and v [B, S, NH*hd] and the mask: None, a
    quarter of the keys (never the first), or that with the last image's
    keys all masked (``masked="all"``)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B * K, Q, NH * hd), generator=g)
    k = torch.randn((B, S, NH * hd), generator=g)
    v = torch.randn((B, S, NH * hd), generator=g)
    mask = None
    if masked:
        mask = torch.rand((B, S), generator=g) < 0.25
        mask[:, 0] = False
        if masked == "all":
            mask[-1] = True
    return q, k, v, mask


def _heads(x, NH):
    """[N, T, NH*hd] -> the [N, NH, T, hd] view, as the module takes it."""
    N, T, h = x.shape
    return x.view(N, T, NH, h // NH).transpose(1, 2)


def _offset(x):
    """``x`` as a view one value into rows 8 values wider: no start is 4-
    or 16-byte aligned in bf16, and the rows are strided."""
    N, T, h = x.shape
    wide = torch.zeros((N, T, h + 8), dtype=x.dtype, device=x.device)
    wide[..., 1:h + 1] = x
    return wide[..., 1:h + 1]


# (images, beams, Q, S, NH, hd, masked, layout): the first five as served
# and at the first version's edges, then the tensor-core path's tile edges
# (S across the 8- and 16-key tiles and past its 64 keys; K x Q across the
# 16-row tiles; each head width), batch 1, an image whose keys are all
# masked, and q, k, v at unaligned strided views
_SDPA_CUDA_CASES = [
    (64, 5, 1, 49, 8, 64, False, "heads"),   # served: 64 images x 5 beams
    (64, 5, 1, 49, 8, 64, True, "heads"),
    (64, 1, 20, 49, 8, 64, True, "heads"),   # teacher-forced shape, Q = 20
    (3, 3, 5, 13, 2, 20, True, "heads"),     # odd rows, hd not 16-byte whole
    (2, 1, 40, 196, 4, 32, False, "heads"),  # two row chunks, ViT-sized memory
] + [(2, K, Q, S, 2, 64, True, "heads") for S in (1, 8, 49, 56, 64, 65)
     for K, Q in ((1, 1), (5, 1), (16, 1), (17, 1), (1, 20), (5, 8))] + [
    (2, 5, 1, 49, 2, hd, True, "heads") for hd in (16, 32, 128, 20)] + [
    (1, 5, 1, 49, 8, 64, True, "heads"),     # batch 1
    (4, 5, 1, 49, 8, 64, "all", "heads"),
    (4, 1, 20, 49, 8, 64, "all", "heads"),
    (4, 5, 1, 49, 8, 64, True, "offset"),
    (4, 1, 20, 49, 8, 64, "all", "offset"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,Q,S,NH,hd,masked,layout", _SDPA_CUDA_CASES)
def test_sdpa_kernel_matches_plain(dev, dtype, B, K, Q, S, NH, hd, masked,
                                   layout):
    """Context: f32 within 1e-5 (another summation order), bf16 within 2
    ulps of its largest magnitude (a weight near a bf16 rounding boundary
    rounds the other way); weights within 1e-5 in both. bf16 with hd a
    multiple of 16 up to 128, S <= 64 and K x Q <= 64 runs on the tensor
    cores, the rest on the CUDA cores; an all-masked image gets 1/S."""
    q, k, v, mask = _sdpa_inputs(B, K, Q, S, NH, hd, masked, B * S + Q + hd)
    view = _offset if layout == "offset" else (lambda x: x)
    q, k, v = (_heads(view(t.to(dev, dtype)), NH) for t in (q, k, v))
    mask = None if mask is None else mask.to(dev)
    kw = dict(scale=hd ** -0.5, beam_size=K)
    before = port_sdpa.sdpa.launches
    ctx, w = port_sdpa.sdpa(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert port_sdpa.sdpa.launches == before + 1
    tensor_cores = (dtype == torch.bfloat16 and hd % 16 == 0 and hd <= 128
                    and S <= 64 and K * Q <= 64)
    assert port_sdpa.sdpa.last_route == (
        "tensor_cores" if tensor_cores else "cuda_cores")
    want_ctx, want_w = port_sdpa.sdpa_plain(q, k, v, mask, **kw)
    assert ctx.shape == want_ctx.shape and ctx.dtype == q.dtype
    torch.testing.assert_close(w, want_w, atol=1e-5, rtol=1e-5)
    if masked == "all":
        torch.testing.assert_close(
            w[-K:], torch.full_like(w[-K:], 1.0 / S), atol=1e-7, rtol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(ctx, want_ctx, atol=1e-5, rtol=1e-5)
    else:
        assert float((ctx.float() - want_ctx.float()).abs().max()) <= \
            2 * _bf16_ulp(want_ctx.float())


def test_sdpa_kernel_raises_on_what_it_does_not_take(dev):
    q, k, v, _ = _sdpa_inputs(2, 1, 1, 5, 2, 8, False, 0)
    q, k, v = (_heads(t.to(dev), 2) for t in (q, k, v))
    kw = dict(scale=1.0, beam_size=1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        port_sdpa.sdpa(q.half(), k.half(), v.half(), None, **kw)
    with pytest.raises(ValueError, match="head dimension must be contiguous"):
        strided = torch.cat([q, q], dim=-1)[..., ::2]  # q's shape, stride 2
        port_sdpa.sdpa(strided, k, v, None, **kw)
    with pytest.raises(ValueError, match="v is"):
        port_sdpa.sdpa(q, k, v.cpu(), None, **kw)
    with pytest.raises(RuntimeError, match="shared memory"):
        big = torch.zeros((1, 1, 4000, 256), device=dev)
        port_sdpa.sdpa(torch.zeros((1, 1, 1, 256), device=dev), big, big,
                       None, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,Q,S,H,masked", [
    (64, 5, 1, 49, 512, False),   # served: 64 images x 5 beams, 7x7 rows
    (64, 5, 1, 49, 512, True),
    (64, 1, 20, 49, 512, True),   # teacher-forced shape, Q = 20
    (3, 3, 5, 13, 40, True),      # odd rows, width not a multiple of 32
    (1, 5, 1, 49, 512, False),    # the service's buckets 1 and 8
    (1, 5, 1, 49, 512, True),
    (8, 5, 1, 49, 512, False),
    (8, 5, 1, 49, 512, True),
    (64, 1, 20, 49, 512, False),
    (2, 3, 2, 7, 1024, True),     # two passes of a lane's key chunks
])
def test_additive_scores_kernel_matches_plain(dev, dtype, B, K, Q, S, H,
                                              masked):
    """Within 1e-5 of the largest unmasked score, in both dtypes: the sum
    and the tanh round to the input dtype exactly as the plain version's
    do, and only the f32 sum's order differs; masked scores equal."""
    g = torch.Generator().manual_seed(B * S + Q)
    qp = (torch.randn((B * K, Q, H), generator=g) * 0.5).to(dev, dtype)
    kp = (torch.randn((B, S, H), generator=g) * 0.5).to(dev, dtype)
    ew = (torch.randn((1, H), generator=g) * 0.1).to(dev, dtype)
    eb = torch.randn((1,), generator=g).to(dev, dtype)
    mask = None
    if masked:
        mask = (torch.rand((B, S), generator=g) < 0.25).to(dev)
        mask[:, 0] = False
    kw = dict(temperature=0.7, beam_size=K)
    before = adds.additive_scores.launches
    got = adds.additive_scores(qp, kp, ew, eb, mask, **kw)
    torch.cuda.synchronize()
    assert adds.additive_scores.launches == before + 1
    want = adds.additive_scores_plain(qp, kp, ew, mask, **kw) \
        + eb.reshape(()) / kw["temperature"]
    assert got.dtype == torch.float32 and got.shape == (B * K, Q, S)
    keep = want > -1e8
    assert torch.equal(got[~keep], want[~keep])
    mag = float(want[keep].abs().max())
    assert float((got - want)[keep].abs().max()) <= 1e-5 * mag


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_additive_scores_kernel_adds_the_bias(dev, dtype):
    """The kernel adds ``round_T(energy_b / T)`` to every score, masked
    ones included, as the plain version plus the bias does."""
    g = torch.Generator().manual_seed(77)
    B, K, S, H = 4, 5, 49, 512
    qp = (torch.randn((B * K, 1, H), generator=g) * 0.5).to(dev, dtype)
    kp = (torch.randn((B, S, H), generator=g) * 0.5).to(dev, dtype)
    ew = (torch.randn((1, H), generator=g) * 0.1).to(dev, dtype)
    mask = (torch.rand((B, S), generator=g) < 0.25).to(dev)
    mask[:, 0] = False
    for bias, T in ((3.3, 0.6), (-1.7, 1.3), (0.0, 2.0)):
        eb = torch.tensor([bias], dtype=dtype, device=dev)
        got = adds.additive_scores(qp, kp, ew, eb, mask, temperature=T,
                                   beam_size=K)
        scores = adds.additive_scores_plain(qp, kp, ew, mask, temperature=T,
                                            beam_size=K)
        want = scores + eb.reshape(()) / T
        keep = ~mask[:, None, None, :].expand(B, K, 1, S).reshape(B * K, 1,
                                                                  S)
        assert torch.equal(got[~keep], want[~keep])
        mag = float(want[keep].abs().max())
        assert float((got - want)[keep].abs().max()) <= 1e-5 * mag


def test_additive_scores_kernel_raises_on_what_it_does_not_take(dev):
    """The kernel reads rows in 16-byte chunks from 16-byte boundaries; it
    has no shared memory and so no other limit on the width."""
    qp, kp = torch.zeros((2, 1, 8), device=dev), torch.zeros((2, 3, 8),
                                                             device=dev)
    ew, eb = torch.zeros((1, 8), device=dev), torch.zeros(1, device=dev)
    kw = dict(temperature=1.0, beam_size=1)
    before = adds.additive_scores.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        adds.additive_scores(qp.half(), kp.half(), ew.half(), eb, None, **kw)
    with pytest.raises(ValueError, match="k_proj is"):
        adds.additive_scores(qp, kp.cpu(), ew, eb, None, **kw)
    with pytest.raises(ValueError, match="width 6"):
        adds.additive_scores(qp[..., :6].contiguous(),
                             kp[..., :6].contiguous(),
                             ew[:, :6].contiguous(), eb, None, **kw)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flat = torch.zeros(2 * 8 + 1, device=dev)
        adds.additive_scores(flat[1:].view(2, 1, 8), kp, ew, eb, None, **kw)
    with pytest.raises(ValueError, match="energy_b is"):
        adds.additive_scores(qp, kp, ew, eb.bfloat16(), None, **kw)
    assert adds.additive_scores.launches == before
    wide = torch.zeros((1, 1, 20000), device=dev)  # no width limit
    out = adds.additive_scores(wide, torch.zeros((1, 2, 20000), device=dev),
                               torch.zeros(20000, device=dev), eb, None, **kw)
    assert torch.equal(out, torch.zeros((1, 1, 2), device=dev))


_CONFIGS = {"stack": ("1", "1", "1"), "fold": ("0", "1", "1"),
            "split": ("0", "0", "0")}


@pytest.mark.parametrize("config", ["fold", "split"])
def test_tiny_model_decode_on_each_configuration_matches_cpu(
        dev, config, monkeypatch):
    """f32, per decode configuration (the default one is the test
    below)."""
    for name, value in zip(("ICT_DECODE_STACK", "ICT_DECODE_FOLD",
                            "ICT_ENCODER_FOLD"), _CONFIGS[config]):
        monkeypatch.setenv(name, value)
    _tiny_decode_matches_cpu(dev, 5000)


@pytest.mark.parametrize("vocab", [1000, 5000])
def test_tiny_model_decode_on_the_card_matches_cpu(dev, vocab):
    """f32: the kernels' decode equals the plain versions' decode (on the
    configuration the switches choose, by default stack + encoder
    fold)."""
    _tiny_decode_matches_cpu(dev, vocab)


@pytest.mark.parametrize("fold", ["1", "0"], ids=["fold", "split"])
def test_tiny_transformer_decode_on_the_card_matches_cpu(dev, fold,
                                                         monkeypatch):
    """f32, ViT + Transformer decoder, both configurations."""
    monkeypatch.setenv("ICT_DECODE_FOLD", fold)
    _tiny_decode_matches_cpu(dev, 5000, transformer_config())


@pytest.mark.parametrize("attention,heads,pallas", [
    ("soft", 8, True), ("soft", 8, False), ("multi_head", 8, True),
    ("adaptive", 1, True), ("aoa", 8, True)])
def test_tiny_lstm_decode_on_the_card_matches_cpu(dev, attention, heads,
                                                  pallas):
    """f32, ResNet + LSTM with each attention variant."""
    c = lstm_config()
    c.model.attention.attention_type = AttentionType(attention)
    c.model.attention.num_heads = heads
    c.model.attention.use_pallas = pallas
    _tiny_decode_matches_cpu(dev, 1000, c)


def _peak_logits(c, models, images, target_std=3.0):
    """Scale the LSTM's output layer on both models so that the CPU
    model's first-step logits have a standard deviation of 3 over the
    vocabulary: the seeded tiny LSTM's logits are almost flat, so its beams
    sit in near-ties that either device's f32 summation order may flip."""
    with torch.inference_mode():
        state = models["cpu"].init_cache(images, c.inference.max_length)
        bos = torch.full((images.shape[0],), c.model.bos_token_id)
        logits = models["cpu"].step(state, bos)[0]
        factor = target_std / float(logits.std(dim=-1).mean())
        for model in models.values():
            model.decoder.output_layer.weight.mul_(factor)
            model.decoder.output_layer.bias.mul_(factor)


def _tiny_decode_matches_cpu(dev, vocab, c=None):
    c = c or flagship_config()
    e, d = c.model.encoder, c.model.decoder
    e.hidden_size = e.feature_dim = d.hidden_dim = 64
    c.model.attention.hidden_dim = 64
    e.num_layers = d.num_layers = 2
    e.num_heads = d.num_heads = 4
    e.resnet_depths, e.resnet_hidden_sizes = (1, 2), (16, 32)
    e.resnet_embedding_size = 8
    e.patch_size, d.prefix_length = 16, 3
    c.image_size, c.model.vocab_size, c.model.dtype = 32, vocab, "float32"
    c.inference.max_length, c.inference.min_length = 10, 2
    images = torch.from_numpy(np.random.RandomState(vocab).randint(
        0, 256, (3, 32, 32, 3)).astype(np.uint8))
    models = {where.type: load_model(c, where)
              for where in (dev, torch.device("cpu"))}
    if d.decoder_type == DecoderType.LSTM:
        _peak_logits(c, models, images)
    out = []
    for where, model in models.items():
        mc, ic = c.model, c.inference
        with torch.inference_mode():
            state = model.init_cache(images.to(where), ic.max_length)
            res = beam_search(model.step, state, 3, ic.beam_size,
                              mc.bos_token_id, mc.eos_token_id,
                              mc.pad_token_id, ic.max_length,
                              length_penalty=ic.length_penalty,
                              min_length=ic.min_length, return_all=True)
        out.append((res.tokens.cpu(), res.scores.cpu()))
    if d.decoder_type == DecoderType.LSTM:
        # the seeded tiny LSTM's attention is nearly uniform, so every step
        # gives nearly the same distribution and its lower beams are
        # permutations of one another with equal scores, ordered by the
        # last bits of their sums: the best hypothesis is held token for
        # token, every beam's score to 1e-4
        assert torch.equal(out[0][0][:, 0], out[1][0][:, 0])
    else:
        assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[0][1], out[1][1], atol=1e-4, rtol=0)


# -- training (the CE step reaches no kernel; validation does) --------------

_KERNELS = (bds.beam_decode_stack, es.encoder_stack,
            port_lse.lse_and_block_max, bda.beam_decode_attention, bda.beam_decode_attention_qkv,
            ca.cross_attention, port_sdpa.sdpa, adds.additive_scores)


def test_global_norm_on_the_card(dev):
    """The card's one ``_foreach_norm`` over a list holding GPT-2's
    embedding-sized gradient: within 1e-6 relative of a float64 sum."""
    from image_captioning_ml_project_tpu_torch.train.optim import (
        global_norm)

    g = torch.Generator().manual_seed(3)
    grads = [torch.randn(50257, 768, generator=g) * 1e-3,
             torch.randn(768, generator=g), torch.zeros(5)]
    want = float(sum(t.double().square().sum() for t in grads).sqrt())
    got = global_norm([t.to(dev) for t in grads])
    assert got.is_cuda
    assert float(got) == pytest.approx(want, rel=1e-6)


def _train_config(tmp_path, family):
    from image_captioning_ml_project_tpu_torch.config import (
        EncoderType, get_default_config)

    c = get_default_config()
    e, d = c.model.encoder, c.model.decoder
    e.encoder_type = EncoderType(family[0])
    e.hidden_size = e.feature_dim = d.hidden_dim = 64
    e.num_layers = d.num_layers = 2
    e.num_heads = d.num_heads = 4
    e.patch_size, e.resnet_depths, e.resnet_hidden_sizes = 16, (1, 2), \
        (16, 32)
    e.resnet_embedding_size = 8
    d.decoder_type = DecoderType(family[1])
    d.prefix_length, d.max_length, d.dropout = 3, 16, 0.0
    c.model.attention.attention_type = AttentionType.SOFT
    c.model.attention.hidden_dim, c.model.attention.use_pallas = 64, True
    c.model.vocab_size, c.model.dtype, c.image_size = 5000, "float32", 32
    c.inference.max_length = 8
    tc = c.training
    tc.use_rl, tc.use_amp, tc.warmup_steps, tc.batch_size = False, False, 0, 2
    tc.learning_rate = 1e-3
    c.output_dir = c.checkpoint_dir = str(tmp_path)
    return c


@pytest.mark.parametrize("family", [("clip", "gpt2"), ("vit", "transformer"),
                                    ("resnet", "lstm")],
                         ids=lambda f: "-".join(f))
def test_train_step_on_the_card_matches_the_cpu(dev, tmp_path, family):
    """Two f32 CE steps of a tiny model on the card and on the CPU: losses
    within 1e-5 relative, ``grad_norm`` within 1e-4; no kernel launched in
    a step; the validation decode of the trained weights launches the
    family's kernels."""
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    cfg = _train_config(tmp_path, family)
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 32, 32, 3), generator=g,
                           dtype=torch.uint8)
    caps = torch.randint(3, 1000, (2, 7), generator=g)
    mask = torch.ones(2, 7, dtype=torch.int32)
    metrics = {}
    for device in (dev, "cpu"):
        t = CaptioningTrainer(cfg, [None] * 2, [], None, device=device)
        for k in _KERNELS:
            k.launches = 0
        metrics[str(device)] = [t.train_step(images, caps, mask)
                                for _ in range(2)]
        assert all(k.launches == 0 for k in _KERNELS)
        if device == dev:
            model = t.eval_state()
            tokens = t.val_decode_step(model, images)
            assert tokens.is_cuda
            assert port_lse.lse_and_block_max.launches > 0
            if family[1] == "gpt2":
                assert es.encoder_stack.launches > 0
                assert bds.beam_decode_stack.launches > 0
            if family[1] == "lstm":
                assert adds.additive_scores.launches > 0
    for a, b in zip(metrics[str(dev)], metrics["cpu"]):
        for key in ("total_loss", "ce_loss"):
            assert float(a[key]) == pytest.approx(float(b[key]), rel=1e-5)
        assert float(a["grad_norm"]) == pytest.approx(float(b["grad_norm"]),
                                                      rel=1e-4)


def _launches():
    return {k.__name__: k.launches for k in _KERNELS}


def test_scst_step_launches_kernels_in_the_rollouts_only(dev, tmp_path):
    """An SCST step of a tiny flagship (bf16) on the card: the rollouts
    launch #5 once and #3 once a decode step of each of their two decodes,
    and nothing else; the rewards and the update launch no kernel; the
    rewards are finite."""
    from image_captioning_ml_project_tpu_torch.evaluate.cider_device import (
        build_df_table, encode_references)
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    cfg = _train_config(tmp_path, ("clip", "gpt2"))
    cfg.model.dtype, cfg.training.use_amp = "bfloat16", True
    t = CaptioningTrainer(cfg, [None] * 2, [], None, device=dev)
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 32, 32, 3), generator=g,
                           dtype=torch.uint8).to(dev)
    refs = [[torch.randint(3, 50, (6,), generator=g).tolist()]
            for _ in range(2)]
    t._cider_df = build_df_table(refs, device=dev)
    ref_tokens, ref_valid = encode_references(refs, 5, 16)
    L = cfg.inference.max_length
    before = _launches()
    sampled, mask, greedy = t.rollout_step(
        t.rollout_model(), images, t._rollout_generator(t.step))
    rolled = {k: v - before[k] for k, v in _launches().items()}
    assert rolled["encoder_stack"] == 1
    assert 2 <= rolled["beam_decode_stack"] <= 2 * (L - 1)
    assert not {k: v for k, v in rolled.items()
                if v and k not in ("encoder_stack", "beam_decode_stack")}
    before = _launches()
    sample_r, greedy_r, adv = t.scst_rewards(sampled, greedy, ref_tokens,
                                             ref_valid)
    m = t.rl_update_step(images, sampled, mask, adv)
    assert _launches() == before
    assert sample_r.is_cuda and torch.isfinite(sample_r).all()
    assert math.isfinite(float(m["rl_loss"]))


def test_lstm_reinforce_forward_and_backward_skip_the_kernels(dev, tmp_path):
    """A tiny ResNet + LSTM with ``use_pallas`` on, soft and multi-head
    attention: its REINFORCE update on the card enters neither #8 nor #7
    (the eval forward under autograd takes the plain route), and matches
    the CPU's loss within 1e-5 relative."""
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    g = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (2, 32, 32, 3), generator=g,
                           dtype=torch.uint8)
    sampled = torch.randint(3, 1000, (2, 8), generator=g)
    mask = torch.ones(2, 8, dtype=torch.bool)
    adv = torch.tensor([0.5, -1.0])
    for attention in (AttentionType.SOFT, AttentionType.MULTI_HEAD):
        cfg = _train_config(tmp_path, ("resnet", "lstm"))
        cfg.model.attention.attention_type = attention
        losses = []
        for device in (dev, "cpu"):
            t = CaptioningTrainer(cfg, [None] * 2, [], None, device=device)
            before = _launches()
            losses.append(float(t.rl_update_step(images, sampled, mask,
                                                 adv)["rl_loss"]))
            assert _launches() == before, attention
        assert losses[0] == pytest.approx(losses[1], rel=1e-5), attention


def test_ngram_hashes_on_the_card_equal_the_host_hash(dev):
    """The device n-gram hash on the card, bit-equal to
    ``ngram_hashes_np`` on every in-range window (the -1 sentinel
    included) for n = 1..4."""
    from image_captioning_ml_project_tpu_torch.ops.ngram import (
        ngram_hashes, ngram_hashes_np)

    g = torch.Generator().manual_seed(2)
    toks = torch.randint(-1, 50257, (4, 50), generator=g)
    toks[0, :5] = -1
    for n in range(1, 5):
        h, v = ngram_hashes(toks.to(dev), n, (toks >= 0).to(dev))
        assert h.is_cuda
        for row, hashes in zip(toks.numpy(), h.cpu().numpy()):
            host = ngram_hashes_np(row.astype(np.uint32), n)
            np.testing.assert_array_equal(
                hashes[:len(host)].astype(np.uint32), host)


# -- the LayerNorm op (forward and backward kernels) ------------------------

# the main path's shapes (rows, width, eps): CLIP's CE step (512 x 50
# tokens), GPT-2's (512 x 30), the ViT-B/16 encode at 512 images (eps
# 1e-12), the Transformer decode step (512 x 5 beams); Swin-B's widths and
# its patch merging's; one width that is no whole number of 16-byte chunks
LN_SHAPES = [(25600, 768, 1e-5), (15360, 768, 1e-5), (100864, 768, 1e-12),
             (2560, 768, 1e-5), (3136, 128, 1e-5), (784, 256, 1e-5),
             (196, 512, 1e-5), (49, 1024, 1e-5), (784, 512, 1e-5),
             (196, 1024, 1e-5), (49, 2048, 1e-5), (49, 4096, 1e-5),
             (333, 129, 1e-5)]


def _ln_inputs(rows, H, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, H, generator=g) * 1.5 + 0.3
    w = 1 + 0.1 * torch.randn(H, generator=g)
    b = 0.1 * torch.randn(H, generator=g)
    dy = torch.randn(rows, H, generator=g) * 1e-2
    return (x.to(dev, dtype), w.to(dev), b.to(dev), dy.to(dev, dtype))


def _within(got, want, dtype, f32_rel):
    """float32: within ``f32_rel`` of the largest entry; bfloat16: within
    one bf16 ulp of it (each side rounds the same f32 value once)."""
    tol = (f32_rel * float(want.abs().max()) if dtype == torch.float32
           else _bf16_ulp(want.float()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,H,eps", LN_SHAPES)
def test_layer_norm_kernels_match_plain(dev, rows, H, eps, dtype):
    """y, dx, dgamma and dbeta of the op against its plain version on the
    same card; the forward without a gradient (no statistics written) too."""
    from image_captioning_ml_project_tpu_torch.ops import layer_norm as ln

    x, w, b, dy = _ln_inputs(rows, H, dtype, dev, rows + H)
    y_plain, stats_plain = ln.layer_norm_plain(x, w, b, eps)
    dx_plain, dw_plain, db_plain = ln.layer_norm_backward_plain(
        dy, x, stats_plain, w)
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    before = (ln.layer_norm.launches, ln.layer_norm_backward.launches)
    y = ln.layer_norm(xr, wr, br, eps)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (ln.layer_norm.launches, ln.layer_norm_backward.launches) == (
        before[0] + 1, before[1] + 1)
    _within(y.detach(), y_plain, dtype, 1e-5)
    _within(xr.grad, dx_plain, dtype, 1e-5)
    torch.testing.assert_close(wr.grad, dw_plain, rtol=0,
                               atol=1e-4 * float(dw_plain.abs().max()))
    torch.testing.assert_close(br.grad, db_plain, rtol=0,
                               atol=1e-4 * float(db_plain.abs().max()))
    with torch.inference_mode():
        y_eval = ln.layer_norm(x, w, b, eps)
    _within(y_eval, y_plain, dtype, 1e-5)


def test_layer_norm_backward_repeats_bit_for_bit(dev):
    """No atomics: the same backward twice gives the same bits."""
    from image_captioning_ml_project_tpu_torch.ops import layer_norm as ln

    x, w, b, dy = _ln_inputs(25600, 768, torch.bfloat16, dev, 1)
    _, stats = ln.layer_norm_plain(x, w, b, 1e-5)
    first = ln.layer_norm_backward(dy, x, stats, w)
    second = ln.layer_norm_backward(dy, x, stats, w)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def test_layer_norm_kernels_take_views_and_constant_rows(dev):
    """A strided view (``post_layernorm(x[:, 0])``): the gradients as the
    plain version's, on the view's base only; constant rows: the mean,
    rstd near eps's on whichever side of 0 the variance's rounding falls,
    finite gradients."""
    from image_captioning_ml_project_tpu_torch.ops import layer_norm as ln

    x, w, b, dy = _ln_inputs(512 * 3, 768, torch.float32, dev, 2)
    base = x.view(512, 3, 768).clone().requires_grad_()
    y = ln.layer_norm(base[:, 1], w, b, 1e-12)
    y.backward(dy[:512])
    want_x = x.view(512, 3, 768)[:, 1].contiguous()
    _, stats = ln.layer_norm_plain(want_x, w, b, 1e-12)
    dx, _, _ = ln.layer_norm_backward_plain(dy[:512], want_x, stats, w)
    _within(base.grad[:, 1], dx, torch.float32, 1e-5)
    assert not base.grad[:, [0, 2]].any()
    # constant rows: the variance is 0 but for the rounding of E[x^2] -
    # mu^2 (a few f32 ulps of x^2, either side of 0: below, the clamp)
    rows = torch.linspace(0.1, 3.0, 64, device=dev)[:, None].expand(
        64, 768).contiguous().requires_grad_()
    y, st = ln._forward(rows.detach(), w, b, 1e-5, stats=True)
    torch.testing.assert_close(st[:, 0], rows[:, 0].detach(), rtol=1e-6,
                               atol=0)
    scaled = st[:, 1].abs() * 1e-5 ** 0.5
    assert (scaled <= 1 + 1e-6).all() and (scaled >= 0.5).all()
    ln.layer_norm(rows, w, b, 1e-5).backward(dy[:64])
    assert torch.isfinite(rows.grad).all()


def test_layer_norm_counters_over_a_ce_step_and_a_decode_step(dev,
                                                              tmp_path):
    """The flagship's bf16 CE step runs 51 LayerNorms through the op,
    forward and backward (CLIP's pre, 2 x 12 and post; GPT-2's 2 x 12 and
    ln_f); the Transformer decoder's step 18 (three post-LN norms a layer,
    six layers)."""
    from image_captioning_ml_project_tpu_torch.ops import layer_norm as ln
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)

    c = flagship_config()
    c.model.dtype, c.training.use_amp, c.training.batch_size = (
        "bfloat16", True, 2)
    c.training.use_rl, c.training.warmup_steps = False, 0
    c.output_dir = c.checkpoint_dir = str(tmp_path)
    t = CaptioningTrainer(c, [None] * 2, [], None, device=dev)
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 224, 224, 3), generator=g,
                           dtype=torch.uint8)
    caps = torch.randint(3, 1000, (2, 20), generator=g)
    mask = torch.ones(2, 20, dtype=torch.int32)
    ln.layer_norm.launches = ln.layer_norm_backward.launches = 0
    t.train_step(images, caps, mask)
    torch.cuda.synchronize()
    assert (ln.layer_norm.launches, ln.layer_norm_backward.launches) == (
        51, 51)
    del t

    c = transformer_config()
    model = load_model(c, dev)
    with torch.inference_mode():
        state = model.init_cache(images.to(dev), c.inference.max_length)
        tokens = torch.full((2,), c.model.bos_token_id, device=dev)
        ln.layer_norm.launches = 0
        model.step(state, tokens)
    assert ln.layer_norm.launches == 18
