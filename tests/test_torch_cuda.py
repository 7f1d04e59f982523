"""The port's hand-written kernels on the card, against their plain PyTorch
versions: beam-decode attention (CUDA C++) and LSE/block-max (Triton), then
a tiny model's decode on the card against the same decode on the CPU.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere. The
file imports neither JAX nor the repository's conftest helpers, so it runs
on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu_torch.inference.decoding import (
    beam_search)
from image_captioning_ml_project_tpu_torch.main import flagship_config
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from image_captioning_ml_project_tpu_torch.ops import beam_decode_attention \
    as bda
from image_captioning_ml_project_tpu_torch.ops import lse as port_lse

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The first CUDA device, TF32 off; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
@pytest.mark.parametrize("R,V", [(320, 50257), (6, 1000), (3, 4097)])
def test_lse_kernel_matches_plain(dev, dtype, R, V):
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


@pytest.mark.parametrize("vocab", [1000, 5000])
def test_tiny_model_decode_on_the_card_matches_cpu(dev, vocab):
    """f32: the kernels' decode equals the plain versions' decode."""
    c = flagship_config()
    e, d = c.model.encoder, c.model.decoder
    e.hidden_size = e.feature_dim = d.hidden_dim = 64
    e.num_layers = d.num_layers = 2
    e.num_heads = d.num_heads = 4
    e.patch_size, d.prefix_length = 16, 3
    c.image_size, c.model.vocab_size, c.model.dtype = 32, vocab, "float32"
    c.inference.max_length, c.inference.min_length = 10, 2
    images = torch.from_numpy(np.random.RandomState(vocab).randint(
        0, 256, (3, 32, 32, 3)).astype(np.uint8))
    out = []
    for where in (dev, torch.device("cpu")):
        model = load_model(c, where)
        mc, ic = c.model, c.inference
        with torch.inference_mode():
            state = model.init_cache(images.to(where), ic.max_length)
            res = beam_search(model.step, state, 3, ic.beam_size,
                              mc.bos_token_id, mc.eos_token_id,
                              mc.pad_token_id, ic.max_length,
                              length_penalty=ic.length_penalty,
                              min_length=ic.min_length, return_all=True)
        out.append((res.tokens.cpu(), res.scores.cpu()))
    assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[0][1], out[1][1], atol=1e-4, rtol=0)
