"""The operation and byte counts against values worked by hand: each
configuration's (``configs/<config>.py``) and each kernel roofline's
(``metrics/<kernel>_roofline.py``)."""

import pytest

from portbench import flops, run
from tiny import load


def _work(metric):
    return run.reader_module(metric).work


def _ops(name):
    cfg = load(name)
    return cfg, flops.config_module(cfg)


def test_vision_tower_ops_clip_b32():
    # 49 patches of 32*32*3 into 768; 12 layers over 50 tokens:
    # 2*50*(4*768^2 + 2*768*3072) + 4*50^2*768 each
    embed = 2 * 49 * 3072 * 768
    layer = 2 * 50 * (4 * 768 ** 2 + 2 * 768 * 3072) + 4 * 50 * 50 * 768
    assert embed == 231_211_008 and layer == 715_468_800
    assert flops.vit_ops(load("flagship")["vision"]) == 8_816_836_608
    cfg, m = _ops("flagship")
    assert m.vision_ops(cfg) == 8_816_836_608


def test_vision_tower_ops_vit_b16():
    embed = 2 * 196 * 768 * 768
    layer = 2 * 197 * (4 * 768 ** 2 + 2 * 768 * 3072) + 4 * 197 ** 2 * 768
    cfg, m = _ops("transformer")
    assert m.vision_ops(cfg) == embed + 12 * layer == 35_126_120_448


def test_gpt2_decode_step_and_prefix():
    cfg, m = _ops("flagship")
    # 5 beams of one image at pos 3: 5 rows x 12 layers x 2 x 12 x 768^2,
    # attention over 10 + 3 + 1 keys, LM head 2 x 768 x 50257 a row
    rows = 5
    expect = (12 * (2 * rows * 12 * 768 ** 2 + 4 * rows * 14 * 768)
              + 2 * rows * 768 * 50257)
    assert m.step_ops(cfg, rows, 3) == expect == 1_237_900_800
    # the prefix: projection 768 -> 10 x 768, 12 layers over 10 causal
    # positions (55 query-key pairs)
    prefix = 2 * 768 * 7680 + 12 * (2 * 10 * 12 * 768 ** 2 + 4 * 55 * 768)
    assert m.condition_ops(cfg) == prefix


def test_transformer_decode_step_and_memory():
    cfg, m = _ops("transformer")
    rows = 5
    layer = (2 * rows * 14 * 768 ** 2 + 4 * rows * 1 * 768
             + 4 * rows * 196 * 768)
    assert m.step_ops(cfg, rows, 0) == 6 * layer + 2 * rows * 768 * 30000
    # the memory: 196 tokens projected, then each layer's K and V
    assert m.condition_ops(cfg) == (2 * 196 * 768 ** 2
                                    + 6 * 2 * 2 * 196 * 768 ** 2)


@pytest.mark.parametrize("name", ["flagship", "transformer"])
def test_serve_ops_sums_steps(name):
    cfg, m = _ops(name)
    one = m.vision_ops(cfg) + m.condition_ops(cfg)
    assert flops.serve_ops(cfg, 2, 19) == 2 * one + sum(
        m.step_ops(cfg, 10, p) for p in range(19))


def test_train_ops_three_forwards():
    cfg = load("flagship")
    fwd = (8_816_836_608 + 2 * 768 * 7680
           + 12 * (2 * 30 * 12 * 768 ** 2 + 4 * (30 * 31 // 2) * 768)
           + 2 * 20 * 768 * 50257)
    assert flops.train_ops(cfg, 512, 20) == 3 * 512 * fwd


def test_kernel_bounds():
    pk = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    # the stack at B = 512, K = 5, pos 19: FLOP-bound
    w = _work("beam_decode_stack_roofline")(2560, 512, 768, 12, 10, 19)
    assert w["ops"] == 12 * (2 * 2560 * 12 * 768 ** 2 + 4 * 2560 * 30 * 768)
    weights = 12 * (12 * 768 ** 2 * 2 + 9 * 768 * 2 + 4 * 768 * 4)
    caches = 12 * 4 * 768 * (512 * 10 + 2560 * 19 + 2560)
    assert w["bytes"] == weights + caches + 4 * 2560 * 768
    assert flops.bound_s(w["ops"], w["bytes"], pk) == pytest.approx(
        max(w["ops"] / 989e12, w["bytes"] / 3.35e12))
    e = _work("encoder_stack_roofline")(512, 50, 768, 12, 3072)
    assert e["ops"] == 512 * 12 * (2 * 50 * (4 * 768 ** 2 + 2 * 768 * 3072)
                                   + 4 * 2500 * 768)
    q = _work("beam_decode_attention_qkv_roofline")(2560, 512, 768, 0, 0)
    assert q["ops"] == 2 * 2560 * 4 * 768 ** 2 + 4 * 2560 * 768
    assert q["bytes"] == (4 * 768 ** 2 * 2 + 4 * 768 * 2 + 4 * 768 * 2560
                          + 4 * 2560 * 768)
