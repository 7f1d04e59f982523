"""The port's copies of the JAX package's host code (port: config.py,
data/tokenizer.py, data/coco.py) against their originals: the same config
fields, defaults and JSON in both directions, the same word ids and
captions, and the same host-side crop (the on-device normalisation is
held against JAX in test_torch_clip.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu import config as jax_config
from image_captioning_ml_project_tpu.data import coco as jax_coco
from image_captioning_ml_project_tpu.data import tokenizer as jax_tokenizer
from image_captioning_ml_project_tpu_torch import config as port_config
from image_captioning_ml_project_tpu_torch.data import coco as port_coco
from image_captioning_ml_project_tpu_torch.data import (
    tokenizer as port_tokenizer)
from image_captioning_ml_project_tpu_torch.main import flagship_config

torch.set_num_threads(1)

_SECTIONS = ["EncoderConfig", "DecoderConfig", "AttentionConfig",
             "TrainingConfig", "InferenceConfig", "MeshConfig", "ModelConfig",
             "Config"]


@pytest.mark.parametrize("name", _SECTIONS)
def test_config_sections_have_the_same_fields_and_defaults(name):
    want = [(f.name, f.type) for f in
            dataclasses.fields(getattr(jax_config, name))]
    got = [(f.name, f.type) for f in
           dataclasses.fields(getattr(port_config, name))]
    assert got == want
    assert (port_config.config_to_dict(getattr(port_config, name)())
            == jax_config.config_to_dict(getattr(jax_config, name)()))


@pytest.mark.parametrize("enum", ["EncoderType", "DecoderType",
                                  "AttentionType"])
def test_config_enums_have_the_same_members(enum):
    want = {m.name: m.value for m in getattr(jax_config, enum)}
    assert {m.name: m.value for m in getattr(port_config, enum)} == want
    for m in getattr(port_config, enum):
        assert m == getattr(jax_config, enum)[m.name]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_config_json_round_trips_between_packages(tmp_path, direction):
    cfg = flagship_config()
    cfg.model.encoder.swin_depths = (2, 2, 6, 2)
    cfg.training.learning_rate = 1e-4
    path = str(tmp_path / "config.json")
    if direction == "jax_to_port":
        src, dst = jax_config, port_config
        src.save_config(src.config_from_dict(port_config.config_to_dict(cfg)),
                        path)
    else:
        src, dst = port_config, jax_config
        src.save_config(cfg, path)
    loaded = dst.load_config(path)
    assert isinstance(loaded, dst.Config)
    assert isinstance(loaded.model.encoder.encoder_type, dst.EncoderType)
    assert loaded.model.encoder.swin_depths == (2, 2, 6, 2)
    assert dst.config_to_dict(loaded) == port_config.config_to_dict(cfg)


def test_word_vocab_ids_and_captions_match_jax(tmp_path):
    corpus = ["A dog runs on the grass.", "a dog, two cats", "the grass",
              "Two cats sit on a mat 3 times"] * 3
    jv = jax_tokenizer.WordVocab.build(corpus, threshold=2)
    pv = port_tokenizer.WordVocab.build(corpus, threshold=2)
    assert pv.word2idx == jv.word2idx and len(pv) == pv.vocab_size
    for text in ("A dog sits on the mat!", "unseen words here"):
        for got, want in zip(pv.encode(text, 6), jv.encode(text, 6)):
            np.testing.assert_array_equal(got, want)
    ids = [1, 5, 3, 7, 0, 2, 9]
    for skip in (True, False):
        assert pv.decode(ids, skip) == jv.decode(ids, skip)
    path = str(tmp_path / "vocab.json")
    jv.save(path)
    assert port_tokenizer.WordVocab.load(path).word2idx == jv.word2idx
    assert (pv.pad_token_id, pv.bos_token_id, pv.eos_token_id,
            pv.unk_token_id) == (0, 1, 2, 3)


@pytest.mark.parametrize("size", [(50, 31), (31, 50), (40, 40)])
def test_center_crop_resize_matches_jax(size):
    from PIL import Image

    arr = np.random.RandomState(1).randint(0, 256, size + (3,)).astype(
        np.uint8)
    img = Image.fromarray(arr)
    got = np.asarray(port_coco.center_crop_resize(img, 24))
    want = np.asarray(jax_coco.center_crop_resize(img, 24))
    assert got.shape == (24, 24, 3)
    np.testing.assert_array_equal(got, want)
