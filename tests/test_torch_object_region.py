"""The object-region (BUTD) pieces of the port against the JAX package's
on the CPU: ``ObjectRegionEncoder`` on the same weights (features within
1e-5 relative, the masked mean-pool over the valid regions, the mask
passed on), in bf16 too (within 2 bf16 ulps of the largest feature); and
on a synthetic fixture of detector features written by both packages'
``make_synthetic_object_features`` (the same files from the same seed),
``build_object_datasets`` and ``ObjectDetectionFeaturesDataset``: the same
examples, samples and batches, the same region counts and caption
lengths, and the zero-fill of a file that fails to load."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.config import EncoderType
from image_captioning_ml_project_tpu.data import coco as jax_coco
from image_captioning_ml_project_tpu.data import synthetic as jax_synthetic
from image_captioning_ml_project_tpu.data.tokenizer import WordVocab
from image_captioning_ml_project_tpu.models.encoders import (
    ObjectRegionEncoder as JaxEncoder)
from image_captioning_ml_project_tpu_torch.data import coco, synthetic
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.models.encoders import (
    ObjectRegionEncoder)
from image_captioning_ml_project_tpu_torch.params import _Bridge, _flatten
from torch_port_helpers import bf16_ulp, family_config, family_inputs

torch.set_num_threads(1)


def _encoders(dtype=torch.float32):
    cfg = family_config("butd").model.encoder
    jenc = JaxEncoder(cfg, dtype=jnp.bfloat16 if dtype == torch.bfloat16
                      else jnp.float32)
    x = family_inputs(family_config("butd"), 3, n=3)
    params = jenc.init(jax.random.PRNGKey(1),
                       {k: jnp.asarray(v) for k, v in x.items()})["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(p.size),
                                              p.shape), params)
    br = _Bridge({f"encoder/{k}": v for k, v in _flatten(params).items()})
    for n in ("proj", "geo_proj_0", "geo_proj_1", "combine"):
        br.dense(f"encoder/{n}", f"{n}")
    assert not br.flat
    enc = ObjectRegionEncoder(cfg)
    enc.load_state_dict(br.out, strict=True)
    return jenc, params, enc.to(dtype).eval(), x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_encoder_matches_jax(dtype):
    jenc, params, enc, x = _encoders(dtype)
    if dtype == torch.bfloat16:
        params = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16),
                                        params)
    want = jenc.apply({"params": params},
                      {k: jnp.asarray(v) for k, v in x.items()})
    with torch.no_grad():
        got = enc({k: torch.from_numpy(v) for k, v in x.items()})
    np.testing.assert_array_equal(got["attention_mask"].numpy(),
                                  x["region_mask"])
    for key in ("features", "pooled_features"):
        a = got[key].float().numpy()
        b = np.asarray(want[key].astype(jnp.float32))
        tol = (1e-5 * np.abs(b).max() if dtype == torch.float32
               else 2 * bf16_ulp(b))
        assert np.abs(a - b).max() <= tol, key
    # the pool is the mean of the valid regions only
    f = got["features"].float().numpy()
    m = x["region_mask"]
    np.testing.assert_allclose(
        got["pooled_features"].float().numpy()[0], f[0][m[0]].mean(0),
        rtol=1e-5 if dtype == torch.float32 else 1e-2, atol=1e-5)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """Captions and detector features written by both packages from one
    seed; one validation image's file removed (the zero-fill case)."""
    roots = {}
    for name, make in (("jax", jax_synthetic), ("port", synthetic)):
        root = make.make_synthetic_coco(str(tmp_path_factory.mktemp(name)),
                                        num_images=6, captions_per_image=2,
                                        image_size=16, seed=4)
        for split in ("train", "val"):
            make.make_synthetic_object_features(
                os.path.join(root, "features"),
                os.path.join(root, f"annotations/captions_{split}2014.json"),
                max_objects=9, feature_dim=16, seed=5)
        roots[name] = root
    with open(os.path.join(roots["jax"],
                           "annotations/captions_val2014.json")) as f:
        victim = json.load(f)["images"][1]["id"]
    for root in roots.values():
        os.remove(os.path.join(root, "features", f"{victim}.npz"))
    with open(os.path.join(roots["jax"],
                           "annotations/captions_train2014.json")) as f:
        vocab = WordVocab.build([a["caption"] for a in
                                 json.load(f)["annotations"]], threshold=1)
    return roots, vocab


def _config(root):
    cfg = family_config("butd")
    cfg.data_root = root
    cfg.model.encoder.max_objects = 6
    cfg.model.encoder.region_feature_dim = 16
    cfg.model.decoder.max_length = 10
    return cfg


def test_fixture_files_are_the_same(fixture):
    roots, _ = fixture
    folder = os.path.join(roots["jax"], "features")
    names = sorted(os.listdir(folder))
    assert names == sorted(os.listdir(os.path.join(roots["port"],
                                                   "features")))
    for name in names:
        a = np.load(os.path.join(folder, name))
        b = np.load(os.path.join(roots["port"], "features", name))
        for key in ("features", "boxes"):
            np.testing.assert_array_equal(a[key], b[key])


def test_datasets_and_batches_are_the_same(fixture, capsys):
    roots, vocab = fixture
    cfg = _config(roots["port"])
    assert cfg.model.encoder.encoder_type == EncoderType.OBJECT_REGION
    want = jax_coco.build_object_datasets(cfg, vocab)
    got = coco.build_object_datasets(cfg, PortVocab(dict(vocab.word2idx)))
    for a, b in zip(want, got):
        assert a.examples == b.examples and len(a) == len(b)
        np.testing.assert_array_equal(a.num_objects(), b.num_objects())
        np.testing.assert_array_equal(a.caption_lengths(),
                                      b.caption_lengths())
        kw = dict(shuffle=False, drop_last=False, pad_last=True)
        ba = list(jax_coco.iterate_batches(a, 4, **kw))
        bb = list(coco.iterate_batches(b, 4, **kw))
        assert len(ba) == len(bb)
        for x, y in zip(ba, bb):
            assert set(x) == set(y)
            for k in x:
                if isinstance(x[k], np.ndarray):
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
                else:
                    assert x[k] == y[k], k
    val = got[1]
    counts = val.num_objects()
    # the removed file: zeros and no valid region, with the error printed
    assert counts.min() == 0 and counts.max() == 6
    empty = int(np.argmin(counts))
    assert not val[empty]["region_mask"].any()
    assert not val[empty]["region_features"].any()
    assert "Error loading features" in capsys.readouterr().out
    assert val[0]["region_features"].shape == (6, 16)
