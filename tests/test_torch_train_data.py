"""The port's copies of the JAX package's training host code, held equal to
the originals on the CPU: the synthetic COCO fixture (same files from the
same seed), the caption dataset and its batching (``iterate_batches`` with
shuffling, ``drop_last``, ``pad_last``, ``skip_batches`` and worker
processes: the same batches in the same order from the same seed, train
crops included), the caption metrics (the same scores on fixed captions;
without nltk the port leaves METEOR out) and the logging meters; and the
port's ``prefetch`` hands over the iterator's batches unchanged."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.data import coco as jax_coco
from image_captioning_ml_project_tpu.data import synthetic as jax_synthetic
from image_captioning_ml_project_tpu.data.tokenizer import WordVocab
from image_captioning_ml_project_tpu.evaluate import metrics as jax_metrics
from image_captioning_ml_project_tpu.utils import logging as jax_logging
from image_captioning_ml_project_tpu_torch.config import get_default_config
from image_captioning_ml_project_tpu_torch.data import coco, synthetic
from image_captioning_ml_project_tpu_torch.data.pipeline import prefetch
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.evaluate import metrics
from image_captioning_ml_project_tpu_torch.utils import logging as port_logging


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The same fixture written by both packages (PNG, sizes jittered)."""
    roots = {}
    for name, make in (("jax", jax_synthetic), ("port", synthetic)):
        roots[name] = make.make_synthetic_coco(
            str(tmp_path_factory.mktemp(name)), num_images=9,
            captions_per_image=3, image_size=40, seed=3, size_jitter=9)
    with open(os.path.join(roots["jax"],
                           "annotations/captions_train2014.json")) as f:
        ann = json.load(f)
    vocab = WordVocab.build([a["caption"] for a in ann["annotations"]],
                            threshold=1)
    return roots, vocab


def test_synthetic_fixture_is_the_same(fixtures):
    roots, _ = fixtures
    from PIL import Image

    for split in ("train", "val"):
        name = f"annotations/captions_{split}2014.json"
        with open(os.path.join(roots["jax"], name)) as a, \
                open(os.path.join(roots["port"], name)) as b:
            assert json.load(a) == json.load(b)
        for fname in sorted(os.listdir(os.path.join(roots["jax"],
                                                    f"{split}2014"))):
            a = np.asarray(Image.open(os.path.join(
                roots["jax"], f"{split}2014", fname)))
            b = np.asarray(Image.open(os.path.join(
                roots["port"], f"{split}2014", fname)))
            assert np.array_equal(a, b)


def _config(root):
    cfg = get_default_config()
    cfg.data_root = root
    cfg.image_size = 32
    cfg.seed = 5
    cfg.model.decoder.max_length = 12
    return cfg


def _datasets(fixtures, name="jax"):
    roots, vocab = fixtures
    cfg = _config(roots[name])
    return (jax_coco.build_coco_datasets(cfg, vocab),
            coco.build_coco_datasets(cfg, PortVocab(dict(vocab.word2idx))))


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert np.array_equal(x[k], y[k]), k
            else:
                assert x[k] == y[k], k


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=7),
    dict(shuffle=True, seed=7, skip_batches=1),
    dict(shuffle=False, drop_last=False, pad_last=True),
    dict(shuffle=True, seed=8, num_workers=2)],
    ids=["shuffle", "skip", "pad_last", "workers"])
def test_batches_are_the_same(fixtures, split, kw):
    (jt, jv), (pt, pv) = _datasets(fixtures)
    jds, pds = (jt, pt) if split == 0 else (jv, pv)
    assert jds.examples == pds.examples
    want = list(jax_coco.iterate_batches(jds, 4, **kw))
    got = list(coco.iterate_batches(pds, 4, **kw))
    assert want
    _assert_batches_equal(want, got)


def test_transforms_are_the_same(fixtures):
    roots, _ = fixtures
    path = os.path.join(roots["jax"], "train2014",
                        sorted(os.listdir(os.path.join(roots["jax"],
                                                       "train2014")))[0])
    for train in (True, False):
        a = jax_coco.load_image(path, 24, train, np.random.RandomState(1))
        b = coco.load_image(path, 24, train, np.random.RandomState(1))
        assert np.array_equal(a, b)
    for W, H in ((40, 49), (64, 33)):
        assert jax_coco.draw_crop_box(W, H, np.random.RandomState(2)) == \
            coco.draw_crop_box(W, H, np.random.RandomState(2))


def test_native_loader_and_device_resize_are_not_ported(fixtures):
    """Both are ported now (the name predates the device-resident resize):
    ``native_loader`` builds the datasets (on this PNG fixture every image
    falls back to PIL, so the batches are the PIL path's), and
    ``device_resize`` gives the validation set the JAX package's canvas
    batches (``image`` canvases and each square's ``image_size``; some of
    the fixture's squares exceed the 48-pixel canvas and take the host
    downscale), the training set its crops."""
    roots, vocab = fixtures
    cfg = _config(roots["port"])
    cfg.native_loader = True
    tok = PortVocab(dict(vocab.word2idx))
    native_sets = coco.build_coco_datasets(cfg, tok)
    cfg.native_loader = False
    plain_sets = coco.build_coco_datasets(cfg, tok)
    for ds_native, ds_plain in zip(native_sets, plain_sets):
        assert ds_native.native_loader and not ds_plain.native_loader
        a, b = (next(coco.iterate_batches(ds, 4, shuffle=True, seed=1))
                for ds in (ds_native, ds_plain))
        assert np.array_equal(a["image"], b["image"])
    cfg.device_resize = True
    want = jax_coco.build_coco_datasets(cfg, vocab)
    got = coco.build_coco_datasets(cfg, tok)
    assert [d.device_resize for d in got] == [False, True]
    for a, b in zip(want, got):
        kw = dict(shuffle=False, drop_last=False, pad_last=True)
        _assert_batches_equal(list(jax_coco.iterate_batches(a, 4, **kw)),
                              list(coco.iterate_batches(b, 4, **kw)))
    assert got[1][0]["image"].shape == (48, 48, 3)


CANDIDATES = ["a man riding a horse on a street",
              "two dogs playing in the snow",
              "a red bird sitting on a tree",
              "group of people standing near the water"]
REFERENCES = [["a man rides a horse down the street",
               "a person riding a brown horse"],
              ["dogs play in the snow", "two dogs running in snow",
               "a pair of dogs playing outside"],
              ["a small red bird sits on a branch"],
              ["people standing by the lake", "a group near the water"]]


def test_metrics_are_the_same():
    want = jax_metrics.calculate_metrics_native(CANDIDATES, REFERENCES)
    got = metrics.calculate_metrics_native(CANDIDATES, REFERENCES)
    assert want.keys() == got.keys()
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-12), k
    assert float(metrics.calculate_metrics(CANDIDATES, REFERENCES)["CIDEr"]) \
        == pytest.approx(float(jax_metrics.calculate_metrics(
            CANDIDATES, REFERENCES)["CIDEr"]), rel=1e-12)
    np.testing.assert_array_equal(
        metrics.per_sample_cider(CANDIDATES, REFERENCES),
        jax_metrics.per_sample_cider(CANDIDATES, REFERENCES))


def test_metrics_leave_meteor_out_without_nltk(monkeypatch):
    """Where nltk is missing, the native scorers report no METEOR (rather
    than a score without its stem stage); the other scores stay."""
    want = metrics.calculate_metrics_native(CANDIDATES, REFERENCES,
                                            per_sample=True)
    monkeypatch.setattr(metrics, "_METEOR_AVAILABLE", None)
    monkeypatch.setattr(metrics.importlib.util, "find_spec",
                        lambda name: None)
    got = metrics.calculate_metrics_native(CANDIDATES, REFERENCES,
                                           per_sample=True)
    assert "METEOR" in want and "METEOR" not in got
    assert "METEOR" not in got["per_sample"]
    for k, v in got.items():
        if k != "per_sample":
            assert v == want[k], k


def test_logging_meters_are_the_same(tmp_path):
    a, b = jax_logging.MetricLogger(), port_logging.MetricLogger()
    for i in range(5):
        a.update(loss=i * 0.5, lr=1e-3, n=i + 1)
        b.update(loss=i * 0.5, lr=1e-3, n=i + 1)
    assert a.averages() == b.averages() and str(a) == str(b)
    logger = port_logging.setup_logging(str(tmp_path), "port_test")
    logger.info("hello")
    for h in logging.getLogger().handlers:
        h.flush()
    with open(tmp_path / "training.log") as f:
        assert "hello" in f.read()


def test_prefetch_hands_over_the_batches():
    batches = [{"image": np.full((2, 3), i, np.uint8), "captions": [str(i)]}
               for i in range(5)]
    got = list(prefetch(iter(batches), "cpu"))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["image"], torch.Tensor)
        assert torch.equal(b["image"], torch.full((2, 3), i,
                                                  dtype=torch.uint8))
        assert b["captions"] == [str(i)]
    # abandoned mid-way: the producer stops and the iterator is closed
    closed = []

    def gen():
        try:
            for b in batches:
                yield b
        finally:
            closed.append(True)

    it = prefetch(gen(), "cpu")
    next(it)
    it.close()
    assert closed == [True]
