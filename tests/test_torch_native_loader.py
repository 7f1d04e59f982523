"""The port's native JPEG loader (``native/loader.py`` over its copy of
``jpeg_loader.cpp``) against the JAX package's, on the CPU.

The two libraries are built apart (the port's under its package's
``_build/``, as ``libicl_port_<hash>.so``) and both loaded in this
process. On seeded JPEG fixtures they must give byte-identical images:
the eval transform (full decode, DCT draft, explicit draft target), the
train transform (crop boxes and flips), the header probe, and whole
batches of the caption dataset with ``native_loader`` on, train and eval.
Against PIL the native output holds the JAX tests' limits
(``tests/test_native_loader.py``: eval at most 2 levels apart and 0.5 on
average, train batches at most 3 and 0.6); the output does not depend on
the thread count or on forked workers; corrupt input gets a non-zero
status and the dataset falls back to PIL for non-JPEG files; a failed
build leaves the library unavailable with the compiler's reason. Skipped
where ``g++`` or libjpeg is missing."""

import io
import os
import subprocess

import numpy as np
import pytest
from PIL import Image

from image_captioning_ml_project_tpu import native as jax_native
from image_captioning_ml_project_tpu.data.coco import (
    COCOCaptionDataset as JaxDataset)
from image_captioning_ml_project_tpu.data.synthetic import make_synthetic_coco
from image_captioning_ml_project_tpu.data.tokenizer import WordVocab
from image_captioning_ml_project_tpu_torch import native
from image_captioning_ml_project_tpu_torch.data.coco import (
    COCOCaptionDataset, center_crop_resize, iterate_batches)
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.native import loader

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="g++ or libjpeg unavailable")


def _jpegs(n=6, seed=0, sizes=((640, 480), (480, 640), (500, 375),
                                (97, 211))):
    rng = np.random.RandomState(seed)
    bufs = []
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        arr = np.asarray(Image.fromarray(arr).resize((w, h), Image.BILINEAR))
        bio = io.BytesIO()
        Image.fromarray(arr).save(bio, "JPEG", quality=92)
        bufs.append(bio.getvalue())
    return bufs


def test_the_libraries_are_apart():
    assert os.path.dirname(loader.library_path()) == os.path.join(
        os.path.dirname(os.path.dirname(loader.__file__)), "_build")
    assert os.path.exists(loader.library_path())
    assert loader._get()._name != jax_native.loader._get()._name
    assert native.unavailable_reason() == ""


@pytest.mark.parametrize("size,draft", [(224, False), (224, True),
                                        (97, False), (64, 160)])
def test_eval_batch_is_byte_equal_to_jax(size, draft):
    bufs = _jpegs(8)
    mine, st = native.decode_eval_batch(bufs, size, draft=draft,
                                        n_threads=3)
    theirs, jst = jax_native.decode_eval_batch(bufs, size, draft=draft,
                                               n_threads=3)
    assert (st == 0).all() and np.array_equal(st, jst)
    assert np.array_equal(mine, theirs)


def test_train_batch_and_probe_are_byte_equal_to_jax():
    bufs = _jpegs(8, seed=1)
    rs = np.random.RandomState(2)
    boxes, flips = [], []
    for b in bufs:
        w, h = native.probe(b)
        assert (w, h) == jax_native.probe(b)
        bw, bh = rs.randint(8, w + 1), rs.randint(8, h + 1)
        boxes.append((rs.randint(0, w - bw + 1), rs.randint(0, h - bh + 1),
                      bw, bh))
        flips.append(rs.randint(0, 2))
    for size in (64, 224):
        mine, st = native.decode_train_batch(bufs, np.array(boxes),
                                             np.array(flips), size)
        theirs, _ = jax_native.decode_train_batch(bufs, np.array(boxes),
                                                  np.array(flips), size)
        assert (st == 0).all() and np.array_equal(mine, theirs)


def test_eval_matches_pil_within_the_jax_limits():
    bufs = _jpegs()
    out, st = native.decode_eval_batch(bufs, 224, draft=False, n_threads=2)
    assert (st == 0).all()
    for b, img in zip(bufs, out):
        pil = np.asarray(center_crop_resize(
            Image.open(io.BytesIO(b)).convert("RGB"), 224), dtype=np.uint8)
        d = np.abs(img.astype(int) - pil.astype(int))
        assert d.max() <= 2 and d.mean() < 0.5


def test_thread_invariance():
    bufs = _jpegs(8)
    a, _ = native.decode_eval_batch(bufs, 224, draft=False, n_threads=1)
    b, _ = native.decode_eval_batch(bufs, 224, draft=False, n_threads=4)
    assert np.array_equal(a, b)


def test_corrupt_inputs_report_status():
    good = _jpegs(1)[0]
    bad = b"not a jpeg at all" * 10
    trunc = good[: len(good) // 3]
    out, st = native.decode_eval_batch([good, bad, trunc], 64, draft=False)
    _, jst = jax_native.decode_eval_batch([good, bad, trunc], 64,
                                          draft=False)
    assert st[0] == 0 and st[1] != 0 and np.array_equal(st, jst)
    assert native.probe(bad) is None and native.probe(good) is not None


def test_a_failed_build_is_unavailable_with_its_reason(tmp_path,
                                                       monkeypatch):
    def no_compiler(*a, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(loader, "library_path",
                        lambda: str(tmp_path / "libicl_port_x.so"))
    monkeypatch.setattr(loader.subprocess, "run", no_compiler)
    monkeypatch.setattr(loader, "_reason", "")
    assert loader._build() is None
    assert "g++" in loader._reason

    def failing(cmd, **kw):
        raise subprocess.CalledProcessError(1, cmd, stderr="jpeglib.h: No "
                                            "such file or directory")

    monkeypatch.setattr(loader.subprocess, "run", failing)
    assert loader._build() is None
    assert "jpeglib.h" in loader._reason


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    out = {}
    for fmt, n, jitter in (("jpg", 10, 48), ("png", 6, 16)):
        out[fmt] = make_synthetic_coco(
            str(tmp_path_factory.mktemp(fmt)), num_images=n,
            captions_per_image=2, image_size=96, splits=["train"], seed=0,
            image_format=fmt, size_jitter=jitter)
    return out


def _datasets(root, **kw):
    words = ["a", "b", "c", "d"]
    args = dict(root_dir=root,
                annotation_file="annotations/captions_train2014.json",
                image_dir="train2014", image_size=64, max_length=12, seed=3,
                **kw)
    return (COCOCaptionDataset(tokenizer=PortVocab.build(words, threshold=1),
                               **args),
            JaxDataset(tokenizer=WordVocab.build(words, threshold=1), **args))


def _batches(ds, num_workers=0, n=3):
    it = iterate_batches(ds, batch_size=4, shuffle=True, seed=11,
                         pad_last=True, num_workers=num_workers)
    return [b for _, b in zip(range(n), it)]


@pytest.mark.parametrize("is_training", [True, False])
def test_dataset_batches_are_jax_and_near_pil(roots, is_training):
    from image_captioning_ml_project_tpu.data.coco import (
        iterate_batches as jax_iterate)

    mine, theirs = _datasets(roots["jpg"], is_training=is_training,
                             native_loader=True)
    pil, _ = _datasets(roots["jpg"], is_training=is_training)
    want = [b for _, b in zip(range(3), jax_iterate(
        theirs, batch_size=4, shuffle=True, seed=11, pad_last=True))]
    for bm, bj, bp in zip(_batches(mine), want, _batches(pil)):
        assert np.array_equal(bm["image"], bj["image"])
        assert np.array_equal(bm["caption_tokens"], bj["caption_tokens"])
        assert np.array_equal(bm["caption_tokens"], bp["caption_tokens"])
        d = np.abs(bm["image"].astype(int) - bp["image"].astype(int))
        if is_training:
            assert d.max() <= 3 and d.mean() < 0.6
        else:
            assert d.max() <= 3


def test_forked_workers_decode_what_the_batch_call_does(roots):
    """Workers decode one image at a time (``_load_native_one``), the
    serial path a batch at once (``decode_chunk``): bit-identical."""
    a = _batches(_datasets(roots["jpg"], is_training=True,
                           native_loader=True)[0])
    b = _batches(_datasets(roots["jpg"], is_training=True,
                           native_loader=True)[0], num_workers=2)
    for ba, bb in zip(a, b):
        assert np.array_equal(ba["image"], bb["image"])


def test_png_corpus_falls_back_to_pil(roots):
    for is_training in (True, False):
        nat = _batches(_datasets(roots["png"], is_training=is_training,
                                 native_loader=True)[0])
        pil = _batches(_datasets(roots["png"], is_training=is_training)[0])
        for bn, bp in zip(nat, pil):
            assert np.array_equal(bn["image"], bp["image"])
