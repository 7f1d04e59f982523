"""The port's curriculum sampler (``train/curriculum.py``) against the JAX
package's, and its use in training, on the CPU.

The sampler's index lists equal JAX's, epoch for epoch across
``warmup_epochs``, for every strategy x pacing x ``shuffle_within_bins``
(a ``numpy.random.RandomState`` from the same seed on both sides). With a
sampler, the trainer's schedule horizon (``total_steps``) is JAX's. One
``main.train`` run with ``use_curriculum`` on the synthetic fixture draws
the batches the JAX trainer draws, epoch for epoch and pass for pass (the
SCST pass of an epoch iterates the sampler again, as JAX's does), and a
resume's ``skip_batches`` skips in the sampler's order."""

import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.data.coco import (
    build_coco_datasets as jax_datasets)
from image_captioning_ml_project_tpu.train import curriculum as jax_cur
from image_captioning_ml_project_tpu.train.trainer import (
    CaptioningTrainer as JaxTrainer)
from image_captioning_ml_project_tpu_torch import main as port_main
from image_captioning_ml_project_tpu_torch.data.coco import (
    build_coco_datasets)
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.train import curriculum
from image_captioning_ml_project_tpu_torch.train import (
    trainer as port_trainer_mod)
from image_captioning_ml_project_tpu_torch.train.trainer import (
    CaptioningTrainer)
from torch_port_helpers import (coco_fixture, one_device_mesh, port_config,
                                train_config)

torch.set_num_threads(1)


class Metadata:
    """A dataset of ``n`` examples with seeded difficulty metadata: caption
    lengths (many ties), object counts and CLIP scores."""

    def __init__(self, n, seed):
        rs = np.random.RandomState(seed)
        self.n = n
        self._lengths = rs.randint(3, 12, n)
        self._objects = rs.randint(0, 20, n)
        self._clip = rs.rand(n)

    def __len__(self):
        return self.n

    def caption_lengths(self):
        return self._lengths

    def num_objects(self):
        return self._objects

    def clip_scores(self):
        return self._clip


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("pacing", ["linear", "root", "exponential", "step",
                                    "unknown"])
@pytest.mark.parametrize("strategy", ["caption_length", "num_objects",
                                      "clip_score", "unknown"])
def test_sampler_order_is_jax(strategy, pacing, shuffle):
    for n, seed in ((103, 0), (7, 1)):  # 7: fewer items than bins
        ds = Metadata(n, seed)
        kw = dict(strategy=strategy, num_epochs=9, warmup_epochs=4,
                  shuffle_within_bins=shuffle, seed=seed + 5, pacing=pacing)
        mine = curriculum.CurriculumSampler(ds, **kw)
        theirs = jax_cur.CurriculumSampler(ds, **kw)
        np.testing.assert_array_equal(mine.sorted_indices,
                                      theirs.sorted_indices)
        for epoch in range(6):  # across warmup_epochs
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert len(mine) == len(theirs)
            for _ in range(2):  # a second pass draws anew on both
                assert list(mine) == list(theirs), (epoch, n)


def test_pacing_and_factory_are_jax():
    for name in ("linear", "root", "exponential", "step"):
        for epoch in range(7):
            assert getattr(curriculum.PacingFunction, name)(epoch, 5) == \
                getattr(jax_cur.PacingFunction, name)(epoch, 5)

    class Cfg:
        class training:
            use_curriculum = False
            curriculum_strategy = "caption_length"
            num_epochs = 10
            curriculum_pacing = "root"
        seed = 4

    ds = Metadata(50, 2)
    assert curriculum.create_curriculum_sampler(ds, Cfg) is None
    Cfg.training.use_curriculum = True
    mine = curriculum.create_curriculum_sampler(ds, Cfg)
    theirs = jax_cur.create_curriculum_sampler(ds, Cfg)
    assert (mine.warmup_epochs, mine.pacing) == (3, "root")
    for epoch in range(5):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(mine) == list(theirs)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return coco_fixture(str(tmp_path_factory.mktemp("coco")))


def _curriculum_config(data, tmp):
    """vit_lstm at batch 8 over 24 training examples, 6 epochs (warmup 2:
    epoch 0 takes half the examples), SCST from epoch 5."""
    root, vocab = data
    cfg = train_config("vit_lstm", root, vocab, tmp)
    tc = cfg.training
    tc.use_curriculum, tc.curriculum_strategy = True, "caption_length"
    tc.batch_size, tc.num_epochs = 8, 6
    tc.use_rl, tc.rl_start_epoch = True, 5
    return cfg


@pytest.fixture(scope="module")
def jax_trainer(data, tmp_path_factory):
    root, vocab = data
    cfg = _curriculum_config(data, tmp_path_factory.mktemp("jax"))
    jtrain, jval = jax_datasets(cfg, vocab)
    sampler = jax_cur.create_curriculum_sampler(jtrain, cfg)
    return JaxTrainer(cfg, jtrain, jval, vocab, mesh=one_device_mesh(),
                      curriculum_sampler=sampler)


def _port_trainer(data, tmp):
    root, vocab = data
    cfg = port_config(_curriculum_config(data, tmp))
    port_vocab = PortVocab(dict(vocab.word2idx))
    train_ds, val_ds = build_coco_datasets(cfg, port_vocab)
    return CaptioningTrainer(
        cfg, train_ds, val_ds, port_vocab, device="cpu",
        curriculum_sampler=curriculum.create_curriculum_sampler(train_ds,
                                                                cfg))


def _ids(batches):
    return [np.asarray(b["image_id"]).tolist() for b in batches]


def _fresh_sampler(jt):
    """The JAX trainer's sampler anew (the tests share the trainer; a
    sampler's generator advances at each pass)."""
    jt.curriculum_sampler = jax_cur.create_curriculum_sampler(
        jt.train_dataset, jt.config)
    return jt


def test_total_steps_and_resume_order_are_jax(data, jax_trainer, tmp_path):
    pt = _port_trainer(data, tmp_path)
    jax_trainer = _fresh_sampler(jax_trainer)
    # epochs of 12, 24, 24, 24, 24 and 2 x 24 examples, at batch 8
    assert pt.total_steps == jax_trainer.total_steps == 1 + 3 * 4 + 6
    assert pt.total_steps != pt.steps_per_epoch * 7
    for epoch, skip in ((1, 1), (3, 2)):
        pt.curriculum_sampler.set_epoch(epoch)
        jax_trainer.curriculum_sampler.set_epoch(epoch)
        assert _ids(pt._train_batches(epoch, skip)) == \
            _ids(jax_trainer._train_batches(epoch, skip))


def test_main_train_draws_the_jax_trainers_batches(data, jax_trainer,
                                                    tmp_path, monkeypatch):
    """main.train with use_curriculum (6 epochs, the last with its SCST
    pass): every training pass's batches, by image id, are the ones the
    JAX trainer's sampler gives the same passes."""
    root, vocab = data
    cfg = port_config(_curriculum_config(data, tmp_path))
    seen = []
    real = port_trainer_mod.iterate_batches

    def recording(dataset, *args, **kw):
        for b in real(dataset, *args, **kw):
            if dataset.is_training:
                seen[-1].append(b["image_id"].tolist())
            yield b

    def pass_start(*args, **kw):
        seen.append([])
        return recording(*args, **kw)

    monkeypatch.setattr(port_trainer_mod, "iterate_batches", pass_start)
    trainer = port_main.train(cfg, tokenizer=PortVocab(dict(vocab.word2idx)),
                              device="cpu")
    jt = _fresh_sampler(jax_trainer)
    want = []
    for epoch in range(cfg.training.num_epochs):
        jt.curriculum_sampler.set_epoch(epoch)
        for _ in range(2 if epoch >= cfg.training.rl_start_epoch else 1):
            want.append(_ids(jt._train_batches(epoch)))
    got = [p for p in seen if p]  # validation passes record nothing
    assert got == want
    assert [len(p) for p in got] == [1, 3, 3, 3, 3, 3, 3]
    assert trainer.step == jt.total_steps
