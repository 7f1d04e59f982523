"""The port's ``main.evaluate`` and ``main.demo`` (``device="cpu"``) and
the trainer's CLIP-reranked validation against the JAX package's, on a
tiny ViT + LSTM and a tiny CLIP + GPT-2 configuration, from one checkpoint:
a JAX trainer's state saved by the JAX trainer and, bridged through
``params.train_state_from_flax``, by the port's.

JAX's ``evaluate`` rounds its batch of ``inference.num_candidates`` (5) up
to its 8-device test mesh; the port's stays 5 (one device). So captions
are compared per image id. Greedy, beam and beam + a stub reranker (it
picks the last candidate, as ``tests/test_round2_fixes.py`` does) are
deterministic: the captions must be identical and the metrics equal,
exactly. The stub sees [B, num_candidates, L] candidates on both sides,
and the port's eval writes ``results.json`` with every image once. The
demo's caption of a fixture image is JAX's. Reranked validation: the
validation loss within 1e-5 relative (the trainer tests' tolerance) and
the metrics equal. The same holds with ``device_resize`` (the validation
set's canvases resized and normalised on the device; the stub reranker of
``evaluate`` and of validation handed the resized float pixels) and with
``fold_normalize`` (uint8 pixels to the patch embed's fold)."""

import json
import os

import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu import main as jax_main
from image_captioning_ml_project_tpu.data.coco import (
    build_coco_datasets as jax_datasets)
from image_captioning_ml_project_tpu.evaluate import metrics as jax_metrics
from image_captioning_ml_project_tpu.train.trainer import (
    CaptioningTrainer as JaxTrainer)
from image_captioning_ml_project_tpu_torch import main as port_main
from image_captioning_ml_project_tpu_torch.data.coco import (
    build_coco_datasets)
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.evaluate import (
    coco_eval as port_coco_eval)
from image_captioning_ml_project_tpu_torch.train import (
    trainer as port_trainer_mod)
from image_captioning_ml_project_tpu_torch.train.trainer import (
    CaptioningTrainer)
from torch_port_helpers import (LOSS_RTOL, bridge_state, coco_fixture,
                                one_device_mesh, port_config, train_config)

torch.set_num_threads(1)

NUM_CANDIDATES = 5


class LastCandidate:
    """A stub reranker: keeps the shapes it was given and picks each
    image's last candidate."""

    def __init__(self):
        self.shapes = []
        self.pixels = []

    def __call__(self, images, candidates):
        cands = np.asarray(candidates)
        self.shapes.append(cands.shape)
        self.pixels.append((tuple(images.shape), str(images.dtype)))
        assert len(images) == len(cands)
        return cands[:, -1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return coco_fixture(str(tmp_path_factory.mktemp("coco")))


@pytest.fixture(scope="module", params=["vit_lstm", "clip_gpt2"])
def setup(request, data, tmp_path_factory):
    """(kind, JAX config, port config, JAX vocab, port vocab, the JAX
    trainer whose state both checkpoints hold, the port trainer on it),
    with ``best_model`` saved under each config's checkpoint_dir."""
    root, vocab = data
    tmp = tmp_path_factory.mktemp(request.param)
    cfg = train_config(request.param, root, vocab, tmp)
    cfg.inference.num_candidates = NUM_CANDIDATES
    cfg.inference.beam_size = 3
    jtrain, jval = jax_datasets(cfg, vocab)
    jt = JaxTrainer(cfg, jtrain, jval, vocab, mesh=one_device_mesh(),
                    reranker=LastCandidate())
    jt.save_checkpoint(0, is_best=True)
    jt.ckpt.wait_until_finished()

    pcfg = port_config(cfg)
    pcfg.output_dir = str(tmp / "port_out")
    pcfg.checkpoint_dir = str(tmp / "port_ckpt")
    port_vocab = PortVocab(dict(vocab.word2idx))
    ptrain, pval = build_coco_datasets(pcfg, port_vocab)
    pt = CaptioningTrainer(pcfg, ptrain, pval, port_vocab, device="cpu",
                           reranker=LastCandidate())
    pt.load_state(bridge_state(jt))
    pt.save_checkpoint(0, is_best=True)
    pt.ckpt.wait_until_finished()
    return request.param, cfg, pcfg, vocab, port_vocab, jt, pt


def _captured(monkeypatch, module):
    """Record every (generated, references, image_ids) that ``module``'s
    ``calculate_metrics`` scores."""
    seen = []
    real = module.calculate_metrics

    def recording(generated, references, image_ids):
        seen.append((list(generated), list(references), list(image_ids)))
        return real(generated, references, image_ids)

    monkeypatch.setattr(module, "calculate_metrics", recording)
    return seen


def _strategy(cfg, strategy):
    import copy

    cfg = copy.deepcopy(cfg)
    rerank = strategy == "rerank"
    cfg.inference.decoding_strategy = "beam" if rerank else strategy
    cfg.inference.use_clip_reranking = rerank
    return cfg


@pytest.mark.parametrize("strategy", ["greedy", "beam", "rerank"])
def test_evaluate_matches_jax(setup, strategy, monkeypatch):
    kind, cfg, pcfg, vocab, port_vocab = setup[:5]
    jcfg, pcfg = _strategy(cfg, strategy), _strategy(pcfg, strategy)
    stubs = {"jax": LastCandidate(), "port": LastCandidate()}
    rerank = strategy == "rerank"
    jseen = _captured(monkeypatch, jax_metrics)
    j = jax_main.evaluate(jcfg, "best_model", tokenizer=vocab,
                          reranker=stubs["jax"] if rerank else None)
    pseen = _captured(monkeypatch, port_coco_eval)
    p = port_main.evaluate(pcfg, "best_model", tokenizer=port_vocab,
                           reranker=stubs["port"] if rerank else None,
                           device="cpu")
    (jgen, jrefs, jids), = jseen
    (pgen, prefs, pids), = pseen
    n = len(setup[6].val_dataset)
    assert sorted(pids) == sorted(set(pids)) and len(pids) == n
    assert dict(zip(pids, pgen)) == dict(zip(jids, jgen)), kind
    assert dict(zip(pids, prefs)) == dict(zip(jids, jrefs))
    assert p == j, (kind, strategy)
    with open(os.path.join(pcfg.output_dir, "results.json")) as f:
        results = json.load(f)
    assert [(r["image_id"], r["caption"]) for r in results] == list(
        zip(pids, pgen))
    if rerank:
        # every batch's candidates: [B, num_candidates, max_length]
        L = cfg.inference.max_length
        assert stubs["port"].shapes == [(NUM_CANDIDATES, NUM_CANDIDATES, L)
                                        ] * -(-n // NUM_CANDIDATES)
        assert {s[1:] for s in stubs["jax"].shapes} == {(NUM_CANDIDATES, L)}
    else:
        assert not stubs["port"].shapes


@pytest.mark.parametrize("strategy", ["beam", "rerank"])
def test_demo_matches_jax(setup, strategy, capsys):
    kind, cfg, pcfg, vocab, port_vocab, _, pt = setup
    jcfg, pcfg = _strategy(cfg, strategy), _strategy(pcfg, strategy)
    rerank = strategy == "rerank"
    ex = pt.val_dataset.examples[3]
    path = os.path.join(pt.val_dataset.image_dir, ex["filename"])
    j = jax_main.demo(jcfg, "best_model", path, tokenizer=vocab,
                      reranker=LastCandidate() if rerank else None)
    stub = LastCandidate()
    p = port_main.demo(pcfg, "best_model", path, tokenizer=port_vocab,
                       reranker=stub if rerank else None, device="cpu")
    assert p == j, kind
    assert capsys.readouterr().out.splitlines()[-1] == p
    if rerank:
        assert stub.shapes == [(1, NUM_CANDIDATES, cfg.inference.max_length)]


def test_reranked_validation_matches_jax(setup, monkeypatch):
    """The JAX and port trainers, each with the stub reranker, on the same
    state: the same validation loss and metrics, and the stub's picks are
    the captions scored."""
    kind, *_, jt, pt = setup
    j_loss, j_metrics = jt._validate_epoch(0)
    pseen = _captured(monkeypatch, port_trainer_mod)
    p_loss, p_metrics = pt._validate_epoch(0)
    np.testing.assert_allclose(p_loss, j_loss, rtol=LOSS_RTOL)
    assert p_metrics == j_metrics, kind
    (generated, _, ids), = pseen
    assert len(ids) == len(pt.val_dataset)
    L = pt.config.inference.max_length
    assert {s[1:] for s in pt.reranker.shapes} == {(NUM_CANDIDATES, L)}


def _option(cfg, option):
    import copy

    cfg = copy.deepcopy(cfg)
    cfg.device_resize = option.startswith("device_resize")
    cfg.fold_normalize = option == "fold_normalize"
    cfg.inference.use_clip_reranking = option.endswith("rerank")
    return cfg


@pytest.mark.parametrize("option", ["device_resize", "device_resize_rerank",
                                    "fold_normalize"])
def test_preprocessing_options_evaluate_as_jax(setup, option, monkeypatch):
    kind, cfg, pcfg, vocab, port_vocab = setup[:5]
    jcfg, pcfg = _option(cfg, option), _option(pcfg, option)
    rerank = option.endswith("rerank")
    stubs = {"jax": LastCandidate(), "port": LastCandidate()}
    jseen = _captured(monkeypatch, jax_metrics)
    j = jax_main.evaluate(jcfg, "best_model", tokenizer=vocab,
                          reranker=stubs["jax"] if rerank else None)
    pseen = _captured(monkeypatch, port_coco_eval)
    p = port_main.evaluate(pcfg, "best_model", tokenizer=port_vocab,
                           reranker=stubs["port"] if rerank else None,
                           device="cpu")
    (jgen, _, jids), = jseen
    (pgen, _, pids), = pseen
    assert len(pids) == len(setup[6].val_dataset)
    assert dict(zip(pids, pgen)) == dict(zip(jids, jgen)), (kind, option)
    assert p == j, (kind, option)
    if rerank:
        size = pcfg.image_size
        assert set(stubs["port"].pixels) == {
            ((NUM_CANDIDATES, size, size, 3), "torch.float32")}


def test_device_resize_validation_matches_jax(setup, monkeypatch):
    """Reranked validation over the canvases of a ``device_resize``
    validation set: the loss within 1e-5 relative, the metrics equal, the
    stub handed the resized pixels."""
    kind, cfg, pcfg, vocab, port_vocab, jt, pt = setup
    jval = jax_datasets(_option(cfg, "device_resize"), vocab)[1]
    pval = build_coco_datasets(_option(pcfg, "device_resize"),
                               port_vocab)[1]
    assert jval.device_resize and pval.device_resize
    monkeypatch.setattr(jt, "val_dataset", jval)
    monkeypatch.setattr(pt, "val_dataset", pval)
    pt.reranker.pixels.clear()
    j_loss, j_metrics = jt._validate_epoch(0)
    p_loss, p_metrics = pt._validate_epoch(0)
    np.testing.assert_allclose(p_loss, j_loss, rtol=LOSS_RTOL)
    assert p_metrics == j_metrics, kind
    size = pcfg.image_size
    assert set(pt.reranker.pixels) == {
        ((NUM_CANDIDATES, size, size, 3), "torch.float32")}
