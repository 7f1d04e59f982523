"""The port's CE trainer on the tiny Q-Former and BUTD configurations
against the JAX trainer on the CPU, at f32 and dropout 0 (the trainer
tests' procedure, tests/test_torch_trainer.py): the JAX trainer takes the
first step on a batch, its state crosses into the port
(``params.train_state_from_flax``: the Q-Former's and the object-region
encoder's leaves and their Adam moments included), then both take a
second step on the next batch: the loss, ``learning_rate`` and
``grad_norm`` within 1e-5 relative, every parameter and moment within the
trainer tests' tolerances (with their rule for entries whose gradient on
either side lies under 1e-7, such as the cross-attention key biases the
softmax cancels); then validation: the loss within 1e-5 relative
and the metrics equal; then ``main.evaluate`` of each trainer's
``best_model``: the captions of every image and the metrics equal (in
the object-region mode with ``use_clip_reranking`` set, the reranker
skipped with the JAX package's warning, never called). BUTD reads
detector features of the synthetic fixture (``build_object_datasets``)
in both packages."""

import copy
import logging
import os

import jax
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu import main as jax_main
from image_captioning_ml_project_tpu.data import coco as jax_coco
from image_captioning_ml_project_tpu.evaluate import metrics as jax_metrics
from image_captioning_ml_project_tpu.data.synthetic import (
    make_synthetic_object_features)
from image_captioning_ml_project_tpu.train.trainer import (
    CaptioningTrainer as JaxTrainer)
from image_captioning_ml_project_tpu_torch import main as port_main
from image_captioning_ml_project_tpu_torch.data import coco
from image_captioning_ml_project_tpu_torch.evaluate import (
    coco_eval as port_coco_eval)
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.train.trainer import (
    CaptioningTrainer)
from torch_port_helpers import (LOSS_RTOL, LR, assert_state_close,
                                bridge_state, coco_fixture, family_config,
                                jax_gradients, loose_entries,
                                one_device_mesh, port_config,
                                record_gradients)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root, vocab = coco_fixture(str(tmp_path_factory.mktemp("coco")))
    for split in ("train", "val"):
        make_synthetic_object_features(
            os.path.join(root, "features"),
            os.path.join(root, f"annotations/captions_{split}2014.json"),
            max_objects=6, feature_dim=24, seed=3)
    return root, vocab


def _config(family, root, vocab, tmp):
    cfg = family_config(family, vocab=vocab.vocab_size)
    cfg.data_root, cfg.seed = root, 0
    cfg.output_dir, cfg.checkpoint_dir = str(tmp / "out"), str(tmp / "ckpt")
    cfg.log_every, cfg.num_workers = 1, 0
    mc = cfg.model
    mc.pad_token_id, mc.bos_token_id, mc.eos_token_id = (
        vocab.pad_token_id, vocab.bos_token_id, vocab.eos_token_id)
    mc.decoder.dropout = 0.0
    tc = cfg.training
    tc.batch_size, tc.num_epochs, tc.use_rl, tc.use_amp = 4, 2, False, False
    tc.learning_rate, tc.warmup_steps, tc.weight_decay = LR, 1, 0.01
    cfg.inference.max_length = 8
    cfg.inference.num_candidates = 4
    return cfg


@pytest.fixture(scope="module", params=["qformer", "butd"])
def pair(request, data, tmp_path_factory):
    root, vocab = data
    family = request.param
    cfg = _config(family, root, vocab, tmp_path_factory.mktemp(family))
    build = {"qformer": (jax_coco.build_coco_datasets,
                         coco.build_coco_datasets),
             "butd": (jax_coco.build_object_datasets,
                      coco.build_object_datasets)}[family]
    jtrain, jval = build[0](cfg, vocab)
    jt = JaxTrainer(cfg, jtrain, jval, vocab, mesh=one_device_mesh())
    batches = list(jax_coco.iterate_batches(jtrain, 4, shuffle=True,
                                            seed=cfg.seed))[:2]
    rng = jax.random.PRNGKey(cfg.seed + 1)

    def jax_step(b):
        jt.state, m = jt._train_step(jt.state, jt._batch_inputs(b),
                                     b["caption_tokens"],
                                     b["attention_mask"], rng)
        return {k: float(v) for k, v in m.items()}

    jax_step(batches[0])
    pcfg = port_config(cfg)
    pcfg.checkpoint_dir = cfg.checkpoint_dir + "_port"
    port_vocab = PortVocab(dict(vocab.word2idx))
    ptrain, pval = build[1](pcfg, port_vocab)
    pt = CaptioningTrainer(pcfg, ptrain, pval, port_vocab, device="cpu")
    assert pt._object_mode == (family == "butd")
    before = bridge_state(jt)
    pt.load_state(before)
    port_grads = record_gradients(pt)
    jax_grads = [jax_gradients(jt, jt._batch_inputs(batches[1]),
                               batches[1], rng)]
    jm = jax_step(batches[1])
    pm = {k: float(v) for k, v in pt.train_step(
        pt._batch_inputs(batches[1]), batches[1]["caption_tokens"],
        batches[1]["attention_mask"]).items()}
    return family, jt, pt, jm, pm, before, loose_entries(port_grads,
                                                         jax_grads)


def test_second_step_matches_the_jax_trainer(pair):
    family, jt, pt, jm, pm, before, loose = pair
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=f"{family}: {k}")
    assert_state_close(pt._state_tree(), bridge_state(jt), before, loose,
                       [pm["learning_rate"]], pt.config.training.weight_decay,
                       family)


def test_validation_matches_the_jax_trainer(pair):
    family, jt, pt = pair[:3]
    j_loss, j_metrics = jt._validate_epoch(0)
    p_loss, p_metrics = pt._validate_epoch(0)
    np.testing.assert_allclose(p_loss, j_loss, rtol=LOSS_RTOL)
    assert p_metrics == j_metrics, family


class _Never:
    def __call__(self, images, candidates):
        raise AssertionError("the reranker was called")


def test_evaluate_matches_jax(pair, tmp_path, monkeypatch):
    family, jt, pt = pair[:3]
    jt.save_checkpoint(0, is_best=True)
    jt.ckpt.wait_until_finished()
    pt.save_checkpoint(0, is_best=True)
    pt.ckpt.wait_until_finished()
    jcfg, pcfg = copy.deepcopy(jt.config), copy.deepcopy(pt.config)
    jcfg.output_dir, pcfg.output_dir = (str(tmp_path / n)
                                        for n in ("jax", "port"))
    rerank = family == "butd"
    jcfg.inference.use_clip_reranking = rerank
    pcfg.inference.use_clip_reranking = rerank
    scored = {}
    for name, module in (("jax", jax_metrics), ("port", port_coco_eval)):
        def record(generated, references, image_ids, name=name,
                   real=module.calculate_metrics):
            scored[name] = dict(zip(image_ids, generated))
            return real(generated, references, image_ids)

        monkeypatch.setattr(module, "calculate_metrics", record)
    warned = []
    monkeypatch.setattr(
        logging.getLogger("image_captioning_ml_project_tpu_torch.main"),
        "warning", lambda msg, *a: warned.append(msg % a))
    want = jax_main.evaluate(jcfg, "best_model", tokenizer=jt.tokenizer,
                             reranker=_Never() if rerank else None)
    got = port_main.evaluate(pcfg, "best_model", tokenizer=pt.tokenizer,
                             reranker=_Never() if rerank else None,
                             device="cpu")
    assert got == want, family
    assert scored["port"] == scored["jax"]
    assert len(scored["port"]) == len(pt.val_dataset)
    assert rerank == any("CLIP reranking needs raw images" in w
                         for w in warned)
