"""The port's CE trainer (train/trainer.py) against the JAX trainer on the
CPU, at f32, on three tiny configurations: the JAX trainer tests' fixture
(ViT + LSTM with soft attention), a 2-layer CLIP + 2-layer GPT-2 (with the
contrastive loss on, so the loss's own parameters train too) and a small
ResNet + Transformer decoder (BatchNorm statistics in the state).

The JAX trainer takes the first step; its whole state crosses into the
port through ``params.train_state_from_flax``; both then take steps 2 and
3 on the same batches. Stated tolerances: losses, ``learning_rate`` and
``grad_norm`` within 1e-5 relative; every parameter and BatchNorm
statistic within atol 1e-5 + rtol 1e-4, and the Adam moments, sums of
gradients in which large terms cancel (the CLIP class embedding's reach
1.5e-4 relative), within atol 1e-7 + rtol 1e-3; the validation loss within
1e-5 relative and the validation decode's tokens identical. Entries whose
gradient, on either trainer, lies in (0, 1e-7) in a step
(:data:`SMALL_GRADIENT`) need more: AdamW's step g / (|g| + 1e-8) there
follows the rounding of g, not g (an attention key bias, or the soft
attention's energy bias, shifts every score of a query alike, which the
softmax removes, so its gradient is zero but for rounding). The JAX
trainer's gradients come from ``jax.grad`` of its own loss on the same
batch, so an entry the port alone zeroes stays under the tight rule, as do
entries whose gradient is exactly zero on both (AdamW's update there is
its decay). Each trainer's move of those entries is held to the
bias-corrected Adam step's bound (:func:`adam_step_bound`, about one
learning rate a step), and their difference to twice it;
``chip_smoke.py`` holds the card to the CPU by the same rule. Also: a
port-only mid-epoch resume from a rolling step checkpoint is
bit-identical to the uninterrupted run, and the CLI trains on the
synthetic fixture and serves the checkpoint it wrote."""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.config import config_to_dict
from image_captioning_ml_project_tpu.data.coco import (
    build_coco_datasets as jax_datasets)
from image_captioning_ml_project_tpu.data.coco import (
    iterate_batches as jax_iterate)
from image_captioning_ml_project_tpu.train.trainer import (
    CaptioningTrainer as JaxTrainer)
from image_captioning_ml_project_tpu_torch.data.coco import (
    build_coco_datasets)
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.train.trainer import (
    CaptioningTrainer)
from torch_port_helpers import (LOSS_RTOL, assert_state_close,
                                loose_entries, jax_gradients,
                                record_gradients, bridge_state, coco_fixture,
                                one_device_mesh, port_config, train_config)

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return coco_fixture(str(tmp_path_factory.mktemp("coco")))


@pytest.fixture(scope="module", params=["vit_lstm", "clip_gpt2",
                                        "resnet_transformer"])
def pair(request, data, tmp_path_factory):
    """(JAX trainer after step 3, port trainer after step 3, the metrics
    of steps 2-3 of each, the state both began step 2 from, the entries
    held to the Adam steps' bound)."""
    root, vocab = data
    tmp = tmp_path_factory.mktemp(request.param)
    cfg = train_config(request.param, root, vocab, tmp)
    jtrain, jval = jax_datasets(cfg, vocab)
    jt = JaxTrainer(cfg, jtrain, jval, vocab, mesh=one_device_mesh())
    batches = list(jax_iterate(jtrain, 4, shuffle=True, seed=cfg.seed))[:3]
    assert len(batches) == 3
    rng = jax.random.PRNGKey(cfg.seed + 1)

    def jax_step(b):
        jt.state, m = jt._train_step(jt.state, b["image"],
                                     b["caption_tokens"],
                                     b["attention_mask"], rng)
        return {k: float(v) for k, v in m.items()}

    jax_step(batches[0])
    pcfg = port_config(cfg)
    port_vocab = PortVocab(dict(vocab.word2idx))
    ptrain, pval = build_coco_datasets(pcfg, port_vocab)
    pt = CaptioningTrainer(pcfg, ptrain, pval, port_vocab, device="cpu")
    before = bridge_state(jt)
    pt.load_state(before)
    port_grads, jax_grads = record_gradients(pt), []
    jm, pm = [], []
    for b in batches[1:]:
        jax_grads.append(jax_gradients(jt, b["image"], b, rng))
        jm.append(jax_step(b))
        pm.append({k: float(v) for k, v in pt.train_step(
            b["image"], b["caption_tokens"], b["attention_mask"]).items()})
    return (request.param, jt, pt, jm, pm, before,
            loose_entries(port_grads, jax_grads))


def test_steps_two_and_three_match_the_jax_trainer(pair):
    kind, jt, pt, jm, pm, before, loose = pair
    for j, p in zip(jm, pm):
        assert set(p) == set(j), (sorted(p), sorted(j))
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"{kind}: {k}")
    assert_state_close(pt._state_tree(), bridge_state(jt), before, loose,
                        [p["learning_rate"] for p in pm],
                        pt.config.training.weight_decay, kind)


def test_validation_matches_the_jax_trainer(pair):
    """Validation loss within 1e-5 relative; the decode's tokens of every
    validation image identical (beam 5 on the configured strategy)."""
    kind, jt, pt = pair[:3]
    j_loss, j_metrics = jt._validate_epoch(0)
    p_loss, p_metrics = pt._validate_epoch(0)
    np.testing.assert_allclose(p_loss, j_loss, rtol=LOSS_RTOL)
    estate, model = jt.eval_state(), pt.eval_state()
    rng = jax.random.PRNGKey(0)
    for b in jax_iterate(jt.val_dataset, 4, shuffle=False, drop_last=False,
                         pad_last=True):
        want = np.asarray(jt._val_decode_step(estate, b["image"], rng))
        got = pt.val_decode_step(model, b["image"]).numpy()
        np.testing.assert_array_equal(got, want, err_msg=kind)
    assert p_metrics["CIDEr"] == pytest.approx(j_metrics["CIDEr"])


def test_mid_epoch_resume_is_bit_identical(data, tmp_path):
    """save_every_steps writes the rolling step checkpoint; a new trainer
    that loads it and finishes the epoch ends bit-identical to one that
    never stopped (the same batches, the same dropout masks)."""
    root, vocab = data
    cfg = port_config(train_config("clip_gpt2", root, vocab, tmp_path))
    cfg.model.decoder.dropout = 0.1
    cfg.training.num_epochs = 1
    cfg.save_every_steps = 2
    port_vocab = PortVocab(dict(vocab.word2idx))
    train_ds, val_ds = build_coco_datasets(cfg, port_vocab)
    assert len(train_ds) // 4 == 6
    whole = CaptioningTrainer(cfg, train_ds, val_ds, port_vocab,
                              device="cpu")
    whole._train_epoch(0)
    whole.ckpt.wait_until_finished()

    cfg2 = copy.deepcopy(cfg)
    cfg2.checkpoint_dir = str(tmp_path / "ckpt2")
    cut = CaptioningTrainer(cfg2, train_ds, val_ds, port_vocab, device="cpu")
    for i, b in enumerate(cut._train_batches(0)):
        cut.train_step(b["image"], b["caption_tokens"], b["attention_mask"])
        if i == 3:
            cut.save_step_checkpoint(0, 4, "ce")
            break
    cut.ckpt.wait_until_finished()
    resumed = CaptioningTrainer(cfg2, train_ds, val_ds, port_vocab,
                                device="cpu")
    resumed.load_checkpoint("checkpoint_step")
    assert (resumed.start_epoch, resumed.start_batch) == (0, 4)
    resumed._train_epoch(0, start_batch=resumed.start_batch)
    a, b = whole._state_tree(), resumed._state_tree()
    assert a["step"] == b["step"] == 6
    for group in ("model", "loss"):
        for name, t in a["params"][group].items():
            assert torch.equal(t, b["params"][group][name]), name
    for key in ("mu", "nu"):
        for name, t in a["opt_state"][key].items():
            assert torch.equal(t, b["opt_state"][key][name]), name


def test_cli_trains_then_serves_the_checkpoint(data, tmp_path):
    """``main --mode train`` on the synthetic fixture (CPU, 1 epoch)
    writes ``best_model``; ``--mode serve --checkpoint best_model`` builds
    its service from it (served here through ``CaptionService``, as the
    CLI's ``serve`` does before it binds its port)."""
    from image_captioning_ml_project_tpu_torch import main as port_main
    from image_captioning_ml_project_tpu_torch.inference import server

    root, vocab = data
    cfg = port_config(train_config("vit_lstm", root, vocab, tmp_path))
    cfg.training.num_epochs = 1
    cfg_path = tmp_path / "cfg.json"
    with open(cfg_path, "w") as f:
        json.dump(config_to_dict(cfg), f)
    vocab_path = str(tmp_path / "vocab.json")
    PortVocab(dict(vocab.word2idx)).save(vocab_path)
    out = tmp_path / "run"
    trainer = port_main.main(["--mode", "train", "--config", str(cfg_path),
                              "--device", "cpu", "--output_dir", str(out),
                              "--vocab", vocab_path])
    ckpt = os.path.join(str(out), "checkpoints")
    assert os.path.isdir(os.path.join(ckpt, "best_model"))
    assert trainer.history[0]["val_metrics"]["CIDEr"] > 0

    seen = {}

    def fake_serve(config, tokenizer, device, checkpoint_path=None, **kw):
        service = server.CaptionService(config, tokenizer, device,
                                        checkpoint_path=checkpoint_path,
                                        batch_size=2, bucket_sizes=[2])
        seen["model"] = service.model

    orig = server.serve
    server.serve = fake_serve
    try:
        port_main.main(["--mode", "serve", "--config", str(cfg_path),
                        "--device", "cpu", "--output_dir", str(out),
                        "--vocab", vocab_path,
                        "--checkpoint", "best_model"])
    finally:
        server.serve = orig
    want = trainer.eval_state().state_dict()
    got = seen["model"].state_dict()
    for name, t in want.items():
        assert torch.equal(got[name], t), name
