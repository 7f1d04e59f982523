"""The port's checkpoints (utils/checkpoint.py) on the CPU: synchronous and
asynchronous round trips; the two rolling step slots and
``latest_step_checkpoint`` (and the legacy ``checkpoint_step`` name); a
bare name under the directory against a name spelled as a path;
``restore_partial`` reading no optimizer file, memory-mapped; the epoch
checkpoint with ``best_model``; the sidecar's config; a save cut short
leaving no checkpoint under its name. And a JAX trainer's Orbax
checkpoint, read here and written through ``params.train_state_from_flax``
in the port's format, decodes token-identical in both packages."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.data.coco import (
    build_coco_datasets as jax_datasets)
from image_captioning_ml_project_tpu.data.coco import (
    iterate_batches as jax_iterate)
from image_captioning_ml_project_tpu.train.trainer import (
    CaptioningTrainer as JaxTrainer)
from image_captioning_ml_project_tpu_torch.config import (config_from_dict,
                                                          get_default_config)
from image_captioning_ml_project_tpu_torch.data.coco import (
    build_coco_datasets)
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.inference.server import (
    CaptionService)
from image_captioning_ml_project_tpu_torch.params import (
    train_state_from_flax)
from image_captioning_ml_project_tpu_torch.train.trainer import (
    CaptioningTrainer)
from image_captioning_ml_project_tpu_torch.utils import checkpoint
from image_captioning_ml_project_tpu_torch.utils.checkpoint import (
    STEP_SLOTS, CheckpointManager, latest_step_checkpoint)
from torch_port_helpers import (coco_fixture, one_device_mesh, port_config,
                                train_config)

torch.set_num_threads(1)


def _state(seed, step=3):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"model": {"w": torch.randn(4, 3, generator=g),
                                 "b": torch.randn(3, generator=g)},
                       "loss": {}},
            "batch_stats": {"m": torch.randn(3, generator=g)},
            "opt_state": {"count": step,
                          "mu": {"w": torch.randn(4, 3, generator=g).to(
                              torch.bfloat16)},
                          "nu": {"w": torch.rand(4, 3, generator=g)}},
            "step": step}


def _assert_equal(a, b):
    assert type(a) is type(b) or isinstance(a, dict), (a, b)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip(async_save, tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    state = _state(0)
    cfg = get_default_config()
    cfg.seed = 123
    mgr.save("c", state, metadata={"epoch": 2}, config=cfg)
    mgr.wait_until_finished()
    restored, meta, config = mgr.restore("c")
    _assert_equal(restored, state)
    assert meta == {"epoch": 2}
    assert config_from_dict(config).seed == 123
    assert sorted(os.listdir(tmp_path)) == ["c", "c.meta.json"]
    assert sorted(os.listdir(tmp_path / "c")) == [
        "batch_stats.pt", "opt_state.pt", "params.pt", "step.pt"]


def test_async_save_stages_a_copy(tmp_path):
    """The async save writes the state as it was at ``save``, whatever the
    caller changes in place afterwards."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _state(1)
    want = json.loads(json.dumps(state["params"]["model"]["w"].tolist()))
    mgr.save("c", state)
    state["params"]["model"]["w"].add_(1.0)
    assert mgr.exists("c")  # drains first
    restored, _, _ = mgr.restore("c")
    assert restored["params"]["model"]["w"].tolist() == want


def test_step_slots_alternate_and_resolve(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert latest_step_checkpoint(str(tmp_path)) is None
    written = [mgr.save_step(_state(i, step=i), metadata={"step": i})
               for i in range(3)]
    assert written == [STEP_SLOTS[0], STEP_SLOTS[1], STEP_SLOTS[0]]
    assert latest_step_checkpoint(str(tmp_path)) == STEP_SLOTS[0]
    restored, meta, _ = mgr.restore("checkpoint_step")
    assert restored["step"] == 2 and meta["step"] == 2
    # a sidecar without a directory is not a committed save
    with open(tmp_path / f"{STEP_SLOTS[1]}.meta.json", "w") as f:
        json.dump({"metadata": {"step": 99}}, f)
    import shutil

    shutil.rmtree(tmp_path / STEP_SLOTS[1])
    assert latest_step_checkpoint(str(tmp_path)) == STEP_SLOTS[0]


def test_bare_name_and_path_name(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    elsewhere = tmp_path / "runs" / "x"
    mgr.save(str(elsewhere / "best_model"), _state(2))
    assert (elsewhere / "best_model" / "params.pt").exists()
    # a bare name resolves under the directory, not the working directory
    monkeypatch.chdir(elsewhere)
    assert not mgr.exists("best_model")
    mgr.save("best_model", _state(3))
    assert (tmp_path / "ckpt" / "best_model").is_dir()
    restored, _, _ = mgr.restore(str(elsewhere / "best_model"))
    _assert_equal(restored, _state(2))


def test_restore_partial_reads_no_optimizer_file(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("best_model", _state(4))
    loads = []
    real = torch.load

    def spy(path, *a, **k):
        loads.append((os.path.basename(path), k.get("mmap")))
        return real(path, *a, **k)

    monkeypatch.setattr(checkpoint.torch, "load", spy)
    restored, _, _ = mgr.restore_partial(
        "best_model", {"params": None, "batch_stats": None})
    assert loads == [("params.pt", True), ("batch_stats.pt", True)]
    assert set(restored) == {"params", "batch_stats"}
    _assert_equal(restored["params"], _state(4)["params"])


def test_save_epoch_and_best(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_epoch(0, _state(5), metadata={"epoch": 0})
    mgr.save_epoch(1, _state(6), metadata={"epoch": 1}, is_best=True)
    assert sorted(n for n in os.listdir(tmp_path)
                  if not n.endswith(".json")) == [
        "best_model", "checkpoint_epoch_1", "checkpoint_epoch_2"]
    _assert_equal(mgr.restore("best_model")[0], _state(6))


def test_a_save_cut_short_leaves_no_checkpoint(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("c", _state(7))
    real = torch.save

    def failing(obj, path):  # the second file of every save fails
        if path.endswith("batch_stats.pt"):
            raise OSError("disk full")
        return real(obj, path)

    monkeypatch.setattr(checkpoint.torch, "save", failing)
    with pytest.raises(OSError):
        mgr.save("c", _state(8))
    with pytest.raises(OSError):
        mgr.save("new", _state(8))
    monkeypatch.undo()
    _assert_equal(mgr.restore("c")[0], _state(7))  # the old one stands
    assert not mgr.exists("new")


def test_async_save_failure_raises_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_save=True)

    def failing(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", failing)
    mgr.save("c", _state(9))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait_until_finished()


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX trainer (CLIP + GPT-2, f32) after two steps, its epoch-1 and
    best Orbax checkpoints written."""
    root, vocab = coco_fixture(str(tmp_path_factory.mktemp("coco")))
    cfg = train_config("clip_gpt2", root, vocab, tmp_path_factory.mktemp(
        "jax"))
    train_ds, val_ds = jax_datasets(cfg, vocab)
    jt = JaxTrainer(cfg, train_ds, val_ds, vocab, mesh=one_device_mesh())
    rng = jax.random.PRNGKey(1)
    for b in list(jax_iterate(train_ds, 4, shuffle=True, seed=0))[:2]:
        jt.state, _ = jt._train_step(jt.state, b["image"],
                                     b["caption_tokens"],
                                     b["attention_mask"], rng)
    jt.save_checkpoint(0, is_best=True)
    jt.ckpt.wait_until_finished()
    return cfg, vocab, jt


def test_jax_checkpoint_decodes_identically_in_the_port(jax_checkpoint,
                                                        tmp_path):
    cfg, vocab, jt = jax_checkpoint
    restored, meta, _ = jt.ckpt.restore("best_model")
    state = train_state_from_flax(restored)
    pcfg = port_config(cfg)
    pcfg.checkpoint_dir = str(tmp_path / "port")
    CheckpointManager(pcfg.checkpoint_dir).save(
        "best_model", state, metadata=meta, config=pcfg)

    images = next(jax_iterate(jt.val_dataset, 4, shuffle=False))["image"]
    fresh = JaxTrainer(cfg, jt.train_dataset, jt.val_dataset, vocab,
                       mesh=one_device_mesh())
    fresh.load_checkpoint("best_model")
    want = np.asarray(fresh._val_decode_step(fresh.eval_state(), images,
                                             jax.random.PRNGKey(0)))

    port_vocab = PortVocab(dict(vocab.word2idx))
    train_ds, val_ds = build_coco_datasets(pcfg, port_vocab)
    pt = CaptioningTrainer(pcfg, train_ds, val_ds, port_vocab, device="cpu")
    pt.load_checkpoint("best_model")
    assert pt.step == 2 and pt.optimizer.count == 2
    assert pt.start_epoch == 1
    got = pt.val_decode_step(pt.eval_state(), images).numpy()
    np.testing.assert_array_equal(got, want)

    # load_weights: the weights alone, the optimizer and the step untouched
    weights_only = CaptioningTrainer(pcfg, train_ds, val_ds, port_vocab,
                                     device="cpu")
    weights_only.load_weights("best_model")
    assert weights_only.step == 0 and weights_only.optimizer.count == 0
    for name, t in pt._state_tree()["params"]["model"].items():
        assert torch.equal(
            weights_only._state_tree()["params"]["model"][name], t), name

    # the service reads the same checkpoint, weights only
    service = CaptionService(pcfg, port_vocab, "cpu",
                             checkpoint_path="best_model", batch_size=4,
                             bucket_sizes=[4])
    service.start(warmup=False)
    try:
        captions = [service.submit(img) for img in images]
    finally:
        service.stop()
    assert captions == [port_vocab.decode(t, skip_special_tokens=True)
                        for t in want]


def test_step_checkpoints_are_throttled(tmp_path, monkeypatch):
    """``step_ckpt_max_overhead``: after a save that blocked for c
    seconds, step saves are skipped until c / frac seconds have passed."""
    cfg = get_default_config()
    cfg.model.encoder.hidden_size = cfg.model.encoder.feature_dim = 16
    cfg.model.encoder.num_layers = cfg.model.decoder.num_layers = 1
    cfg.model.encoder.num_heads = cfg.model.decoder.num_heads = 2
    cfg.model.decoder.hidden_dim, cfg.model.vocab_size = 16, 50
    cfg.image_size, cfg.model.encoder.patch_size = 32, 16
    cfg.training.use_rl = False
    cfg.output_dir = cfg.checkpoint_dir = str(tmp_path)
    cfg.step_ckpt_max_overhead = 1e-6
    t = CaptioningTrainer(cfg, [None] * 2, [], None, device="cpu")
    slots = []
    save_step = t.ckpt.save_step
    monkeypatch.setattr(t.ckpt, "save_step",
                        lambda *a, **k: slots.append(save_step(*a, **k)))
    t.save_step_checkpoint(0, 1, "ce")
    t.save_step_checkpoint(0, 2, "ce")   # within c / 1e-6 seconds: skipped
    assert slots == [STEP_SLOTS[0]]
    t.config.step_ckpt_max_overhead = 0.0
    t.save_step_checkpoint(0, 3, "ce")
    assert slots == [STEP_SLOTS[0], STEP_SLOTS[1]]
