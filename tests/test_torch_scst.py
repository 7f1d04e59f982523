"""The port's SCST half (train/trainer.py) against the JAX trainer on the
CPU, at f32, on two tiny configurations: the JAX trainer tests' fixture
(ViT + LSTM with soft attention) and a 2-layer CLIP + 2-layer GPT-2 (with
the contrastive loss, whose parameters take AdamW's decay on a zero
gradient).

The JAX trainer takes one CE step; its whole state crosses into the port
through ``params.train_state_from_flax``. Both then take (A) one
``rl_update_step`` on the same injected sampled tokens, mask and
advantages, and (B) one SCST step with the rollouts injected: JAX's
``per_sample_cider_device`` and ``_rl_update_step`` against the port's
``scst_fused_step(..., rollouts=...)``. Stated tolerances: ``rl_loss``
within 1e-5 relative, rewards within rtol 1e-5 / atol 1e-6; parameters
and Adam moments under ``tests/test_torch_trainer.py``'s rules
(:func:`torch_port_helpers.assert_state_close`), with the JAX gradients
from ``jax.grad`` of its REINFORCE loss. The port's LSTM has
``use_pallas`` on: its REINFORCE forward must take the plain route (the
additive-score wrapper raises under autograd, on the CPU too), and the
CLIP encoder must not fold (the trainer's model has no stacked weights).
JAX's side runs with ``use_pallas`` off: its Pallas kernels have no VJP,
so its own REINFORCE update cannot differentiate through them.

Also, port only: the rollouts share one ``init_cache`` and decode what
separate decodes would; the refreshed rollout model equals a fresh
``eval_state()`` tensor for tensor; a resume inside ``"scst"`` from a
rolling step checkpoint ends bit-identical to the uninterrupted run;
``train()`` runs CE then SCST; the host-reward pass returns its mean RL
loss; ``_rewards`` equals JAX's for each reward name."""

import copy
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.data.coco import (
    build_coco_datasets as jax_datasets)
from image_captioning_ml_project_tpu.data.coco import (
    iterate_batches as jax_iterate)
from image_captioning_ml_project_tpu.evaluate import (
    cider_device as jax_cider)
from image_captioning_ml_project_tpu.train.trainer import (
    CaptioningTrainer as JaxTrainer)
from image_captioning_ml_project_tpu_torch.data.coco import (
    build_coco_datasets)
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    greedy_decode, sample_decode)
from image_captioning_ml_project_tpu_torch.params import _grouped
from image_captioning_ml_project_tpu_torch.train.trainer import (
    CaptioningTrainer)
from torch_port_helpers import (LOSS_RTOL, assert_state_close, bridge_state,
                                coco_fixture, loose_entries,
                                one_device_mesh, port_config,
                                record_gradients, train_config)

torch.set_num_threads(1)

REWARD_RTOL, REWARD_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return coco_fixture(str(tmp_path_factory.mktemp("coco")))


def _rollout_tokens(rs, B, L, vocab):
    """Seeded rollouts as the decoders give them: BOS, words, an EOS at a
    random position (or none), pads after; the sampler's mask True from
    position 1 to the EOS. Token 0 (the pad) never appears as a word."""
    tokens = np.full((B, L), vocab.pad_token_id, dtype=np.int32)
    mask = np.zeros((B, L), dtype=bool)
    tokens[:, 0] = vocab.bos_token_id
    for b in range(B):
        end = rs.randint(2, L + 1)        # L: no EOS in the row
        tokens[b, 1:end] = rs.randint(4, vocab.vocab_size, end - 1)
        if end < L:
            tokens[b, end] = vocab.eos_token_id
        mask[b, 1:min(end + 1, L)] = True
    return tokens, mask


def _jax_reinforce_gradients(jt, images, sampled, mask, adv):
    """{optimizer name: |gradient|} of the JAX trainer's REINFORCE loss
    (its ``reinforce_update``'s ``loss_fn``) at its current state."""
    state = jt.state

    def loss_fn(params, images, sampled, mask, adv):
        out = jt.model.apply(jt._model_vars(state, params),
                             jt._prepare_inputs(images), sampled,
                             train=False)
        logp = jax.nn.log_softmax(out["logits"].astype(jnp.float32)[:, :-1],
                                  axis=-1)
        tok = jnp.take_along_axis(logp, sampled[:, 1:, None], axis=-1)[..., 0]
        m = mask[:, 1:].astype(jnp.float32)
        return jt.config.training.rl_weight * -(
            adv[:, None] * tok * m).sum() / jnp.maximum(m.sum(), 1.0)

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(
        state.params, images, sampled, mask, adv))
    return {n: g.abs() for n, g in _grouped(
        grads["model"], grads.get("loss", {}), stats=False).items()}


def _snapshot(trainer):
    """A copy of the trainer's state, kept while it trains on."""
    return copy.deepcopy(trainer._state_tree())


@pytest.fixture(scope="module", params=["vit_lstm", "clip_gpt2"])
def pair(request, data, tmp_path_factory):
    """The JAX and port trainers after (A) and (B) (module docstring):
    {"A": (JAX metrics, port metrics, port state, JAX state, the state
    both began (A) from, the entries held to the Adam steps' bound, the
    learning rates of the steps so far), "B": likewise}."""
    kind = request.param
    root, vocab = data
    cfg = train_config(kind, root, vocab, tmp_path_factory.mktemp(kind))
    jtrain, jval = jax_datasets(cfg, vocab)
    jt = JaxTrainer(cfg, jtrain, jval, vocab, mesh=one_device_mesh())
    batches = list(jax_iterate(jtrain, 4, shuffle=True, seed=cfg.seed))[:3]
    jt.state, _ = jt._train_step(jt.state, batches[0]["image"],
                                 batches[0]["caption_tokens"],
                                 batches[0]["attention_mask"],
                                 jax.random.PRNGKey(cfg.seed + 1))
    pcfg = port_config(cfg)
    if kind == "vit_lstm":
        pcfg.model.attention.use_pallas = True
    port_vocab = PortVocab(dict(vocab.word2idx))
    ptrain, pval = build_coco_datasets(pcfg, port_vocab)
    pt = CaptioningTrainer(pcfg, ptrain, pval, port_vocab, device="cpu")
    pt.load_state(bridge_state(jt))
    port_grads = record_gradients(pt)
    rs = np.random.RandomState(7)
    L = cfg.inference.max_length
    out = {}

    # (A) one rl_update_step on injected rollouts
    b = batches[1]
    sampled, mask = _rollout_tokens(rs, 4, L, vocab)
    adv = rs.randn(4).astype(np.float32)
    before = bridge_state(jt)
    jax_grads = [_jax_reinforce_gradients(jt, b["image"], sampled, mask,
                                          adv)]
    jt.state, jm = jt._rl_update_step(jt.state, b["image"], sampled, mask,
                                      adv)
    pm = pt.rl_update_step(b["image"], sampled, mask, adv)
    lrs = [float(pm["learning_rate"])]
    out["A"] = ({"rl_loss": float(jm["rl_loss"])},
                {k: float(v) for k, v in pm.items()}, _snapshot(pt),
                bridge_state(jt), before,
                loose_entries(port_grads, jax_grads), list(lrs))

    # (B) the fused step with the rollouts injected, device CIDEr
    b = batches[2]
    mc = cfg.model
    specials = (mc.pad_token_id, mc.bos_token_id, mc.eos_token_id)
    ref_len = mc.decoder.max_length
    jrefs = jt._tokenized_refs_by_image_id(ref_len)
    prefs = pt._tokenized_refs_by_image_id(ref_len)
    assert jrefs == prefs
    jdf = jax_cider.build_df_table(list(jrefs.values()), special_ids=specials)
    refs = [jrefs[int(i)] for i in b["image_id"]]
    ref_tokens, ref_valid = jax_cider.encode_references(refs, 5, ref_len)
    got_tokens, got_valid = pt.scst_references(b["image_id"])
    np.testing.assert_array_equal(got_tokens, ref_tokens)
    np.testing.assert_array_equal(got_valid, ref_valid)
    sampled, mask = _rollout_tokens(rs, 4, L, vocab)
    greedy, _ = _rollout_tokens(rs, 4, L, vocab)
    # one greedy row equal to its sampled row: an advantage of exactly 0
    greedy[0] = sampled[0]
    sample_r = jax_cider.per_sample_cider_device(
        jnp.asarray(sampled), jnp.asarray(ref_tokens),
        jnp.asarray(ref_valid), jdf, specials)
    greedy_r = jax_cider.per_sample_cider_device(
        jnp.asarray(greedy), jnp.asarray(ref_tokens),
        jnp.asarray(ref_valid), jdf, specials)
    adv = np.asarray(sample_r - greedy_r)
    jax_grads.append(_jax_reinforce_gradients(jt, b["image"], sampled, mask,
                                              adv))
    jt.state, jm = jt._rl_update_step(jt.state, b["image"], sampled, mask,
                                      adv)
    jm = {"rl_loss": float(jm["rl_loss"]),
          "reward": float(sample_r.mean()),
          "greedy_reward": float(greedy_r.mean()),
          "adv_abs": float(np.abs(adv).mean())}
    pm = pt.scst_fused_step(b["image"], ref_tokens, ref_valid,
                            rollouts=(sampled, mask, greedy))
    lrs.append(float(pm["learning_rate"]))
    # both steps from the state before (A): entries whose gradient was
    # small in either step are held to the two steps' Adam bound
    out["B"] = (jm, {k: float(v) for k, v in pm.items()}, _snapshot(pt),
                bridge_state(jt), before,
                loose_entries(port_grads, jax_grads), lrs)
    return kind, out


@pytest.mark.parametrize("step", ["A", "B"])
def test_scst_updates_match_the_jax_trainer(pair, step):
    """(A) ``rl_update_step`` and (B) ``scst_fused_step`` with injected
    rollouts: the loss and rewards, every parameter and Adam moment."""
    kind, out = pair
    jm, pm, port_state, jax_state, before, loose, lrs = out[step]
    assert min(lrs) > 0
    np.testing.assert_allclose(pm["rl_loss"], jm["rl_loss"],
                               rtol=LOSS_RTOL, atol=1e-7,
                               err_msg=f"{kind} {step}: rl_loss")
    assert jm["rl_loss"] != 0.0
    for key in ("reward", "greedy_reward", "adv_abs"):
        if key in jm:
            np.testing.assert_allclose(pm[key], jm[key], rtol=REWARD_RTOL,
                                       atol=REWARD_ATOL,
                                       err_msg=f"{kind} {step}: {key}")
    assert_state_close(port_state, jax_state, before, loose, lrs,
                       0.01, f"{kind} {step}")


@pytest.mark.parametrize("reward", ["cider", "bleu", "meteor", "rouge",
                                    "spice", "bogus"])
def test_rewards_match_the_jax_trainer(reward):
    """``_rewards`` per reward name on the texts of
    ``tests/test_trainer.py::test_reward_dispatch_all_types``: equal to the
    JAX trainer's; ``spice`` falls back to CIDEr with one warning where
    SPICE cannot run, ``bogus`` to CIDEr."""
    texts = ["a red dog runs fast", "a blue cat sits"]
    refs = [["a red dog runs fast", "the red dog is running"],
            ["a blue cat sits still"]]
    got = []
    for cls in (JaxTrainer, CaptioningTrainer):
        cfg = types.SimpleNamespace(
            training=types.SimpleNamespace(rl_reward=reward))
        host = types.SimpleNamespace(config=cfg,
                                     logger=logging.getLogger(__name__))
        got.append(np.asarray(cls._rewards(host, texts, refs)))
    assert got[1].shape == (2,) and np.all(np.isfinite(got[1]))
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6, atol=1e-9)


def _port_trainer(data, tmp, kind="clip_gpt2", dtype="float32",
                  dropout=0.0, save_every_steps=0, **training):
    """A port trainer of ``train_config(kind)`` with ``use_rl`` from epoch
    0, one epoch, the model in ``dtype`` (``use_amp`` follows it)."""
    root, vocab = data
    cfg = port_config(train_config(kind, root, vocab, tmp))
    cfg.model.dtype = dtype
    cfg.model.decoder.dropout = dropout
    cfg.save_every_steps = save_every_steps
    tc = cfg.training
    tc.use_amp = dtype == "bfloat16"
    tc.use_rl, tc.rl_start_epoch, tc.num_epochs = True, 0, 1
    for k, v in training.items():
        setattr(tc, k, v)
    port_vocab = PortVocab(dict(vocab.word2idx))
    train_ds, val_ds = build_coco_datasets(cfg, port_vocab)
    return CaptioningTrainer(cfg, train_ds, val_ds, port_vocab, device="cpu")


def test_rollouts_share_one_init_cache(data, tmp_path):
    """``rollout_step``'s sampled and greedy decodes from one
    ``init_cache`` give what each decode gives from its own."""
    t = _port_trainer(data, tmp_path)
    b = next(iter(t._train_batches(0)))
    model = t.rollout_model()
    sampled, mask, greedy = t.rollout_step(model, b["image"],
                                           t._rollout_generator(3))
    mc, L = t.config.model, t.config.inference.max_length
    with torch.no_grad():
        state = model.init_cache(b["image"], L)
        want = sample_decode(model.step, state, t._rollout_generator(3), 4,
                             mc.bos_token_id, mc.eos_token_id,
                             mc.pad_token_id, L)
        state = model.init_cache(b["image"], L)
        want_greedy = greedy_decode(model.step, state, 4, mc.bos_token_id, L,
                                    eos_token_id=mc.eos_token_id,
                                    pad_token_id=mc.pad_token_id)
    assert torch.equal(sampled, want.tokens)
    assert torch.equal(mask, want.mask)
    assert torch.equal(greedy, want_greedy)
    assert sampled.shape == greedy.shape == (4, L)


@pytest.mark.parametrize("kind,amp", [("clip_gpt2", True),
                                      ("resnet_transformer", False)])
def test_refreshed_rollout_model_equals_eval_state(data, tmp_path, kind, amp):
    """After CE and SCST steps, the rollout model refreshed in place equals
    a fresh ``eval_state()`` tensor for tensor: parameters, BatchNorm
    statistics, the stacked operands of the kernels (CLIP and GPT-2 in
    bf16) and the Transformer's concatenated QKV."""
    t = _port_trainer(data, tmp_path, kind,
                      dtype="bfloat16" if amp else "float32")
    b = next(iter(t._train_batches(0)))
    first = t.rollout_model()
    t.train_step(b["image"], b["caption_tokens"], b["attention_mask"])
    sampled, mask, _ = t.rollout_step(t.rollout_model(), b["image"],
                                      t._rollout_generator(t.step))
    t.rl_update_step(b["image"], sampled, mask,
                     torch.linspace(-1.0, 1.0, 4))
    refreshed, fresh = t.rollout_model(), t.eval_state()
    assert refreshed is first

    def tensors(m):
        out = dict(m.named_parameters())
        out.update(m.named_buffers())
        for name, mod in m.named_modules():
            for attr in ("stack", "wqkv", "bqkv"):
                val = getattr(mod, attr, None)
                if isinstance(val, dict):
                    out.update({f"{name}.{attr}.{k}": v
                                for k, v in val.items()})
                elif isinstance(val, torch.Tensor):
                    out[f"{name}.{attr}"] = val
        return out

    got, want = tensors(refreshed), tensors(fresh)
    assert set(got) == set(want)
    assert any(".stack." in n for n in want) or any("wqkv" in n
                                                    for n in want)
    if amp:
        assert any(v.dtype == torch.bfloat16 for v in want.values())
    for name, v in want.items():
        assert got[name].dtype == v.dtype, name
        assert torch.equal(got[name], v), name


def test_resume_inside_scst_is_bit_identical(data, tmp_path):
    """The uninterrupted epoch (6 CE and 6 SCST batches, dropout 0.1)
    writes its rolling step checkpoint at SCST batch 4; a new trainer that
    loads it resumes inside ``"scst"`` and ends bit-identical (the same
    batches, the same rollout draws: the generator is keyed on the
    step)."""
    whole = _port_trainer(data, tmp_path, dropout=0.1, save_every_steps=4)
    whole._train_epoch(0)
    whole.ckpt.wait_until_finished()
    assert whole.step == 12

    resumed = _port_trainer(data, tmp_path, dropout=0.1, save_every_steps=4)
    resumed.load_checkpoint("checkpoint_step")
    assert (resumed.start_epoch, resumed.start_phase,
            resumed.start_batch) == (0, "scst", 4)
    assert resumed.step == 10
    loss = resumed._train_epoch(0, start_batch=resumed.start_batch,
                                start_phase=resumed.start_phase)
    assert isinstance(loss, float) and loss != 0.0
    a, b = whole._state_tree(), resumed._state_tree()
    assert a["step"] == b["step"] == 12
    for group in ("model", "loss"):
        for name, t in a["params"][group].items():
            assert torch.equal(t, b["params"][group][name]), name
    for key in ("mu", "nu"):
        for name, t in a["opt_state"][key].items():
            assert torch.equal(t, b["opt_state"][key][name]), name


def test_train_runs_ce_then_scst(data, tmp_path):
    """``train()`` with ``use_rl`` and ``rl_start_epoch = 0``: the CE pass,
    then the SCST pass (every step of both taken), ``"scst": True`` in the
    history, whose train loss is the CE pass's mean loss."""
    t = _port_trainer(data, tmp_path, "vit_lstm")
    ce, rl = [], []
    ce_step, rl_step = t.train_step, t.rl_update_step

    def counting_ce(*a):
        m = ce_step(*a)
        ce.append(float(m["total_loss"]))
        return m

    def counting_rl(*a):
        m = rl_step(*a)
        rl.append(float(m["rl_loss"]))
        return m

    t.train_step, t.rl_update_step = counting_ce, counting_rl
    t.train()
    assert len(ce) == len(rl) == 6 and t.step == 12
    (row,) = t.history
    assert row["scst"] is True
    assert row["train_loss"] == pytest.approx(np.mean(ce), rel=1e-6)
    assert row["train_loss"] != pytest.approx(np.mean(rl))


def test_host_reward_pass_returns_its_loss(data, tmp_path):
    """The host-reward pass (``rouge``) returns its mean RL loss, a float,
    where the JAX trainer's returns None."""
    t = _port_trainer(data, tmp_path, "vit_lstm", rl_reward="rouge")
    rl = []
    rl_step = t.rl_update_step

    def counting_rl(*a):
        m = rl_step(*a)
        rl.append(float(m["rl_loss"]))
        return m

    t.rl_update_step = counting_rl
    loss = t._train_reinforcement_learning(0)
    assert isinstance(loss, float)
    assert len(rl) == 6 and loss == pytest.approx(np.mean(rl))
    assert t._rollout is None          # the pass dropped its rollout model
