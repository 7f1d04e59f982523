"""The port's mesh (``parallel/``): data parallelism and Megatron tensor
parallelism over two gloo ranks on the CPU, against the JAX package on its
8-device CPU mesh (``tests/conftest.py``), two devices of it.

* ``mesh_shape`` against JAX ``create_mesh``'s shapes for every case of
  ``tests/test_parallel.py``, its assert included;
* the placement table against JAX ``infer_param_shardings`` (kernels
  transposed), the non-dividing case included; the head-whole
  ``shard_params`` layout and its inverse, bit for bit;
* ``iterate_batches(rows=)``: each rank's rows of the whole batch, the
  list fields whole, only its own images decoded;
* the tp2 GPT-2 forward against JAX's tp2 forward within 2e-5;
* two CE steps of the tiny ``clip_gpt2`` configuration (contrastive loss
  on) at dp2 and at tp2, and of ``resnet_transformer`` (BatchNorm) at dp2,
  against the JAX trainer on a mesh of the same shape: the JAX trainer
  takes step 1, its state crosses into the ranks, both take steps 2 and
  3; losses, ``learning_rate`` and ``grad_norm`` within 1e-5 relative,
  the state under ``tests/test_torch_trainer.py``'s rules
  (:func:`torch_port_helpers.assert_state_close`: parameters atol 1e-5 +
  rtol 1e-4, entries whose gradient lies in (0, 1e-7) on either side held
  to the Adam steps' bound);
* one SCST step at dp2 (rollouts injected) against the one-process port
  trainer's on the same state: ``rl_loss`` and the rewards within 1e-5
  relative, parameters within atol 1e-5 + rtol 1e-4 plus twice the Adam
  step;
* validation at dp2 and tp2: each rank decodes its rows, the tokens
  gathered on the host equal the one-process decode's row for row, the
  loss within 1e-5 relative, CIDEr equal;
* ``main.evaluate`` at dp2 writes the one-process ``results.json``;
* a tp2 checkpoint restores in one process bit-identical to the gathered
  state.

The ranks run in subprocesses (``torch_parallel_ranks.py``), all scenarios
in one launch."""

import copy

import jax
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.config import MeshConfig as JaxMesh
from image_captioning_ml_project_tpu.config import config_to_dict
from image_captioning_ml_project_tpu.data.coco import (
    build_coco_datasets as jax_datasets)
from image_captioning_ml_project_tpu.data.coco import (
    iterate_batches as jax_iterate)
from image_captioning_ml_project_tpu.data.pipeline import (
    shard_batch as jax_shard_batch)
from image_captioning_ml_project_tpu.parallel import mesh as jax_mesh
from image_captioning_ml_project_tpu.parallel import sharding as jax_sharding
from image_captioning_ml_project_tpu.train.trainer import (
    CaptioningTrainer as JaxTrainer)
from image_captioning_ml_project_tpu_torch.config import MeshConfig
from image_captioning_ml_project_tpu_torch.data.coco import (
    build_coco_datasets)
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.models.gpt2 import GPT2Backbone
from image_captioning_ml_project_tpu_torch.parallel import mesh as port_mesh
from image_captioning_ml_project_tpu_torch.parallel import sharding
from image_captioning_ml_project_tpu_torch.train.trainer import (
    CaptioningTrainer)
from torch_parallel_ranks import _RecordingVocab, run_ranks
from torch_port_helpers import (LOSS_RTOL, PARAM_ATOL, PARAM_RTOL,
                                adam_step_bound, assert_state_close,
                                bridge_state, coco_fixture, jax_gradients,
                                loose_entries, port_config, train_config)

torch.set_num_threads(1)

# (the JAX trainer's configuration, data axis, model axis)
RUNS = {"clip_gpt2 dp2": ("clip_gpt2", 2, 1),
        "clip_gpt2 tp2": ("clip_gpt2", 1, 2),
        "resnet_transformer dp2": ("resnet_transformer", 2, 1)}
GPT2 = dict(vocab=64, hidden=16, layers=2, heads=2, positions=32)


# ----------------------------------------------------------------------
# mesh and placements (no processes)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dp,mp", [(-1, 1), (-1, 2), (3, 2), (4, -1),
                                   (-1, -1), (2, 4), (8, 1)])
def test_mesh_shape_matches_jax_create_mesh(dp, mp):
    want = None
    try:
        m = jax_mesh.create_mesh(JaxMesh(data_parallel=dp, model_parallel=mp))
        want = (m.shape["data"], m.shape["model"])
    except AssertionError:
        pass
    cfg = MeshConfig(data_parallel=dp, model_parallel=mp)
    if want is None:
        with pytest.raises(AssertionError, match="does not cover"):
            port_mesh.mesh_shape(cfg, 8)
    else:
        assert port_mesh.mesh_shape(cfg, 8) == want


def _jax_spec_table(params, mp):
    mesh = jax_mesh.create_mesh(JaxMesh(data_parallel=-1,
                                        model_parallel=mp))
    specs = jax_sharding.infer_param_shardings(params, mesh)
    return {jax_sharding._path_str(path): tuple(s.spec)
            for path, s in jax.tree_util.tree_leaves_with_path(specs)}


def _port_name(path):
    """A JAX GPT-2 path (``block_0/attn/c_attn/kernel``) as the port's
    parameter name."""
    name = path.replace("block_", "blocks.").replace("/", ".")
    for a, b in ((".kernel", ".weight"), (".scale", ".weight"),
                 (".embedding", ".weight")):
        if name.endswith(a):
            name = name[:-len(a)] + b
    return name


def _transposed(spec, ndim):
    return tuple(reversed(spec)) if ndim == 2 and spec else spec


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_gpt2_placements_match_jax(mp):
    """The tiny GPT-2 backbone's placement table: the port's (torch
    layout) against JAX ``infer_param_shardings`` (flax layout), at model
    axes of 1, 2 and 4."""
    import flax

    from image_captioning_ml_project_tpu.models.gpt2 import (
        GPT2Backbone as JaxGPT2)

    jb = JaxGPT2(vocab_size=GPT2["vocab"], hidden_dim=GPT2["hidden"],
                 num_layers=GPT2["layers"], num_heads=GPT2["heads"],
                 n_positions=GPT2["positions"])
    shapes = jax.eval_shape(jb.init, jax.random.PRNGKey(0),
                            jax.numpy.zeros((1, 4), jax.numpy.int32))
    params = flax.core.unfreeze(shapes)["params"]
    want = _jax_spec_table(params, mp)
    port = GPT2Backbone(GPT2["vocab"], GPT2["hidden"], GPT2["layers"],
                        GPT2["heads"], GPT2["positions"])
    got = sharding.infer_param_shardings(
        {n: tuple(p.shape) for n, p in port.named_parameters()}, mp)
    flat = {_port_name(k): v for k, v in want.items()}
    assert set(flat) == set(got)
    ndims = {n: p.ndim for n, p in port.named_parameters()}
    for name, spec in flat.items():
        assert got[name] == _transposed(spec, ndims[name]), name
    assert sum(bool(s) for s in got.values()) == (
        6 * GPT2["layers"] if mp > 1 else 0)


def test_placement_rules_and_non_dividing_dims_match_jax():
    """``tests/test_parallel.py``'s two trees: the rules' specs, and a
    ``c_attn`` of 9 outputs over 2 ranks left replicated."""
    tree = {"block_0": {
        "attn": {"c_attn": {"kernel": np.zeros((8, 24)),
                            "bias": np.zeros(24)},
                 "c_proj": {"kernel": np.zeros((8, 8)), "bias": np.zeros(8)}},
        "mlp": {"c_fc": {"kernel": np.zeros((8, 32)), "bias": np.zeros(32)},
                "c_proj": {"kernel": np.zeros((32, 8)),
                           "bias": np.zeros(8)}},
        "ln_1": {"scale": np.zeros(8), "bias": np.zeros(8)}},
        "wte": {"embedding": np.zeros((50, 8))}}
    odd = {"attn": {"c_attn": {"kernel": np.zeros((8, 9))}}}
    for t in (tree, odd):
        want = _jax_spec_table(t, 2)
        shapes, ndims = {}, {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(t):
            name = _port_name(jax_sharding._path_str(path))
            shapes[name] = (tuple(reversed(leaf.shape)) if leaf.ndim == 2
                            else leaf.shape)
            ndims[name] = leaf.ndim
        got = sharding.infer_param_shardings(shapes, 2)
        for path, spec in want.items():
            name = _port_name(path)
            assert got[name] == _transposed(spec, ndims[name]), name
    assert sharding.infer_param_shardings(
        {"attn.c_attn.weight": (9, 8)}, 2) == {"attn.c_attn.weight": ()}


@pytest.mark.parametrize("mp", [2, 4])
def test_shard_params_round_trip_and_head_whole_layout(mp):
    """Each rank's shards of a GPT-2 state dict, put back together by
    ``unshard_tensor``, are the full tensors bit for bit; rank r's
    ``c_attn`` rows are its heads' q, k and v rows, and its MLP and
    output-projection shards contiguous slices."""
    torch.manual_seed(0)
    model = GPT2Backbone(GPT2["vocab"], 32, 1, 4, GPT2["positions"])
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    specs = sharding.infer_param_shardings(
        {n: tuple(t.shape) for n, t in full.items()}, mp)
    shards = [sharding.shard_params(full, port_mesh.Mesh(
        shape={"data": 1, "model": mp}, data_axis="data",
        model_axis="model", rank=r, coords={"model": r}))
        for r in range(mp)]
    for name, t in full.items():
        back = sharding.unshard_tensor(name, [s[name] for s in shards],
                                       specs[name])
        assert torch.equal(back, t), name
    H, h = 32, 32 // mp
    w = full["blocks.0.attn.c_attn.weight"]
    for r, s in enumerate(shards):
        local = s["blocks.0.attn.c_attn.weight"]
        assert local.shape == (3 * h, H)
        for i in range(3):  # q, k, v
            assert torch.equal(local[i * h:(i + 1) * h],
                               w[i * H + r * h:i * H + (r + 1) * h])
        assert torch.equal(s["blocks.0.attn.c_proj.weight"],
                           full["blocks.0.attn.c_proj.weight"][
                               :, r * h:(r + 1) * h])
        assert torch.equal(s["blocks.0.mlp.c_fc.bias"],
                           full["blocks.0.mlp.c_fc.bias"][
                               r * 4 * h:(r + 1) * 4 * h])
        assert torch.equal(s["ln_f.weight"], full["ln_f.weight"])


def test_trainer_refuses_a_batch_that_does_not_divide(tmp_path):
    root, vocab = coco_fixture(str(tmp_path / "coco"))
    cfg = port_config(train_config("clip_gpt2", root, vocab, tmp_path))
    cfg.training.batch_size = 3
    mesh = port_mesh.Mesh(shape={"data": 2, "model": 1}, data_axis="data",
                          model_axis="model", rank=0,
                          coords={"data": 0, "model": 0})
    pv = PortVocab(dict(vocab.word2idx))
    train_ds, val_ds = build_coco_datasets(cfg, pv)
    with pytest.raises(ValueError, match="does not divide"):
        CaptioningTrainer(cfg, train_ds, val_ds, pv, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        port_mesh.batch_rows(3, mesh)
    assert port_mesh.batch_rows(4, mesh) == slice(0, 2)


@pytest.mark.parametrize("training", [True, False])
def test_iterate_batches_decodes_only_this_ranks_rows(tmp_path, training):
    """``iterate_batches(rows=)`` on each rank of a dp2 mesh: its array
    fields (``batch_valid`` included) are its rows of the whole batch,
    augmentations included; its list fields (the captions) are the whole
    batch's; it decodes its own rows' images and no other."""
    from image_captioning_ml_project_tpu_torch.data.coco import (
        iterate_batches)

    root, vocab = coco_fixture(str(tmp_path / "coco"))
    cfg = port_config(train_config("clip_gpt2", root, vocab, tmp_path))
    train_ds, val_ds = build_coco_datasets(cfg, PortVocab(dict(
        vocab.word2idx)))
    ds = train_ds if training else val_ds
    # the eval set's 8 images end in a batch of 2 padded to 6
    kw = dict(shuffle=training, seed=3, drop_last=training,
              pad_last=not training)
    whole = list(iterate_batches(ds, 6, **kw))
    lists = "caption" if training else "captions"
    decoded = []
    get_sample = ds.get_sample
    ds.get_sample = lambda i, image=None: (decoded.append(i),
                                           get_sample(i, image))[1]
    for r in range(2):
        mesh = port_mesh.Mesh(shape={"data": 2, "model": 1},
                              data_axis="data", model_axis="model", rank=r,
                              coords={"data": r, "model": 0})
        rows = port_mesh.batch_rows(6, mesh)
        decoded.clear()
        mine = list(iterate_batches(ds, 6, rows=rows, **kw))
        assert len(mine) == len(whole) and len(decoded) == 3 * len(whole)
        for a, b in zip(mine, whole):
            assert set(a) == set(b)
            assert a[lists] == b[lists]
            for k, v in b.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(a[k], v[rows], err_msg=k)
    if not training:
        assert not whole[-1]["batch_valid"][3:].any()


# ----------------------------------------------------------------------
# the ranks
# ----------------------------------------------------------------------

def _jax_run(kind, dp, mp, root, vocab, tmp):
    """The JAX trainer on a (dp, mp) mesh of two devices after steps 1-3:
    (config, trainer, the state after step 1 (bridged), the batches of
    steps 2-3, the JAX gradients and metrics of steps 2-3)."""
    cfg = train_config(kind, root, vocab, tmp)
    mesh = jax_mesh.create_mesh(JaxMesh(data_parallel=dp, model_parallel=mp),
                                devices=jax.devices()[:2])
    jtrain, jval = jax_datasets(cfg, vocab)
    jt = JaxTrainer(cfg, jtrain, jval, vocab, mesh=mesh)
    batches = list(jax_iterate(jtrain, 4, shuffle=True, seed=cfg.seed))[:3]
    rng = jax.random.PRNGKey(cfg.seed + 1)

    def step(b):
        s = jax_shard_batch({k: b[k] for k in ("image", "caption_tokens",
                                                "attention_mask")}, mesh)
        jt.state, m = jt._train_step(jt.state, s["image"],
                                     s["caption_tokens"],
                                     s["attention_mask"], rng)
        return {k: float(v) for k, v in m.items()}

    step(batches[0])
    before = bridge_state(jt)
    grads, metrics = [], []
    for b in batches[1:]:
        grads.append(jax_gradients(jt, b["image"], b, rng))
        metrics.append(step(b))
    return cfg, jt, before, batches[1:], grads, metrics


def _rollouts(vocab, B, L, rs):
    tokens = np.full((B, L), vocab.pad_token_id, dtype=np.int32)
    mask = np.zeros((B, L), dtype=bool)
    tokens[:, 0] = vocab.bos_token_id
    for b in range(B):
        end = rs.randint(2, L + 1)
        tokens[b, 1:end] = rs.randint(4, vocab.vocab_size, end - 1)
        if end < L:
            tokens[b, end] = vocab.eos_token_id
        mask[b, 1:min(end + 1, L)] = True
    return tokens, mask


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every JAX run, then one launch of two ranks running each port
    scenario: {name: (JAX run, rank 0's result)} plus the tp2 GPT-2
    forward's inputs and result."""
    tmp = tmp_path_factory.mktemp("parallel")
    root, vocab = coco_fixture(str(tmp / "coco"))
    word2idx = dict(vocab.word2idx)
    jax_runs, scenarios = {}, []
    rs = np.random.RandomState(7)
    for name, (kind, dp, mp) in RUNS.items():
        run = _jax_run(kind, dp, mp, root, vocab,
                       tmp / name.replace(" ", "_"))
        jax_runs[name] = run
        cfg, _, before, batches, _, _ = run
        sc = dict(kind="train", mesh=(dp, mp), config=config_to_dict(cfg),
                  word2idx=word2idx, state=before, batches=batches,
                  validate=kind == "clip_gpt2")
        if name == "clip_gpt2 dp2":
            sc["evaluate"] = str(tmp / "evaluate_dp2")
            L = cfg.inference.max_length
            sampled, mask = _rollouts(vocab, 4, L, rs)
            greedy, _ = _rollouts(vocab, 4, L, rs)
            greedy[0] = sampled[0]
            b = batches[-1]
            sc["scst"] = dict(image=b["image"], image_id=b["image_id"],
                              sampled=sampled, mask=mask, greedy=greedy)
        if mp > 1:
            sc["save_dir"] = str(tmp / "tp_ckpt")
        scenarios.append(sc)

    from image_captioning_ml_project_tpu.models.gpt2 import (
        GPT2Backbone as JaxGPT2)

    jb = JaxGPT2(vocab_size=GPT2["vocab"], hidden_dim=GPT2["hidden"],
                 num_layers=GPT2["layers"], num_heads=GPT2["heads"],
                 n_positions=GPT2["positions"])
    ids = np.random.RandomState(0).randint(0, GPT2["vocab"], (4, 7))
    variables = jb.init(jax.random.PRNGKey(0), jax.numpy.asarray(ids))
    mesh = jax_mesh.create_mesh(JaxMesh(data_parallel=1, model_parallel=2),
                                devices=jax.devices()[:2])
    sharded = {"params": jax_sharding.shard_params(variables["params"],
                                                   mesh)}
    ids_sharded = jax.device_put(ids, jax_mesh.batch_sharding(mesh, 2))
    jax_logits = np.asarray(jax.jit(jb.apply)(sharded, ids_sharded))
    state = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            variables["params"]):
        name = _port_name(jax_sharding._path_str(path))
        leaf = np.asarray(leaf)
        state[name] = torch.from_numpy(np.array(
            leaf.T if leaf.ndim == 2 and not name.startswith("w")
            else leaf))
    scenarios.append(dict(kind="gpt2_forward", mesh=(1, 2), args=GPT2,
                          state=state, ids=ids))

    sc = scenarios[0]["scst"]
    (tmp / "ranks").mkdir()
    results = run_ranks(tmp / "ranks", scenarios, timeout=300)
    out = {name: (jax_runs[name], results[i])
           for i, name in enumerate(RUNS)}
    out["scst_inputs"] = dict(sc, evaluate_dir=scenarios[0]["evaluate"])
    out["gpt2_forward"] = (jax_logits, results[-1])
    out["fixture"] = (root, vocab, str(tmp / "tp_ckpt"))
    return out


def test_tp2_gpt2_forward_matches_jax(runs):
    want, got = runs["gpt2_forward"]
    np.testing.assert_allclose(got["logits"], want, rtol=2e-5, atol=2e-5)
    shapes = got["local_shapes"]
    H = GPT2["hidden"]
    assert shapes["blocks.0.attn.c_attn.weight"] == (3 * H // 2, H)
    assert shapes["blocks.0.mlp.c_proj.weight"] == (H, 4 * H // 2)
    assert shapes["wte.weight"] == (GPT2["vocab"], H)


@pytest.mark.parametrize("name", list(RUNS))
def test_ce_steps_match_the_jax_trainer_on_the_same_mesh(runs, name):
    (cfg, jt, before, _, jax_grads, jm), res = runs[name]
    for j, p in zip(jm, res["metrics"]):
        assert set(p) == set(j), (sorted(p), sorted(j))
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"{name}: {k}")
    assert_state_close(res["state"], bridge_state(jt), before,
                       loose_entries(res["grads"], jax_grads),
                       [p["learning_rate"] for p in res["metrics"]],
                       cfg.training.weight_decay, name)


def _one_process(runs, name, state):
    """A one-process port trainer of run ``name``'s configuration on
    ``state`` (recording its decoded rows)."""
    root, vocab, _ = runs["fixture"]
    cfg = port_config(runs[name][0][0])
    vocab_rec = _RecordingVocab(dict(vocab.word2idx))
    train_ds, val_ds = build_coco_datasets(
        cfg, PortVocab(dict(vocab.word2idx)))
    t = CaptioningTrainer(cfg, train_ds, val_ds, vocab_rec, device="cpu")
    t.load_state(copy.deepcopy(state))
    return t, vocab_rec


def test_scst_step_at_dp2_matches_one_process(runs):
    """``scst_fused_step`` with injected rollouts: each rank scores and
    updates on its 2 rows, normalised over all 4."""
    s = runs["clip_gpt2 dp2"][1]
    t, _ = _one_process(runs, "clip_gpt2 dp2", s["state"])
    sc = runs["scst_inputs"]
    ref_tokens, ref_valid = t.scst_references(
        [int(i) for i in sc["image_id"]])
    m = t.scst_fused_step(sc["image"], ref_tokens, ref_valid,
                          rollouts=(sc["sampled"], sc["mask"],
                                    sc["greedy"]))
    got = s["scst"]
    assert m["adv_abs"] > 0
    for k in ("rl_loss", "reward", "greedy_reward", "adv_abs", "grad_norm"):
        np.testing.assert_allclose(got[k], float(m[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    lr = float(m["learning_rate"])
    adam = 2 * lr * adam_step_bound(t.optimizer.count)
    want = t._state_tree()
    for group in ("model", "loss"):
        for n, v in want["params"][group].items():
            np.testing.assert_allclose(
                s["scst_state"]["params"][group][n].numpy(), v.numpy(),
                rtol=PARAM_RTOL, atol=PARAM_ATOL + adam, err_msg=n)


@pytest.mark.parametrize("name", ["clip_gpt2 dp2", "clip_gpt2 tp2"])
def test_validation_gathers_the_one_process_decode(runs, name):
    """``_validate_epoch``: the decoded rows gathered from the ranks equal
    the one-process trainer's on the same weights, in order; the loss
    within 1e-5 relative, CIDEr equal."""
    res = runs[name][1]
    loss, metrics, rows = res["validation"]
    t, rec = _one_process(runs, name, res["state"])
    want_loss, want_metrics = t._validate_epoch(0)
    np.testing.assert_array_equal(rows, np.stack(rec.seen))
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    assert metrics["CIDEr"] == pytest.approx(want_metrics["CIDEr"])


def test_main_evaluate_at_dp2_matches_one_process(runs, tmp_path):
    """``main.evaluate`` on two ranks (the batch of 4 rounded to the data
    axis, each rank decoding its rows, rank 0 writing ``results.json``)
    against one process on the same seeded weights: the same captions for
    every image and the same metrics."""
    import json

    from image_captioning_ml_project_tpu_torch import main as port_main

    res = runs["clip_gpt2 dp2"][1]
    root, vocab, _ = runs["fixture"]
    cfg = port_config(runs["clip_gpt2 dp2"][0][0])
    cfg.output_dir = str(tmp_path)
    want = port_main.evaluate(cfg, tokenizer=PortVocab(dict(vocab.word2idx)),
                              device="cpu")
    assert res["evaluate"] == pytest.approx(want)
    with open(tmp_path / "results.json") as f:
        one = json.load(f)
    with open(runs["scst_inputs"]["evaluate_dir"] + "/results.json") as f:
        two = json.load(f)
    assert two == one and len(one) == 8


def test_tp2_checkpoint_restores_in_one_process(runs):
    """The ranks' ``save_checkpoint`` after their steps (rank 0 writes the
    gathered tensors): a one-process trainer's ``load_checkpoint`` holds
    the same state bit for bit, Adam moments and step included."""
    res = runs["clip_gpt2 tp2"][1]
    root, vocab, ckpt_dir = runs["fixture"]
    cfg = port_config(runs["clip_gpt2 tp2"][0][0])
    cfg.checkpoint_dir = ckpt_dir
    pv = PortVocab(dict(vocab.word2idx))
    train_ds, val_ds = build_coco_datasets(cfg, pv)
    t = CaptioningTrainer(cfg, train_ds, val_ds, pv, device="cpu")
    t.load_checkpoint("checkpoint_epoch_1")
    got, want = t._state_tree(), res["state"]
    for group in ("model", "loss"):
        for n, v in want["params"][group].items():
            assert torch.equal(got["params"][group][n], v), n
    for key in ("mu", "nu"):
        for n, v in want["opt_state"][key].items():
            assert torch.equal(got["opt_state"][key][n], v), n
    assert got["step"] == want["step"] == 3
