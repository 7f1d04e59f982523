"""The port's legacy Show-Attend-Tell stack (``legacy/``) against the JAX
package's on the CPU: one counterpart of each test of
``tests/test_legacy.py``, on its tiny two-stage ResNet (``TINY_ENC``),
the JAX weights carried across by ``params.legacy_from_flax``.

Stated tolerances (f32): the adaptive pool within 1e-6 of JAX's and of
``torch.nn.AdaptiveAvgPool2d``; the model's teacher-forced predictions and
alphas within 1e-5, ``generate``'s tokens identical and its alphas within
1e-5; the CE helper within 1e-6 relative; over two trainer steps (dropout
0 on both sides: the JAX model's decoder is rebuilt with rate 0, as its
fixed 0.5 cannot draw the same masks in both packages) ``ce`` and
``att_reg`` within 1e-5 relative and every parameter within atol 1e-5 +
rtol 1e-4 plus the steps' Adam bound (at step 1 Adam moves every entry by
+-lr whatever the gradient's size, so an entry whose gradient is rounding
noise may move either way: JAX's own dp test holds parameters to 1e-3 for
this); validation's loss within 1e-5 relative and its BLEU equal (1e-6).
The dp2 step over two gloo ranks is held to JAX's dp2 step by the same
rules."""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_captioning_ml_project_tpu.config import EncoderConfig
from image_captioning_ml_project_tpu.config import MeshConfig as JaxMesh
from image_captioning_ml_project_tpu.data.coco import COCOCaptionDataset
from image_captioning_ml_project_tpu.data.coco import (
    iterate_batches as jax_iterate)
from image_captioning_ml_project_tpu.data.synthetic import make_synthetic_coco
from image_captioning_ml_project_tpu.data.tokenizer import WordVocab
from image_captioning_ml_project_tpu.legacy import model as jax_model
from image_captioning_ml_project_tpu.legacy import train as jax_train
from image_captioning_ml_project_tpu_torch.config import (
    EncoderConfig as PortEncoderConfig)
from image_captioning_ml_project_tpu_torch.data.coco import (
    COCOCaptionDataset as PortDataset)
from image_captioning_ml_project_tpu_torch.data.tokenizer import (
    WordVocab as PortVocab)
from image_captioning_ml_project_tpu_torch.legacy import model as port_model
from image_captioning_ml_project_tpu_torch.legacy.train import (
    LegacyTrainer, legacy_schedule, load_legacy_checkpoints,
    masked_caption_ce)
from image_captioning_ml_project_tpu_torch.params import (
    init_legacy_flax_params, legacy_from_flax)
from image_captioning_ml_project_tpu_torch.train.optim import AdamW
from torch_port_helpers import adam_step_bound
from torch_parallel_ranks import run_ranks

# the legacy packages export a function named validate: the modules
jax_validate = importlib.import_module(
    "image_captioning_ml_project_tpu.legacy.validate")
port_validate = importlib.import_module(
    "image_captioning_ml_project_tpu_torch.legacy.validate")

torch.set_num_threads(1)

TINY = dict(resnet_embedding_size=8, resnet_hidden_sizes=(8, 16),
            resnet_depths=(1, 1))
TINY_ENC = EncoderConfig(**TINY)
PORT_TINY_ENC = PortEncoderConfig(**TINY)
LR = 4e-4


class NoDropoutShowAttendTell(jax_model.ShowAttendTell):
    """The JAX model with its decoder's dropout at 0 (its one fixed rate
    is 0.5; the same parameter tree)."""

    def setup(self):
        self.encoder = jax_model.LegacyEncoder(
            self.encoded_image_size, self.encoder_config, dtype=self.dtype)
        cfg = self.encoder_config or EncoderConfig()
        self.decoder = jax_model.LegacyDecoder(
            vocab_size=self.vocab_size, use_bert=self.use_bert,
            encoder_dim=cfg.resnet_hidden_sizes[-1],
            embed_dim=768 if self.use_bert else self.embed_dim,
            dtype=self.dtype, dropout=0.0)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """tests/test_legacy.py's fixture, with the port's datasets beside
    JAX's: (root, JAX vocab, JAX train, JAX val, port vocab, port train,
    port val)."""
    root = str(tmp_path_factory.mktemp("legacy_coco"))
    make_synthetic_coco(root, num_images=6, captions_per_image=2,
                        image_size=48)
    with open(os.path.join(root, "annotations/captions_train2014.json")) as f:
        ann = json.load(f)
    vocab = WordVocab.build([a["caption"] for a in ann["annotations"]],
                            threshold=1)
    pvocab = PortVocab(dict(vocab.word2idx))
    out = [root, vocab]
    for cls, v in ((COCOCaptionDataset, vocab), (PortDataset, pvocab)):
        if cls is PortDataset:
            out.append(pvocab)
        out.append(cls(root, "annotations/captions_train2014.json",
                       "train2014", v, image_size=32, max_length=12,
                       is_training=True))
        out.append(cls(root, "annotations/captions_val2014.json", "val2014",
                       v, image_size=32, max_length=12, is_training=False))
    return tuple(out)


def _jax_trainer(coco, tmp, mesh=None, **kw):
    root, vocab, train, val = coco[:4]
    t = jax_train.LegacyTrainer(vocab, train, val, batch_size=6,
                                num_epochs=1, encoder_config=TINY_ENC,
                                checkpoint_dir=str(tmp), mesh=mesh, **kw)
    t.model = NoDropoutShowAttendTell(vocab_size=len(vocab),
                                      encoder_config=TINY_ENC,
                                      use_bert=t.use_bert)
    t._build_step()
    return t


def _variables(jt):
    s = jax.device_get(jt.state)
    return {"params": s.params, "batch_stats": s.batch_stats}


@pytest.fixture(scope="module")
def jax_and_port(coco, tmp_path_factory):
    """A JAX legacy trainer (dropout 0) and the port's on its weights."""
    tmp = tmp_path_factory.mktemp("legacy_pair")
    jt = _jax_trainer(coco, tmp / "jax")
    pt = LegacyTrainer(coco[4], coco[5], coco[6], batch_size=6,
                       num_epochs=1, encoder_config=PORT_TINY_ENC,
                       checkpoint_dir=str(tmp / "port"), device="cpu",
                       params=_variables(jt), dropout=0.0)
    return jt, pt


# ----------------------------------------------------------------------
# model
# ----------------------------------------------------------------------

def test_adaptive_avg_pool():
    x = np.arange(2 * 4 * 4 * 1, dtype=np.float32).reshape(2, 4, 4, 1)
    for size in (2, 8):
        got = port_model.adaptive_avg_pool_2d(torch.from_numpy(x), size)
        want = np.asarray(jax_model.adaptive_avg_pool_2d(jnp.asarray(x),
                                                         size))
        assert got.shape == (2, size, size, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(port_model.adaptive_avg_pool_2d(
        torch.from_numpy(x), 8).mean()), float(x.mean()), rtol=1e-6)


def test_fuzz_adaptive_pool_matches_torch_and_jax():
    """Seeded fuzz over random (H, W) -> output sizes, non-divisible and
    upsampling cases included: the port's pool against
    ``torch.nn.AdaptiveAvgPool2d`` and the JAX package's."""
    r = np.random.RandomState(13)
    for trial in range(12):
        H, W = int(r.randint(3, 33)), int(r.randint(3, 33))
        S = int(r.choice([2, 5, 7, 14]))
        x = r.randn(2, H, W, 3).astype(np.float32)
        ours = port_model.adaptive_avg_pool_2d(torch.from_numpy(x),
                                               S).numpy()
        with torch.no_grad():
            want = torch.nn.AdaptiveAvgPool2d(S)(
                torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(ours, want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"trial {trial} {H}x{W}->{S}")
        np.testing.assert_allclose(
            ours, np.asarray(jax_model.adaptive_avg_pool_2d(
                jnp.asarray(x), S)), rtol=1e-5, atol=1e-6)


def test_legacy_from_flax_consumes_every_leaf(jax_and_port):
    jt, _ = jax_and_port
    variables = _variables(jt)
    sd = legacy_from_flax(variables)
    model = port_model.ShowAttendTell(len(jt.vocab),
                                      encoder_config=PORT_TINY_ENC)
    assert set(sd) == set(model.state_dict())
    extra = {"params": dict(variables["params"], stray={"w": np.zeros(2)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="unmapped"):
        legacy_from_flax(extra)


def test_seeded_init_has_the_jax_layout(coco):
    """``init_legacy_flax_params`` draws the JAX model's tree, leaf for
    leaf and shape for shape."""
    vocab = coco[1]
    model = jax_model.ShowAttendTell(vocab_size=len(vocab),
                                     encoder_config=TINY_ENC)
    want = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((2, 32, 32, 3)),
                          jnp.zeros((2, 5), jnp.int32))
    got = init_legacy_flax_params(len(vocab), PORT_TINY_ENC, 0)

    def shapes(tree):
        return {"/".join(str(k.key) for k in path): tuple(x.shape)
                for path, x in jax.tree_util.tree_leaves_with_path(tree)}

    assert shapes(got) == shapes(dict(want))


@pytest.mark.parametrize("use_table", [False, True])
def test_decoder_matches_the_jax_decoder(use_table):
    """The decoder alone (B 2, 9 regions of 32, vocab 17, attention and
    LSTM 16, embedding 8): teacher-forced predictions and alphas, and
    ``generate``'s tokens (identical) and alphas, through the learned
    embedding or an ``embedding_table`` (the BERT path)."""
    rs = np.random.RandomState(0)
    B, N, V, E, A, D, EMB = 2, 9, 17, 32, 16, 16, 8
    dec = jax_model.LegacyDecoder(vocab_size=V, encoder_dim=E,
                                  attention_dim=A, decoder_dim=D,
                                  embed_dim=EMB, dropout=0.0,
                                  use_bert=use_table)
    enc = rs.randn(B, N, E).astype(np.float32)
    caps = rs.randint(0, V, (B, 6))
    emb = rs.randn(B, 6, EMB).astype(np.float32)
    table = rs.randn(V, EMB).astype(np.float32)
    kw = {"caption_embeddings": jnp.asarray(emb)} if use_table else {}
    variables = dec.init(jax.random.PRNGKey(0), jnp.asarray(enc),
                         jnp.asarray(caps), **kw)
    out = dec.apply(variables, jnp.asarray(enc), jnp.asarray(caps), **kw)
    toks, alphas = dec.apply(
        variables, jnp.asarray(enc), 7,
        embedding_table=jnp.asarray(table) if use_table else None,
        method=dec.generate)

    mine = port_model.LegacyDecoder(V, encoder_dim=E, attention_dim=A,
                                    decoder_dim=D, embed_dim=EMB,
                                    dropout=0.0, use_bert=use_table)
    tree = {"encoder": {}, "decoder": variables["params"]}
    flat = {}
    for k, v in jax.tree_util.tree_leaves_with_path(tree):
        flat["/".join(p.key for p in k)] = np.asarray(v)
    sd = {}
    for path, v in flat.items():
        name = path[len("decoder/"):].replace("/", ".")
        name = name.replace(".kernel", ".weight").replace(
            "embedding.embedding", "embedding.weight")
        sd[name] = torch.from_numpy(np.array(v.T if path.endswith("kernel")
                                             else v))
    mine.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = mine(torch.from_numpy(enc), torch.from_numpy(caps),
                   caption_embeddings=(torch.from_numpy(emb)
                                       if use_table else None))
        gt, ga = mine.generate(torch.from_numpy(enc), 7,
                               embedding_table=(torch.from_numpy(table)
                                                if use_table else None))
    np.testing.assert_allclose(got["predictions"].numpy(),
                               np.asarray(out["predictions"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["alphas"].numpy(),
                               np.asarray(out["alphas"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(toks))
    np.testing.assert_allclose(ga.numpy(), np.asarray(alphas), rtol=1e-5,
                               atol=1e-5)


def test_model_matches_the_jax_model(jax_and_port, coco):
    """The whole model (ResNet, pool to 14 x 14, decoder) in eval mode on
    the validation images: predictions and alphas, and 12 generated
    tokens identical."""
    jt, pt = jax_and_port
    b = next(iter(jax_iterate(coco[3], 4, shuffle=False)))
    images = np.asarray(b["image"])
    caps = np.asarray(b["caption_tokens"][:, 0])
    from image_captioning_ml_project_tpu.data.coco import normalize_images

    variables = _variables(jt)
    ji = normalize_images(jnp.asarray(images))
    out = jt.model.apply(variables, ji, jnp.asarray(caps))
    toks, alphas = jt.model.apply(variables, ji, 12,
                                  method=lambda m, im, L: m.generate(im, L))
    from image_captioning_ml_project_tpu_torch.data.coco import (
        normalize_images as port_normalize)

    model = pt.model.eval()
    with torch.no_grad():
        pi = port_normalize(torch.from_numpy(images))
        got = model(pi, torch.from_numpy(caps))
        gt, ga = model.generate(pi, 12)
    np.testing.assert_allclose(got["predictions"].numpy(),
                               np.asarray(out["predictions"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["alphas"].numpy(),
                               np.asarray(out["alphas"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(toks))
    np.testing.assert_allclose(ga.numpy(), np.asarray(alphas), rtol=1e-5,
                               atol=1e-6)


def test_masked_caption_ce():
    V = 5
    preds = torch.zeros((1, 3, V))
    caps = torch.tensor([[1, 2, 3, 0]])  # targets 2, 3, pad
    np.testing.assert_allclose(float(masked_caption_ce(preds, caps, 0)),
                               np.log(V), rtol=1e-5)
    rs = np.random.RandomState(1)
    p = rs.randn(3, 6, 11).astype(np.float32)
    c = rs.randint(0, 11, (3, 8))
    c[:, -3:] = 0
    np.testing.assert_allclose(
        float(masked_caption_ce(torch.from_numpy(p), torch.from_numpy(c), 0)),
        float(jax_train.masked_caption_ce(jnp.asarray(p), jnp.asarray(c), 0)),
        rtol=1e-6)


# ----------------------------------------------------------------------
# trainer
# ----------------------------------------------------------------------

def test_lr_decay_clamp_and_adam_match_optax():
    """The update the trainer takes: the element-wise clamp to +-5, Adam
    in optax's arithmetic and ``lr * 0.8 ** (count // 2)``, against the
    JAX trainer's ``optax.chain`` over six steps of gradients up to +-20
    (the clamp bites) on one tensor."""
    rs = np.random.RandomState(3)
    p0 = rs.randn(4, 5).astype(np.float32)
    sched = legacy_schedule(LR, 2, 0.8)

    def schedule(step):
        return LR * 0.8 ** (step // 2)

    assert [float(sched(c)) for c in range(6)] == pytest.approx(
        [float(np.float32(schedule(jnp.asarray(c)))) for c in range(6)],
        rel=1e-7)
    tx = optax.chain(optax.clip(5.0), optax.scale_by_adam(),
                     optax.scale_by_learning_rate(schedule))
    jp = jnp.asarray(p0)
    jstate = tx.init(jp)
    tp = torch.from_numpy(p0.copy())
    opt = AdamW({"w": tp}, sched, weight_decay=0.0)
    for _ in range(6):
        g = (rs.randn(4, 5) * 8).astype(np.float32)
        updates, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step({"w": torch.from_numpy(g).clamp(-5.0, 5.0)})
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)


def _assert_params_close(port, want, steps, what):
    adam = sum(LR * adam_step_bound(c) for c in range(1, steps + 1))
    for name, t in port.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5 + 2 * adam,
                                   err_msg=f"{what}: {name}")


def test_two_trainer_steps_match_the_jax_trainer(coco, tmp_path):
    """Two steps (batch 6, LR decayed after the first) from the same
    weights: ``ce`` and ``att_reg`` each step within 1e-5 relative, the
    BatchNorm statistics within 1e-5, the parameters as the module
    docstring states."""
    jt = _jax_trainer(coco, tmp_path / "jax", decay_every=1)
    pt = LegacyTrainer(coco[4], coco[5], coco[6], batch_size=6,
                       encoder_config=PORT_TINY_ENC, decay_every=1,
                       checkpoint_dir=str(tmp_path / "port"), device="cpu",
                       params=_variables(jt), dropout=0.0)
    rng = jax.random.PRNGKey(1)
    batches = list(jax_iterate(coco[2], 3, shuffle=True, seed=0))[:2]
    for b in batches:
        jt.state, jm = jt._train_step(jt.state, b["image"],
                                      b["caption_tokens"], None, rng)
        pm = pt.train_step(b["image"], b["caption_tokens"])
        for k in ("ce", "att_reg"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-8, err_msg=k)
    want = legacy_from_flax(_variables(jt))
    state = pt.state_tree()
    _assert_params_close(state["params"], want, 2, "two steps")
    for name, t in state["batch_stats"].items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert pt.step == 2 and pt.optimizer.count == 2
    assert float(pt.optimizer.schedule(1)) == pytest.approx(LR * 0.8)


def test_epoch_checkpoints_restore_bit_identical(coco, tmp_path):
    """``train()`` writes ``encoder_epoch_0``/``decoder_epoch_0`` and the
    ``_mid`` pair (decay_every 1); ``load_legacy_checkpoints`` restores
    the model bit for bit."""
    pt = LegacyTrainer(coco[4], coco[5], coco[6], batch_size=3,
                       num_epochs=1, decay_every=1,
                       encoder_config=PORT_TINY_ENC,
                       checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    pt.train()
    for name in ("encoder_epoch_0", "decoder_epoch_0", "encoder_epoch_0_mid",
                 "decoder_epoch_0_mid"):
        assert pt.ckpt.exists(name), name
    fresh = port_model.ShowAttendTell(len(coco[4]),
                                      encoder_config=PORT_TINY_ENC)
    load_legacy_checkpoints(fresh, str(tmp_path / "ck"), "encoder_epoch_0",
                            "decoder_epoch_0")
    want = pt.model.state_dict()
    for name, t in fresh.state_dict().items():
        assert torch.equal(t, want[name]), name


def test_dp2_step_matches_the_jax_dp2_step(coco, tmp_path):
    """One step of batch 6 at data parallelism 2: the port's two gloo
    ranks (3 rows each, BatchNorm over all 6) against the JAX trainer on
    a two-device mesh, ``ce`` within 1e-5 relative, ``att_reg`` within
    1e-5, the parameters and statistics as the single-process step."""
    from image_captioning_ml_project_tpu.data.pipeline import shard_batch
    from image_captioning_ml_project_tpu.parallel.mesh import create_mesh

    mesh = create_mesh(JaxMesh(data_parallel=2, model_parallel=1),
                       devices=jax.devices()[:2])
    jt = _jax_trainer(coco, tmp_path / "jax", mesh=mesh)
    variables = _variables(jt)
    b = next(iter(jax_iterate(coco[2], 6, shuffle=True, seed=0)))
    host = {"image": np.asarray(b["image"]),
            "caption_tokens": np.asarray(b["caption_tokens"])}
    sharded = shard_batch(host, mesh)
    jt.state, jm = jt._train_step(jt.state, sharded["image"],
                                  sharded["caption_tokens"], None,
                                  jax.random.PRNGKey(1))
    (res,) = run_ranks(tmp_path, [dict(
        kind="legacy_step", mesh=(2, 1), vocab=coco[4], batch=host,
        ckpt=str(tmp_path / "ranks"),
        kwargs=dict(encoder_config=PORT_TINY_ENC, params=variables,
                    dropout=0.0, batch_size=6))])
    for k in ("ce", "att_reg"):
        np.testing.assert_allclose(res["metrics"][k], float(jm[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)
    want = legacy_from_flax(_variables(jt))
    _assert_params_close(res["state"]["params"], want, 1, "dp2")
    for name, t in res["state"]["batch_stats"].items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# ----------------------------------------------------------------------
# validation, demo, tools
# ----------------------------------------------------------------------

def test_validate_matches_the_jax_validate(jax_and_port, coco):
    jt, pt = jax_and_port
    want = jax_validate.validate(jt.model, jt.state, coco[3], coco[1],
                                 batch_size=6, max_length=8)
    got = port_validate.validate(pt.model, coco[6], coco[4], batch_size=6,
                                 max_length=8)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for k in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_validate_pad_invariant(jax_and_port, coco):
    """Batch 4 over 6 images pads the trailing batch; loss and BLEU equal
    the evenly dividing batch 6's."""
    _, pt = jax_and_port
    even = port_validate.validate(pt.model, coco[6], coco[4], batch_size=6,
                                  max_length=8)
    padded = port_validate.validate(pt.model, coco[6], coco[4],
                                    batch_size=4, max_length=8)
    np.testing.assert_allclose(padded["loss"], even["loss"], rtol=1e-5)
    for k in ("Bleu_1", "Bleu_4"):
        np.testing.assert_allclose(padded[k], even[k], rtol=1e-6)


def test_demo_matches_the_jax_demo(jax_and_port, coco, tmp_path):
    from image_captioning_ml_project_tpu.legacy.demo import (
        generate_captions as jax_captions)
    from image_captioning_ml_project_tpu_torch.legacy.demo import (
        generate_captions)

    jt, pt = jax_and_port
    image_dir = os.path.join(coco[0], "val2014")
    want = jax_captions(jt.model, _variables(jt), coco[1], image_dir,
                        image_size=32, max_length=6)
    got = generate_captions(pt.model, coco[4], image_dir, image_size=32,
                            max_length=6,
                            save_attention_dir=str(tmp_path / "att"))
    assert got == want and len(got) == 6
    assert len(os.listdir(tmp_path / "att")) == 6


def test_strip_specials(coco):
    vocab = coco[4]
    ids = [vocab.bos_token_id, 5, 6, vocab.eos_token_id, 7]
    words = port_validate.strip_specials(np.asarray(ids), vocab)
    assert words == jax_validate.strip_specials(np.asarray(ids), coco[1])
    assert vocab.idx2word[5] in words and len(words) == 2


def test_process_data_tools(coco, tmp_path):
    from image_captioning_ml_project_tpu.legacy import (
        process_data as jax_process)
    from image_captioning_ml_project_tpu_torch.legacy import process_data
    from PIL import Image

    path = os.path.join(coco[0], "annotations/captions_train2014.json")
    assert process_data.build_vocab(path, threshold=1).word2idx \
        == jax_process.build_vocab(path, threshold=1).word2idx
    images = os.path.join(coco[0], "train2014")
    assert process_data.resize_images(images, str(tmp_path / "a"),
                                      size=24) == 6
    jax_process.resize_images(images, str(tmp_path / "b"), size=24)
    for name in sorted(os.listdir(tmp_path / "a")):
        a = np.asarray(Image.open(tmp_path / "a" / name))
        assert a.shape == (24, 24, 3)
        np.testing.assert_array_equal(
            a, np.asarray(Image.open(tmp_path / "b" / name)))
    vocab_path = str(tmp_path / "vocab.json")
    process_data.main(["--caption_path", path, "--vocab_path", vocab_path,
                       "--threshold", "1"])
    assert PortVocab.load(vocab_path).word2idx \
        == jax_process.build_vocab(path, threshold=1).word2idx


def _tiny_bert(words, hidden_size):
    import tempfile

    from transformers import BertConfig, BertModel, BertTokenizerFast

    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + sorted(words)
    d = tempfile.mkdtemp()
    vocab_file = os.path.join(d, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(tokens))
    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=len(tokens), hidden_size=hidden_size,
                     num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=32, max_position_embeddings=32)
    return BertModel(cfg), BertTokenizerFast(vocab_file=vocab_file,
                                             do_lower_case=True)


def test_bert_embedder_with_tiny_bert():
    from image_captioning_ml_project_tpu.legacy.bert_embedder import (
        BertCaptionEmbedder as JaxEmbedder)
    from image_captioning_ml_project_tpu_torch.legacy.bert_embedder import (
        BertCaptionEmbedder)

    model, tok = _tiny_bert(["a", "man", "rid", "##ing", "horse"], 16)
    emb = BertCaptionEmbedder(model=model, tokenizer=tok)
    out = emb.embed_batch(["a man riding a horse"], max_length=8)
    assert out.shape == (1, 8, 16)
    assert np.allclose(out[0, 0], 0) and not np.allclose(out[0, 1], 0)
    want = JaxEmbedder(model=model, tokenizer=tok).embed_batch(
        ["a man riding a horse"], max_length=8)
    np.testing.assert_array_equal(out, want)


def test_use_bert_train_and_validate(coco, tmp_path):
    """use_bert end to end on a seeded 768-wide one-layer BERT: the vocab
    table (specials zero, cached), one epoch of training on contextual
    embeddings, validation generating through the table, and
    ``generate`` without a table raising."""
    from image_captioning_ml_project_tpu_torch.legacy.bert_embedder import (
        BertCaptionEmbedder)

    vocab = coco[4]
    words = [w for w in vocab.word2idx
             if w not in ("<pad>", "<start>", "<end>", "<unk>")]
    embedder = BertCaptionEmbedder(*_tiny_bert(words, 768))
    table = embedder.vocab_table(vocab)
    assert table.shape == (len(vocab), 768)
    for sid in (vocab.pad_token_id, vocab.bos_token_id, vocab.eos_token_id,
                vocab.unk_token_id):
        assert np.allclose(table[sid], 0)
    assert embedder.vocab_table(vocab) is table
    trainer = LegacyTrainer(vocab, coco[5], coco[6], batch_size=6,
                            num_epochs=1, use_bert=True,
                            encoder_config=PORT_TINY_ENC, device="cpu",
                            checkpoint_dir=str(tmp_path / "ck"))
    trainer.train(bert_embedder=embedder)
    assert trainer.step == len(coco[5]) // 6
    metrics = port_validate.validate(trainer.model, coco[6], vocab,
                                     batch_size=4, max_length=8,
                                     bert_embedder=embedder)
    for k in ("loss", "Bleu_1", "Bleu_4"):
        assert np.isfinite(metrics[k])
    with pytest.raises(ValueError, match="embedding_table"):
        trainer.model.generate(torch.zeros((1, 32, 32, 3)), 4)


def test_legacy_train_and_validate_cli(coco, tmp_path):
    """``python -m ...legacy.train --device cpu`` (the default ResNet-50
    encoder, 32-pixel images, one epoch) writes the epoch checkpoints;
    the validate CLI scores them and the demo CLI captions a directory
    with them."""
    from image_captioning_ml_project_tpu_torch.legacy import demo
    from image_captioning_ml_project_tpu_torch.legacy import train

    root = coco[0]
    vocab_path = str(tmp_path / "vocab.json")
    coco[4].save(vocab_path)
    ckpt = str(tmp_path / "ckpt")
    train.main(["--data_root", root, "--vocab", vocab_path,
                "--batch_size", "6", "--num_epochs", "1", "--image_size",
                "32", "--max_length", "12", "--checkpoint_dir", ckpt,
                "--device", "cpu"])
    assert os.path.isdir(os.path.join(ckpt, "encoder_epoch_0"))
    metrics = port_validate.main([
        "--data_root", root, "--vocab", vocab_path, "--batch_size", "6",
        "--image_size", "32", "--max_length", "8", "--checkpoint_dir", ckpt,
        "--device", "cpu"])
    assert metrics["loss"] > 0 and 0.0 <= metrics["Bleu_4"] <= 1.0
    captions = demo.main(["--vocab", vocab_path, "--image_dir",
                          os.path.join(root, "val2014"), "--image_size",
                          "32", "--checkpoint_dir", ckpt, "--device", "cpu"])
    assert len(captions) == 6


def test_resize_token_embeddings():
    """On a small table, then on a tiny HF GPT-2 converted by each
    package's ``hf_port.port_gpt2``: the resized tables equal the JAX
    package's, and the rest of the state is left as it was."""
    from transformers import GPT2Config, GPT2LMHeadModel

    from image_captioning_ml_project_tpu.models.hf_port import (
        port_gpt2 as jax_port_gpt2, resize_token_embeddings as jax_resize)
    from image_captioning_ml_project_tpu_torch.models.hf_port import (
        port_gpt2)
    from image_captioning_ml_project_tpu_torch.params import (
        resize_token_embeddings)

    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    key = "decoder.backbone.wte.weight"
    for n in (6, 2, 4):
        got = resize_token_embeddings({key: torch.from_numpy(table)}, n)[key]
        want = jax_resize({"wte": {"embedding": table}}, n)["wte"][
            "embedding"]
        assert got.shape == (n, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    torch.manual_seed(0)
    sd = GPT2LMHeadModel(GPT2Config(vocab_size=29, n_positions=16, n_embd=8,
                                    n_layer=1, n_head=2)).state_dict()
    ported = port_gpt2(sd, 1)
    jax_ported = jax_port_gpt2({k: v.numpy() for k, v in sd.items()},
                               num_layers=1)["params"]
    for n in (33, 20, 29):
        got = resize_token_embeddings(ported, n, seed=3)
        want = jax_resize(jax_ported, n, seed=3)["wte"]["embedding"]
        assert got[key].shape == (n, 8)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want))
        assert all(got[k] is v for k, v in ported.items() if k != key)
