"""The port imports no JAX: in a fresh interpreter, importing every module
of ``image_captioning_ml_project_tpu_torch`` (the trainer, its losses,
optimizer, checkpoints, data and metrics, and ``models/swin.py``
included) and building and running a tiny model of each built-in
configuration and of Swin, and a training step, an SCST
update and a checkpoint of each, then the eval path's host modules (the
BPE tokenizer, the curriculum sampler, the native JPEG loader,
``coco_eval`` through ``main.evaluate``, and ``main.demo``), leaves ``jax``, ``flax``, ``optax``, ``orbax``,
``triton`` and the JAX package ``image_captioning_ml_project_tpu`` out of
``sys.modules`` (and converting an HF-layout GPT-2 through
``models/hf_port.py`` imports none of them, nor transformers); no
source of the port names ``triton`` in an import (its kernels are CUDA C++
built with nvcc). And
``chip_smoke.py`` refuses to run, printing no result, without a GPU or
without the port beside it."""

import os
import shutil
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import pkgutil, sys, importlib, os
import torch
import image_captioning_ml_project_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from image_captioning_ml_project_tpu_torch.main import CONFIGS
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
def swin_config():
    c = CONFIGS["transformer"]()
    c.model.encoder.encoder_type = EncoderType.SWIN
    return c


def inputs(c, n):
    if c.model.encoder.encoder_type != EncoderType.OBJECT_REGION:
        return torch.zeros(n, 64, 64, 3, dtype=torch.uint8)
    return {"region_features": torch.zeros(n, 36, 16),
            "region_boxes": torch.zeros(n, 36, 4),
            "region_mask": torch.ones(n, 36, dtype=torch.bool)}


from image_captioning_ml_project_tpu_torch.config import EncoderType
# an image configuration last: the eval path below runs it
for make in [CONFIGS[k] for k in sorted(CONFIGS)] + [swin_config]:
    c = make()
    e, d = c.model.encoder, c.model.decoder
    e.hidden_size = e.feature_dim = d.hidden_dim = 32
    c.model.attention.hidden_dim = c.model.projection_dim = 32
    e.resnet_depths, e.resnet_hidden_sizes = (1,), (32,)
    e.resnet_embedding_size = 8
    e.swin_embed_dim, e.swin_depths, e.swin_num_heads = 8, (1, 1), (1, 2)
    e.region_feature_dim = 16
    e.num_layers = d.num_layers = 1
    e.num_heads = d.num_heads = c.model.q_former_num_heads = 2
    c.image_size, c.model.vocab_size, c.model.dtype = 64, 100, "float32"
    model = load_model(c, "cpu")
    with torch.inference_mode():
        state = model.init_cache(inputs(c, 1), 4)
        model.step(state, torch.ones(1, dtype=torch.long))
    # and one training step of each, checkpointed
    import tempfile
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)
    c.training.use_rl, c.training.batch_size = False, 2
    c.output_dir = c.checkpoint_dir = tempfile.mkdtemp()
    t = CaptioningTrainer(c, [None] * 2, [], None, device="cpu")
    t.train_step(inputs(c, 2),
                 torch.ones(2, 5, dtype=torch.long),
                 torch.ones(2, 5, dtype=torch.long))
    t.rl_update_step(inputs(c, 2),
                     torch.ones(2, 5, dtype=torch.long),
                     torch.ones(2, 5, dtype=torch.bool), torch.ones(2))
    t.save_checkpoint(0)
    t.ckpt.wait_until_finished()
# the eval path's host modules: the BPE tokenizer, the curriculum sampler,
# the native JPEG loader under the dataset, and main.evaluate and
# main.demo (coco_eval's results.json) on the last configuration
import json
from image_captioning_ml_project_tpu_torch import main as port_main
from image_captioning_ml_project_tpu_torch.data import GPT2BPETokenizer
from image_captioning_ml_project_tpu_torch.data.bpe import bytes_to_unicode
from image_captioning_ml_project_tpu_torch.data.synthetic import (
    make_synthetic_coco)
from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab
from image_captioning_ml_project_tpu_torch.train.curriculum import (
    CurriculumSampler)
d = tempfile.mkdtemp()
units = [bytes_to_unicode()[b] for b in range(256)] + ["<|endoftext|>"]
with open(d + "/vocab.json", "w") as f:
    json.dump({u: i for i, u in enumerate(units)}, f)
with open(d + "/merges.txt", "w") as f:
    f.write("#version: 0.2\\n")
bpe = GPT2BPETokenizer(d + "/vocab.json", d + "/merges.txt")
assert bpe.decode(bpe.encode("a cat", 8)[0]) == "a cat"
root = make_synthetic_coco(d + "/coco", num_images=3, captions_per_image=2,
                           image_size=64, image_format="jpg")
with open(root + "/annotations/captions_train2014.json") as f:
    vocab = WordVocab.build([a["caption"] for a in json.load(f)[
        "annotations"]], threshold=1)
c.data_root, c.native_loader, c.training.use_curriculum = root, True, True
c.model.vocab_size = len(vocab)
c.model.pad_token_id, c.model.bos_token_id, c.model.eos_token_id = (
    vocab.pad_token_id, vocab.bos_token_id, vocab.eos_token_id)
c.inference.max_length = 4
port_main.evaluate(c, tokenizer=vocab, device="cpu")
with open(c.output_dir + "/results.json") as f:
    assert len(json.load(f)) == 3
port_main.demo(c, image_path=root + "/val2014/" + sorted(
    os.listdir(root + "/val2014"))[0], tokenizer=vocab, device="cpu")
assert sorted(CurriculumSampler(list(range(10)), warmup_epochs=0)) == list(
    range(10))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "triton",
                                    "image_captioning_ml_project_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def _env():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PYTHONSTARTUP", None)
    return env


def test_port_never_imports_jax_or_flax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_no_triton():
    """Imports inside functions included: where Triton is not installed,
    the probe above would not see a lazy one."""
    import re

    port = os.path.join(REPO, "image_captioning_ml_project_tpu_torch")
    pattern = re.compile(r"^\s*(import|from)\s+triton\b", re.M)
    sources = [os.path.join(d, f) for d, _, files in os.walk(port)
               for f in files if f.endswith(".py")]
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    found = []
    for path in sources:
        with open(path) as f:
            if pattern.search(f.read()):
                found.append(os.path.relpath(path, REPO))
    assert len(sources) > 20 and found == []


def test_chip_smoke_fails_without_a_gpu_or_the_port(tmp_path):
    if torch.cuda.is_available():
        return  # the refusal paths need a machine without a card
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert proc.stdout == ""


_PROBE_MESH = """
import importlib, pkgutil, sys, tempfile
import torch
import image_captioning_ml_project_tpu_torch.legacy as legacy
import image_captioning_ml_project_tpu_torch.parallel as parallel
for pkg in (legacy, parallel):
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
from image_captioning_ml_project_tpu_torch.config import EncoderConfig
from image_captioning_ml_project_tpu_torch.data.tokenizer import WordVocab
from image_captioning_ml_project_tpu_torch.legacy.train import LegacyTrainer
from image_captioning_ml_project_tpu_torch.parallel.mesh import (
    create_mesh, init_distributed)
d = tempfile.mkdtemp()
init_distributed(rank=0, world_size=1, init_method="file://" + d + "/store",
                 timeout_s=60)
mesh = create_mesh()
assert mesh.shape == {"data": 1, "model": 1}
vocab = WordVocab.build(["a cat on a mat"], threshold=1)
t = LegacyTrainer(vocab, None, mesh=mesh, device="cpu", checkpoint_dir=d,
                  encoder_config=EncoderConfig(
                      resnet_embedding_size=8, resnet_hidden_sizes=(8, 16),
                      resnet_depths=(1, 1)))
m = t.train_step(torch.zeros(2, 32, 32, 3, dtype=torch.uint8),
                 torch.ones(2, 5, dtype=torch.long))
assert torch.isfinite(m["ce"])
torch.distributed.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "image_captioning_ml_project_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_parallel_and_legacy_import_no_jax():
    """``parallel/`` and ``legacy/`` alone, in a fresh interpreter: every
    module imported, a one-rank mesh built over gloo and a legacy step
    taken on it, and nothing of JAX or the JAX package in
    ``sys.modules``."""
    proc = subprocess.run([sys.executable, "-c", _PROBE_MESH], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_PROBE_HF = """
import sys
import torch
from image_captioning_ml_project_tpu_torch.models import hf_port
from image_captioning_ml_project_tpu_torch.params import scorer_from_hf
H = 8
sd = {"transformer.wte.weight": torch.ones(10, H),
      "transformer.wpe.weight": torch.ones(4, H)}
for n, shape in (("ln_1", (H,)), ("ln_2", (H,)), ("attn.c_attn", (H, 3 * H)),
                 ("attn.c_proj", (H, H)), ("mlp.c_fc", (H, 4 * H)),
                 ("mlp.c_proj", (4 * H, H))):
    sd[f"transformer.h.0.{n}.weight"] = torch.ones(shape)
    sd[f"transformer.h.0.{n}.bias"] = torch.ones(shape[-1])
sd["transformer.ln_f.weight"] = sd["transformer.ln_f.bias"] = torch.ones(H)
sd["lm_head.weight"] = sd["transformer.wte.weight"]
out = hf_port.port_gpt2(sd, 1)
assert out["decoder.backbone.blocks.0.attn.c_attn.weight"].shape == (3 * H, H)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "transformers",
                                    "image_captioning_ml_project_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_hf_port_imports_no_jax():
    """``models/hf_port.py`` and ``params`` alone, in a fresh interpreter:
    a GPT-2 in HF's layout converted, and nothing of JAX, flax,
    transformers or the JAX package in ``sys.modules``."""
    proc = subprocess.run([sys.executable, "-c", _PROBE_HF], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
