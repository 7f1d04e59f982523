"""The port imports no JAX: in a fresh interpreter, importing every module
of ``image_captioning_ml_project_tpu_torch`` (the trainer, its losses,
optimizer, checkpoints, data and metrics included) and building and
running a tiny model of each ported family, and a training step, an SCST
update and a checkpoint of each, leaves ``jax``, ``flax``, ``optax``, ``orbax``,
``triton`` and the JAX package ``image_captioning_ml_project_tpu`` out of
``sys.modules``; no
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
import pkgutil, sys, importlib
import torch
import image_captioning_ml_project_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from image_captioning_ml_project_tpu_torch.main import CONFIGS
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
for make in CONFIGS.values():
    c = make()
    e, d = c.model.encoder, c.model.decoder
    e.hidden_size = e.feature_dim = d.hidden_dim = 32
    c.model.attention.hidden_dim = 32
    e.resnet_depths, e.resnet_hidden_sizes = (1,), (32,)
    e.resnet_embedding_size = 8
    e.num_layers = d.num_layers = 1
    e.num_heads = d.num_heads = 2
    c.image_size, c.model.vocab_size, c.model.dtype = 64, 100, "float32"
    model = load_model(c, "cpu")
    with torch.inference_mode():
        state = model.init_cache(torch.zeros(1, 64, 64, 3,
                                             dtype=torch.uint8), 4)
        model.step(state, torch.ones(1, dtype=torch.long))
    # and one training step of each, checkpointed
    import tempfile
    from image_captioning_ml_project_tpu_torch.train.trainer import (
        CaptioningTrainer)
    c.training.use_rl, c.training.batch_size = False, 2
    c.output_dir = c.checkpoint_dir = tempfile.mkdtemp()
    t = CaptioningTrainer(c, [None] * 2, [], None, device="cpu")
    t.train_step(torch.zeros(2, 64, 64, 3, dtype=torch.uint8),
                 torch.ones(2, 5, dtype=torch.long),
                 torch.ones(2, 5, dtype=torch.long))
    t.rl_update_step(torch.zeros(2, 64, 64, 3, dtype=torch.uint8),
                     torch.ones(2, 5, dtype=torch.long),
                     torch.ones(2, 5, dtype=torch.bool), torch.ones(2))
    t.save_checkpoint(0)
    t.ckpt.wait_until_finished()
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
