"""The port imports no JAX: in a fresh interpreter, importing every module
of ``image_captioning_ml_project_tpu_torch`` and building and running a
tiny model leaves ``jax``, ``flax`` and the JAX package
``image_captioning_ml_project_tpu`` out of ``sys.modules``. And
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
from image_captioning_ml_project_tpu_torch.main import flagship_config
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
c = flagship_config()
e, d = c.model.encoder, c.model.decoder
e.hidden_size = e.feature_dim = d.hidden_dim = 32
e.num_layers = d.num_layers = 1
e.num_heads = d.num_heads = 2
c.image_size, c.model.vocab_size, c.model.dtype = 64, 100, "float32"
model = load_model(c, "cpu")
with torch.inference_mode():
    state = model.init_cache(torch.zeros(1, 64, 64, 3, dtype=torch.uint8), 4)
    model.step(state, torch.ones(1, dtype=torch.long))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
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
