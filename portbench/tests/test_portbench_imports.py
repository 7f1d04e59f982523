"""Nothing the harness or the reference loads is JAX, flax or the JAX
package (top-level names compared whole), and the reference loads nothing
of the program."""

import json
import os
import subprocess
import sys

from conftest import ROOT
from portbench import run

PORT = "image_captioning_ml_project_tpu_torch"


def test_forbidden_names_are_compared_whole():
    mods = {"jax": 1, "jax.numpy": 1, "flax.linen": 1, "numpy": 1,
            PORT: 1, PORT + ".ops": 1, "jaxtyping": 1,
            "image_captioning_ml_project_tpu.models": 1}
    assert run.forbidden_modules(mods) == [
        "flax", "image_captioning_ml_project_tpu", "jax"]
    assert run.forbidden_modules({PORT: 1, PORT + ".main": 1}) == []


def _loaded(code: str):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = _loaded(
        "import portbench.run, portbench.serve, portbench.train, "
        "portbench.check, portbench.control, portbench.knee, "
        "portbench.system, portbench.trace, portbench.loadgen\n"
        "from portbench import system\n"
        "from image_captioning_ml_project_tpu_torch.main import CONFIGS\n"
        "from image_captioning_ml_project_tpu_torch.inference import server\n"
        "from image_captioning_ml_project_tpu_torch.train import trainer\n"
        "for n in ('flagship', 'transformer'):\n"
        "    system.port_config(portbench.run.load_json("
        "f'portbench/configs/{n}.json'))\n")
    assert not top & {"jax", "jaxlib", "flax",
                      "image_captioning_ml_project_tpu"}
    assert PORT in top


def test_reference_loads_nothing_of_the_program():
    top = _loaded("import portbench.reference.common, "
                  "portbench.reference.flagship, "
                  "portbench.reference.transformer")
    assert not top & {"jax", "jaxlib", "flax",
                      "image_captioning_ml_project_tpu", PORT}


def test_reference_sources_import_only_torch_numpy_and_each_other():
    ref = os.path.join(ROOT, "portbench", "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            for line in f:
                line = line.strip()
                if line.startswith(("import ", "from ")):
                    mod = line.split()[1]
                    assert mod.split(".")[0] in (
                        "torch", "numpy", "math", "typing", "__future__",
                        "") or mod.startswith("."), (name, line)
