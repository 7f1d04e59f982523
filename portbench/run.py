"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: its configuration file (the
``file`` of its ``configs`` entry) and plain reference
(``portbench/reference/<config>.py``), its traffic file
(``portbench/traffic/<traffic>.json``), its configuration's module
(``portbench/configs/<config>.py``: where the program keeps each size,
the work it counts, where its conditioning sits), and one reader per
metric (``portbench/metrics/<metric>.py``, which may name the program
function it wraps in the traced run). With ``--trace 0`` the result line
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
ones. The last line of standard output is the result; the numbers that
decide ``correct`` close standard error and the result's line.

It runs the program (``image_captioning_ml_project_tpu_torch``) on the
card and nothing else: it exits 2 without a result where CUDA is missing
or the card count is short, and 3 where a module of JAX, flax or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "image_captioning_ml_project_tpu")


def _env():
    """Caches at fixed paths inside the checkout; no library may pull in
    JAX or flax on its own."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (the port's own name only begins with the
    last)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    """The cell named ``name``, with its configuration's file and traffic
    file read, and the metrics it reports at each trace level."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return {"cell": w, "cfg": load_json(os.path.join(ROOT, conf["file"])),
            "traffic": load_json(os.path.join(BENCH, "traffic",
                                              w["traffic"] + ".json")),
            "end_to_end": e2e, "per_layer": layer}


def reader_module(metric: str):
    """The reader of ``metric``: ``portbench/metrics/<name>.py`` for the
    whole name or, where there is none, for the longest name it begins
    with, cut at a dot (``metrics/__init__.py``)."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        name = ".".join(parts[:n])
        path = os.path.join(BENCH, "metrics", name + ".py")
        if os.path.exists(path):
            break
    else:
        raise FileNotFoundError(f"no reader for the metric {metric!r} in "
                                f"portbench/metrics")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    return reader_module(metric).read


def device_info(torch, count: int) -> dict:
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable: {e}"
    log(f"device: {name}; nvidia-smi: {smi}")
    return {"platform": "gpu", "kind": name, "count": count}


def measure(spec: dict, seed: int, seconds: float, traced: bool, device,
            t_process: float):
    """Run the cell (``portbench/serve.py`` or ``portbench/train.py``, as
    its traffic file's kind says); returns its context for the readers
    and the check."""
    kind = spec["traffic"]["kind"]
    runner = importlib.import_module(f"portbench.{kind}").run
    probes = [reader_module(m["name"]) for m in spec["per_layer"]] \
        if traced else []
    return runner(spec["cfg"], spec["traffic"], seed, seconds, traced,
                  device, t_process, log,
                  probes=[p for p in probes if hasattr(p, "WRAPS")])


def judge(ctx: dict, device) -> dict:
    """The compared numbers beside their limits; what is read beside them
    and not compared goes to standard error."""
    from portbench import check

    if ctx["kind"] == "train":
        values = importlib.import_module("portbench.train").compared(
            ctx, device)
    else:
        s = ctx["sample"]
        values = {}
        if s["images"] is not None:
            values = check.numbers(ctx["cfg"], ctx["state"], s["images"],
                                   s["served"], device)
            values.update(check.condition_gaps(
                ctx["cfg"], ctx["state"], s["condition_images"],
                s["condition"], device))
    limits = ctx["cfg"]["correct"][ctx["kind"]]
    shown = dict(values.get("diagnostic", {}))
    shown.update({k: v for k, v in values.items()
                  if k != "diagnostic" and k not in limits})
    for k, v in shown.items():
        log(f"not compared: {k} {v!r}")
    return check.judge(values, limits)


def result(spec: dict, ctx: dict, traced: bool, device_entry: dict,
           compared: dict) -> dict:
    from portbench import trace

    if traced and ctx.get("prof", {}).get("events") is not None:
        ctx["events"] = ctx["prof"]["events"]
        ctx["trace"] = trace.read(ctx["events"])
    metrics = {}
    for m in (spec["per_layer"] if traced else spec["end_to_end"]):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(device_entry, memory_peak_bytes=ctx["memory_peak_bytes"])
    out = {"correct": bool(compared) and all(c["ok"]
                                             for c in compared.values())
           and ctx["failed"] == 0,
           "attempted": ctx["attempted"], "failed": ctx["failed"],
           "metrics": metrics, "device": dev}
    if traced and "trace" in ctx:
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["trace_window_s"]
        out["breakdown"] = trace.breakdown(ctx["trace"])
    out["compared"] = {k: {"value": v["value"], "limit": v["limit"]}
                       for k, v in compared.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    if not os.path.exists(os.path.join(ROOT, "image_captioning_ml_project_"
                                             "tpu_torch")):
        log("the program (image_captioning_ml_project_tpu_torch) is not in "
            "this checkout")
        return 2
    sys.path.insert(0, ROOT)
    spec = cell_of(load_json(os.path.join(ROOT, "BENCHMARK.json")),
                   args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    entry = device_info(torch, chips)
    log(f"set-up: torch and the card ready "
        f"{time.perf_counter() - T_PROCESS:.3f} s after the process")
    seed = args.seed % (2 ** 63)
    ctx = measure(spec, seed, args.seconds, bool(args.trace), device,
                  T_PROCESS)
    t0 = time.perf_counter()
    compared = judge(ctx, device)
    log(f"check: {time.perf_counter() - t0:.3f} s after the window")
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {bad}")
        return 3
    out = result(spec, ctx, bool(args.trace), entry, compared)
    log(f"attempted {out['attempted']}, failed {out['failed']}")
    for name, c in compared.items():
        log(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
