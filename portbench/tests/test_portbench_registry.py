"""Cells, configurations, traffic and metrics are found by name, and
``BENCHMARK.json`` keeps to the benchmark's contract."""

import importlib
import json
import os
import re

import pytest

from conftest import ROOT
from portbench import flops, run, system

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"][1].startswith("portbench/")
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_keys(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and c["source"].startswith("http")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        layers.add(m["layer"])
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert "setup_s" in e2e


def test_every_cell_reports_setup_another_e2e_and_a_layer(bench):
    for w in bench["workloads"]:
        spec = run.cell_of(bench, w["name"])
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in e2e


def test_everything_is_found_by_name(bench):
    for w in bench["workloads"]:
        spec = run.cell_of(bench, w["name"])
        assert spec["cfg"]["name"] == w["config"]
        assert spec["traffic"]["kind"] in ("serve", "train")
        importlib.import_module(f"portbench.{spec['traffic']['kind']}")
        importlib.import_module(f"portbench.reference.{w['config']}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_traffic_files_are_data(bench):
    folder = os.path.join(ROOT, "portbench", "traffic")
    for name in os.listdir(folder):
        assert name.endswith(".json")
        with open(os.path.join(folder, name)) as f:
            json.load(f)


def test_a_metric_is_read_by_the_longest_name_it_begins_with(bench):
    idle = run.reader_module("device_idle")
    for name in ("device_idle.serve", "device_idle.serve_poisson",
                 "device_idle.train", "device_idle.serve.transformer"):
        assert run.reader_module(name).__file__ == idle.__file__
    assert run.reader_module("mfu.serve.transformer").__file__ == \
        run.reader_module("mfu.serve").__file__
    with pytest.raises(FileNotFoundError):
        run.reader_module("no_such_metric.serve")
    ctx = {"trace": {"busy_s": 3.0, "trace_window_s": 4.0}}
    assert run.reader("device_idle.train")(ctx) == pytest.approx(25.0)


def test_roofline_readers_name_what_they_wrap(bench):
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline"):
            mod = run.reader_module(m["name"])
            owner = importlib.import_module(mod.WRAPS[0])
            assert callable(getattr(owner, mod.WRAPS[1]))
            assert callable(mod.shapes) and callable(mod.work)


@pytest.mark.parametrize("name", ["flagship", "transformer"])
def test_each_configuration_has_its_module(bench, name):
    cfg = run.load_json(os.path.join(ROOT, "portbench", "configs",
                                     name + ".json"))
    m = flops.config_module(cfg)
    for fn in ("vision_ops", "condition_ops", "step_ops",
               "program_condition"):
        assert callable(getattr(m, fn))
    assert system.port_config(cfg) is not None
    first = next(iter(m.PROGRAM.values())).split(".")
    cfg[first[0]][first[1]] += 1
    with pytest.raises(ValueError, match="differs from the file"):
        system.port_config(cfg)
