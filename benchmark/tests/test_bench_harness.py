"""The benchmark's own tests. On the CPU: BENCHMARK.json against its contract,
every entry found by name (a new cell file too), the JAX check, and each
driver's whole run at a tiny size, unbroken and with each fault planted. On
the card (``chip``): the control's readings at each cell's own size.

    python3 -m pytest benchmark/tests -q                   # CPU; the chip tests skip
    python3 -m pytest benchmark/tests -q -m chip -s        # on the card
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _cells():
    return [w["name"] for w in _spec()["workloads"]]


def _run_script(code: str, timeout: int = 900) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)


def test_benchmark_json_keys():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) <= 64 * 1024


def test_names_units_and_lines():
    spec = _spec()
    entries = spec["configs"] + spec["workloads"] + spec["end_to_end"] + spec["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in spec["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in ([e["why"] for e in spec["configs"] + spec["workloads"]]
                 + [c["source"] for c in spec["configs"]] + spec["command"]
                 + [m["layer"] for m in spec["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for group in ("configs", "workloads"):
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_entry_found_by_name():
    from benchmark import harness

    spec = _spec()
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert ROOT / c["file"] == harness.config_path(c["name"])
        assert harness.load_json(harness.config_path(c["name"]))["name"] == c["name"]
    for w in spec["workloads"]:
        cell = harness.load_json(harness.cell_path(w["name"]))
        assert cell["config"] == w["config"] and w["config"] in configs
        assert cell["driver"] == w["traffic"]
        driver = harness.load_file_module(harness.driver_path(cell["driver"]), "d")
        assert all(hasattr(driver, f) for f in ("setup", "unit", "check"))
    for m in spec["per_layer"]:
        reader = harness.load_file_module(harness.metric_path(m["name"]), "m")
        assert callable(reader.read)
        assert reader.read({}) is None         # nothing to read: the metric is left out


def test_new_cell_file_is_found_without_code(tmp_path):
    """A cell is a file and an entry: the harness finds one added in a copy of
    the benchmark's data, with no change to its code."""
    from benchmark import harness

    shutil.copytree(ROOT / "benchmark" / "cells", tmp_path / "benchmark" / "cells")
    shutil.copytree(ROOT / "benchmark" / "configs", tmp_path / "benchmark" / "configs")
    spec = _spec()
    first = spec["workloads"][0]
    name = first["name"] + "-copy"
    new = dict(first, name=name, traffic=first["traffic"] + "-copy")
    spec["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_json(harness.cell_path(first["name"], tmp_path))
    harness.cell_path(name, tmp_path).write_text(json.dumps(cell))
    loaded = harness.load_spec(tmp_path)
    assert harness.find_workload(loaded, name)["config"] == new["config"]
    assert harness.load_json(harness.cell_path(name, tmp_path)) == cell
    e2e, layer = harness.cell_metrics(loaded, name)
    assert {m["name"] for m in e2e} >= {"setup_s"}
    assert all("workloads" not in m or name in m["workloads"] for m in layer)


def test_every_cell_reports_what_its_layers_move():
    from benchmark import harness

    spec = _spec()
    for cell in _cells():
        e2e, layer = harness.cell_metrics(spec, cell)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer, cell
        listed = [m for m in spec["per_layer"] if cell in m.get("workloads", [cell])]
        assert all(m["moves"] in names for m in listed), cell


def test_no_jax_and_a_reference_free_of_the_program():
    """Whole top-level names: the port's begins with the JAX package's."""
    forbidden = ("jax", "jaxlib", "flax", "followmyhold_tpu")
    out = _run_script(
        "import sys, glob, importlib; "
        "[importlib.import_module('benchmark.reference.' + p.split('/')[-1][:-3]) "
        " for p in sorted(glob.glob('benchmark/reference/*.py'))]; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & set(forbidden + ("followmyhold_tpu_torch",)), top
    out = _run_script(
        "import sys, glob; from benchmark import harness, probe; "
        "[harness.load_file_module(__import__('pathlib').Path(p), 'x%d' % i) "
        " for i, p in enumerate(sorted(glob.glob('benchmark/drivers/*.py') "
        "+ glob.glob('benchmark/metrics/*.py')))]; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0, out.stderr
    assert not set(eval(out.stdout.strip().splitlines()[-1])) & set(forbidden)


_TINY_RUN = """
import json, sys, time, argparse
import torch
torch.set_num_threads(2)
from benchmark import harness
from benchmark.tests import faults
from benchmark.tests.tiny import tiny_config
cell, fault = sys.argv[1], sys.argv[2]
spec = harness.load_spec()
w = harness.find_workload(spec, cell)
faults.plant(w["traffic"], fault)
lines = []
rc = harness.run_cell(argparse.Namespace(workload=cell, seed=2 ** 31 + 12345, seconds=0.1,
                                         trace=int(sys.argv[3])),
                      time.perf_counter(), device=torch.device("cpu"),
                      config_override=tiny_config(w["config"]), emit=lines.append)
print(json.dumps({"rc": rc, "line": lines[-1] if lines else None,
                  "forbidden": harness.loaded_forbidden()}))
"""


def _tiny(cell: str, fault: str = "none", trace: int = 0) -> dict:
    out = subprocess.run([sys.executable, "-c", _TINY_RUN, cell, fault, str(trace)], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0 and not got["forbidden"], got
    return json.loads(got["line"])


@pytest.mark.parametrize("cell", _cells())
@pytest.mark.parametrize("trace", [0, 1])
def test_driver_runs_at_a_tiny_size(cell, trace):
    from benchmark import harness

    line = _tiny(cell, trace=trace)
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    e2e, layer = harness.cell_metrics(_spec(), cell)
    want = {m["name"] for m in (layer if trace else e2e)}
    if trace:
        # the device readers need a card's trace: on the CPU only the others read
        assert set(line["metrics"]) <= want and {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == want


@pytest.mark.parametrize("cell,fault", [(c, f) for c in _cells()
                                        for f in ("state_unchanged", "half_batch",
                                                  "answer_altered")])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    line = _tiny(cell, fault)
    assert line["correct"] is False, line["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", _cells())
def test_control_fails_at_the_cells_size(chip, cell):
    """The reference in the precision below the configuration's, put in the
    program's place, fails a limit on every seed, and the program passes."""
    import argparse
    import time

    from benchmark import harness

    for seed in (2 ** 31 + 7, 2 ** 31 + 11, 2 ** 31 + 13):
        lines = []
        rc = harness.run_cell(argparse.Namespace(workload=cell, seed=seed, seconds=1.0,
                                                 trace=0),
                              time.perf_counter(), emit=lines.append, control=True)
        assert rc == 0
        line = json.loads(lines[-1])
        print(cell, seed, json.dumps({"checks": line["checks"], "control": line["control"]}))
        assert line["correct"] is True
        assert any(line["control"][k] > c["limit"] for k, c in line["checks"].items())
