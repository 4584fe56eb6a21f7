"""The benchmark's general part: it reads ``BENCHMARK.json``, finds a cell's
files by name, sets up, measures the window, reads the trace and prints the
result line. What belongs to one configuration, traffic mix or metric lives in
the files named below; nothing here names one.

- ``benchmark/cells/<cell>.json``: ``config``, ``driver``, ``params``, ``why``.
- ``benchmark/configs/<config>.json``: the configuration as it is run.
- ``benchmark/drivers/<driver>.py``: ``setup(ctx) -> state``, ``unit(ctx, state)
  -> (attempted, failed)`` (one unit of work; the harness synchronises after
  it), and ``check(ctx, state, control) -> ([Check], control readings or
  None)`` after the window; optionally ``traced(ctx, state) -> dict`` (what
  the readers take from the driver), ``min_units(ctx)`` (the fewest units a
  window holds) and ``COUNT_SYNCS`` (count host syncs in a traced run).
- ``benchmark/metrics/<metric>.py``: ``read(rec) -> float | None``.

A traced run (``--trace 1``) times the spans the driver hooked with CUDA
events in the window's first unit, counts host syncs in the second where the
driver asks for it, and profiles the third (the traced window) with
``torch.profiler``, counting the models' FLOPs in it; its result line carries
the per-layer metrics and not the end-to-end ones. An end-to-end metric is
named for its quantity (``setup_s``, ``images_per_s``, ``peak_mem_gib``),
after a prefix where a quantity is split by cell.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "followmyhold_tpu")
GIB = float(2 ** 30)


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit (value <= limit
    is correct; a number that is not finite is not)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Context:
    """What a driver gets: the run's arguments, its cell and configuration,
    its device and a scratch directory under TMPDIR, and the probe."""

    name: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    device: Any
    tmpdir: str
    probe: Any


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_file_module(path: Path, name: str):
    """A module from its file (names of cells and metrics may hold dots)."""
    if not path.exists():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "cells" / f"{name}.json"


def config_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "configs" / f"{name}.json"


def driver_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "drivers" / f"{name}.py"


def metric_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "metrics" / f"{name}.py"


def find_workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(spec: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) this cell reports; a per-layer
    metric only where its cell reports the end-to-end metric it moves."""
    e2e = [m for m in spec["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, cell) and m["moves"] in names]
    return e2e, layer


def loaded_forbidden() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if getattr(device, "type", "") == "cuda":
        torch.cuda.synchronize(device)


def run_cell(args, t0: float, device=None, root: Path = ROOT,
             config_override: Optional[dict] = None, cell_override: Optional[dict] = None,
             emit: Callable[[str], None] = None, control: bool = False) -> int:
    """One run of one cell. ``device`` (tests only) skips the look for a chip
    and runs where it says; the overrides (tests only) replace the cell's or
    the configuration's entries; ``control`` (the control's test) adds the
    control's readings of each compared number to the line, under
    ``control``. Returns the exit code."""
    emit = emit or (lambda line: print(line, flush=True))
    spec = load_spec(root)
    workload = find_workload(spec, args.workload)
    cell = load_json(cell_path(args.workload, root))
    if cell_override:
        cell = {**cell, **cell_override}
    config = load_json(config_path(workload["config"], root))
    if config_override:
        config = {**config, **config_override}
    e2e, layer = cell_metrics(spec, args.workload)

    import torch

    if device is None:
        chips = int(workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            say(f"no result: the cell asks for {chips} CUDA device(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
    torch.set_num_threads(min(4, torch.get_num_threads()))

    from benchmark.probe import Probe

    driver = load_file_module(driver_path(cell["driver"], root), f"bench_driver_{cell['driver']}")
    tmpdir = tempfile.mkdtemp(prefix="bench_")
    try:
        ctx = Context(name=args.workload, seed=int(args.seed), seconds=float(args.seconds),
                      trace=bool(args.trace), cell=cell, config=config, device=device,
                      tmpdir=tmpdir, probe=Probe(device))
        state = driver.setup(ctx)
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t0
        say(f"{args.workload}: set-up {setup_s:.3f} s")

        attempted = failed = 0
        units = []
        need = max(3 if ctx.trace else 1,
                   driver.min_units(ctx) if hasattr(driver, "min_units") else 1)
        start = time.perf_counter()
        while True:
            k = len(units)
            u0 = time.perf_counter()
            if ctx.trace and k == 0:
                with ctx.probe.timing_spans():
                    a, f = driver.unit(ctx, state)
                    _sync(device)
            elif ctx.trace and k == 2:
                with ctx.probe.traced():
                    a, f = driver.unit(ctx, state)
                    _sync(device)
            elif ctx.trace and k == 1 and getattr(driver, "COUNT_SYNCS", False):
                with ctx.probe.counting_syncs():
                    a, f = driver.unit(ctx, state)
                    _sync(device)
            else:
                a, f = driver.unit(ctx, state)
                _sync(device)
            u1 = time.perf_counter()
            units.append(u1 - u0)
            attempted, failed = attempted + a, failed + f
            if u1 - start >= ctx.seconds and len(units) >= need:
                break
        window_s = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        say(f"{args.workload}: {len(units)} units in {window_s:.3f} s "
            f"({', '.join(f'{x:.3f}' for x in units)}), {attempted} attempted, {failed} failed")

        metrics: Dict[str, dict] = {}
        breakdown = None
        device_info = dict(platform="gpu" if device.type == "cuda" else device.type,
                           kind=torch.cuda.get_device_name(device) if device.type == "cuda"
                           else "cpu",
                           count=int(workload["chips"]), memory_peak_bytes=int(peak))
        if ctx.trace:
            rec: Dict[str, Any] = ctx.probe.record()
            rec["units_s"] = units
            if hasattr(driver, "traced"):
                rec["driver"] = driver.traced(ctx, state)
            for m in layer:
                reader = load_file_module(metric_path(m["name"], root),
                                          "bench_metric_" + m["name"].replace(".", "_"))
                value = reader.read(rec)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            device_info["busy_s"] = rec["busy_s"]
            device_info["window_s"] = rec["window_s"]
            breakdown = rec.get("breakdown")
        else:
            values = {"setup_s": setup_s,
                      "images_per_s": (attempted - failed) / window_s,
                      "peak_mem_gib": peak / GIB}
            for m in e2e:          # a metric is named for its quantity, after any prefix
                quantity = m["name"].split(".")[-1]
                if quantity in values:
                    metrics[m["name"]] = {"value": values[quantity], "unit": m["unit"]}

        ctx.probe.close()
        c0 = time.perf_counter()
        checks, control_values = driver.check(ctx, state, control=control)
        say(f"{args.workload}: check {time.perf_counter() - c0:.3f} s")
        del state
        correct = bool(checks) and all(c.ok for c in checks) and failed == 0
        found = loaded_forbidden()
        if found:
            say(f"no result: the run loaded {found}")
            return 4
        result = {"correct": correct, "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": device_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        if control_values is not None:
            result["control"] = control_values
            for name, value in control_values.items():
                say(f"control {name}: {value!r}")
        result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
        for c in checks:
            say(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}")
        emit(json.dumps(result))
        return 0
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
