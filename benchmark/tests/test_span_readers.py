"""The readers of the program's own spans (``benchmark/metrics/flux.step_span_ms.py``,
``flux.host_bound_pct.py``, ``inpaint.outside_steps_ms.py``) on synthetic
records: None where the program records nothing or has no span layer; only
the calls after the warm-up and before the first profiled one read; the
medians and the share; and a tiny traced run that reports all three.

    python3 -m pytest benchmark/tests/test_span_readers.py -q
"""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.test_bench_harness import _tiny

READERS = {"flux.step_span_ms": "ms", "flux.host_bound_pct": "%",
           "inpaint.outside_steps_ms": "ms"}
MS = 1_000_000


def _reader(name: str):
    return harness.load_file_module(harness.metric_path(name), "test_" + name.replace(".", "_"))


def _call(profiling, call_id: int, t0: int, leads, step_ms: float, profiled=False):
    """One stage call's records: the call, then one step a lead, back to back
    on the device from 20 ms + the first lead after the call's start, each of
    ``step_ms`` and issued by the host its lead before the card reached it,
    then 30 ms to the call's end."""
    rec = profiling.SpanRecord
    out = []
    for k, lead in enumerate(leads):
        d = t0 + round((20 + leads[0] + k * step_ms) * MS)
        h = d - round(lead * MS)
        out.append(rec("flux.step", call_id + 1 + k, call_id, call_id, 1, h, h + MS,
                       d, d + round(step_ms * MS), profiled))
    end = out[-1].device_end_ns + 30 * MS
    out.append(rec("inpaint.call", call_id, None, call_id, 1, t0, end, t0, end, profiled))
    return out


@pytest.fixture
def profiling():
    from followmyhold_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


def test_readers_find_nothing_without_spans(profiling, monkeypatch):
    for name in READERS:
        assert _reader(name).read({}) is None
    monkeypatch.delattr(profiling, "collect")         # a program without the span layer
    for name in READERS:
        assert _reader(name).read({}) is None


def test_readers_take_the_calls_between_the_warm_up_and_the_profiler(profiling, monkeypatch):
    records = (_call(profiling, 100, 0, [0.1, 0.1, 0.1], step_ms=500.0)          # warm-up
               + _call(profiling, 200, 10_000 * MS, [0.05, 30.0, 0.5], step_ms=120.0)
               + _call(profiling, 300, 20_000 * MS, [2.0, 30.0, 30.0], step_ms=140.0)
               + _call(profiling, 400, 30_000 * MS, [90.0] * 3, step_ms=900.0, profiled=True)
               + _call(profiling, 500, 40_000 * MS, [0.2] * 3, step_ms=800.0))
    monkeypatch.setattr(profiling, "collect", lambda: records)
    assert _reader("flux.step_span_ms").read({}) == pytest.approx(130.0)
    assert _reader("flux.host_bound_pct").read({}) == pytest.approx(100.0 * 2 / 6)
    # each call: 20 ms and its first lead before its steps, 30 ms after them
    outside = _reader("inpaint.outside_steps_ms").read({})
    assert outside == pytest.approx(20.0 + (0.05 + 2.0) / 2 + 30.0)
    # a warm-up alone, or calls only under the profiler, leave nothing to read
    for kept in (records[:4], records[:4] + records[12:16]):
        monkeypatch.setattr(profiling, "collect", lambda: kept)
        for name in READERS:
            assert _reader(name).read({}) is None, name


def test_a_traced_tiny_run_reports_the_span_metrics():
    line = _tiny("inpaint-2crops", trace=1)
    assert line["correct"] is True
    for name, unit in READERS.items():
        assert name in line["metrics"] and line["metrics"][name]["unit"] == unit, name
    assert line["metrics"]["flux.step_span_ms"]["value"] > 0
    assert line["metrics"]["inpaint.outside_steps_ms"]["value"] > 0
    assert 0 <= line["metrics"]["flux.host_bound_pct"]["value"] <= 100
