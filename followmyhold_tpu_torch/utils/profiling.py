"""Wall-time spans and an opt-in device trace.

Counterpart of followmyhold_tpu/utils/profiling.py: ``span`` adds a region's
wall time to a process-wide registry, ``summary`` prints it, ``reset`` clears
it. ``device_trace`` records a ``torch.profiler`` session (CPU and, where
CUDA is available, CUDA activities) as a Chrome trace
``<FOHO_TPU_TRACE_DIR>/<name>.pt.trace.json`` where that variable is set, and
does nothing otherwise.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Tuple

import torch

_SPANS: Dict[str, Tuple[int, float]] = defaultdict(lambda: (0, 0.0))


@contextlib.contextmanager
def span(name: str, block: bool = False) -> Iterator[None]:
    """Time a region. ``block=True`` waits for the card at its end (where CUDA
    is initialised), so the span holds the device's work and not only its
    dispatch; a failed synchronisation raises."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        n, total = _SPANS[name]
        _SPANS[name] = (n + 1, total + time.perf_counter() - t0)


def summary() -> str:
    lines = ["span                              calls   total_s    mean_ms"]
    for name, (n, total) in sorted(_SPANS.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<32} {n:>6} {total:>9.3f} {total / max(n, 1) * 1e3:>10.2f}")
    return "\n".join(lines)


def reset() -> None:
    _SPANS.clear()


@contextlib.contextmanager
def device_trace(name: str = "trace") -> Iterator[None]:
    """A torch.profiler session over the block, exported as a Chrome trace
    under FOHO_TPU_TRACE_DIR; nothing without that variable."""
    trace_dir = os.environ.get("FOHO_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.pt.trace.json"))
