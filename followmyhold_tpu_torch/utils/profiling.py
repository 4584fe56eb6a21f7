"""The port's spans, on one clock with the device, and an opt-in device trace.

``span(name)`` keeps one record per call in a bounded in-memory ring
(``RING`` records; the oldest are dropped): its name, its id, the enclosing
span on its thread (``parent``), the outermost one (``call``: the spans of
one stage call share it), the thread, the host's start and end, the device's
start and end, and whether a torch.profiler session was active when it began
(``profiled``). Where CUDA is initialised a span records a pair of timing
events on the current stream (none while that stream captures a CUDA graph:
the device interval is then unknown); without CUDA the device interval is the
host interval. Nothing synchronises on the path: the events are resolved in
``collect()``.

One clock: every exported time is Unix-epoch nanoseconds, the clock of
torch.profiler's events (``time.perf_counter_ns`` plus one offset fixed at
import). A device time is placed on it through anchors: ``anchor()``, called
where the host has just waited for the card (a synchronous copy, a
readback), records an event whose device time equals its host time, because
nothing was queued before it, and ties it to the open call. With two anchors
in a call, an event's device time is interpolated between the first and the
last (the timing events' clock drifts from the host's by some ppm, which
over a call of seconds would pass 0.1 ms); with one, it is that anchor's
host time less the event's elapsed time to it. Calls without an anchor take
the one that ``collect()`` records after its own synchronise.

While a profiler session is active a span also opens
``torch.profiler.record_function(name)``, which places it on the profiler's
timelines (``device_trace``'s Chrome export too); without a session that
costs nothing but the check.

``summary()`` prints calls, host and device totals and the mean device self
time (the device interval less what child spans cover) by name; ``reset()``
clears the ring. ``device_trace`` records a ``torch.profiler`` session (CPU
and, where CUDA is available, CUDA activities) as a Chrome trace
``<FOHO_TPU_TRACE_DIR>/<name>.pt.trace.json`` where that variable is set, and
does nothing otherwise.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

RING = 8192
# perf_counter_ns + _EPOCH_NS = Unix-epoch ns, the clock of torch.profiler's events
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()

_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()
_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One closed span, every time in Unix-epoch ns; the device times are
    None where the span ran while its stream captured a CUDA graph."""

    name: str
    id: int
    parent: Optional[int]
    call: int
    thread: int
    host_start_ns: int
    host_end_ns: int
    device_start_ns: Optional[int]
    device_end_ns: Optional[int]
    profiled: bool

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_start_ns is None:
            return None
        return (self.device_end_ns - self.device_start_ns) / 1e6


class _Open:
    """A span's record until ``collect()`` resolves it (perf_counter ns)."""

    __slots__ = ("name", "id", "parent", "call", "thread", "t0", "t1", "e0", "e1", "d0", "d1",
                 "profiled", "anchors")


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _timing_event() -> torch.cuda.Event:
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _recording_events() -> bool:
    # no events while the stream captures a graph: the device interval stays unknown
    return torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing()


class span:
    """``with span(name):`` records the block (see the module's docstring).
    An exception raised in the block passes through."""

    __slots__ = ("_name", "_rec", "_events", "_range")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self) -> "span":
        stack = _stack()
        parent = stack[-1] if stack else None
        rec = self._rec = _Open()
        rec.name, rec.id, rec.thread = self._name, next(_ids), threading.get_ident()
        rec.parent = None if parent is None else parent.id
        rec.call = rec.id if parent is None else parent.call
        rec.e0 = rec.e1 = rec.d0 = rec.d1 = rec.anchors = None
        rec.profiled = _profiler_enabled()
        self._range = None
        if rec.profiled:
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        stack.append(rec)
        self._events = _recording_events()
        rec.t0 = time.perf_counter_ns()
        if self._events:
            rec.e0 = _timing_event()
        elif not torch.cuda.is_initialized():
            rec.d0 = rec.t0
        return self

    def __exit__(self, *exc) -> None:
        rec = self._rec
        if self._events:
            rec.e1 = _timing_event()
        rec.t1 = time.perf_counter_ns()
        if rec.d0 is not None:
            rec.d1 = rec.t1
        stack = _stack()
        stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        _ring.append(rec)


def anchor() -> None:
    """Ties the open call's device times to the host's clock here. Call it
    only where the host has just waited for the card's queue to drain (a
    synchronous copy, a readback): it records one timing event and
    synchronises nothing. Outside a span, or where no events are recorded,
    it does nothing."""
    stack = _stack()
    if not stack or not _recording_events():
        return
    call = stack[0]
    if call.anchors is None:
        call.anchors = []
    call.anchors.append((_timing_event(), time.perf_counter_ns()))


def now_ns() -> int:
    """The spans' clock now (Unix-epoch ns)."""
    return time.perf_counter_ns() + _EPOCH_NS


def _clock(anchors):
    """An event's host time (perf_counter ns) from its call's anchors: from
    the first one at the rate the first and the last give the event clock,
    or from the one anchor at the event clock's own rate."""
    (e_a, t_a), (e_b, t_b) = anchors[0], anchors[-1]
    span_ms = e_a.elapsed_time(e_b)
    rate = (t_b - t_a) / (span_ms * 1e6) if span_ms > 0 else 1.0
    return lambda event: t_a + round(e_a.elapsed_time(event) * 1e6 * rate)


def collect() -> List[SpanRecord]:
    """The ring's records, oldest first, their device times resolved. Where
    events are pending this synchronises the card once (off the hot path)."""
    recs = list(_ring)
    pending = [r for r in recs if r.e0 is not None and r.d0 is None]
    if pending:
        torch.cuda.synchronize()
        fallback = (_timing_event(), time.perf_counter_ns())
        fallback[0].synchronize()
        clocks = {r.id: _clock(r.anchors) for r in recs if r.anchors}
        for r in pending:
            to_host = clocks.get(r.call) or _clock([fallback])
            r.d0, r.d1 = to_host(r.e0), to_host(r.e1)
            r.e0 = r.e1 = None
        for r in recs:
            r.anchors = None

    def epoch(t):
        return None if t is None else t + _EPOCH_NS

    return [SpanRecord(r.name, r.id, r.parent, r.call, r.thread, epoch(r.t0), epoch(r.t1),
                       epoch(r.d0), epoch(r.d1), r.profiled) for r in recs]


def covered_ns(intervals, start: int, end: int) -> int:
    """How much of [start, end] the union of ``intervals`` covers."""
    total, reach = 0, start
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, end)
        if e > s:
            total += e - s
            reach = e
    return total


def self_ms(records: List[SpanRecord]) -> Dict[int, float]:
    """Each record's device self time (ms): its device interval less what its
    child spans' device intervals cover. Records with no device interval are
    left out."""
    children: Dict[int, List[Tuple[int, int]]] = collections.defaultdict(list)
    for r in records:
        if r.parent is not None and r.device_start_ns is not None:
            children[r.parent].append((r.device_start_ns, r.device_end_ns))
    return {r.id: (r.device_end_ns - r.device_start_ns
                   - covered_ns(children[r.id], r.device_start_ns, r.device_end_ns)) / 1e6
            for r in records if r.device_start_ns is not None}


def summary() -> str:
    """Per name, the longest host total first: calls, host and device totals
    (s) and the mean device self time (ms)."""
    records = collect()
    own = self_ms(records)
    rows: Dict[str, list] = {}
    for r in records:
        row = rows.setdefault(r.name, [0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += r.host_ms / 1e3
        row[2] += (r.device_ms or 0.0) / 1e3
        row[3] += own.get(r.id, 0.0)
    lines = ["span                              calls    host_s  device_s   self_ms"]
    for name, (n, host, dev, own_ms) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<32} {n:>6} {host:>9.3f} {dev:>9.3f} {own_ms / n:>9.2f}")
    return "\n".join(lines)


def reset() -> None:
    _ring.clear()


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
