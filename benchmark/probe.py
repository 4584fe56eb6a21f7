"""What a traced run records, from the benchmark's own files, each in a unit
of its own: CUDA-event spans around the forwards the driver hooks (the first
unit), the host syncs (the second, where the driver counts them), and the
profiler's device timeline with the FLOPs of the models' matrix products and
attentions and the port's attention forward calls with their shapes (the
third: the profiler slows the host, and once it has run, the process's later
launches too). Outside those units every hook passes its call through.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from benchmark.frozen import roofline
from benchmark.frozen.syncs import count_syncs

ATTN_RANGE = "bench::attn_fwd"


def _union(intervals) -> tuple:
    """(covered length, the gaps [(start, end)]) of sorted intervals."""
    covered, gaps, end = 0.0, [], None
    for s, e in intervals:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, gaps


class _HostEvent:
    """A CUDA event's stand-in on the CPU: the host clock."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def _merged(intervals) -> tuple:
    """Sorted intervals merged where they overlap: (starts, ends) arrays."""
    starts, ends = [], []
    for s, e in intervals:
        if starts and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return np.array(starts, dtype=np.int64), np.array(ends, dtype=np.int64)


def _covered(merged, s: int, e: int) -> int:
    """How much of [s, e] the merged intervals cover."""
    starts, ends = merged
    lo, hi = np.searchsorted(ends, s), np.searchsorted(starts, e)
    if hi <= lo:
        return 0
    return int(np.maximum(0, np.minimum(ends[lo:hi], e) - np.maximum(starts[lo:hi], s)).sum())


class Probe:
    def __init__(self, device):
        self.device = device
        self.active = False        # the profiled unit: FLOPs and attention ranges
        self.timing = False        # the span unit: CUDA events around the hooked forwards
        self.spans: Dict[str, List[tuple]] = {}
        self.flops = 0.0
        self.attn: List[dict] = []
        self.syncs: Dict[str, int] = {}
        self.restore: List[tuple] = []
        self.handles: List[Any] = []
        self._trace: Dict[str, Any] = {}

    # ---- hooks (installed in set-up, live only inside a traced window) ----- #

    def _event(self):
        if self.device.type != "cuda":
            return _HostEvent()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span_module(self, module: nn.Module, name: str) -> None:
        """Time every forward of ``module`` with CUDA events (no sync)."""
        def pre(_m, _a):
            if self.timing:
                self.spans.setdefault(name, []).append([self._event(), None])

        def post(_m, _a, _o):
            if self.timing and self.spans.get(name) and self.spans[name][-1][1] is None:
                self.spans[name][-1][1] = self._event()

        self.handles += [module.register_forward_pre_hook(pre),
                         module.register_forward_hook(post)]

    def count_flops(self, *models: nn.Module) -> None:
        """Count the matrix products of every ``nn.Linear`` and ``nn.Conv2d``
        of ``models`` (the input gradient too, where the input takes one;
        the weights are frozen)."""
        def linear(m, args, out):
            if self.active:
                x = args[0]
                f = roofline.linear_flops(x.numel() // m.in_features, m.in_features,
                                          m.out_features)
                self.flops += f * (2 if torch.is_grad_enabled() and x.requires_grad else 1)

        def conv(m, args, out):
            if self.active:
                x = args[0]
                k = m.kernel_size[0] * m.kernel_size[1]
                f = roofline.conv_flops(out.numel(), m.in_channels // m.groups, k)
                self.flops += f * (2 if torch.is_grad_enabled() and x.requires_grad else 1)

        for model in models:
            for mod in model.modules():
                if isinstance(mod, nn.Linear):
                    self.handles.append(mod.register_forward_hook(linear))
                elif isinstance(mod, nn.Conv2d):
                    self.handles.append(mod.register_forward_hook(conv))

    def attention(self, attn_module: Any) -> None:
        """Wrap the port's attention entries in ``attn_module`` (its
        ``ops.attention``): the forward of the flash path in a profiler range
        (its kernels' device time, against the bound of its shapes), and the
        FLOPs of every attention forward and backward."""
        fwd = attn_module.flash_attention_forward
        bwd = attn_module.flash_attention_backward
        plain = attn_module.attention_plain

        def shape(q, k):
            B, H, N, D = q.shape
            return B, H, N, k.shape[2], D

        def fwd_wrapped(q, k, v, *args, **kwargs):
            if not self.active:
                return fwd(q, k, v, *args, **kwargs)
            s = shape(q, k)
            self.flops += roofline.attention_forward_flops(*s)
            call = {"shape": s, "itemsize": q.element_size(), "events": [self._event()]}
            with torch.profiler.record_function(ATTN_RANGE):
                out = fwd(q, k, v, *args, **kwargs)
            call["events"].append(self._event())
            self.attn.append(call)
            return out

        def bwd_wrapped(q, k, v, *args, **kwargs):
            if self.active:
                self.flops += roofline.attention_backward_flops(*shape(q, k))
            return bwd(q, k, v, *args, **kwargs)

        def plain_wrapped(q, k, v, *args, **kwargs):
            if self.active:
                s = shape(q, k)
                grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                                    or v.requires_grad)
                self.flops += roofline.attention_forward_flops(*s) * (3 if grad else 1)
            return plain(q, k, v, *args, **kwargs)

        for attr, fn in (("flash_attention_forward", fwd_wrapped),
                         ("flash_attention_backward", bwd_wrapped),
                         ("attention_plain", plain_wrapped)):
            self.restore.append((attn_module, attr, getattr(attn_module, attr)))
            setattr(attn_module, attr, fn)

    # ---- windows ------------------------------------------------------------ #

    @contextlib.contextmanager
    def traced(self):
        """Profile the block (one unit, ended by a synchronise inside it)."""
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            self.active = True
            try:
                yield
            finally:
                self.active = False
                window_s = time.perf_counter() - t0
        self._trace = self._read(prof, window_s)

    @contextlib.contextmanager
    def timing_spans(self):
        """Time the hooked forwards of the block with CUDA events."""
        self.timing = True
        try:
            yield
        finally:
            self.timing = False

    @contextlib.contextmanager
    def counting_syncs(self):
        if self.device.type != "cuda":
            yield
            return
        with count_syncs(self.syncs, "unit"):
            yield

    def _read(self, prof, window_s: float) -> Dict[str, Any]:
        """The device timeline from the profiler's raw events: busy time (the
        union of the device's operations), the longest idle gaps labelled by
        the innermost host operation running at their middle, the operations
        by time, and the device time inside each attention range."""
        from torch.autograd import DeviceType

        dev, cpu, attn = [], [], []
        for e in prof.profiler.kineto_results.events():
            span = (e.start_ns(), e.end_ns())
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation():
                    if e.name() == ATTN_RANGE:
                        attn.append(span)
                else:
                    dev.append((*span, e.name()))
            elif not e.is_user_annotation():
                cpu.append((*span, e.name()))
        dev.sort()
        busy_ns, gaps = _union((s, e) for s, e, _ in dev)
        merged = _merged([(s, e) for s, e, _ in dev])
        by_name: Dict[str, float] = {}
        for s, e, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        cs = np.array([c[0] for c in cpu], dtype=np.int64)
        ce = np.array([c[1] for c in cpu], dtype=np.int64)

        def host_at(t: float) -> str:
            inside = np.nonzero((cs <= t) & (ce >= t))[0]
            if inside.size == 0:
                return "host: no op"
            return cpu[int(inside[np.argmin(ce[inside] - cs[inside])])][2]

        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return dict(
            busy_s=busy_ns / 1e9, window_s=window_s,
            attn_kernel_s=sum(_covered(merged, s, e) for s, e in attn) / 1e9,
            attn_ranges=len(attn),
            breakdown=dict(
                device_ops=[[n, t / 1e9] for n, t in
                            sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
                idle_gaps=[[host_at((s + e) / 2), (e - s) / 1e9] for s, e in longest]))

    def record(self) -> Dict[str, Any]:
        """The traced run's records for the metric readers."""
        self._sync()
        spans = {name: [s[0].elapsed_time(s[1]) for s in calls if s[1] is not None]
                 for name, calls in self.spans.items()}
        attn = [dict(shape=c["shape"], itemsize=c["itemsize"],
                     event_s=c["events"][0].elapsed_time(c["events"][1]) / 1e3)
                for c in self.attn]
        return dict(self._trace, spans_ms=spans, flops=self.flops,
                    attn=attn, syncs=self.syncs.get("unit"))

    def close(self) -> None:
        for h in self.handles:
            h.remove()
        for owner, attr, fn in reversed(self.restore):
            setattr(owner, attr, fn)
        self.handles, self.restore = [], []
