"""The arithmetic of the per-layer metrics that more than one cell reports
under names of its own (``benchmark/metrics/<metric>.<cell kind>.py`` import
it): what a traced run's records (``probe.Probe.record``) give."""

from __future__ import annotations

from benchmark.frozen import roofline


def attn_fwd_roofline_pct(rec):
    """Over every call of the port's attention forward entry in the profiled
    unit: the least time one H100 could take (``roofline.
    attention_forward_bound_s`` of each call's shapes) over the device time
    the profiler's timeline spends in operations inside the benchmark's
    ranges around the calls, in %."""
    calls = rec.get("attn") or ()
    if not calls or not rec.get("attn_kernel_s") or rec.get("attn_ranges") != len(calls):
        return None
    bound = sum(roofline.attention_forward_bound_s(*c["shape"], c["itemsize"]) for c in calls)
    return 100.0 * bound / rec["attn_kernel_s"]


def device_idle_pct(rec):
    """The share of a unit's wall time in which no operation ran on the
    device, in %: one minus the profiled unit's busy time (the union of the
    profiler's device intervals) over the wall time of the window's first
    unit, which runs the same work unprofiled (the profiler slows the host,
    so the profiled unit's own wall time would read its overhead)."""
    units = rec.get("units_s") or []
    if not units or rec.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / units[0])


def mfu(rec):
    """A unit's model FLOPs over what one H100 could do in it at its bf16
    peak, in %: the matrix products of every linear and convolution layer
    of the cell's models (the input gradient too where one is taken) and
    every attention forward and backward at the shapes the run saw, counted
    in the profiled unit, over the time of the window's first unit (the same
    work, run before the profiler). The renderer, the losses, the optimizer
    and the elementwise work are not counted."""
    units = rec.get("units_s") or []
    if not rec.get("flops") or not units:
        return None
    return 100.0 * rec["flops"] / (units[0] * roofline.PEAK_BF16_FLOPS)
