"""The program's own spans (``followmyhold_tpu_torch.utils.profiling``) that
the span readers (``benchmark/metrics/flux.step_span_ms.py``,
``flux.host_bound_pct.py``, ``inpaint.outside_steps_ms.py``) read: those of
a traced run's stage calls (``inpaint.call``) after the set-up's warm-up and
before the first call that ran under the profiler. The warm-up is the
process's first call, cold; the profiler slows the host in its unit and,
once it has run, the process's later launches too. So the records read are
the window's first two units', which run the same work at the host's own
pace (``drivers/inpaint.py``'s check hooks add clones and one sync in
``inpaint.text``).
"""

from __future__ import annotations

CALL = "inpaint.call"


def window_calls():
    """[(the call's ``inpaint.call`` record, its other records)] of those
    calls, in order; None where the program has no span layer or records no
    such call."""
    from followmyhold_tpu_torch.utils import profiling

    collect = getattr(profiling, "collect", None)
    if collect is None:
        return None
    records = collect()
    calls = sorted((r for r in records if r.name == CALL and r.id == r.call), key=lambda r: r.id)
    kept = []
    for call in calls[1:]:
        if call.profiled:
            break
        kept.append(call)
    if not kept:
        return None
    inside = {c.id: [] for c in kept}
    for r in records:
        if r.call in inside and r.id != r.call:
            inside[r.call].append(r)
    return [(c, inside[c.id]) for c in kept]


def steps(records) -> list:
    """The ``flux.step`` records among ``records`` that have a device
    interval."""
    return [r for r in records if r.name == "flux.step" and r.device_start_ns is not None]
