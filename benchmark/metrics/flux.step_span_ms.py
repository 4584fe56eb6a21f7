"""Median device ms of the program's own ``flux.step`` span
(``followmyhold_tpu_torch.utils.profiling``: one step's transformer forward
and Euler update, between the CUDA events the span records on the card's
stream), over the steps of the window's unprofiled calls before the
profiled one (``frozen/spans.window_calls``). None where the program records
no such span."""

import statistics

from benchmark.frozen import spans


def read(rec):
    ms = [r.device_ms for _, recs in spans.window_calls() or () for r in spans.steps(recs)]
    return statistics.median(ms) if ms else None
