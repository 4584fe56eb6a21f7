"""Median over stage-3 calls of the device ms a call spends outside its
FLUX steps: the program's ``inpaint.call`` span's device interval
(``followmyhold_tpu_torch.utils.profiling``) less the part of it that the
call's ``flux.step`` spans cover; that is the towers, the VAE, the readback
and the card's idle time between them. Over the window's unprofiled calls
before the profiled one (``frozen/spans.window_calls``). None where the
program records no such spans."""

import statistics

from benchmark.frozen import spans
from benchmark.probe import _covered, _merged


def read(rec):
    outside = []
    for call, recs in spans.window_calls() or ():
        steps = sorted((r.device_start_ns, r.device_end_ns) for r in spans.steps(recs))
        if steps and call.device_start_ns is not None:
            s, e = call.device_start_ns, call.device_end_ns
            outside.append((e - s - _covered(_merged(steps), s, e)) / 1e6)
    return statistics.median(outside) if outside else None
