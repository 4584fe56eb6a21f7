"""The share of the program's ``flux.step`` spans
(``followmyhold_tpu_torch.utils.profiling``) that the card reached less than
1 ms after the host began to issue them, in %: steps where the card's queue
had run dry, so that it waited on the host's launches. Over the steps of the
window's unprofiled calls before the profiled one
(``frozen/spans.window_calls``); each call's first step follows the
synchronous copy of the position ids, so one step in 28 is the floor. The
lead itself (device start less host start) tops out at the launch queue's
depth and falls with a shorter step, so it goes to standard error as a
diagnostic only. None where the program records no such span."""

import statistics
import sys

from benchmark.frozen import spans

BOUND_MS = 1.0


def read(rec):
    lead = [(r.device_start_ns - r.host_start_ns) / 1e6
            for _, recs in spans.window_calls() or () for r in spans.steps(recs)]
    if not lead:
        return None
    print(f"flux.step: the card's queue ran {statistics.median(lead):.3f} ms behind the host "
          f"at the median step (min {min(lead):.3f}, max {max(lead):.3f}, {len(lead)} steps)",
          file=sys.stderr, flush=True)
    return 100.0 * sum(x < BOUND_MS for x in lead) / len(lead)
