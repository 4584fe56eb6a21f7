"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell; its file
``benchmark/cells/<cell>.json`` names the configuration
(``benchmark/configs/<config>.json``) and the traffic driver
(``benchmark/drivers/<driver>.py``); every per-layer metric is a reader
``benchmark/metrics/<metric>.py``. Nothing here names a cell, a
configuration or a metric: a later cell is a new file and a new entry.
"""

from __future__ import annotations

import os
import sys
import time

_T0 = time.perf_counter()

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every compile cache at a fixed place inside the checkout (the port's nvcc and
# g++ libraries go to <checkout>/build/ by themselves), and no JAX behind a
# library's back
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(_ROOT, "build", "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def main(argv=None) -> int:
    from benchmark import harness

    args = harness.parse_args(argv)
    return harness.run_cell(args, t0=_T0)


if __name__ == "__main__":
    sys.exit(main())
