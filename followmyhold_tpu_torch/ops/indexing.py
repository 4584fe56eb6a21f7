"""Row gathers whose gradient scales with duplicate indices.

``x[index]`` with an integer tensor differentiates into ``index_put_`` with
accumulation, which sorts the indices and walks runs of duplicates serially.
The renderer gathers a face row for every pixel (262,144 rows out of 1,538
faces at 512x512), so nearly every index is a duplicate: measured with
torch.profiler on an H100, each such backward took 7.4 ms and seven of them
made up 95 % of a hand-pose iteration. ``index_select`` differentiates into
``index_add_`` (atomic adds) and takes microseconds; the order of its sums can
change from run to run.
"""

from __future__ import annotations

import torch


def take_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` along dim 0 for an integer ``index`` of any shape."""
    out = x.index_select(0, index.reshape(-1))
    return out.reshape(*index.shape, *x.shape[1:])
