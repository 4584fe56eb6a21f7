"""The host-sync counter: torch's CUDA sync debug mode warns once for each
call that makes the host wait for the device; the warnings are counted. A
copy of the program's ``chip_smoke._count_syncs``, as a context."""

from __future__ import annotations

import contextlib
import warnings

import torch


@contextlib.contextmanager
def count_syncs(out: dict, key: str = "syncs"):
    """Count the host syncs inside the block into ``out[key]``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode("default")
            out[key] = sum("synchroniz" in str(w.message).lower() for w in caught)
