"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``. A
CUDA request on a machine without a card raises: nothing carries on on the CPU
because it found no GPU. Tests ask for ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but no CUDA device is present; pass "
            "device='cpu' explicitly to run on the CPU")
    return dev
