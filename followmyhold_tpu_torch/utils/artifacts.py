"""Artifact names shared by the stages.

The port's copy of the host-only helpers of followmyhold_tpu/utils/artifacts.py
that the ported stages use. ``artifacts_for``, which needs the pipeline's
configuration, comes with the orchestrator.
"""

from __future__ import annotations

import os
from typing import Tuple


def parse_cropped_hoi_name(filename: str) -> Tuple[str, bool]:
    """'{id}_cropped_hoi_{is_right}.png' -> (id, is_right)."""
    stem = os.path.basename(filename)
    stem = stem[: stem.rfind(".")] if "." in stem else stem
    parts = stem.split("_")
    return parts[0], parts[-1] == "1"


def should_skip(*paths: str) -> bool:
    """The resume contract: skip work whose outputs all exist."""
    return all(os.path.exists(p) for p in paths)
