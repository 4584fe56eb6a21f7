"""Where model assets live: ``FOHO_TPU_ASSETS``, else ``assets/`` at the root of
the checkout (the port's copy of the reference's ``assets_root``)."""

from __future__ import annotations

import os


def assets_root() -> str:
    """Weights, MANO pickles and regressors. A missing asset degrades to a
    synthetic stand-in, so the stage runs without downloads."""
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    return os.environ.get("FOHO_TPU_ASSETS", os.path.join(root, "assets"))
