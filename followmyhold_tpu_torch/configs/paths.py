"""Where the package, the checkout and the model assets live (the port's copy
of the reference's ``configs/paths.py``). Assets are ``FOHO_TPU_ASSETS``,
else ``assets/`` at the root of the checkout."""

from __future__ import annotations

import os


def package_root() -> str:
    """The root of the followmyhold_tpu_torch package."""
    return os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def repo_root() -> str:
    """The root of the checkout (the package's parent)."""
    return os.path.abspath(os.path.join(package_root(), ".."))


def assets_root() -> str:
    """Weights, MANO pickles and regressors. A missing asset degrades to a
    synthetic stand-in, so the stage runs without downloads."""
    return os.environ.get("FOHO_TPU_ASSETS", os.path.join(repo_root(), "assets"))
