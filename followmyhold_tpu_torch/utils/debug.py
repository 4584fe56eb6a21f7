"""Debug dumps: the ``FOHO_DEBUG_DIR`` contract.

The port's copy of followmyhold_tpu/utils/debug.py. When ``FOHO_DEBUG_DIR`` is
set, a stage writes params.json, a losses.txt log, and periodic render and
mesh artifacts into a subdirectory per run; unset, every call does nothing.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Optional

import numpy as np


class DebugDir:
    """Per-run debug sink; a no-op when FOHO_DEBUG_DIR is unset."""

    def __init__(self, run_name: str, root: Optional[str] = None):
        root = root if root is not None else os.environ.get("FOHO_DEBUG_DIR")
        self.enabled = bool(root)
        self.dir: Optional[str] = None
        self._loss_log = None
        if self.enabled:
            self.dir = os.path.join(root, run_name)
            os.makedirs(self.dir, exist_ok=True)

    def path(self, name: str) -> Optional[str]:
        return os.path.join(self.dir, name) if self.enabled else None

    def dump_params(self, params: Mapping[str, Any], name: str = "params.json") -> None:
        if not self.enabled:
            return
        with open(self.path(name), "w", encoding="utf-8") as f:
            json.dump({k: _jsonable(v) for k, v in params.items()}, f, indent=4)

    def log_loss(self, message: str) -> None:
        if not self.enabled:
            return
        if self._loss_log is None:
            self._loss_log = open(self.path("losses.txt"), "a", encoding="utf-8")
        self._loss_log.write(message + "\n")
        self._loss_log.flush()

    def dump_array(self, name: str, array) -> None:
        if not self.enabled:
            return
        np.save(self.path(name), np.asarray(array))

    def dump_mesh(self, name: str, vertices, faces) -> None:
        if not self.enabled:
            return
        from followmyhold_tpu_torch.utils.mesh_io import save_mesh

        save_mesh(self.path(name), np.asarray(vertices), np.asarray(faces))

    def close(self) -> None:
        if self._loss_log is not None:
            self._loss_log.close()
            self._loss_log = None


def _jsonable(v: Any) -> Any:
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, Mapping):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:
        return np.asarray(v).tolist()
    except Exception:
        return str(v)
