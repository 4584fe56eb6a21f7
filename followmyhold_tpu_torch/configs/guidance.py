"""Guidance optimizer hyperparameters.

The port's own copy of followmyhold_tpu/configs/guidance.py (the port imports
nothing of that package): same step counts, per-group learning rates, phase
boundaries and loss toggles as the original pipeline's OptimizationConfig
(src/foho/configs/guid_config.py:6-32). ``guidance_mesh_caps`` holds the
full-size static capacities of followmyhold_tpu/configs/profiles.py.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class LrGroup:
    scale: float
    trans: float
    rot: float


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    obj_guidance_scale: float = 5.0
    batch_size: int = 1

    # Optimization steps per phase (reference guid_config.py:12-15)
    optimization_steps_hand: int = 200
    optimization_steps_joint: int = 50
    optimization_steps_scale: int = 100
    num_inference_steps: int = 20

    # In-loop SDF grid resolution (reference pipelines.py:1126) and final
    # decode resolution (reference pipelines.py:1624-1625).
    octree_resolution: int = 64
    final_octree_resolution: int = 384

    # Learning rates (reference guid_config.py:21-26)
    phase1_hand_lrs: LrGroup = LrGroup(scale=1e-2, trans=1e-2, rot=0.5)
    phase2_hand_lrs: LrGroup = LrGroup(scale=1e-4, trans=1e-4, rot=1e-2)
    obj_2half_lrs: LrGroup = LrGroup(scale=1e-2, trans=1e-2, rot=1e-2)
    obj_lrs: LrGroup = LrGroup(scale=5e-2, trans=1e-2, rot=1e-2)
    noise_obj_lr1: float = 1e-4
    noise_obj_lr2: float = 1e-2

    use_intersection_loss: bool = True

    @property
    def guidance_start_step(self) -> int:
        return self.num_inference_steps // 2

    @property
    def handopt_start_step(self) -> int:
        return self.guidance_start_step - 1

    @property
    def guidance_end_step(self) -> int:
        return self.num_inference_steps

    def __call__(self) -> "OptimizationConfig":
        # Reference config objects are called to self-return (guid_config.py:31).
        return self

    def as_dict(self) -> Mapping[str, object]:
        return dataclasses.asdict(self)


def guidance_mesh_caps() -> dict:
    """Full-size capacities of the guided sampler. ``raster_faces_per_tile`` is
    the most faces one pixel tile keeps; a tile's list is packed, so capacity
    above the true count costs nothing."""
    return dict(max_verts=32768, max_faces=65536, vae_chunk=8192,
                raster_faces_per_tile=24576)
