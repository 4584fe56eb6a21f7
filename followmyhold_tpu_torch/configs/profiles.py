"""Runtime size profiles.

The port's copy of followmyhold_tpu/configs/profiles.py. FOHO_TPU_PROFILE=full
(default) runs production shapes (512^2 crops, 64^3 in-loop SDF grids, the
384^3 export, the reference's step counts). FOHO_TPU_PROFILE=tiny shrinks every
knob for CPU smoke runs and tests: the same code paths and artifact names at
a fraction of the work.
"""

from __future__ import annotations

import os

import torch

from followmyhold_tpu_torch.configs.guidance import OptimizationConfig
from followmyhold_tpu_torch.models.moge import MoGeConfig
from followmyhold_tpu_torch.models.vit import ViTConfig


def profile_name() -> str:
    return os.environ.get("FOHO_TPU_PROFILE", "full")


def is_tiny() -> bool:
    return profile_name() == "tiny"


def crop_size() -> int:
    return 64 if is_tiny() else 512


def optimization_config() -> OptimizationConfig:
    if is_tiny():
        return OptimizationConfig(
            num_inference_steps=6,
            optimization_steps_hand=3,
            optimization_steps_scale=2,
            optimization_steps_joint=2,
            octree_resolution=12,
            final_octree_resolution=16,
        )
    return OptimizationConfig()


def moge_config() -> MoGeConfig:
    """MoGe with DINOv2-L and the published neck and heads, or the
    reference's tiny configuration: a 2-block encoder of width 32 on a 2x2
    checkpoint grid, three neck levels, 4-16 tokens."""
    if is_tiny():
        return MoGeConfig(
            encoder=ViTConfig(img_size=(28, 28), patch_size=14, embed_dim=32, depth=2,
                              num_heads=2, use_cls_token=True, layerscale_init=1e-5,
                              dtype=torch.float32),
            intermediate_layers=(0, 1), dim_proj=16, neck_dims=(16, 16, 8),
            head_dims=(16, 16, 8), num_res_blocks=1, scale_head_dims=(16, 1),
            num_tokens_range=(4, 16), dtype=torch.float32)
    return MoGeConfig()


def hunyuan_octree_resolution() -> int:
    """Export resolution of the un-guided shape stage: 384, or 24 tiny."""
    return 24 if is_tiny() else 384


def guidance_mesh_caps() -> dict:
    """Static capacities of the guided sampler. ``raster_faces_per_tile`` is
    the most faces one pixel tile keeps; a tile's list is packed, so capacity
    above the true count costs nothing."""
    if is_tiny():
        return dict(max_verts=2048, max_faces=4096, vae_chunk=512,
                    raster_faces_per_tile=512)
    return dict(max_verts=32768, max_faces=65536, vae_chunk=8192,
                raster_faces_per_tile=24576)
