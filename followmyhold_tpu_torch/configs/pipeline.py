"""The pipeline's configuration: a KEY=VALUE env file -> a frozen dataclass
with the derived output directories.

The port's copy of followmyhold_tpu/configs/pipeline.py: the same keys,
defaults, BASE_DIR directory grammar and errors. ``mesh_shape`` (MESH_SHAPE)
stays the string it is, in the grammar of ``parallel.mesh.parse_mesh_shape``
("dp=4,tp=2", one axis -1 to fill); the orchestrator runs in one process.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class PipelineConfig:
    project_root: str
    split_path: Optional[str]
    image_path: Optional[str]
    base_dir: str
    # the artifact directories, by default under BASE_DIR
    original_img_dir: str
    masked_obj_path: str
    cropped_hoi_path: str
    cropped_hoi_wo_bckg_path: str
    cropped_inpainted_obj: str
    mask_dir_path: str
    moge_out_path: str
    hunyuan_hoi_mesh_path: str
    hamer_out_path: str
    h2m_rt_path: str
    aligned_mano_path: str
    guidance_out_path: str
    gemini_responses: Optional[str]
    # switches
    run_inpaint: bool
    suppress_warnings: bool
    # keys of the original pipeline's env file, kept as they are
    gemini_api_key: Optional[str]
    hf_token: Optional[str]
    hy3dgen_models: Optional[str]
    # the reference's device mesh ("dp=8", "dp=4,tp=2") and the assets directory
    mesh_shape: str
    assets_dir: Optional[str]

    def output_dirs(self) -> Dict[str, str]:
        return {
            "original_img_dir": self.original_img_dir,
            "masked_obj_path": self.masked_obj_path,
            "cropped_hoi_path": self.cropped_hoi_path,
            "cropped_hoi_wo_bckg_path": self.cropped_hoi_wo_bckg_path,
            "cropped_inpainted_obj": self.cropped_inpainted_obj,
            "mask_dir_path": self.mask_dir_path,
            "moge_out_path": self.moge_out_path,
            "hunyuan_hoi_mesh_path": self.hunyuan_hoi_mesh_path,
            "hamer_out_path": self.hamer_out_path,
            "h2m_rt_path": self.h2m_rt_path,
            "aligned_mano_path": self.aligned_mano_path,
            "guidance_out_path": self.guidance_out_path,
        }


def _parse_env_file(path: str) -> Dict[str, str]:
    """KEY=VALUE lines; blank lines, '#' comments and lines without '=' are
    skipped; quotes around a value are stripped."""
    data: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, val = line.split("=", 1)
            data[key.strip()] = val.strip().strip('"').strip("'")
    return data


def load_config(path: str) -> PipelineConfig:
    """The configuration of the env file ``path``. PROJECT_ROOT, BASE_DIR and
    one of SPLIT_PATH and IMAGE_PATH are required."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Missing config: {path}")

    env = _parse_env_file(path)

    project_root = env.get("PROJECT_ROOT")
    base_dir = env.get("BASE_DIR")
    if not project_root or not base_dir:
        raise ValueError("PROJECT_ROOT and BASE_DIR are required in config")

    split_path = env.get("SPLIT_PATH") or None
    image_path = env.get("IMAGE_PATH") or None
    if not split_path and not image_path:
        raise ValueError("Set either SPLIT_PATH or IMAGE_PATH in config")

    def _p(key: str, default: str) -> str:
        return env.get(key, default)

    return PipelineConfig(
        project_root=project_root,
        split_path=split_path,
        image_path=image_path,
        base_dir=base_dir,
        original_img_dir=_p("ORIGINAL_IMG_DIR", f"{base_dir}/original_imgs"),
        masked_obj_path=_p("MASKED_OBJ_PATH", f"{base_dir}/masked_obj_imgs"),
        cropped_hoi_path=_p("CROPPED_HOI_PATH", f"{base_dir}/cropped_hoi_imgs"),
        cropped_hoi_wo_bckg_path=_p("CROPPED_HOI_WO_BCKG_PATH",
                                    f"{base_dir}/cropped_hoi_imgs_wo_bckg"),
        cropped_inpainted_obj=_p("CROPPED_INPAINTED_OBJ", f"{base_dir}/ours_inpaint"),
        mask_dir_path=_p("MASK_DIR_PATH", f"{base_dir}/cropped_hand_masks"),
        moge_out_path=_p("MOGE_OUT_PATH", f"{base_dir}/moge_out"),
        hunyuan_hoi_mesh_path=_p("HUNYUAN_HOI_MESH_PATH", f"{base_dir}/hunyuan_hoi_out"),
        hamer_out_path=_p("HAMER_OUT_PATH", f"{base_dir}/hamer_out"),
        h2m_rt_path=_p("H2M_RT_PATH", f"{base_dir}/h2m_transformations"),
        aligned_mano_path=_p("ALIGNED_MANO_PATH", f"{base_dir}/aligned_mano"),
        guidance_out_path=_p("GUIDANCE_OUT_PATH", f"{base_dir}/guidance_out"),
        gemini_responses=env.get("GEMINI_RESPONSES") or None,
        run_inpaint=env.get("RUN_INPAINT", "1") == "1",
        suppress_warnings=env.get("FOHO_SUPPRESS_WARNINGS", "1") == "1",
        gemini_api_key=env.get("GEMINI_API_KEY") or None,
        hf_token=env.get("HF_TOKEN") or None,
        hy3dgen_models=env.get("HY3DGEN_MODELS") or None,
        mesh_shape=env.get("MESH_SHAPE", "dp=-1"),
        assets_dir=env.get("FOHO_TPU_ASSETS") or None,
    )
