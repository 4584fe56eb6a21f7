"""The artifact names the stages share.

The port's copy of followmyhold_tpu/utils/artifacts.py: the stages talk
through files named by a grammar of the image id; ``artifacts_for`` spells
it out for one image, and ``should_skip`` is the resume contract (work whose
outputs all exist is skipped).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

from followmyhold_tpu_torch.configs.pipeline import PipelineConfig


@dataclass(frozen=True)
class ImageArtifacts:
    """Every artifact path of one image id."""

    image_id: str
    is_right: bool

    original_img: str
    masked_obj_img: str          # the occluded object
    cropped_hoi: str             # {id}_cropped_hoi_{is_right}.png
    cropped_hoi_wo_bckg: str
    cropped_obj_mask: str        # {id}_cropped_obj_mask.png
    cropped_hand_mask: str       # {id}_cropped_hand_mask.png
    inpainted_obj: str
    moge_dir: str                # moge_out/{id}_cropped_hoi/
    moge_mesh: str               # .../mesh.ply
    moge_fov: str                # .../fov.json
    hunyuan_hoi_mesh: str        # {id}_hoi_mesh.ply
    hamer_npy: str               # {id}.npy
    hamer_kps: str               # {id}_kps_for_guidance.npy
    hamer_mesh: str              # {id}_hamer.obj
    h2m_transform: str           # {id}_hoi_mesh.npy (4x4)
    aligned_mano_mesh: str       # {id}_hamer_aligned_mano.ply
    guidance_obj: str            # {id}_obj.ply
    guidance_hand: str           # {id}_hand.ply

    def guidance_done(self) -> bool:
        return os.path.exists(self.guidance_obj) and os.path.exists(self.guidance_hand)


def artifacts_for(cfg: PipelineConfig, image_id: str, is_right: bool = True,
                  original_ext: str = ".png") -> ImageArtifacts:
    """The artifact paths of ``image_id`` under ``cfg``'s directories."""
    rid = int(bool(is_right))
    moge_dir = os.path.join(cfg.moge_out_path, f"{image_id}_cropped_hoi")
    return ImageArtifacts(
        image_id=image_id,
        is_right=bool(is_right),
        original_img=os.path.join(cfg.original_img_dir, f"{image_id}{original_ext}"),
        masked_obj_img=os.path.join(cfg.masked_obj_path, f"{image_id}_masked_obj.png"),
        cropped_hoi=os.path.join(cfg.cropped_hoi_path, f"{image_id}_cropped_hoi_{rid}.png"),
        cropped_hoi_wo_bckg=os.path.join(cfg.cropped_hoi_wo_bckg_path,
                                         f"{image_id}_cropped_hoi_{rid}.png"),
        cropped_obj_mask=os.path.join(cfg.mask_dir_path, f"{image_id}_cropped_obj_mask.png"),
        cropped_hand_mask=os.path.join(cfg.mask_dir_path, f"{image_id}_cropped_hand_mask.png"),
        inpainted_obj=os.path.join(cfg.cropped_inpainted_obj, f"{image_id}_inpainted_{rid}.png"),
        moge_dir=moge_dir,
        moge_mesh=os.path.join(moge_dir, "mesh.ply"),
        moge_fov=os.path.join(moge_dir, "fov.json"),
        hunyuan_hoi_mesh=os.path.join(cfg.hunyuan_hoi_mesh_path, f"{image_id}_hoi_mesh.ply"),
        hamer_npy=os.path.join(cfg.hamer_out_path, f"{image_id}.npy"),
        hamer_kps=os.path.join(cfg.hamer_out_path, f"{image_id}_kps_for_guidance.npy"),
        hamer_mesh=os.path.join(cfg.hamer_out_path, f"{image_id}_hamer.obj"),
        h2m_transform=os.path.join(cfg.h2m_rt_path, f"{image_id}_hoi_mesh.npy"),
        aligned_mano_mesh=os.path.join(cfg.aligned_mano_path,
                                       f"{image_id}_hamer_aligned_mano.ply"),
        guidance_obj=os.path.join(cfg.guidance_out_path, f"{image_id}_obj.ply"),
        guidance_hand=os.path.join(cfg.guidance_out_path, f"{image_id}_hand.ply"),
    )


def parse_cropped_hoi_name(filename: str) -> Tuple[str, bool]:
    """'{id}_cropped_hoi_{is_right}.png' -> (id, is_right)."""
    stem = os.path.basename(filename)
    stem = stem[: stem.rfind(".")] if "." in stem else stem
    parts = stem.split("_")
    return parts[0], parts[-1] == "1"


def should_skip(*paths: str) -> bool:
    """The resume contract: skip work whose outputs all exist."""
    return all(os.path.exists(p) for p in paths)
