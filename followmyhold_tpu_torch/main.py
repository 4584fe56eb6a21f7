"""The pipeline's orchestrator: stages 1-9 from one photo, in one process.

Counterpart of followmyhold_tpu/main.py, with its stage order, its
``run_inpaint`` switch, its environment variables and directories:

1. object naming (``preprocess/gemini_objname``; skipped when the env file
   names a GEMINI_RESPONSES CSV);
2. detection, crop and segmentation (``preprocess/get_hunyuan_input``);
3. hand-removal inpainting (``preprocess/inpaint``; RUN_INPAINT=1);
4. MoGe geometry (``geometry/moge``);
5. the Hunyuan HOI mesh (``geometry/hunyuan``);
6. HaMeR (``hand/hamer``);
7. Hunyuan -> MoGe alignment (``alignment/h2m``);
8. MANO -> Hunyuan alignment (``alignment/mano``);
9. the guided reconstruction (``guidance/run``), on the inpainted object
   (or the masked one without stage 3).

Every stage runs on ``device`` and skips the images whose outputs exist, so
a second run on the same directories does no work. Each stage loads the
converted checkpoints under ``<assets>/params/`` where they exist and draws
seeded random weights where they do not.

    python -m followmyhold_tpu_torch.main --config <env file> [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import warnings

from followmyhold_tpu_torch.configs import PipelineConfig, load_config
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device


def run_pipeline(cfg: PipelineConfig, device: DeviceLike = "cuda") -> None:
    """Stages 1-9 over the configuration's images."""
    # The reference turns on XLA's persistent compilation cache here. The port
    # has no such cache: its CUDA kernels are built once into build/ by
    # ops/_kernels.py (rebuilt only when a source changes), which plays its part.
    dev = resolve_device(device)
    if cfg.suppress_warnings:
        warnings.filterwarnings("ignore", category=FutureWarning)
        warnings.filterwarnings("ignore", category=UserWarning)
    os.environ["FOHO_PROJECT_ROOT"] = cfg.project_root
    if cfg.assets_dir:
        os.environ["FOHO_TPU_ASSETS"] = cfg.assets_dir

    for path in cfg.output_dirs().values():
        os.makedirs(path, exist_ok=True)

    gemini_csv = cfg.gemini_responses or os.path.join(cfg.base_dir, "gemini_responses.csv")

    # 1. object naming
    if not cfg.gemini_responses:
        from followmyhold_tpu_torch.preprocess import gemini_objname

        gemini_objname.run(out_csv=gemini_csv, split_path=cfg.split_path,
                           image_path=cfg.image_path)

    # 2. HOI input generation
    from followmyhold_tpu_torch.preprocess import get_hunyuan_input

    get_hunyuan_input.run(
        occ_img_dir=cfg.masked_obj_path,
        cropped_img_dir=cfg.cropped_hoi_path,
        cropped_img_wo_bckg_dir=cfg.cropped_hoi_wo_bckg_path,
        mask_dir=cfg.mask_dir_path,
        original_img_dir=cfg.original_img_dir,
        split_path=cfg.split_path,
        image_path=cfg.image_path,
        gemini_responses=gemini_csv,
        project_root=cfg.project_root,
        device=dev,
    )

    # 3. inpainting
    if cfg.run_inpaint:
        from followmyhold_tpu_torch.preprocess import inpaint

        inpaint.run(save_dir=cfg.cropped_inpainted_obj, cropped_img_dir=cfg.cropped_hoi_path,
                    gemini_responses=gemini_csv, mask_dir=cfg.mask_dir_path, device=dev)

    # 4. MoGe geometry
    from followmyhold_tpu_torch.geometry import moge

    moge.run(input_dir=cfg.cropped_hoi_wo_bckg_path, output_dir=cfg.moge_out_path,
             project_root=cfg.project_root, device=dev)

    # 5. the Hunyuan HOI mesh
    from followmyhold_tpu_torch.geometry import hunyuan

    hunyuan.run(image_dir=cfg.cropped_hoi_wo_bckg_path, save_dir=cfg.hunyuan_hoi_mesh_path,
                project_root=cfg.project_root, device=dev)

    # 6. HaMeR
    from followmyhold_tpu_torch.hand import hamer

    hamer.run(img_folder=cfg.cropped_hoi_path, out_folder=cfg.hamer_out_path,
              full_img_dir=cfg.original_img_dir, mask_dir=cfg.mask_dir_path, save_mesh=True,
              device=dev)

    # 7. Hunyuan -> MoGe alignment
    from followmyhold_tpu_torch.alignment import h2m

    h2m.run(hunyuan_mesh_dir=cfg.hunyuan_hoi_mesh_path, moge_out_dir=cfg.moge_out_path,
            h2m_rt_dir=cfg.h2m_rt_path, device=dev)

    # 8. MANO -> Hunyuan alignment
    from followmyhold_tpu_torch.alignment import mano as mano_align

    mano_align.run(hamer_out_dir=cfg.hamer_out_path, hunyuan_mesh_dir=cfg.hunyuan_hoi_mesh_path,
                   aligned_mano_dir=cfg.aligned_mano_path, device=dev)

    # 9. the guided reconstruction
    from followmyhold_tpu_torch.guidance import run as guidance_run

    guidance_run.run(
        project_root=cfg.project_root,
        cropped_obj_img_dir=(cfg.cropped_inpainted_obj if cfg.run_inpaint
                             else cfg.masked_obj_path),
        mask_dir=cfg.mask_dir_path,
        moge_out_dir=cfg.moge_out_path,
        hunyuan_hoi_mesh_dir=cfg.hunyuan_hoi_mesh_path,
        hamer_out_dir=cfg.hamer_out_path,
        h2m_rt_dir=cfg.h2m_rt_path,
        aligned_mano_dir=cfg.aligned_mano_path,
        guidance_out_dir=cfg.guidance_out_path,
        device=dev,
    )


def main() -> None:
    parser = argparse.ArgumentParser(description="FollowMyHold: stages 1-9 from a photo")
    parser.add_argument("--config", required=True, help="the KEY=VALUE env file")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run_pipeline(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
