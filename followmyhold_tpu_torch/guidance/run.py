"""The guidance stage: per image, the guided sampler, then {id}_obj.ply and
{id}_hand.ply.

Counterpart of followmyhold_tpu/guidance/run.py, with the same artifact
inputs (the inpainted object crop, the masks, the MoGe mesh and fov.json, the
HaMeR keypoints, the aligned MANO mesh, the hand-to-MoGe transform), the same
outputs, the same skip-and-continue, task-list sharding and flags. Per image:

1. ``build_targets``: the aligned MANO mesh taken into MoGe space, and the
   MoGe mesh rendered (through the rasterizer kernels) into the masked normal
   and disparity targets;
2. ``encode_condition``: the DINOv2-G conditioner on the crop;
3. ``GuidedSampler.run``;
4. ``_export_and_write``: the 384^3 export (two-level decode on the device,
   compose and marching tets on the host), floater and degenerate-face
   removal, face reduction, the PLY writes.

``run`` overlaps one image's export (host-bound) with the next image's
sampler in a one-worker pool, as the reference does. With ``batch_size > 1``
(``--batch_size``) it groups the images into batches (``_run_batched``), and
``run_batch_images`` takes each batch through one ``GuidedSampler.run_batch``
(the DiT and each optimization phase once a step for the batch) and the
exports through a two-worker pool, so that one image's host extraction
overlaps the other's device decode.

On several cards, one process a card (``torchrun``): the ranks form a dp mesh
over each batch (``parallel.make_mesh``; dp is the largest divisor of the
batch no larger than the ranks, a short last batch takes a smaller one), each
rank runs its images and writes their files, and ``run_batch`` gathers the
results. With ``--batch_size 1`` the ranks take the images in turn. The
backend is NCCL on cards and gloo on the CPU (``--device cpu``).

    python -m followmyhold_tpu_torch.guidance.run --project_root R \\
        --cropped_obj_img_dir ... --mask_dir ... --moge_out_dir ... \\
        --hunyuan_hoi_mesh_dir ... --hamer_out_dir ... --h2m_rt_dir ... \\
        --aligned_mano_dir ... --guidance_out_dir ... [--batch_size 2] [--device cuda]
    torchrun --nproc_per_node=N -m followmyhold_tpu_torch.guidance.run ... --batch_size B
"""

from __future__ import annotations

import argparse
import json
import os
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from PIL import Image

from followmyhold_tpu_torch.configs.guidance import OptimizationConfig
from followmyhold_tpu_torch.configs.profiles import guidance_mesh_caps, optimization_config
from followmyhold_tpu_torch.diffusion.guidance import (
    GuidanceResult,
    GuidanceTargets,
    GuidedSampler,
    PoseParams,
)
from followmyhold_tpu_torch.geometry.hunyuan import build_models, encode_condition
from followmyhold_tpu_torch.geometry.postprocess import (
    reduce_faces,
    remove_degenerate_faces,
    remove_floaters,
)
from followmyhold_tpu_torch.models.mano import load_mano
from followmyhold_tpu_torch.ops.camera import GuidanceCamera
from followmyhold_tpu_torch.ops.rasterizer import render_normal_and_disparity
from followmyhold_tpu_torch.ops.surface import PaddedMesh, vertex_normals
from followmyhold_tpu_torch.utils.debug import DebugDir
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device
from followmyhold_tpu_torch.utils.mesh_io import load_mesh, pad_mesh, write_ply
from followmyhold_tpu_torch.utils.params import scheduler_shift
from followmyhold_tpu_torch.utils.prng import SEED_GUIDANCE, stage_generator


def _load_mask(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("L")) > 0


@torch.no_grad()
def build_targets(
    camera: GuidanceCamera,
    mano_mesh_path: str,
    t_h2m_path: str,
    moge_mesh_path: str,
    hand_mask: np.ndarray,
    obj_mask: np.ndarray,
    hamer_kps_path: str,
    j_regressor: np.ndarray,
    moge_mesh_max_verts: int = 196608,
    moge_mesh_max_faces: int = 393216,
    device: DeviceLike = "cuda",
) -> GuidanceTargets:
    """The per-image guidance inputs: the aligned MANO mesh in MoGe space, and
    the MoGe mesh (packed at the reference's caps) rendered into the normal
    and disparity targets, masked to the hand and object."""
    dev = resolve_device(device)
    t_h2m = np.load(t_h2m_path).astype(np.float32)
    mano_mesh = load_mesh(mano_mesh_path)
    mano_verts_moge = mano_mesh.vertices @ t_h2m[:3, :3].T + t_h2m[:3, 3]

    mv, mf, nv, nf = pad_mesh(load_mesh(moge_mesh_path), moge_mesh_max_verts,
                              moge_mesh_max_faces)
    pm = PaddedMesh(
        verts=torch.from_numpy(mv).to(dev), faces=torch.from_numpy(mf).to(dev).long(),
        vert_mask=(torch.arange(moge_mesh_max_verts, device=dev) < nv).float(),
        face_mask=(torch.arange(moge_mesh_max_faces, device=dev) < nf).float())
    moge_normal, moge_disp, out = render_normal_and_disparity(
        camera, pm.verts, pm.faces, vertex_normals(pm), pm.face_mask, device=dev)
    if out.bin_max > out.bin_capacity:
        print(f"WARNING: build_targets: {out.bin_max} MoGe faces in the densest tile, above "
              f"the rasterizer's {out.bin_capacity}; faces were dropped from the targets")
    hoi_mask = torch.from_numpy(hand_mask | obj_mask).to(dev)
    moge_normal = moge_normal * hoi_mask[..., None]
    moge_disp = moge_disp * hoi_mask

    kps = np.load(hamer_kps_path, allow_pickle=True).item()
    hamer_2d = np.asarray(kps["mano_2d_kps"], np.float32).reshape(-1, 2)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a if dtype is None else a.astype(dtype)))

    return GuidanceTargets(
        mano_verts_moge=t(mano_verts_moge, np.float32),
        mano_faces=t(mano_mesh.faces, np.int64),
        j_regressor=t(np.asarray(j_regressor), np.float32),
        hamer_2d_kps=t(hamer_2d),
        moge_normal=moge_normal,
        moge_disp=moge_disp,
        hand_mask=t(hand_mask),
        obj_mask=t(obj_mask),
        t_h2m=t(t_h2m),
        fov_deg=torch.tensor(camera.fov_deg, dtype=torch.float32),
    ).to(dev)


def _pose_scale(result, targets) -> float:
    """How many times its decoded size the exported object is: the object
    pose's scale times that of the hunyuan -> moge similarity (the cube root
    of its determinant)."""
    s = abs(float(result.obj.scale.reshape(-1)[0]))
    sigma = abs(float(torch.linalg.det(targets.t_h2m[:3, :3].double().cpu()))) ** (1.0 / 3.0)
    return s * sigma


def _export_and_write(sampler: GuidedSampler, result, targets, config: OptimizationConfig,
                      cropped_obj_img_path: str, save_path_obj: str, save_path_hand: str,
                      debug=None, device: DeviceLike = "cuda"):
    """The final export, the post-processing and the PLY writes: the
    host-bound tail of an image, which ``run`` overlaps with the next image's
    sampler. -> ((verts, faces), hand verts), or (None, None) for an empty
    mesh."""
    obj_mesh, hand_verts = sampler.export_meshes(
        result, targets, octree_resolution=config.final_octree_resolution, device=device)
    nv, nf = int(obj_mesh.num_verts), int(obj_mesh.num_faces)
    if nv == 0:
        print(f"Empty mesh for {cropped_obj_img_path}")
        if debug is not None:
            debug.close()
        return None, None
    verts = obj_mesh.verts[:nv].cpu().numpy()
    faces = obj_mesh.faces[:nf].cpu().numpy().astype(np.int32)
    verts, faces = remove_floaters(verts, faces)
    # the reference's threshold (1e-12 on the squared cross product), taken in
    # the decoded mesh's frame: applied to the posed mesh as the reference
    # applies it, it removes every face of an object posed below about a sixth
    # of its decoded size (ROADMAP §3)
    verts, faces = remove_degenerate_faces(verts, faces,
                                           eps=1e-12 * _pose_scale(result, targets) ** 4)
    # the quadric decimation assumes a closed mesh: the export is closed
    # wherever it stays inside the decode box
    verts, faces = reduce_faces(verts, faces)
    hand = hand_verts.cpu().numpy()
    write_ply(save_path_obj, verts, faces)
    write_ply(save_path_hand, hand, targets.mano_faces.cpu().numpy())
    if debug is not None:
        debug.close()
    return (verts, faces), hand


def run_hunyuan_w_guid(
    cropped_obj_img_path: str,
    fovx: float,
    hamer_for_guid_path: str,
    aligned_mano_mesh_path: str,
    cropped_obj_mask_path: str,
    cropped_hand_mask_path: str,
    moge_mesh_path: str,
    T_h2m_path: str,
    hunyuan_hoi_mesh_path: str,  # accepted and unused, as in the original pipeline
    save_path_obj: str,
    save_path_hand: str,
    config: OptimizationConfig,
    models=None,
    j_regressor: Optional[np.ndarray] = None,
    export_pool=None,
    initial_noise: Optional[torch.Tensor] = None,
    device: DeviceLike = "cuda",
):
    """One image through the stage. ``models`` is ``build_models()``'s
    (dit, vae, conditioner) on ``device``; ``initial_noise`` replaces the
    stage generator's draw (to hold the port against another run). With an
    ``export_pool`` the export is submitted there and its future returned."""
    dev = resolve_device(device)
    hand_mask = _load_mask(cropped_hand_mask_path)
    obj_mask = _load_mask(cropped_obj_mask_path)
    H, W = hand_mask.shape
    camera = GuidanceCamera(height=H, width=W, fov_deg=float(fovx))

    if models is None:
        models = build_models(device=dev)
    dit, vae, cond = models
    if j_regressor is None:
        j_regressor = load_mano(device="cpu").j_regressor.numpy()

    image_id = os.path.basename(cropped_obj_img_path).split("_")[0]
    debug = DebugDir(f"exp_obj{image_id}_inpainted")
    debug.dump_params(dict(config.as_dict()))

    targets = build_targets(camera, aligned_mano_mesh_path, T_h2m_path, moge_mesh_path,
                            hand_mask, obj_mask, hamer_for_guid_path, j_regressor, device=dev)
    rgba = np.asarray(Image.open(cropped_obj_img_path).convert("RGBA"))
    cond_main, uncond_main = encode_condition(cond, rgba, device=dev)

    sampler = GuidedSampler(dit=dit, vae=vae, camera=camera, config=config,
                            scheduler_shift=scheduler_shift(), **guidance_mesh_caps())
    result = sampler.run(cond_main, uncond_main, targets,
                         (vae.cfg.num_latents, vae.cfg.embed_dim), initial_noise=initial_noise,
                         generator=stage_generator(SEED_GUIDANCE, "guidance", image_id, dev),
                         device=dev, debug=debug)

    def _export():
        return _export_and_write(sampler, result, targets, config, cropped_obj_img_path,
                                 save_path_obj, save_path_hand, debug, device=dev)

    if export_pool is not None:
        return export_pool.submit(_export)
    return _export()


def run_batch_images(image_jobs: Sequence[dict], config: OptimizationConfig, models,
                     j_regressor: Optional[np.ndarray] = None, device: DeviceLike = "cuda",
                     mesh=None):
    """Several images through the stage at once: per image ``build_targets``
    (with its own field of view), ``encode_condition`` and the initial noise
    of its own stage stream, as ``run_hunyuan_w_guid`` draws it; then one
    ``GuidedSampler.run_batch``; then the exports through a two-worker pool
    (the native library's calls release the interpreter lock, so one image's
    host extraction overlaps the other's device decode). ``image_jobs`` are
    dicts of ``run_hunyuan_w_guid``'s path arguments and ``fovx``. With a dp
    ``mesh`` every rank of it calls this with the whole batch: ``run_batch``
    runs each rank's images, and each rank exports and writes its own images
    only. -> each image's ``_export_and_write`` result (None for an image
    another rank owns)."""
    dev = resolve_device(device)
    owned = range(len(image_jobs))
    if mesh is not None:
        from followmyhold_tpu_torch.parallel.mesh import batch_sharding

        if tuple(mesh.mesh_dim_names or ()) != ("dp",):
            raise ValueError(f"run_batch_images takes a dp mesh, not {mesh.mesh_dim_names}")
        sharding = batch_sharding(mesh, "dp")
        owned = range(*sharding.bounds(len(image_jobs)))
    dit, vae, cond = models
    if j_regressor is None:
        j_regressor = load_mano(device="cpu").j_regressor.numpy()

    cameras, targets, conds, unconds, generators, debugs = [], [], [], [], [], []
    error = None
    try:
        for job in image_jobs:
            hand_mask = _load_mask(job["cropped_hand_mask_path"])
            obj_mask = _load_mask(job["cropped_obj_mask_path"])
            H, W = hand_mask.shape
            camera = GuidanceCamera(height=H, width=W, fov_deg=float(job["fovx"]))
            cameras.append(camera)
            targets.append(build_targets(
                camera, job["aligned_mano_mesh_path"], job["T_h2m_path"], job["moge_mesh_path"],
                hand_mask, obj_mask, job["hamer_for_guid_path"], j_regressor, device=dev))
            rgba = np.asarray(Image.open(job["cropped_obj_img_path"]).convert("RGBA"))
            cond_main, uncond_main = encode_condition(cond, rgba, device=dev)
            conds.append(cond_main)
            unconds.append(uncond_main)
            image_id = os.path.basename(job["cropped_obj_img_path"]).split("_")[0]
            generators.append(stage_generator(SEED_GUIDANCE, "guidance", image_id, dev))
            debugs.append(DebugDir(f"exp_obj{image_id}_inpainted"))
    except Exception as e:       # the mesh's other ranks learn of it before run_batch
        error = e
    if mesh is not None and not sharding.all_ok(error is None) and error is None:
        raise RuntimeError("preparing the batch failed on another rank of the mesh")
    if error is not None:
        raise error

    # the crops share their size; each image's field of view rides in its targets
    sampler = GuidedSampler(dit=dit, vae=vae, camera=cameras[0], config=config,
                            scheduler_shift=scheduler_shift(), **guidance_mesh_caps())
    result = sampler.run_batch(torch.stack(conds), torch.stack(unconds), targets,
                               (vae.cfg.num_latents, vae.cfg.embed_dim), generators=generators,
                               device=dev, debugs=debugs, mesh=mesh)

    def export_one(b: int, job: dict):
        res = GuidanceResult(latents=result.latents[b], noise_pred=result.noise_pred[b],
                             hand=PoseParams(*(x[b] for x in result.hand)),
                             obj=PoseParams(*(x[b] for x in result.obj)))
        return _export_and_write(sampler, res, targets[b], config, job["cropped_obj_img_path"],
                                 job["save_path_obj"], job["save_path_hand"], device=dev)

    try:
        with ThreadPoolExecutor(max_workers=min(2, len(owned))) as pool:
            futures = {b: pool.submit(export_one, b, image_jobs[b]) for b in owned}
            return [futures[b].result() if b in futures else None
                    for b in range(len(image_jobs))]
    finally:
        for debug in debugs:
            debug.close()


def _load_task_list(task_list_file: Optional[str], cropped_obj_img_dir: str) -> List[str]:
    """The images of this task: chunk ``SLURM_ARRAY_TASK_ID`` of a JSON task
    list, or every file of the crop directory."""
    if task_list_file and os.path.exists(task_list_file):
        with open(task_list_file, "r", encoding="utf-8") as f:
            chunks = json.load(f)
        return chunks[int(os.environ.get("SLURM_ARRAY_TASK_ID", 0))]
    return sorted(os.listdir(cropped_obj_img_dir))


def _report_failure(what: str, exc: BaseException) -> None:
    """Print an image's failure with its traceback and carry on."""
    print(f"Error in processing {what} : {exc}")
    traceback.print_exception(type(exc), exc, exc.__traceback__)


def _job_paths(name: str, cropped_obj_img_dir: str, mask_dir: str, moge_out_dir: str,
               hunyuan_hoi_mesh_dir: str, hamer_out_dir: str, h2m_rt_dir: str,
               aligned_mano_dir: str, guidance_out_dir: str) -> dict:
    """The files of one image: ``run_hunyuan_w_guid``'s path arguments, its
    fov.json and its id."""
    image_id = name.split("_")[0]
    moge_dir = os.path.join(moge_out_dir, f"{image_id}_cropped_hoi")
    return dict(
        cropped_obj_img_path=os.path.join(cropped_obj_img_dir, name),
        cropped_hand_mask_path=os.path.join(mask_dir, f"{image_id}_cropped_hand_mask.png"),
        cropped_obj_mask_path=os.path.join(mask_dir, f"{image_id}_cropped_obj_mask.png"),
        moge_mesh_path=os.path.join(moge_dir, "mesh.ply"),
        moge_fov_path=os.path.join(moge_dir, "fov.json"),
        T_h2m_path=os.path.join(h2m_rt_dir, f"{image_id}_hoi_mesh.npy"),
        aligned_mano_mesh_path=os.path.join(aligned_mano_dir,
                                            f"{image_id}_hamer_aligned_mano.ply"),
        hamer_for_guid_path=os.path.join(hamer_out_dir, f"{image_id}_kps_for_guidance.npy"),
        hunyuan_hoi_mesh_path=os.path.join(hunyuan_hoi_mesh_dir, f"{image_id}_hoi_mesh.ply"),
        save_path_obj=os.path.join(guidance_out_dir, f"{image_id}_obj.ply"),
        save_path_hand=os.path.join(guidance_out_dir, f"{image_id}_hand.ply"),
        image_id=image_id,
    )


def _read_fovx(job: dict) -> float:
    with open(job["moge_fov_path"], "r", encoding="utf-8") as f:
        return float(json.load(f)["fov_x"])


def _masks_empty(job: dict) -> bool:
    return not (_load_mask(job["cropped_hand_mask_path"]).any()
                and _load_mask(job["cropped_obj_mask_path"]).any())


def _done(job: dict) -> bool:
    return os.path.exists(job["save_path_obj"]) and os.path.exists(job["save_path_hand"])


def run(
    project_root: str,
    cropped_obj_img_dir: str,
    mask_dir: str,
    moge_out_dir: str,
    hunyuan_hoi_mesh_dir: str,
    hamer_out_dir: str,
    h2m_rt_dir: str,
    aligned_mano_dir: str,
    guidance_out_dir: str,
    task_list_file: Optional[str] = None,
    shard_index: int = 0,
    shard_count: int = 1,
    batch_size: int = 1,
    device: DeviceLike = "cuda",
) -> None:
    """Every assigned image through the stage, one at a time or, with
    ``batch_size > 1``, in batches; an image whose outputs exist, or whose
    masks are empty, is skipped, and a failing image (or batch) is reported
    with its traceback without stopping the others."""
    dev = resolve_device(device)
    config = optimization_config()
    os.makedirs(guidance_out_dir, exist_ok=True)
    assigned = _load_task_list(task_list_file, cropped_obj_img_dir)[shard_index::shard_count]
    dirs = (cropped_obj_img_dir, mask_dir, moge_out_dir, hunyuan_hoi_mesh_dir, hamer_out_dir,
            h2m_rt_dir, aligned_mano_dir, guidance_out_dir)

    models = build_models(device=dev)
    j_reg_path = os.path.join(hamer_out_dir, "J_regressor_hamer.npy")
    j_regressor = np.load(j_reg_path) if os.path.exists(j_reg_path) else None

    if batch_size > 1:
        _run_batched(assigned, batch_size, config, models, j_regressor, dirs, dev)
        return
    world, rank = _world()
    if world > 1:
        # one image at a time: the ranks take the images in turn
        assigned = assigned[rank::world]
        print(f"rank {rank} of {world}: {len(assigned)} images, one at a time")

    pool = ThreadPoolExecutor(max_workers=1)
    prev = None        # (image_id, export future)

    def _finish(entry):
        if entry is None:
            return
        iid, fut = entry
        try:
            obj, _ = fut.result()
            print(f"Error in reconstruction for {iid}" if obj is None
                  else f"Reconstructed object {iid}")
        except Exception as e:
            _report_failure(iid, e)

    for name in assigned:
        try:
            job = _job_paths(name, *dirs)
            image_id = job.pop("image_id")
            if _done(job):
                print(f"{image_id} already exists, skipping")
                continue
            fovx = _read_fovx(job)
            if _masks_empty(job):
                print(f"Skipping {image_id} due to empty mask")
                continue

            print(f"Processing {image_id}")
            job.pop("moge_fov_path")
            fut = run_hunyuan_w_guid(**job, fovx=fovx, config=config, models=models,
                                     j_regressor=j_regressor, export_pool=pool, device=dev)
            # the previous image's export ran behind this image's sampler
            _finish(prev)
            prev = (image_id, fut)
        except Exception as e:
            _report_failure(name, e)
            continue

    _finish(prev)
    pool.shutdown(wait=True)
    print("Finished processing all images")


# the files an image of a batch must have
_NEEDED = ("cropped_hand_mask_path", "cropped_obj_mask_path", "moge_mesh_path", "moge_fov_path",
           "T_h2m_path", "aligned_mano_mesh_path", "hamer_for_guid_path")


def _world() -> tuple:
    """(world size, rank) of the process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _run_batched(assigned: Sequence[str], batch_size: int, config: OptimizationConfig, models,
                 j_regressor: Optional[np.ndarray], dirs: Sequence[str],
                 device: DeviceLike = "cuda") -> None:
    """The runnable images (outputs missing, every input present, masks not
    empty) through ``run_batch_images`` in batches of ``batch_size``; a
    failing batch is reported with its traceback and the next one runs.

    In a process group every rank walks the same batches: a batch runs on a
    dp mesh of the first dp ranks (``_mesh_for``), or on rank 0 alone where
    dp would be 1; the other ranks skip it."""
    dev = resolve_device(device)
    world, rank = _world()
    meshes: dict = {}

    def _mesh_for(n_images: int):
        # dp divides the batch, so that each rank of the mesh holds as many
        # images; a short last batch gets a smaller mesh
        if world <= 1:
            return None
        from followmyhold_tpu_torch.parallel.mesh import make_mesh

        dp = min(world, n_images)
        while n_images % dp:
            dp -= 1
        if dp == 1:
            return None
        if dp not in meshes:     # every rank makes it, in the same order
            meshes[dp] = make_mesh(f"dp={dp}", ranks=range(dp), device_type=dev.type,
                                   backend=dist.get_backend())
        return meshes[dp]

    pending = []
    for name in assigned:
        job = _job_paths(name, *dirs)
        if _done(job):
            print(f"{job['image_id']} already exists, skipping")
            continue
        if not all(os.path.exists(job[k]) for k in _NEEDED):
            print(f"Skipping {job['image_id']}: missing artifacts")
            continue
        if _masks_empty(job):
            print(f"Skipping {job['image_id']} due to empty mask")
            continue
        job["fovx"] = _read_fovx(job)
        pending.append(job)

    for i in range(0, len(pending), batch_size):
        batch = pending[i:i + batch_size]
        ids = [job["image_id"] for job in batch]
        try:
            mesh = _mesh_for(len(batch))
            if (rank >= mesh.size()) if mesh is not None else rank > 0:
                continue         # the batch runs on other ranks
            print("Batch:", ids, "" if world == 1 else
                  f"(rank {rank}, dp={1 if mesh is None else mesh.size()})")
            run_batch_images(batch, config, models, j_regressor, device=dev, mesh=mesh)
        except Exception as e:
            print(f"Error in batch {ids}: {e}")
            traceback.print_exception(type(e), e, e.__traceback__)
    print("Finished processing all images")


def main() -> None:
    parser = argparse.ArgumentParser(description="Guided shape reconstruction")
    parser.add_argument("--project_root", required=True)
    parser.add_argument("--cropped_obj_img_dir", required=True)
    parser.add_argument("--mask_dir", required=True)
    parser.add_argument("--moge_out_dir", required=True)
    parser.add_argument("--hunyuan_hoi_mesh_dir", required=True)
    parser.add_argument("--hamer_out_dir", required=True)
    parser.add_argument("--h2m_rt_dir", required=True)
    parser.add_argument("--aligned_mano_dir", required=True)
    parser.add_argument("--guidance_out_dir", required=True)
    parser.add_argument("--task_list_file", default=None)
    parser.add_argument("--shard_index", type=int, default=0)
    parser.add_argument("--shard_count", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=1,
                        help="images per sampler run")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    device = _launch(args.device, args.batch_size)
    try:
        run(args.project_root, args.cropped_obj_img_dir, args.mask_dir, args.moge_out_dir,
            args.hunyuan_hoi_mesh_dir, args.hamer_out_dir, args.h2m_rt_dir,
            args.aligned_mano_dir, args.guidance_out_dir, args.task_list_file,
            args.shard_index, args.shard_count, args.batch_size, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _launch(device: str, batch_size: int) -> torch.device:
    """This process's device. Under ``torchrun`` (WORLD_SIZE > 1) it joins
    the process group (NCCL for a card, gloo for the CPU, as the device asks)
    and binds the card of its local rank; alone it runs on ``device``, and
    says once how to run on every visible card."""
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend=backend)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                  % torch.cuda.device_count())
            dev = torch.device("cuda", torch.cuda.current_device())
        print(f"rank {dist.get_rank()} of {world} on {dev} ({backend})")
    elif dev.type == "cuda" and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        print(f"{n} cards are visible and this process runs on {dev} alone; to run on all "
              f"of them: torchrun --nproc_per_node={n} -m followmyhold_tpu_torch.guidance.run "
              f"... --batch_size {max(batch_size, n)}")
    return dev


if __name__ == "__main__":
    main()
