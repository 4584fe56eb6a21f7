"""Guidance-in-the-loop flow-matching sampler: the core algorithm.

Counterpart of followmyhold_tpu/diffusion/guidance.py. 20 reversed-sigma Euler
steps of the DiT with classifier-free guidance, with optimization phases
injected inside the loop:

  step 9  (handopt_start):  PHASE 1: 200 Adam steps on hand scale/trans/quat;
          losses: 1e-2 kps2D-MSE + normal + 10 disparity + silhouette-BCE
          + 1e-2 trans reg
  step 10:                  PHASE 1.5: object pose + noise prediction
  steps 11..19:             PHASE 2: hand, object and noise jointly

followed by the scheduler advancing with the (optimized) noise prediction. The
CFG scale decays as scale*(1 - i/N) after guidance starts.

Ported so far: the DiT loop with the CFG decay, phase 1 complete, the
scheduler advance and ``export_meshes`` on the device path. Phases 1.5 and 2
differentiate through the ShapeVAE decode and need the flash-attention
backward kernel; until they are ported ``run`` raises for a configuration that
asks for them (``optimization_steps_scale`` or ``optimization_steps_joint``
above 0) rather than skipping them.

Where the reference folds each optimizer loop into one compiled scan, this is a
Python loop around ``torch.optim.Adam``; an empty render or a NaN loss degrades
to a zero contribution instead of an exception.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from followmyhold_tpu_torch.configs.guidance import OptimizationConfig
from followmyhold_tpu_torch.diffusion.pipeline import cfg_noise_pred, check_surface_capacity
from followmyhold_tpu_torch.diffusion.scheduler import (
    FlowMatchSchedule,
    make_schedule,
    step,
    step_final,
)
from followmyhold_tpu_torch.models.hunyuan import HunyuanDiT, ShapeVAE, vae_query_logits
from followmyhold_tpu_torch.models.mano import mano_vert_to_3dkps
from followmyhold_tpu_torch.ops.camera import GuidanceCamera
from followmyhold_tpu_torch.ops.grid import generate_dense_grid_points
from followmyhold_tpu_torch.ops.losses import (
    binary_cross_entropy,
    masked_l1,
    mse,
    normal_alignment_loss,
)
from followmyhold_tpu_torch.ops.rasterizer import render_normal_and_disparity
from followmyhold_tpu_torch.ops.surface import PaddedMesh, marching_tets, vertex_normals
from followmyhold_tpu_torch.ops.transforms import (
    rt_from_quat_trans,
    transform_around_center_w_scale,
    transform_points,
)
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device


class GuidanceTargets(NamedTuple):
    """Per-image inputs, all precomputed (moge/scene space)."""

    mano_verts_moge: torch.Tensor   # [778,3] aligned MANO verts in moge space
    mano_faces: torch.Tensor        # [Fh,3]
    j_regressor: torch.Tensor       # [16,778]
    hamer_2d_kps: torch.Tensor      # [21,2] image space
    moge_normal: torch.Tensor       # [H,W,3] target normal map (masked, 0-1)
    moge_disp: torch.Tensor         # [H,W] target disparity (masked, 0-1)
    hand_mask: torch.Tensor         # [H,W] bool
    obj_mask: torch.Tensor          # [H,W] bool
    t_h2m: torch.Tensor             # [4,4] hunyuan -> moge transform
    # per-image horizontal fov; None -> camera.fov_deg
    fov_deg: Optional[torch.Tensor] = None

    def to(self, device) -> "GuidanceTargets":
        return GuidanceTargets(*(None if x is None else x.to(device) for x in self))


class PoseParams(NamedTuple):
    scale: torch.Tensor  # [1]
    trans: torch.Tensor  # [3]
    quat: torch.Tensor   # [4] wxyz


class GuidanceResult(NamedTuple):
    latents: torch.Tensor
    noise_pred: torch.Tensor
    hand: PoseParams
    obj: PoseParams
    # per-phase loss curves: {"hand": [200], ...}
    losses: Optional[dict] = None
    # wall seconds (synchronized): {"dit_steps": [N floats], "hand": float}
    seconds: Optional[dict] = None


def init_pose(device: DeviceLike = "cuda") -> PoseParams:
    dev = resolve_device(device)
    return PoseParams(
        scale=torch.ones(1, device=dev), trans=torch.zeros(3, device=dev),
        quat=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
    )


def _transform_hand(targets: GuidanceTargets, p: PoseParams) -> torch.Tensor:
    rt = rt_from_quat_trans(p.quat, p.trans)
    return transform_around_center_w_scale(targets.mano_verts_moge, rt, p.scale[0])


def _hand_render_losses(verts, targets: GuidanceTargets, camera: GuidanceCamera,
                        raster_kw: dict, with_sil: bool):
    faces = targets.mano_faces
    fmask = torch.ones(faces.shape[0], device=verts.device)
    mesh = PaddedMesh(verts=verts, faces=faces,
                      vert_mask=torch.ones(verts.shape[0], device=verts.device),
                      face_mask=fmask)
    vn = vertex_normals(mesh)
    n01, disp01, out = render_normal_and_disparity(
        camera, verts, faces, vn, fmask, fov_deg=targets.fov_deg,
        device=verts.device, **raster_kw)

    kps3d = mano_vert_to_3dkps(verts, targets.j_regressor)
    kps2d = camera.project(kps3d, fov_deg=targets.fov_deg)[:, :2]

    losses = {
        "kps2d": mse(kps2d, targets.hamer_2d_kps),
        "normal": normal_alignment_loss(n01, targets.moge_normal, targets.hand_mask),
        "disp": masked_l1(disp01, targets.moge_disp, targets.hand_mask),
        "trans_reg": torch.zeros((), device=verts.device),  # filled by the caller
    }
    if with_sil:
        losses["sil"] = binary_cross_entropy(out.alpha, targets.hand_mask)
    return losses, (n01, disp01, out)


@torch.no_grad()
def _decode_object(vae: ShapeVAE, sched: FlowMatchSchedule, step_i: int,
                   noise_pred: torch.Tensor, latents: torch.Tensor, xyz, bbox,
                   octree_res: int, max_verts: int, max_faces: int, chunk: int):
    """step_final -> SDF grid -> padded mesh (hunyuan space), plus the grid.
    Dense decode, without autograd: the two-level decode and the
    differentiable decode are not ported yet."""
    x1 = step_final(sched, step_i, noise_pred, latents)
    sdf = -vae_query_logits(vae, x1, xyz[None], chunk)[0]  # inside < 0
    mesh = marching_tets(sdf, bbox[0], bbox[1], octree_res,
                         max_verts=max_verts, max_faces=max_faces)
    return mesh, sdf


def _transform_object(mesh: PaddedMesh, targets: GuidanceTargets,
                      p: PoseParams) -> PaddedMesh:
    v = transform_points(mesh.verts, targets.t_h2m)      # hunyuan -> moge
    rt = rt_from_quat_trans(p.quat, p.trans)
    v = transform_around_center_w_scale(v, rt, p.scale[0], mesh.vert_mask)
    return mesh._replace(verts=v)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass(frozen=True)
class GuidedSampler:
    """Bundles models + static config; run() drives the sampling loop."""

    dit: HunyuanDiT
    vae: ShapeVAE
    camera: GuidanceCamera
    config: OptimizationConfig = OptimizationConfig()
    box_v: float = 1.10
    # sized for box-filling objects at 65^3; larger surfaces are truncated
    # and export_meshes warns
    max_verts: int = 32768
    max_faces: int = 65536
    vae_chunk: int = 8192
    # most faces one pixel tile keeps: overflow DROPS faces (wrong pixels AND
    # wrong gradients in the densest tiles); RasterOut.bin_max makes it
    # observable and _warn_capacity reports it
    raster_faces_per_tile: int = 24576
    # hand-only renders draw the 1538-face MANO mesh; a capacity >= the face
    # count can never overflow
    hand_faces_per_tile: int = 2048
    # checkpoint scheduler_config shift, applied to the linspace(0,1) sigmas
    scheduler_shift: float = 1.0

    # ------------------------------------------------------------------ #

    def _schedule(self, n: int) -> FlowMatchSchedule:
        return make_schedule(sigmas=np.linspace(0, 1, n), shift=self.scheduler_shift)

    def _grid(self, res: int, dev: torch.device):
        xyz, _, _ = generate_dense_grid_points([-self.box_v] * 3, [self.box_v] * 3, res,
                                               device=dev)
        bbox = (torch.tensor([-self.box_v] * 3, device=dev),
                torch.tensor([self.box_v] * 3, device=dev))
        return xyz, bbox

    def _hand_raster_kw(self) -> dict:
        return dict(faces_per_tile=min(self.hand_faces_per_tile,
                                       self.raster_faces_per_tile))

    def _warn_capacity(self, tag: str, renders: Optional[dict]) -> None:
        """Post-phase check of the capacity indicators collected over the
        phase's iterations (worst case)."""
        if not renders or not renders.get("raster_bins"):
            return
        worst = max(renders["raster_bins"])
        cap = min(renders["raster_cap"])
        if worst > cap:
            print(f"WARNING: rasterizer bin overflow at {tag}: {worst}/{cap} faces in "
                  f"the densest tile — overflow faces were DROPPED (wrong pixels and "
                  f"gradients there); raise raster_faces_per_tile")

    # phase 1: hand only ------------------------------------------------ #

    def _hand_phase(self, hand: PoseParams, targets: GuidanceTargets
                    ) -> Tuple[PoseParams, torch.Tensor, Dict[str, list]]:
        cfg = self.config
        lrs = cfg.phase1_hand_lrs
        scale, trans, quat = (x.detach().clone().requires_grad_(True) for x in hand)
        # one Adam, three learning rates; eps sits outside the bias-corrected
        # square root, as in the reference's optimizer
        opt = torch.optim.Adam(
            [{"params": [scale], "lr": lrs.scale},
             {"params": [trans], "lr": lrs.trans},
             {"params": [quat], "lr": lrs.rot}], eps=1e-4)
        losses = []
        renders: Dict[str, list] = {"raster_bins": [], "raster_cap": []}
        for _ in range(cfg.optimization_steps_hand):
            p = PoseParams(scale, trans, quat)
            verts = _transform_hand(targets, p)
            terms, (_, _, out) = _hand_render_losses(
                verts, targets, self.camera, self._hand_raster_kw(), with_sil=True)
            total = (
                1e-2 * terms["kps2d"]
                + 1.0 * terms["normal"]
                + 10.0 * terms["disp"]
                + 1.0 * terms["sil"]
                + 1e-2 * torch.mean(trans ** 2)
            )
            total = torch.where(torch.isfinite(total), total, torch.zeros_like(total))
            opt.zero_grad(set_to_none=True)
            total.backward()
            opt.step()
            losses.append(total.detach())
            renders["raster_bins"].append(out.bin_max)
            renders["raster_cap"].append(out.bin_capacity)
        curve = torch.stack(losses) if losses else torch.zeros(0, device=scale.device)
        return PoseParams(scale.detach(), trans.detach(), quat.detach()), curve, renders

    # main loop ----------------------------------------------------------- #

    def run(
        self,
        cond_main: torch.Tensor,     # [1,M,C]
        uncond_main: torch.Tensor,   # [1,M,C]
        targets: GuidanceTargets,
        latent_shape: Tuple[int, int],
        initial_noise: Optional[torch.Tensor] = None,   # [1, *latent_shape]
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = "cuda",
    ) -> GuidanceResult:
        """The guided sampling loop. The initial latents are ``initial_noise``
        or drawn from ``generator``; the models must already lie on
        ``device``."""
        cfg = self.config
        if cfg.optimization_steps_scale > 0 or cfg.optimization_steps_joint > 0:
            raise NotImplementedError(
                "the object phase (optimization_steps_scale) and the joint phase "
                "(optimization_steps_joint) are not ported yet: they differentiate "
                "through the ShapeVAE decode and need the flash-attention backward "
                "kernel. Set both to 0 to run the DiT loop, the hand phase and the export.")
        dev = resolve_device(device)
        n = cfg.num_inference_steps
        sched = self._schedule(n)
        if initial_noise is not None:
            latents = initial_noise.to(dev, torch.float32)
        else:
            latents = torch.randn((1, *latent_shape), generator=generator, device=dev)
        targets = targets.to(dev)
        hand, obj = init_pose(dev), init_pose(dev)
        cond_cat = torch.cat([cond_main, uncond_main], dim=0).to(dev)

        loss_log: dict = {}
        seconds: dict = {"dit_steps": [], "hand": 0.0}
        noise_pred = torch.zeros_like(latents)
        for i in range(n):
            # CFG decay after guidance starts
            if i >= cfg.guidance_start_step + 1:
                g = cfg.obj_guidance_scale * (1 - i / n)
            else:
                g = cfg.obj_guidance_scale
            _sync(dev)
            t0 = time.perf_counter()
            noise_pred = cfg_noise_pred(
                self.dit, cond_cat, latents,
                sched.timesteps[i] / sched.num_train_timesteps, g)
            _sync(dev)
            seconds["dit_steps"].append(time.perf_counter() - t0)

            if i == cfg.handopt_start_step:
                t0 = time.perf_counter()
                hand, curve, renders = self._hand_phase(hand, targets)
                _sync(dev)
                seconds["hand"] = time.perf_counter() - t0
                loss_log["hand"] = curve
                self._warn_capacity("hand", renders)

            latents = step(sched, i, noise_pred, latents)[0]

        return GuidanceResult(latents=latents, noise_pred=noise_pred, hand=hand, obj=obj,
                              losses=loss_log, seconds=seconds)

    def export_meshes(
        self, result: GuidanceResult, targets: GuidanceTargets,
        octree_resolution: Optional[int] = None,
        max_verts: Optional[int] = None, max_faces: Optional[int] = None,
        device: DeviceLike = "cuda",
    ) -> Tuple[PaddedMesh, torch.Tensor]:
        """Final decode and the transformed meshes in moge space: (posed object
        mesh, posed hand verts). The surface is extracted on the device into
        static capacities; resolutions above 256 need the sparse two-level
        export, which is not ported yet."""
        dev = resolve_device(device)
        res = octree_resolution or self.config.octree_resolution
        if res > 256:
            raise NotImplementedError(
                "export above 256^3 needs the hierarchical decode, which is not ported yet")
        targets = targets.to(dev)
        xyz, bbox = self._grid(res, dev)
        mv = max_verts or self.max_verts
        mf = max_faces or self.max_faces
        sdf = -vae_query_logits(self.vae, result.latents.to(dev), xyz[None],
                                self.vae_chunk)[0]
        mesh = marching_tets(sdf, bbox[0], bbox[1], res, max_verts=mv, max_faces=mf)
        check_surface_capacity(sdf, res, mv, mf)
        obj_mesh = _transform_object(mesh, targets, PoseParams(*(x.to(dev) for x in result.obj)))
        hand_verts = _transform_hand(targets, PoseParams(*(x.to(dev) for x in result.hand)))
        return obj_mesh, hand_verts
