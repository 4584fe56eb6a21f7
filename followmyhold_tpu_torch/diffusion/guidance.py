"""Guidance-in-the-loop flow-matching sampler: the core algorithm.

Counterpart of followmyhold_tpu/diffusion/guidance.py. 20 reversed-sigma Euler
steps of the DiT with classifier-free guidance, with optimization phases
injected inside the loop:

  step 9  (handopt_start):  PHASE 1: 200 Adam steps on hand scale/trans/quat;
          losses: 1e-2 kps2D-MSE + normal + 10 disparity + silhouette-BCE
          + 1e-2 trans reg
  step 10:                  PHASE 1.5: 100 AdamW steps on object scale/trans/quat
          + noise prediction; 1 edge + 10 normal + 10 disparity + 100 sil-BCE
          + 1e-3 verts + 1e-2 trans reg
  steps 11..19:             PHASE 2: 50 AdamW steps on all seven jointly;
          + 10 attraction + intersection + HOI-scene normal/disparity/sil
          + 1e-3 * hand losses

followed by the scheduler advancing with the (optimized) noise prediction. The
CFG scale decays as scale*(1 - i/N) after guidance starts.

Phases 1.5 and 2 differentiate, every iteration, through
``step_final`` -> the ShapeVAE grid decode (two-level by default) -> marching
tets -> the pose transform -> the rasterizer, so the flash-attention backward
kernel and both rasterizer kernels run inside them. The joint phase adds an
attraction term (squared nearest-neighbour distances from the hand to the
object, 1 cm margin) and, near the end, a gradient-free intersection count:
the object's occupancy is read from the decoded SDF grid by trilinear lookup,
the hand's by winding number against the MANO mesh.

``export_meshes`` decodes the final latents: up to 256^3 densely with the
device's marching tets, above it (the stage's 384^3) with the two-level
decode (``models.hunyuan.hierarchical_export_logits``) and the host's exact
marching tets (``ops.surface.marching_tets_host``). ``run`` takes a
``utils.debug.DebugDir`` for the reference's loss lines, render snapshots and
mesh dumps. ``run_batch`` runs several images at once: one DiT evaluation a
step for the whole batch, and each optimization phase once for the whole
batch, over a leading image axis (``run`` is the same code on one image).

Where the reference folds each optimizer loop into one compiled scan, this is a
Python loop around ``torch.optim.Adam`` / ``torch.optim.AdamW`` (one parameter
group per learning rate); an empty render or a NaN loss degrades to a zero
contribution instead of an exception.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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
from followmyhold_tpu_torch.models.hunyuan import (
    HunyuanDiT,
    ShapeVAE,
    hierarchical_export_logits,
    vae_query_logits,
    vae_query_logits_hier_grid_batch,
)
from followmyhold_tpu_torch.models.mano import mano_vert_to_3dkps
from followmyhold_tpu_torch.ops.camera import GuidanceCamera
from followmyhold_tpu_torch.ops.grid import generate_dense_grid_points, generate_grid
from followmyhold_tpu_torch.ops.knn import nn_sqdist
from followmyhold_tpu_torch.ops.losses import (
    attraction_loss,
    binary_cross_entropy,
    image_means,
    masked_l1,
    mesh_edge_loss,
    mse,
    normal_alignment_loss,
    verts_reg_loss,
)
from followmyhold_tpu_torch.ops.precision import matmul_f32
from followmyhold_tpu_torch.ops.rasterizer import render_normal_and_disparity
from followmyhold_tpu_torch.ops.sdf import winding_number
from followmyhold_tpu_torch.ops.surface import (
    PaddedMesh,
    marching_tets,
    marching_tets_host,
    mesh_edges,
    vertex_normals,
)
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
    """One image's pose; in the batched phases each leaf leads with B."""

    scale: torch.Tensor  # [1]
    trans: torch.Tensor  # [3]
    quat: torch.Tensor   # [4] wxyz


class GuidanceResult(NamedTuple):
    latents: torch.Tensor
    noise_pred: torch.Tensor
    hand: PoseParams
    obj: PoseParams
    # per-phase loss curves: {"hand": [200], "obj": [100], "joint_11": [50], ...}
    losses: Optional[dict] = None
    # wall seconds (synchronized): {"dit_steps": [N floats], "hand": float,
    # "obj": float, "joint": float (all joint phases together)}
    seconds: Optional[dict] = None


def init_pose(device: DeviceLike = "cuda") -> PoseParams:
    dev = resolve_device(device)
    return PoseParams(
        scale=torch.ones(1, device=dev), trans=torch.zeros(3, device=dev),
        quat=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
    )


def stack_poses(poses: Sequence[PoseParams]) -> PoseParams:
    """B poses -> one whose leaves lead with B."""
    return PoseParams(*(torch.stack(x) for x in zip(*poses)))


def stack_targets(targets: Sequence[GuidanceTargets], camera: GuidanceCamera) -> GuidanceTargets:
    """B images' targets -> one GuidanceTargets whose leaves lead with B. Each
    image keeps its own field of view ([B]; the camera's where an image has
    none), or fov_deg stays None where no image has one."""
    fovs = [t.fov_deg for t in targets]
    fov = None
    if any(f is not None for f in fovs):
        dev = targets[0].t_h2m.device
        fov = torch.stack([torch.as_tensor(camera.fov_deg if f is None else f,
                                           dtype=torch.float32, device=dev).reshape(())
                           for f in fovs])
    return GuidanceTargets(*(torch.stack(x) for x in zip(*(t[:-1] for t in targets))),
                           fov_deg=fov)


def _transform_hand(targets: GuidanceTargets, p: PoseParams) -> torch.Tensor:
    rt = rt_from_quat_trans(p.quat, p.trans)
    return transform_around_center_w_scale(targets.mano_verts_moge, rt, p.scale[..., 0])


def _hand_render_losses(verts, targets: GuidanceTargets, camera: GuidanceCamera,
                        raster_kw: dict, with_sil: bool):
    """A batch's hand renders and the unreduced means of its losses, for the
    caller's ``image_means`` (verts [B,778,3], targets stacked): (kps2d,
    normal, disp, and sil where ``with_sil``), (n01, disp01, RasterOut)."""
    B, V = verts.shape[:2]
    faces = targets.mano_faces
    fmask = torch.ones(faces.shape[:2], device=verts.device)
    mesh = PaddedMesh(verts=verts, faces=faces,
                      vert_mask=torch.ones((B, V), device=verts.device), face_mask=fmask)
    vn = vertex_normals(mesh)
    n01, disp01, out = render_normal_and_disparity(
        camera, verts, faces, vn, fmask, fov_deg=targets.fov_deg,
        device=verts.device, **raster_kw)

    kps3d = mano_vert_to_3dkps(verts, targets.j_regressor)
    kps2d = camera.project(kps3d, fov_deg=targets.fov_deg)[..., :2]

    losses = (mse(kps2d, targets.hamer_2d_kps),
              normal_alignment_loss(n01, targets.moge_normal, targets.hand_mask),
              masked_l1(disp01, targets.moge_disp, targets.hand_mask))
    if with_sil:
        losses += (binary_cross_entropy(out.alpha, targets.hand_mask),)
    return losses, (n01, disp01, out)


def _decode_objects(vae: ShapeVAE, sched: FlowMatchSchedule, step_i: int,
                    noise_pred: torch.Tensor, latents: torch.Tensor, xyz, bbox,
                    octree_res: int, max_verts: int, max_faces: int, chunk: int,
                    hier_cf: int = 0, hier_cap: int = 10240, remat: str = "full",
                    hier_small_cap: Optional[int] = None):
    """step_final -> SDF grids -> padded meshes (hunyuan space) of B images at
    once (noise_pred, latents [B,L,E]): (mesh with leaves [B,...], sdf [B,
    (res+1)^3], each image's capacity indicator), differentiable with respect
    to ``noise_pred``. One decode and one marching tets for the batch; each
    image's mesh is truncated at the capacities on its own.

    ``hier_cf > 1`` takes the two-level decode (exact wherever marching tets
    emits geometry, far fewer geo queries); ``hier_cf`` 0 or 1 the dense one,
    whose indicator is 0. An indicator above ``hier_cap`` means the two-level
    decode kept interpolated background in the cells it missed."""
    x1 = step_final(sched, step_i, noise_pred, latents)
    B = x1.shape[0]
    if hier_cf > 1:
        logits, n_sel = vae_query_logits_hier_grid_batch(
            vae, x1, bbox[0], bbox[1], octree_res, chunk, coarse_factor=hier_cf,
            cell_cap=hier_cap, remat=remat, small_cell_cap=hier_small_cap)
    else:
        logits = vae_query_logits(vae, x1, xyz[None].expand(B, -1, -1), chunk, remat=remat)
        n_sel = [0] * B
    sdf = -logits  # inside < 0
    mesh = marching_tets(sdf, bbox[0], bbox[1], octree_res,
                         max_verts=max_verts, max_faces=max_faces)
    return mesh, sdf, n_sel


def _decode_object(vae: ShapeVAE, sched: FlowMatchSchedule, step_i: int,
                   noise_pred: torch.Tensor, latents: torch.Tensor, *args, **kwargs):
    """``_decode_objects`` of one image (noise_pred, latents [1,L,E]): (mesh,
    sdf [(res+1)^3], capacity indicator)."""
    mesh, sdf, n_sel = _decode_objects(vae, sched, step_i, noise_pred, latents, *args,
                                       **kwargs)
    return PaddedMesh(*(x[0] for x in mesh)), sdf[0], n_sel[0]


def _transform_object(mesh: PaddedMesh, targets: GuidanceTargets,
                      p: PoseParams) -> PaddedMesh:
    v = transform_points(mesh.verts, targets.t_h2m)      # hunyuan -> moge
    rt = rt_from_quat_trans(p.quat, p.trans)
    v = transform_around_center_w_scale(v, rt, p.scale[..., 0], mesh.vert_mask)
    return mesh._replace(verts=v)


def _join_meshes(a_verts, a_faces, a_vmask, a_fmask, b: PaddedMesh) -> PaddedMesh:
    return PaddedMesh(
        verts=torch.cat([a_verts, b.verts], dim=-2),
        faces=torch.cat([a_faces, b.faces + a_verts.shape[-2]], dim=-2),
        vert_mask=torch.cat([a_vmask, b.vert_mask], dim=-1),
        face_mask=torch.cat([a_fmask, b.face_mask], dim=-1),
    )


def _intersection_count(hand_verts, hand_faces, obj_hun: PaddedMesh, obj_verts_posed,
                        obj_sdf_grid, xyz_bbox, octree_res: int, targets: GuidanceTargets,
                        obj_pose: PoseParams, sample_res: int = 32) -> torch.Tensor:
    """Grid points inside both the hand and the object, / 1000; gradient-free
    (call with detached inputs). The grid spans the joint bbox of the hand and
    the posed object. Of one image, or of each image of a batch ([B]; every
    input leads with B).

    ``obj_hun`` is the pre-pose hunyuan-space mesh and ``obj_verts_posed`` the
    posed moge-space verts. The pose inverse pivots on the bbox center of the
    pre-pose moge verts, the center ``_transform_object`` used.
    """
    big = torch.finfo(torch.float32).max
    om = obj_hun.vert_mask[..., None].bool()

    def masked_lo_hi(v):
        return (torch.where(om, v, torch.full_like(v, big)).amin(dim=-2),
                torch.where(om, v, torch.full_like(v, -big)).amax(dim=-2))

    ov_lo, ov_hi = masked_lo_hi(obj_verts_posed)
    lo = torch.minimum(hand_verts.amin(dim=-2), ov_lo)
    hi = torch.maximum(hand_verts.amax(dim=-2), ov_hi)
    pts = generate_grid(lo, hi, sample_res)                       # [(B,)P,3] moge space

    # hand occupancy: winding number against the hand mesh
    inside_hand = winding_number(pts, hand_verts, hand_faces) > 0.5

    # object occupancy: undo the similarity transform, then sample the decoded
    # hunyuan-space SDF grid trilinearly
    rt = rt_from_quat_trans(obj_pose.quat, obj_pose.trans)
    m_lo, m_hi = masked_lo_hi(transform_points(obj_hun.verts, targets.t_h2m))
    center = ((m_lo + m_hi) / 2.0)[..., None, :]
    # p = s*R(q - c) + c + t  =>  q = R^T((p - c - t)/s) + c
    scale = obj_pose.scale[..., 0].clamp(min=1e-6)[..., None, None]
    q = (pts - center - obj_pose.trans[..., None, :]) / scale
    q = matmul_f32(q, rt[..., :3, :3]) + center
    q = transform_points(q, torch.linalg.inv(targets.t_h2m))     # moge -> hunyuan

    n = octree_res + 1
    lo_h, hi_h = xyz_bbox
    u = ((q - lo_h) / (hi_h - lo_h) * octree_res).clamp(0.0, octree_res - 1e-4)
    i0 = torch.floor(u).long()
    f = u - i0
    fx, fy, fz = f.unbind(-1)
    gx, gy, gz = 1 - fx, 1 - fy, 1 - fz

    def g(dx, dy, dz):
        return obj_sdf_grid.gather(
            -1, ((i0[..., 0] + dx) * n + i0[..., 1] + dy) * n + i0[..., 2] + dz)

    sdf_obj = (
        g(0, 0, 0) * gx * gy * gz
        + g(1, 0, 0) * fx * gy * gz
        + g(0, 1, 0) * gx * fy * gz
        + g(0, 0, 1) * gx * gy * fz
        + g(1, 1, 0) * fx * fy * gz
        + g(1, 0, 1) * fx * gy * fz
        + g(0, 1, 1) * gx * fy * fz
        + g(1, 1, 1) * fx * fy * fz
    )
    return torch.sum(inside_hand & (sdf_obj < 0), dim=-1).float() / 1000.0


def _optimize(opt: torch.optim.Optimizer, steps: int, loss_step, n_images: int,
              dev: torch.device):
    """``steps`` optimizer steps on ``loss_step() -> (totals [B], indicators)``:
    one step minimises the sum of the images' totals, where an image's
    non-finite total contributes nothing. The optimizers here (Adam, AdamW)
    are elementwise, so each image's leaves step as under an optimizer of its
    own. -> (loss curves [B, steps], each image's capacity indicators' values
    over the steps)."""
    losses = []
    renders: List[Dict[str, list]] = [{} for _ in range(n_images)]
    for _ in range(steps):
        totals, indicators = loss_step()
        totals = torch.where(torch.isfinite(totals), totals, torch.zeros_like(totals))
        opt.zero_grad(set_to_none=True)
        totals.sum().backward()
        opt.step()
        losses.append(totals.detach())
        for image, ind in zip(renders, indicators):
            for name, value in ind.items():
                image.setdefault(name, []).append(value)
    curve = torch.stack(losses, dim=1) if losses else torch.zeros((n_images, 0), device=dev)
    return curve, renders


_SNAPSHOT_STRIDE = 8   # 512^2 -> 64^2 render snapshots for the debug dumps
# indicator channels that are scalars, not render snapshots
_DIAG_CHANNELS = ("hier_cells", "raster_bins", "raster_cap")


def _indicators(out, n_sel: Optional[List[int]] = None, renders=None) -> List[dict]:
    """Each image's capacity indicators of one iteration of a batch and, when
    ``renders`` = (normal, disparity) is given (a debug run), their
    downsampled copies."""
    inds = []
    for b, bins in enumerate(out.bin_max):
        ind = dict(raster_bins=bins, raster_cap=out.bin_capacity)
        if n_sel is not None:
            ind["hier_cells"] = n_sel[b]
        if renders is not None:
            s = _SNAPSHOT_STRIDE
            ind["normal"] = renders[0][b, ::s, ::s].detach()
            ind["disp"] = renders[1][b, ::s, ::s].detach()
        inds.append(ind)
    return inds


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _guidance_scale(cfg: OptimizationConfig, i: int, n: int) -> float:
    """The CFG scale of step i: it decays as scale * (1 - i/n) after guidance
    starts."""
    if i >= cfg.guidance_start_step + 1:
        return cfg.obj_guidance_scale * (1 - i / n)
    return cfg.obj_guidance_scale


def _phase_at(cfg: OptimizationConfig, i: int):
    """(loss-log tag, phase) of the optimization phase step i runs, or (None,
    None)."""
    if i == cfg.handopt_start_step:
        return "hand", "hand"
    if i == cfg.handopt_start_step + 1:
        return "obj", "obj"
    if i >= cfg.handopt_start_step + 2:
        return f"joint_{i}", "joint"
    return None, None


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
    # in-loop two-level decode: coarse lattice at res/inloop_coarse_factor
    # (0 or 1 = the dense decode); inloop_cell_cap surface cells are refined,
    # the reference's worst case measured on box-filling shapes with margin
    inloop_coarse_factor: int = 2
    inloop_cell_cap: int = 10240
    # the reference's two-tier refine capacity; the refine set is sized to
    # the batch here, so it has no effect (see vae_query_logits_hier_grid_batch)
    inloop_small_cap: Optional[int] = None
    # geo-query rematerialisation in the object/joint phases:
    # 'full' | 'tail' | 'none' (see models.hunyuan._geo_query_grouped)
    vae_remat: str = "none"
    # checkpoint scheduler_config shift, applied to the linspace(0,1) sigmas
    scheduler_shift: float = 1.0
    # export_meshes' resolution when the call names none (None: the config's
    # octree_resolution); the stage passes config.final_octree_resolution
    final_octree_resolution: Optional[int] = None

    # ------------------------------------------------------------------ #

    def _schedule(self, n: int) -> FlowMatchSchedule:
        return make_schedule(sigmas=np.linspace(0, 1, n), shift=self.scheduler_shift)

    def _grid(self, res: int, dev: torch.device):
        xyz, _, _ = generate_dense_grid_points([-self.box_v] * 3, [self.box_v] * 3, res,
                                               device=dev)
        bbox = (torch.tensor([-self.box_v] * 3, device=dev),
                torch.tensor([self.box_v] * 3, device=dev))
        return xyz, bbox

    def _raster_kw(self) -> dict:
        return dict(faces_per_tile=self.raster_faces_per_tile)

    def _hand_raster_kw(self) -> dict:
        return dict(faces_per_tile=min(self.hand_faces_per_tile,
                                       self.raster_faces_per_tile))

    def _warn_capacity(self, tag: str, renders: Optional[dict]) -> None:
        """Post-phase check of the capacity indicators collected over the
        phase's iterations (worst case)."""
        if not renders:
            return
        if renders.get("hier_cells"):
            worst = max(renders["hier_cells"])
            if worst > self.inloop_cell_cap:
                # the indicator is max(cells, points scaled into cell units):
                # either capacity is raised with inloop_cell_cap
                print(f"WARNING: in-loop hier decode capacity overflow (cells or refine "
                      f"points) at {tag}: {worst}/{self.inloop_cell_cap} — missed points "
                      f"kept interpolated values; raise inloop_cell_cap")
        if renders.get("raster_bins"):
            worst = max(renders["raster_bins"])
            cap = min(renders["raster_cap"])
            if worst > cap:
                print(f"WARNING: rasterizer bin overflow at {tag}: {worst}/{cap} faces in "
                      f"the densest tile — overflow faces were DROPPED (wrong pixels and "
                      f"gradients there); raise raster_faces_per_tile")

    def _warn_capacity_batch(self, tag: str, renders: List[dict]) -> None:
        """``_warn_capacity`` of each image of a batched phase, named."""
        for b, image in enumerate(renders):
            self._warn_capacity(f"{tag} (batched), image {b}", image)

    def _decode(self, noise, latents, sched, step_i, xyz, bbox):
        """The in-loop decode of B images (noise, latents [B,L,E])."""
        return _decode_objects(
            self.vae, sched, step_i, noise, latents, xyz, bbox,
            self.config.octree_resolution, self.max_verts, self.max_faces, self.vae_chunk,
            self.inloop_coarse_factor, self.inloop_cell_cap, self.vae_remat,
            self.inloop_small_cap)

    # The phases run over a leading image axis: PoseParams leaves [B,...],
    # noise_pred and latents [B,L,E], targets stacked (stack_targets), one
    # render, decode and marching tets a step for all images, each image's
    # losses reduced on their own. -> leaves [B,...], loss curves [B, steps]
    # and each image's indicators. ``_hand_phase``, ``_obj_phase`` and
    # ``_joint_phase`` are their calls on one image.

    # phase 1: hand only ------------------------------------------------ #

    def _hand_phase_batch(self, hand: PoseParams, targets: GuidanceTargets,
                          snapshot: bool = False
                          ) -> Tuple[PoseParams, torch.Tensor, List[Dict[str, list]]]:
        cfg = self.config
        lrs = cfg.phase1_hand_lrs
        scale, trans, quat = (x.detach().clone().requires_grad_(True) for x in hand)
        # one Adam, three learning rates; eps sits outside the bias-corrected
        # square root, as in the reference's optimizer
        opt = torch.optim.Adam(
            [{"params": [scale], "lr": lrs.scale},
             {"params": [trans], "lr": lrs.trans},
             {"params": [quat], "lr": lrs.rot}], eps=1e-4)

        def loss_step():
            verts = _transform_hand(targets, PoseParams(scale, trans, quat))
            terms, (n01, disp01, out) = _hand_render_losses(
                verts, targets, self.camera, self._hand_raster_kw(), with_sil=True)
            kps2d, normal, disp, sil = image_means(*terms)
            total = (
                1e-2 * kps2d
                + 1.0 * normal
                + 10.0 * disp
                + 1.0 * sil
                + 1e-2 * torch.mean(trans ** 2, dim=-1)
            )
            return total, _indicators(out, renders=(n01, disp01) if snapshot else None)

        curve, renders = _optimize(opt, cfg.optimization_steps_hand, loss_step,
                                   scale.shape[0], scale.device)
        return PoseParams(scale.detach(), trans.detach(), quat.detach()), curve, renders

    def _hand_phase(self, hand: PoseParams, targets: GuidanceTargets, snapshot: bool = False
                    ) -> Tuple[PoseParams, torch.Tensor, Dict[str, list]]:
        hand, curve, renders = self._hand_phase_batch(
            stack_poses([hand]), stack_targets([targets], self.camera), snapshot)
        return PoseParams(*(x[0] for x in hand)), curve[0], renders[0]

    # phase 1.5: object transform + noise -------------------------------- #

    def _obj_phase_batch(self, obj: PoseParams, noise_pred: torch.Tensor,
                         latents: torch.Tensor, targets: GuidanceTargets,
                         sched: FlowMatchSchedule, step_i: int, snapshot: bool = False):
        cfg = self.config
        lrs = cfg.obj_2half_lrs
        dev = latents.device
        scale, trans, quat = (x.detach().clone().requires_grad_(True) for x in obj)
        noise = noise_pred.detach().clone().requires_grad_(True)
        # torch decays p by lr*wd before the Adam step; the reference adds
        # wd*p to the update: the same arithmetic
        opt = torch.optim.AdamW(
            [{"params": [scale], "lr": lrs.scale},
             {"params": [trans], "lr": lrs.trans},
             {"params": [quat], "lr": lrs.rot},
             {"params": [noise], "lr": cfg.noise_obj_lr1}], eps=1e-4, weight_decay=0.01)
        xyz, bbox = self._grid(cfg.octree_resolution, dev)

        def loss_step():
            mesh, _, n_sel = self._decode(noise, latents, sched, step_i, xyz, bbox)
            tmesh = _transform_object(mesh, targets, PoseParams(scale, trans, quat))
            vn = vertex_normals(tmesh)
            n01, disp01, out = render_normal_and_disparity(
                self.camera, tmesh.verts, tmesh.faces, vn, tmesh.face_mask,
                fov_deg=targets.fov_deg, device=dev, **self._raster_kw())
            edges, emask = mesh_edges(tmesh.faces, tmesh.face_mask)
            edge, normal, disp, sil, reg = image_means(
                mesh_edge_loss(tmesh.verts, edges, emask),
                normal_alignment_loss(n01, targets.moge_normal, targets.obj_mask),
                masked_l1(disp01, targets.moge_disp, targets.obj_mask),
                binary_cross_entropy(out.alpha, targets.obj_mask),
                verts_reg_loss(tmesh.verts, tmesh.vert_mask))
            total = (
                1.0 * edge
                + 10.0 * normal
                + 10.0 * disp
                + 100.0 * sil
                + 1e-3 * reg
                + 1e-2 * torch.mean(trans ** 2, dim=-1)
            )
            return total, _indicators(out, n_sel, (n01, disp01) if snapshot else None)

        curve, renders = _optimize(opt, cfg.optimization_steps_scale, loss_step,
                                   noise.shape[0], dev)
        return (PoseParams(scale.detach(), trans.detach(), quat.detach()), noise.detach(),
                curve, renders)

    def _obj_phase(self, obj: PoseParams, noise_pred: torch.Tensor, latents: torch.Tensor,
                   targets: GuidanceTargets, sched: FlowMatchSchedule, step_i: int,
                   snapshot: bool = False):
        """One image: noise_pred and latents [1,L,E]."""
        obj, noise, curve, renders = self._obj_phase_batch(
            stack_poses([obj]), noise_pred, latents, stack_targets([targets], self.camera),
            sched, step_i, snapshot)
        return PoseParams(*(x[0] for x in obj)), noise, curve[0], renders[0]

    # phase 2: joint ----------------------------------------------------- #

    def _joint_phase_batch(self, hand: PoseParams, obj: PoseParams, noise_pred: torch.Tensor,
                           latents: torch.Tensor, targets: GuidanceTargets,
                           sched: FlowMatchSchedule, step_i: int, near_end: bool,
                           snapshot: bool = False):
        cfg = self.config
        h_lrs, o_lrs = cfg.phase2_hand_lrs, cfg.obj_lrs
        dev = latents.device
        hp = PoseParams(*(x.detach().clone().requires_grad_(True) for x in hand))
        op = PoseParams(*(x.detach().clone().requires_grad_(True) for x in obj))
        noise = noise_pred.detach().clone().requires_grad_(True)
        opt = torch.optim.AdamW(
            [{"params": [hp.scale], "lr": h_lrs.scale},
             {"params": [hp.trans], "lr": h_lrs.trans},
             {"params": [hp.quat], "lr": h_lrs.rot},
             {"params": [op.scale], "lr": o_lrs.scale},
             {"params": [op.trans], "lr": o_lrs.trans},
             {"params": [op.quat], "lr": o_lrs.rot},
             {"params": [noise], "lr": cfg.noise_obj_lr2}], eps=1e-4, weight_decay=0.01)
        xyz, bbox = self._grid(cfg.octree_resolution, dev)
        hoi_mask = targets.hand_mask | targets.obj_mask
        B = noise.shape[0]
        hand_vmask = torch.ones(targets.mano_verts_moge.shape[:2], device=dev)
        hand_fmask = torch.ones(targets.mano_faces.shape[:2], device=dev)

        def loss_step():
            hand_verts = _transform_hand(targets, hp)
            h_terms, _ = _hand_render_losses(hand_verts, targets, self.camera,
                                             self._hand_raster_kw(), with_sil=False)

            mesh, sdf, n_sel = self._decode(noise, latents, sched, step_i, xyz, bbox)
            tmesh = _transform_object(mesh, targets, op)

            # attraction: squared NN distances hand -> object, clamp(d - 1cm);
            # the gradient flows through the hand verts only
            d2, _ = nn_sqdist(hand_verts, tmesh.verts.detach(), tmesh.vert_mask)
            # an empty object mesh leaves huge sentinel distances: clamp, and
            # zero the term
            has_obj = (tmesh.vert_mask.sum(dim=-1) > 0)[:, None]
            d2 = torch.where(has_obj, d2.clamp(max=1e6), torch.zeros_like(d2))

            # the count is gradient-free; away from the end its weight is 1e-9,
            # numerically irrelevant, so it is computed only near the end
            if cfg.use_intersection_loss and near_end:
                inter = _intersection_count(
                    hand_verts.detach(), targets.mano_faces,
                    PaddedMesh(*(x.detach() for x in mesh)), tmesh.verts.detach(),
                    sdf.detach(), bbox, cfg.octree_resolution, targets,
                    PoseParams(*(x.detach() for x in op)))
            else:
                inter = torch.zeros(B, device=dev)
            if near_end:
                w_inter = torch.where(d2.mean(dim=-1) < 0.001, 1e-5, 1e-9)
            else:
                w_inter = 1e-9

            hoi = _join_meshes(hand_verts, targets.mano_faces, hand_vmask, hand_fmask, tmesh)
            vn = vertex_normals(hoi)
            n01, disp01, out = render_normal_and_disparity(
                self.camera, hoi.verts, hoi.faces, vn, hoi.face_mask,
                fov_deg=targets.fov_deg, device=dev, **self._raster_kw())

            edges, emask = mesh_edges(tmesh.faces, tmesh.face_mask)
            # one reduction for all of the iteration's means, the hand's included
            (h_kps2d, h_normal, h_disp, distance_loss, normal, disp, sil, reg,
             edge) = image_means(
                *h_terms,
                attraction_loss(d2, margin=0.01),
                normal_alignment_loss(n01, targets.moge_normal, hoi_mask),
                masked_l1(disp01, targets.moge_disp),
                binary_cross_entropy(out.alpha, hoi_mask),
                verts_reg_loss(tmesh.verts, tmesh.vert_mask),
                mesh_edge_loss(tmesh.verts, edges, emask))
            hand_loss = (
                1e-4 * h_kps2d
                + 10.0 * h_normal
                + 10.0 * h_disp
                + 1e-2 * torch.mean(hp.trans ** 2, dim=-1)
            )
            total = (
                w_inter * inter
                + 10.0 * distance_loss
                + 10.0 * normal
                + 10.0 * disp
                + 10.0 * sil
                + 1e-3 * reg
                + 1.0 * edge
                + 1e-3 * torch.mean(op.trans ** 2, dim=-1)
                + 1e-3 * hand_loss
            )
            return total, _indicators(out, n_sel, (n01, disp01) if snapshot else None)

        curve, renders = _optimize(opt, cfg.optimization_steps_joint, loss_step, B, dev)
        return (PoseParams(*(x.detach() for x in hp)), PoseParams(*(x.detach() for x in op)),
                noise.detach(), curve, renders)

    def _joint_phase(self, hand: PoseParams, obj: PoseParams, noise_pred: torch.Tensor,
                     latents: torch.Tensor, targets: GuidanceTargets,
                     sched: FlowMatchSchedule, step_i: int, near_end: bool,
                     snapshot: bool = False):
        """One image: noise_pred and latents [1,L,E]."""
        hand, obj, noise, curve, renders = self._joint_phase_batch(
            stack_poses([hand]), stack_poses([obj]), noise_pred, latents,
            stack_targets([targets], self.camera), sched, step_i, near_end, snapshot)
        return (PoseParams(*(x[0] for x in hand)), PoseParams(*(x[0] for x in obj)), noise,
                curve[0], renders[0])

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
        debug=None,                  # Optional[utils.debug.DebugDir]
    ) -> GuidanceResult:
        """The guided sampling loop. The initial latents are ``initial_noise``
        or drawn from ``generator``; the models must already lie on
        ``device``. With an enabled ``debug`` directory, each phase writes its
        loss every 10 iterations and its last, render snapshots every 10
        iterations, and the joint phases and step 14 the reference's render
        and mesh dumps."""
        dumps = debug is not None and debug.enabled
        cfg = self.config
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
        seconds: dict = {"dit_steps": [], "hand": 0.0, "obj": 0.0, "joint": 0.0}
        noise_pred = torch.zeros_like(latents)
        for i in range(n):
            _sync(dev)
            t0 = time.perf_counter()
            noise_pred = cfg_noise_pred(
                self.dit, cond_cat, latents,
                sched.timesteps[i] / sched.num_train_timesteps, _guidance_scale(cfg, i, n))
            _sync(dev)
            seconds["dit_steps"].append(time.perf_counter() - t0)

            t0 = time.perf_counter()
            tag, phase = _phase_at(cfg, i)
            if phase == "hand":
                hand, curve, renders = self._hand_phase(hand, targets, snapshot=dumps)
            elif phase == "obj":
                obj, noise_pred, curve, renders = self._obj_phase(
                    obj, noise_pred, latents, targets, sched, i, snapshot=dumps)
            elif phase == "joint":
                hand, obj, noise_pred, curve, renders = self._joint_phase(
                    hand, obj, noise_pred, latents, targets, sched, i, near_end=i >= n - 3,
                    snapshot=dumps)
            if tag is not None:
                _sync(dev)
                seconds[phase] += time.perf_counter() - t0
                loss_log[tag] = curve
                self._warn_capacity(tag, renders)
                if dumps:
                    _debug_log_phase(debug, tag, curve, renders)
                    if phase == "joint":
                        self._debug_render_dump(debug, f"step{i:02d}", hand, obj, noise_pred,
                                                latents, targets, sched, i)
            # the intermediate mesh of step 14 (the original pipeline's dump)
            if dumps and i == min(14, n - 2):
                self._debug_mesh_dump(debug, f"step{i:02d}", noise_pred, latents, sched, i)

            latents = step(sched, i, noise_pred, latents)[0]

        return GuidanceResult(latents=latents, noise_pred=noise_pred, hand=hand, obj=obj,
                              losses=loss_log, seconds=seconds)

    def run_batch(
        self,
        cond_main: torch.Tensor,     # [B,1,M,C]
        uncond_main: torch.Tensor,   # [B,1,M,C]
        targets: Sequence[GuidanceTargets],
        latent_shape: Tuple[int, int],
        initial_noise: Optional[torch.Tensor] = None,            # [B,1,*latent_shape]
        generators: Optional[Sequence[torch.Generator]] = None,  # one per image
        device: DeviceLike = "cuda",
        debugs: Optional[Sequence] = None,                       # a DebugDir per image
        mesh=None,                   # a DeviceMesh with a "dp" axis
    ) -> GuidanceResult:
        """The guided loop over B images at once. Each image keeps its own
        targets, and with them its own field of view; its initial latents are
        its slice of ``initial_noise`` or a draw from its generator, as
        ``run`` draws them. The DiT runs once a step for all images (batch
        2B with the guidance pairs) and the CFG scale decays as in ``run``.
        Each optimization phase runs once a step for all images too
        (``_hand_phase_batch``, ``_obj_phase_batch``, ``_joint_phase_batch``):
        one render, decode and marching tets an iteration for the batch, each
        image's losses on their own, one optimizer over the stacked leaves;
        the sizes they read back to the host are read once for the batch.
        Capacity warnings name the image and carry "(batched)"; each image's
        debug directory gets its own loss lines and render snapshots.
        -> a GuidanceResult whose leaves lead with B; ``losses[tag]`` is
        [B, iterations].

        With a ``mesh`` (``parallel.make_mesh``), every rank calls it with the
        whole batch's inputs and runs the images of its dp index (B must
        divide by dp), each with its own slice of ``initial_noise`` or its own
        generator; the leaves are then gathered over dp, so every rank returns
        the result of the run without a mesh (``seconds`` stays its own). A
        failure on any rank of the axis raises on all of them."""
        if mesh is not None and "dp" in (mesh.mesh_dim_names or ()):
            return self._run_batch_sharded(
                mesh, cond_main, uncond_main, targets, latent_shape, initial_noise,
                generators, device, debugs)
        cfg = self.config
        dev = resolve_device(device)
        n = cfg.num_inference_steps
        B = cond_main.shape[0]
        sched = self._schedule(n)
        if initial_noise is not None:
            latents = initial_noise.to(dev, torch.float32).reshape(B, *latent_shape)
        else:
            latents = torch.cat([torch.randn((1, *latent_shape), generator=gen, device=dev)
                                 for gen in generators])
        targets = stack_targets([t.to(dev) for t in targets], self.camera)
        debugs = list(debugs) if debugs is not None else [None] * B
        dumps = [d is not None and d.enabled for d in debugs]
        hand = obj = stack_poses([init_pose(dev)] * B)
        # [cond of every image; uncond of every image] against [latents; latents]
        cond_cat = torch.cat([cond_main[:, 0], uncond_main[:, 0]], dim=0).to(dev)

        loss_log: dict = {}
        seconds: dict = {"dit_steps": [], "hand": 0.0, "obj": 0.0, "joint": 0.0}
        noise_pred = torch.zeros_like(latents)
        for i in range(n):
            _sync(dev)
            t0 = time.perf_counter()
            noise_pred = cfg_noise_pred(
                self.dit, cond_cat, latents, sched.timesteps[i] / sched.num_train_timesteps,
                _guidance_scale(cfg, i, n))
            _sync(dev)
            seconds["dit_steps"].append(time.perf_counter() - t0)

            tag, phase = _phase_at(cfg, i)
            if tag is not None:
                t0 = time.perf_counter()
                snapshot = any(dumps)
                if phase == "hand":
                    hand, curves, renders = self._hand_phase_batch(hand, targets,
                                                                   snapshot=snapshot)
                elif phase == "obj":
                    obj, noise_pred, curves, renders = self._obj_phase_batch(
                        obj, noise_pred, latents, targets, sched, i, snapshot=snapshot)
                else:
                    hand, obj, noise_pred, curves, renders = self._joint_phase_batch(
                        hand, obj, noise_pred, latents, targets, sched, i,
                        near_end=i >= n - 3, snapshot=snapshot)
                _sync(dev)
                seconds[phase] += time.perf_counter() - t0
                loss_log[tag] = curves
                for b in range(B):
                    if dumps[b]:
                        _debug_log_phase(debugs[b], tag, curves[b], renders[b])
                self._warn_capacity_batch(tag, renders)

            latents = step(sched, i, noise_pred, latents)[0]

        return GuidanceResult(latents=latents[:, None], noise_pred=noise_pred[:, None],
                              hand=hand, obj=obj, losses=loss_log, seconds=seconds)

    def _run_batch_sharded(self, mesh, cond_main, uncond_main, targets, latent_shape,
                           initial_noise, generators, device, debugs) -> GuidanceResult:
        """``run_batch`` on this rank's images, its leaves gathered over dp."""
        from followmyhold_tpu_torch.parallel.mesh import batch_sharding

        shard = batch_sharding(mesh, "dp")

        def part(x):
            return None if x is None else shard.shard(x if torch.is_tensor(x) else list(x))

        local, error = None, None
        try:
            local = self.run_batch(
                part(cond_main), part(uncond_main), part(targets), latent_shape,
                initial_noise=part(initial_noise), generators=part(generators),
                device=device, debugs=part(debugs))
        except Exception as e:      # every rank learns of it before the gather
            error = e
        if not shard.all_ok(error is None):
            if error is not None:
                raise error
            raise RuntimeError("GuidedSampler.run_batch failed on another rank of the mesh")

        def poses(p):
            return PoseParams(*(shard.gather(x) for x in p))

        return GuidanceResult(
            latents=shard.gather(local.latents), noise_pred=shard.gather(local.noise_pred),
            hand=poses(local.hand), obj=poses(local.obj),
            losses={tag: shard.gather(c) for tag, c in local.losses.items()},
            seconds=local.seconds)

    @torch.no_grad()
    def _debug_mesh_dump(self, debug, tag, noise_pred, latents, sched, step_i):
        """Decode the current x1 estimate at the in-loop resolution and dump it."""
        res = self.config.octree_resolution
        xyz, bbox = self._grid(res, latents.device)
        mesh, _, _ = self._decode(noise_pred, latents, sched, step_i, xyz, bbox)
        mesh = PaddedMesh(*(x[0] for x in mesh))
        nv, nf = int(mesh.num_verts), int(mesh.num_faces)
        if nf > 0:
            debug.dump_mesh(f"{tag}_obj.ply", mesh.verts[:nv].cpu().numpy(),
                            mesh.faces[:nf].cpu().numpy())

    @torch.no_grad()
    def _debug_render_dump(self, debug, tag, hand, obj, noise_pred, latents, targets, sched,
                           step_i):
        """Normal and disparity renders of the current hand-object scene, as
        .npy maps (after each joint phase)."""
        dev = latents.device
        hand_verts = _transform_hand(targets, hand)
        xyz, bbox = self._grid(self.config.octree_resolution, dev)
        mesh, _, _ = self._decode(noise_pred, latents, sched, step_i, xyz, bbox)
        tmesh = _transform_object(PaddedMesh(*(x[0] for x in mesh)), targets, obj)
        hoi = _join_meshes(hand_verts, targets.mano_faces,
                           torch.ones(hand_verts.shape[0], device=dev),
                           torch.ones(targets.mano_faces.shape[0], device=dev), tmesh)
        n01, disp01, _ = render_normal_and_disparity(
            self.camera, hoi.verts, hoi.faces, vertex_normals(hoi), hoi.face_mask,
            fov_deg=targets.fov_deg, device=dev, **self._raster_kw())
        debug.dump_array(f"{tag}_normal.npy", n01.cpu().numpy())
        debug.dump_array(f"{tag}_disp.npy", disp01.cpu().numpy())

    @torch.no_grad()
    def export_meshes(
        self, result: GuidanceResult, targets: GuidanceTargets,
        octree_resolution: Optional[int] = None,
        max_verts: Optional[int] = None, max_faces: Optional[int] = None,
        device_res_limit: int = 256,
        device: DeviceLike = "cuda",
    ) -> Tuple[PaddedMesh, torch.Tensor]:
        """Final decode and the transformed meshes in moge space: (posed object
        mesh, posed hand verts).

        Up to ``device_res_limit`` the grid is decoded densely and the surface
        extracted on the device into static capacities. Above it the two-level
        decode runs on the device, its compose and an exact-shape marching
        tets on the host (a 385^3 grid's edge tables would not fit static
        buffers); the mesh then has exactly its own size.
        """
        dev = resolve_device(device)
        res = octree_resolution or self.final_octree_resolution or self.config.octree_resolution
        targets = targets.to(dev)
        latents = result.latents.to(dev)
        lo, hi = [-self.box_v] * 3, [self.box_v] * 3
        if res <= device_res_limit:
            xyz, bbox = self._grid(res, dev)
            mv = max_verts or self.max_verts
            mf = max_faces or self.max_faces
            sdf = -vae_query_logits(self.vae, latents, xyz[None], self.vae_chunk)[0]
            mesh = marching_tets(sdf, bbox[0], bbox[1], res, max_verts=mv, max_faces=mf)
            check_surface_capacity(sdf, res, mv, mf)
        else:
            sdf = -hierarchical_export_logits(self.vae, latents, self.box_v, res,
                                              chunk=self.vae_chunk)
            hv, hf = marching_tets_host(sdf, lo, hi, res)
            verts = torch.from_numpy(hv if len(hv) else np.zeros((1, 3), np.float32)).to(dev)
            faces = torch.from_numpy(hf if len(hf) else np.zeros((1, 3), np.int32)).to(dev)
            mesh = PaddedMesh(verts=verts, faces=faces.long(),
                              vert_mask=torch.full((verts.shape[0],), float(len(hv) > 0),
                                                   device=dev),
                              face_mask=torch.full((faces.shape[0],), float(len(hf) > 0),
                                                   device=dev))
        obj_mesh = _transform_object(mesh, targets, PoseParams(*(x.to(dev) for x in result.obj)))
        hand_verts = _transform_hand(targets, PoseParams(*(x.to(dev) for x in result.hand)))
        return obj_mesh, hand_verts


def _debug_log_phase(debug, tag: str, curve: torch.Tensor, renders: Dict[str, list]) -> None:
    """A phase's loss every 10 iterations and its last, and its render
    snapshots every 10 iterations, into the debug directory."""
    arr = curve.float().cpu().numpy()
    for it in range(0, len(arr), 10):
        debug.log_loss(f"{tag} iter {it}: loss {arr[it]:.6f}")
    if len(arr):
        debug.log_loss(f"{tag} final: loss {arr[-1]:.6f}")
    for name, stack in (renders or {}).items():
        if name in _DIAG_CHANNELS or not stack:
            continue
        snaps = torch.stack(stack[::10]).cpu().numpy()
        debug.dump_array(f"{tag}_{name}_grid.npy", snaps)
