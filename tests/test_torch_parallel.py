"""The port's device mesh (followmyhold_tpu_torch/parallel/mesh.py) and its
paths, on the CPU with gloo: ranks are spawned processes (one torch thread
each) that meet through a file in a temporary directory.

Against the JAX package: ``parse_mesh_shape`` on the same specs; the layout
that ``shard_model_params`` chooses (column-parallel, row-parallel or whole)
for every kernel of the tiny DiT and ShapeVAE, read from the JAX function's
own shardings on a virtual-device mesh; and the dry run's train step
(``entry.dryrun_multichip`` at dp=2 x tp=2) against the JAX package's
unsharded, vmapped ``train_step`` of ``__graft_entry__``, rebuilt here from
JAX modules on the same (bridged) weights and numpy inputs, its Pallas
kernels in interpret mode. GSPMD's result is the unsharded one, so the JAX
side runs without a mesh.

Against the port without a mesh: tp=2 for the DiT forward and for the
ShapeVAE decode with the gradient of a scalar loss with respect to its
latents (float32; the collectives sum partial products in another order, so
1e-5 relative; a backward that all-reduced the gradient once too often would
be off by a factor of 2), and dp=2 ``run_batch``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from followmyhold_tpu.configs.guidance import OptimizationConfig as JConfig
from followmyhold_tpu.diffusion import guidance as JG
from followmyhold_tpu.diffusion.scheduler import make_schedule as j_make_schedule
from followmyhold_tpu.models import hunyuan as JH
from followmyhold_tpu.ops.camera import GuidanceCamera as JCamera
from followmyhold_tpu.parallel import mesh as jmesh
from followmyhold_tpu_torch import entry as E
from followmyhold_tpu_torch.models import hunyuan as TH
from followmyhold_tpu_torch.parallel import mesh as tmesh
from followmyhold_tpu_torch.utils.params import flax_slot, flax_to_torch
from test_torch_guidance import _pallas_interpret_on_cpu

import _torch_parallel_ranks as ranks

TP = 2
# the dry run's sampler with a raster capacity above the hand's 1,538 faces:
# at the reference's 256 a tile drops faces, and the two packages drop others
# (their tiles differ: 128 px against 16)
CAPS = dict(raster_faces_per_tile=8192)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------- #
# parse_mesh_shape
# --------------------------------------------------------------------------- #

SPECS = [("dp=4,tp=2", 8), ("dp=-1", 8), ("dp=-1,tp=2", 8), ("tp=-1", 6), ("dp=2, tp=3", 6),
         ("", 4), ("dp=1,tp=-1", 1)]
BAD_SPECS = [("dp=-1,tp=-1", 8), ("dp=-1,tp=3", 8), ("dp:2", 8), ("dp=two", 8),
             ("dp=2,,tp", 4)]


@pytest.mark.parametrize("spec,n", SPECS)
def test_parse_mesh_shape_matches_jax(spec, n):
    assert tmesh.parse_mesh_shape(spec, n) == jmesh.parse_mesh_shape(spec, n)


@pytest.mark.parametrize("spec,n", BAD_SPECS)
def test_parse_mesh_shape_errors_match_jax(spec, n):
    with pytest.raises(ValueError) as want:
        jmesh.parse_mesh_shape(spec, n)
    with pytest.raises(ValueError) as got:
        tmesh.parse_mesh_shape(spec, n)
    assert str(got.value) == str(want.value)


def test_make_mesh_needs_the_spec_to_cover_the_ranks():
    # one rank cannot hold a dp=2 mesh
    with pytest.raises(ValueError, match="does not cover"):
        _single_rank(lambda: tmesh.make_mesh("dp=2", device_type="cpu", backend="gloo"))


def _single_rank(fn):
    """fn() inside a one-rank gloo group of this process."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rdzv", rank=0, world_size=1)
        try:
            return fn()
        finally:
            dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# the layout against the JAX policy
# --------------------------------------------------------------------------- #

def _jax_configs():
    dit_cfg, vae_cfg, _, _ = E.dryrun_configs()
    jdit = JH.HunyuanDiT(JH.DiTConfig(
        in_channels=dit_cfg.in_channels, hidden=dit_cfg.hidden, heads=dit_cfg.heads,
        depth_double=dit_cfg.depth_double, depth_single=dit_cfg.depth_single,
        context_dim=dit_cfg.context_dim, time_dim=dit_cfg.time_dim, dtype=jnp.float32))
    jvae = JH.ShapeVAE(JH.ShapeVAEConfig(
        num_latents=vae_cfg.num_latents, embed_dim=vae_cfg.embed_dim, width=vae_cfg.width,
        heads=vae_cfg.heads, depth=vae_cfg.depth, geo_heads=vae_cfg.geo_heads,
        dtype=jnp.float32))
    return jdit, jvae


@pytest.fixture(scope="module")
def jax_models():
    """The tiny DiT and ShapeVAE of the dry run in both packages on the same
    weights: JAX's init, the geo query's embedding cut to its lowest Fourier
    frequency (random weights then decode a smooth field whose surface stays
    below the dry run's capacities), bridged into the port."""
    jdit, jvae = _jax_configs()
    key = jax.random.key(0)
    dit_params = jdit.init(key, jnp.zeros((1, 16, 8)), jnp.zeros(1), jnp.zeros((1, 4, 32)))
    vae_params = jax.tree_util.tree_map(np.asarray, jvae.init(
        key, jnp.zeros((1, 16, 8)), jnp.zeros((1, 8, 3))))
    kernel = vae_params["params"]["geo"]["query_in"]["kernel"].copy()
    keep = np.zeros(kernel.shape[0], bool)
    keep[[c * 17 + j for c in range(3) for j in (0, 1, 9)]] = True
    kernel[~keep] = 0.0
    vae_params["params"]["geo"]["query_in"]["kernel"] = kernel
    dit_cfg, vae_cfg, _, _ = E.dryrun_configs()
    tdit = flax_to_torch(jax.tree_util.tree_map(np.asarray, dit_params), TH.HunyuanDiT(dit_cfg))
    tvae = flax_to_torch(vae_params, TH.ShapeVAE(vae_cfg))
    return dict(jdit=jdit, jvae=jvae, dit_params=dit_params,
                vae_params=jax.tree_util.tree_map(jnp.asarray, vae_params),
                weights=(tdit.state_dict(), tvae.state_dict()), tdit=tdit, tvae=tvae)


def _jax_layout(params):
    """{Flax path below "params": "col" | "row" | None} from the JAX
    ``shard_model_params``' own shardings on a tp=2 mesh of virtual devices."""
    mesh = jmesh.make_mesh(f"tp={TP}", jax.devices()[:TP])
    sharded = jmesh.shard_model_params(params, mesh)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(sharded)[0]:
        names = tuple(getattr(k, "key", str(k)) for k in path)
        if names[-1] != "kernel":
            continue
        spec = tuple(leaf.sharding.spec) + (None,) * (leaf.ndim - len(leaf.sharding.spec))
        out[names[1:]] = ("col" if spec[-1] == "tp" else "row" if spec[-2] == "tp" else None)
    return out


@pytest.mark.parametrize("which", ["dit", "vae"])
def test_layout_matches_jax_shard_model_params(jax_models, which):
    params = jax_models["dit_params" if which == "dit" else "vae_params"]
    module = jax_models["tdit" if which == "dit" else "tvae"]
    want = _jax_layout(params)
    got = {flax_slot(module, f"{name}.weight")[0]: style
           for name, style in tmesh.tp_layout(module, TP).items()}
    assert got == want
    assert {"col", "row"} <= set(want.values())          # both styles are exercised
    # every split layer is split head-aligned, in pairs; final_proj reads a
    # replicated input and is split alone
    plan = tmesh.tp_plan(module, TP)
    assert {n for n, s in tmesh.tp_layout(module, TP).items() if s} == set(plan)
    alone = sorted(n for n, (_, _, paired) in plan.items() if not paired)
    assert alone == (["final_proj"] if which == "dit" else [])


# --------------------------------------------------------------------------- #
# the two-rank run: tp=2 and dp=2 against the port without a mesh
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def two_ranks(jax_models, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_dp")
    mp.spawn(ranks.tp_dp_rank, nprocs=2, join=True,
             args=(2, str(d / "rendezvous"), str(d), jax_models["weights"]))
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _head_aligned(full, parts, rank, dim):
    """Rank ``rank``'s contiguous half of each part of ``full`` along ``dim``."""
    pieces, off = [], 0
    for width in parts:
        half = width // TP
        index = torch.arange(off + rank * half, off + (rank + 1) * half)
        pieces.append(full.index_select(dim, index))
        off += width
    return torch.cat(pieces, dim=dim)


def test_tp_shards_are_head_aligned_slices(jax_models, two_ranks):
    models = dict(dit=jax_models["tdit"], vae=jax_models["tvae"])
    plans = {k: tmesh.tp_plan(m, TP) for k, m in models.items()}
    for r, out in enumerate(two_ranks):
        assert set(out["split"]) == {f"{k}.{n}" for k, p in plans.items() for n in p}
        for key, (style, weight, bias) in out["split"].items():
            which, name = key.split(".", 1)
            full = models[which].get_submodule(name)
            _, parts, _ = plans[which][name]
            if style == "col":
                torch.testing.assert_close(weight, _head_aligned(full.weight, parts, r, 0),
                                           rtol=0, atol=0)
                torch.testing.assert_close(bias, _head_aligned(full.bias, parts, r, 0),
                                           rtol=0, atol=0)
            else:
                torch.testing.assert_close(weight, _head_aligned(full.weight, parts, r, 1),
                                           rtol=0, atol=0)
                torch.testing.assert_close(bias, full.bias, rtol=0, atol=0)   # added once
    # the fused qkv of a double block holds q, k and v of the rank's heads
    qkv = two_ranks[1]["split"]["dit.double_blocks.0.img_qkv"][1]
    h = jax_models["tdit"].cfg.hidden
    torch.testing.assert_close(qkv[h // 2:h], jax_models["tdit"].double_blocks[0]
                               .img_qkv.weight[h + h // 2:2 * h], rtol=0, atol=0)
    heads = E.DRYRUN_HEADS // TP
    assert two_ranks[0]["local_heads"] == dict(double=heads, single=heads,
                                               single_hidden=h // TP, vae=heads, geo=heads)


def _rel(got, want):
    return float((got - want).norm() / want.norm())


def test_tp_dit_forward_matches_the_unsharded_one(two_ranks):
    for out in two_ranks:
        want, got = out["dit"]
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-5        # measured 2.3e-7


def test_tp_vae_decode_and_its_input_gradient_match_the_unsharded_ones(two_ranks):
    for out in two_ranks:
        (want, want_grad), (got, got_grad) = out["vae"]
        assert _rel(got, want) <= 1e-5        # measured 2.7e-7
        assert _rel(got_grad, want_grad) <= 1e-5   # measured 4.4e-7
    # both ranks hold the same (replicated) result, bit for bit
    torch.testing.assert_close(two_ranks[0]["vae"][1][1], two_ranks[1]["vae"][1][1],
                               rtol=0, atol=0)


def test_tp_layers_split_alone_match_the_unsharded_ones(two_ranks):
    # three heads over tp=2: the reference still splits the fused projections
    # and the projections after the attention; the port splits them alone
    assert two_ranks[0]["odd_split"] == [
        "double_blocks.0.img_proj", "double_blocks.0.img_qkv", "double_blocks.0.txt_proj",
        "double_blocks.0.txt_qkv", "final_proj", "single_blocks.0.linear1",
        "single_blocks.0.linear2"]
    for out in two_ranks:
        (want, want_grad), (got, got_grad) = out["odd"]
        assert _rel(got, want) <= 1e-5        # measured 2.1e-7
        assert _rel(got_grad, want_grad) <= 1e-5   # measured 3.5e-7


def test_dp_run_batch_matches_run_batch_without_a_mesh(two_ranks):
    want = two_ranks[0]["dp_ref"]
    for out in two_ranks:
        got = out["dp"]
        assert sorted(got.losses) == sorted(want.losses) == ["hand", "joint_3", "obj"]
        for a, b in [(got.latents, want.latents), (got.noise_pred, want.noise_pred),
                     *zip(got.hand, want.hand), *zip(got.obj, want.obj),
                     *((got.losses[k], want.losses[k]) for k in want.losses)]:
            assert a.shape == b.shape
            # each rank's image alone against the batch of two: on the CPU the
            # DiT's float32 results depend on the batch (the tiny DiT at batch
            # 4 and at batch 2 part by 9.5e-7), and the phases carry that on:
            # measured 1.3e-6 to 2.3e-6 absolute on the latents
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert not torch.equal(want.obj.quat[0], want.obj.quat[1])     # two images, two runs


# --------------------------------------------------------------------------- #
# the slice: the dry run's train step at dp=2 x tp=2 against JAX's
# --------------------------------------------------------------------------- #

def _jax_train_losses(m, x):
    """__graft_entry__.dryrun_multichip's train_step, vmapped over images and
    jitted, without a mesh, on the dry run's numpy inputs."""
    _, _, cfg, kw = E.dryrun_configs()
    jdit, jvae = m["jdit"], m["jvae"]
    sampler = JG.GuidedSampler(
        dit=jdit, vae=jvae, camera=JCamera(height=E.DRYRUN_SIZE, width=E.DRYRUN_SIZE,
                                           fov_deg=60.0),
        config=JConfig(num_inference_steps=cfg.num_inference_steps,
                       optimization_steps_hand=cfg.optimization_steps_hand,
                       optimization_steps_scale=cfg.optimization_steps_scale,
                       optimization_steps_joint=cfg.optimization_steps_joint,
                       octree_resolution=cfg.octree_resolution), **dict(kw, **CAPS))
    sched = j_make_schedule(sigmas=np.linspace(0, 1, cfg.num_inference_steps))

    def train_step(dit_params, vae_params, noise, lat, cond_cat, targets):
        t = sched.timesteps[E.DRYRUN_STEP] / sched.num_train_timesteps
        lat_in = jnp.concatenate([lat, lat], axis=0)
        eps = jdit.apply(dit_params, lat_in, jnp.full((2,), t), cond_cat)
        eps_c, eps_u = jnp.split(eps, 2, axis=0)
        noise = eps_u + 5.0 * (eps_c - eps_u) + 0.0 * noise
        hand, obj, noise, _losses, _renders = sampler._joint_phase(
            JG.init_pose(), JG.init_pose(), noise, lat, vae_params, targets, sched,
            E.DRYRUN_STEP, near_end=True)
        return (jnp.sum(noise ** 2) + jnp.sum(hand.trans ** 2) + jnp.sum(obj.trans ** 2))

    targets = JG.GuidanceTargets(**{k: jnp.asarray(x[k])
                                    for k in JG.GuidanceTargets._fields[:-1]})
    step_fn = jax.jit(jax.vmap(train_step, in_axes=(None, None, 0, 0, 0, 0)))
    with _pallas_interpret_on_cpu(), jax.default_matmul_precision("highest"):
        losses = step_fn(m["dit_params"], m["vae_params"], jnp.asarray(x["noise"]),
                         jnp.asarray(x["latents"]), jnp.asarray(x["cond_cat"]), targets)
    return np.asarray(losses)


def test_dryrun_multichip_train_step_matches_jax(jax_models):
    dp = 2
    reports = []
    got = E.dryrun_multichip(2 * dp, device_type="cpu", backend="gloo",
                             weights=jax_models["weights"], sampler_kw=CAPS,
                             reports=reports)
    want = _jax_train_losses(jax_models, E.dryrun_inputs(dp))
    assert got.shape == want.shape == (dp,) and np.isfinite(got).all()
    # two AdamW steps on the noise (lr 1e-2) whose gradient runs through
    # float32 renders, then the sum of its squares: measured 5.5e-6 and 2.0e-5
    # relative (the port without a mesh: 5.5e-7 and 3.2e-7 from the mesh's);
    # 1e-3 as test_torch_phases holds the joint phase's losses, since one
    # noise component stepping the other way moves a loss by ~1e-3
    np.testing.assert_allclose(got, want, rtol=1e-3)
    # every rank returns every image's loss
    assert len(reports) == 2 * dp and all(np.array_equal(r["losses"].numpy(), got)
                                          for r in reports)
