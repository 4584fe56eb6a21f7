"""The models, samplers and inputs that the object-phase, joint-phase and
whole-run parity tests share (test_torch_phases.py, test_torch_phases_joint.py,
test_torch_phases_whole.py): tiny float32 Hunyuan DiT and ShapeVAE in both
packages on the same weights (the JAX ``init`` bridged into the port with
``flax_to_torch``), the geo query's field smoothed, and the synthetic targets
of test_torch_guidance.py.

``phase_models()`` builds them once a process; each test file takes them
through a module-scoped fixture, and runs its module on one torch thread
(``one_torch_thread``): the port's small ops spin a thread pool for nothing
(the whole-run file took 1,064 CPU-s alone with the default pool, 170 on one
thread), and in a six-worker run of the suite that CPU time is the cost.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followmyhold_tpu.configs.guidance import OptimizationConfig as JConfig
from followmyhold_tpu.diffusion import guidance as JG
from followmyhold_tpu.models import hunyuan as JH
from followmyhold_tpu.ops.camera import GuidanceCamera as JCamera
from followmyhold_tpu_torch.configs.guidance import OptimizationConfig as TConfig
from followmyhold_tpu_torch.diffusion import guidance as TG
from followmyhold_tpu_torch.models import hunyuan as TH
from followmyhold_tpu_torch.ops.camera import GuidanceCamera as TCamera
from followmyhold_tpu_torch.utils.params import flax_to_torch
from test_torch_guidance import CAPS, RES, SIZE, _numpy_targets, _pallas_interpret_on_cpu

# the object meshes here carry ~2,400 faces, all in the one 128x128 tile: a
# capacity above that keeps both rasterizers below their caps
PHASE_CAPS = dict(CAPS, raster_faces_per_tile=8192)

DIT_KW = dict(in_channels=8, hidden=64, heads=4, depth_double=1, depth_single=1,
              context_dim=32, time_dim=32)
VAE_KW = dict(num_latents=16, embed_dim=8, width=32, heads=4, depth=1, geo_heads=4)
N_PHASE = 2          # optimizer steps of each phase test
STEP_I = 6           # the schedule step the phases decode at (of N_SCHED)
N_SCHED = 10
# one step configuration for both phase tests
PHASE_STEPS = dict(num_inference_steps=N_SCHED, optimization_steps_hand=1,
                   optimization_steps_scale=N_PHASE, optimization_steps_joint=N_PHASE)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _smooth_field(vae_params):
    """Keep only the lowest Fourier frequency of the geo decoder's query
    embedding: random weights then decode a smooth field whose surface crosses
    ~40 of the 64 coarse cells, below every capacity, where the full embedding
    (frequencies up to 2^7) decodes noise that overflows them."""
    params = _np(vae_params)
    kernel = params["params"]["geo"]["query_in"]["kernel"].copy()   # [3 * 17, width]
    keep = np.zeros(kernel.shape[0], bool)
    keep[[c * 17 + j for c in range(3) for j in (0, 1, 9)]] = True   # x, sin x, cos x
    kernel[~keep] = 0.0
    params["params"]["geo"]["query_in"]["kernel"] = kernel
    return params


@functools.lru_cache(maxsize=None)
def phase_models():

    jdit = JH.HunyuanDiT(JH.DiTConfig(dtype=jnp.float32, **DIT_KW))
    jvae = JH.ShapeVAE(JH.ShapeVAEConfig(dtype=jnp.float32, **VAE_KW))
    key = jax.random.key(0)
    dit_params = jdit.init(key, jnp.zeros((1, 16, 8)), jnp.zeros(1), jnp.zeros((1, 4, 32)))
    vae_params = _smooth_field(jvae.init(key, jnp.zeros((1, 16, 8)), jnp.zeros((1, 8, 3))))
    tdit = flax_to_torch(_np(dit_params), TH.HunyuanDiT(
        TH.DiTConfig(dtype=torch.float32, **DIT_KW))).eval().requires_grad_(False)
    tvae = flax_to_torch(_np(vae_params), TH.ShapeVAE(
        TH.ShapeVAEConfig(dtype=torch.float32, **VAE_KW))).eval().requires_grad_(False)
    tg = _numpy_targets()
    return dict(jdit=jdit, jvae=jvae, dit_params=dit_params, vae_params=vae_params,
                tdit=tdit, tvae=tvae, tg=tg,
                jtargets=JG.GuidanceTargets(**{k: jnp.asarray(v) for k, v in tg.items()}),
                ttargets=TG.GuidanceTargets(**{
                    k: torch.from_numpy(v).long() if k == "mano_faces" else torch.from_numpy(v)
                    for k, v in tg.items()}))


def _samplers(m, **steps):
    jsampler = JG.GuidedSampler(
        dit=m["jdit"], vae=m["jvae"], camera=JCamera(height=SIZE, width=SIZE, fov_deg=60.0),
        config=JConfig(octree_resolution=RES, **steps), **PHASE_CAPS)
    tsampler = TG.GuidedSampler(
        dit=m["tdit"], vae=m["tvae"], camera=TCamera(height=SIZE, width=SIZE, fov_deg=60.0),
        config=TConfig(octree_resolution=RES, **steps), **PHASE_CAPS)
    return jsampler, tsampler


def _phase_inputs(seed):
    """A latent state and noise prediction whose step_final decodes to a
    surface at the 8^3 grid, and a hand pose a little off the identity."""
    rng = np.random.default_rng(seed)
    return dict(latents=rng.normal(size=(1, 16, 8)).astype(np.float32),
                noise=rng.normal(size=(1, 16, 8)).astype(np.float32),
                hand=(np.float32([1.02]), np.float32([0.01, -0.01, 0.0]),
                      np.float32([0.99, 0.05, -0.03, 0.02])),
                obj=(np.float32([0.97]), np.float32([0.0, 0.01, 0.02]),
                     np.float32([0.98, -0.04, 0.06, 0.01])))


def _jpose(p):
    return JG.PoseParams(*(jnp.asarray(x) for x in p))


def _tpose(p):
    return TG.PoseParams(*(torch.from_numpy(x) for x in p))
