"""The learned detection stack's tiny models in both packages on the same
weights, for the port's parity tests (test_torch_detectors.py,
test_torch_grounding.py).

No JAX ``model.init`` runs: the parameter tree's shapes come from
``jax.eval_shape`` and its values from a seeded numpy generator (kernels
N(0, 1/fan_in) with a conv's whole fan-in, LayerNorm and GroupNorm scales
1 + N(0, 0.05^2), everything else N(0, 0.05^2)), and ``flax_to_torch``
bridges the same arrays into the port. Each JAX ``apply`` is jitted once a
process and traced under ``jax.default_matmul_precision("highest")``; the JAX
package's host functions take a stand-in with the model's ``cfg`` and that
jitted ``apply``.
"""

from __future__ import annotations

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from followmyhold_tpu.models import gdino as JG
from followmyhold_tpu.models import hand_object_detector as JR
from followmyhold_tpu.models import sam2 as JS
from followmyhold_tpu.models import yolov8 as JY
from followmyhold_tpu_torch.models import gdino as TG
from followmyhold_tpu_torch.models import hand_object_detector as TR
from followmyhold_tpu_torch.models import sam2 as TS
from followmyhold_tpu_torch.models import yolov8 as TY
from followmyhold_tpu_torch.utils.params import flax_to_torch

# the class head's kernel: the background's column zero, the object's drawn
# this many times wider than the others and made to sum to zero, the hand's the
# object's negated; so rois pass detect_hand_object's 0.5 (with the weights of
# frcnn() the hand's, in every roi)
FRCNN_CLS_GAIN = 30.0


def random_params(init, seed: int):
    """A Flax tree of the shapes ``init(key)`` makes, filled from ``seed``."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.normal(scale=0.05, size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, jax.random.key(0)))


def highest(fn):
    """fn jitted, traced and run under the highest matmul precision."""
    jitted = jax.jit(fn)

    def call(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return jitted(*args, **kwargs)

    return call


@dataclasses.dataclass
class Pair:
    jax_model: types.SimpleNamespace     # cfg and the jitted apply
    params: dict
    torch_model: torch.nn.Module


def _pair(module, params, torch_model) -> Pair:
    stand_in = types.SimpleNamespace(cfg=module.cfg, apply=highest(module.apply))
    return Pair(stand_in, params, flax_to_torch(params, torch_model).eval())


@functools.lru_cache(maxsize=None)
def yolo() -> Pair:
    m = JY.YoloV8(JY.YOLOV8_TINY_TEST)
    params = random_params(lambda k: m.init(k, jnp.zeros((1, 64, 64, 3))), 11)
    return _pair(m, params, TY.YoloV8(TY.YOLOV8_TINY_TEST, device="cpu"))


@functools.lru_cache(maxsize=None)
def frcnn() -> Pair:
    m = JR.HandObjectDetector(JR.FRCNN_TINY)
    params = random_params(lambda k: m.init(k, jnp.zeros((64, 64, 3))), 12)
    kernel = params["params"]["cls_score"]["kernel"]
    kernel[:, 0] = 0.0
    kernel[:, 1] = FRCNN_CLS_GAIN * (kernel[:, 1] - kernel[:, 1].mean())
    kernel[:, 2] = -kernel[:, 1]
    return _pair(m, params, TR.HandObjectDetector(TR.FRCNN_TINY, device="cpu"))


@functools.lru_cache(maxsize=None)
def gdino() -> Pair:
    m = JG.GroundingDino(JG.GDINO_TINY)
    c, T = m.cfg, 8

    def init(k):
        return m.init(k, pixel_values=jnp.zeros((1, c.image_size, c.image_size, 3)),
                      input_ids=jnp.zeros((1, T), jnp.int32),
                      token_type_ids=jnp.zeros((1, T), jnp.int32),
                      text_self_attention_masks=jnp.ones((1, T, T), bool),
                      position_ids=jnp.zeros((1, T), jnp.int32),
                      text_token_mask=jnp.ones((1, T), bool))

    return _pair(m, random_params(init, 13), TG.GroundingDino(TG.GDINO_TINY, device="cpu"))


@functools.lru_cache(maxsize=None)
def _sam2_params():
    m = JS.Sam2(JS.SAM2_TINY_TEST)
    s = m.cfg.image_size
    return random_params(lambda k: m.init(k, jnp.zeros((1, s, s, 3)), jnp.zeros((1, 4))), 14)


@functools.lru_cache(maxsize=None)
def sam2(stability_thresh: float = JS.SAM2_TINY_TEST.stability_thresh) -> Pair:
    """SAM2 at the tiny configuration with ``stability_thresh``; every
    threshold shares one parameter tree."""
    m = JS.Sam2(dataclasses.replace(JS.SAM2_TINY_TEST, stability_thresh=stability_thresh))
    t = TS.Sam2(dataclasses.replace(TS.SAM2_TINY_TEST, stability_thresh=stability_thresh),
                device="cpu")
    return _pair(m, _sam2_params(), t)


def close(got, want, what: str = "") -> None:
    """The model-output tolerance: |got - want| <= 1e-4 max|want| + 1e-5,
    -inf where want is -inf."""
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=what)
    scale = np.abs(want[finite]).max() if finite.any() else 0.0
    err = np.abs(got[finite] - want[finite]).max() if finite.any() else 0.0
    assert err <= 1e-4 * scale + 1e-5, (what, err, scale)


def masks_agree(got: np.ndarray, want: np.ndarray, logits: np.ndarray,
                margin: float = 1e-4) -> None:
    """Masks equal wherever the reference logit is further than ``margin`` from 0."""
    decided = np.abs(logits) > margin
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[decided], want[decided])


def boxes_close(got, want) -> None:
    """Final boxes in image pixels: within 1e-3 px."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.size:
        assert np.abs(got - want).max() <= 1e-3, np.abs(got - want).max()
