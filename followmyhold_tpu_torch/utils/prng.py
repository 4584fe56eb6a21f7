"""Seeds of the stages.

The port's counterpart of followmyhold_tpu/utils/prng.py: the same stage seeds
(inpaint 2, hunyuan 2025, guidance 2) and the same stable tags for a stage
and an image. The reference folds the tags into a JAX threefry key;
threefry's streams cannot be reproduced by torch's generators, so the noise
drawn here differs from the reference's for the same seed, stage and image
(tests that compare the two inject the reference's noise instead). What is
kept is the discipline: one generator per (seed, stage, image), independent
of the order in which images are processed.
"""

from __future__ import annotations

import hashlib
from typing import Union

import torch

from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device

# Stage seeds mirroring the reference constants.
SEED_INPAINT = 2
SEED_HUNYUAN = 2025
SEED_GUIDANCE = 2


def _stable_tag(value: Union[str, int]) -> int:
    if isinstance(value, int):
        return value & 0x7FFFFFFF
    digest = hashlib.sha256(value.encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def stage_generator(seed: int, stage: str, image_id: Union[str, int] = 0,
                    device: DeviceLike = "cuda") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for one stage of one image, seeded
    with 63 bits of the hash of (seed, stage tag, image tag)."""
    raw = f"{seed}:{_stable_tag(stage)}:{_stable_tag(image_id)}".encode("ascii")
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int.from_bytes(hashlib.sha256(raw).digest()[:8], "little") >> 1)
    return gen
