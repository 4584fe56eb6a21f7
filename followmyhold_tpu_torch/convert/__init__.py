"""Torch checkpoint -> the stages' parameter files, without JAX (the port's
copy of the reference's ``convert/``).

The reference's model families ship torch checkpoints (HaMeR ViT-H,
MoGe-2/DINOv2, Hunyuan3D-2 DiT+ShapeVAE+conditioner, ViTPose, FLUX and its
text towers, YOLOv8, the Faster R-CNN, GroundingDINO, SAM2). Each converter
maps a torch state dict onto the Flax-layout tree of the port's module
(``utils.params.torch_to_flax``) and writes it with
``utils.params.save_params``: the same flax-msgpack file, under the same
name, that the JAX package's converter writes, so both packages'
``load_or_init`` read it. The converters are host tools: they read a file and
write files, and touch no device.

Usage:
    python -m followmyhold_tpu_torch.convert.hamer --ckpt hamer.ckpt
"""

from followmyhold_tpu_torch.convert.common import (
    ConversionReport,
    conv_kernel,
    dense_kernel,
    put,
)

__all__ = ["ConversionReport", "conv_kernel", "dense_kernel", "put"]
