"""Parameters for the port's modules: the bridge from a Flax parameter tree,
and a seeded random initialisation for full-size models on the device.

The port's modules keep the Flax modules' names, so the bridge is mechanical:

- ``Dense`` ``kernel [in,out]`` -> ``Linear.weight [out,in]``; ``bias`` as is;
- ``LayerNorm`` / ``RMSNorm`` ``scale`` -> ``weight``; ``bias`` as is;
- a scan-stacked block (``<name>/block/...`` with a leading depth axis) ->
  ``<name>.<i>....``, one module per layer.

The tree is given as nested dicts of numpy arrays (the caller converts; this
package imports no JAX). Every module parameter must be filled and every tree
leaf used, or the bridge raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(value)
    return out


def flax_to_torch(params: Mapping, module: nn.Module) -> nn.Module:
    """Load a Flax parameter tree (numpy leaves) into ``module`` in place."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    own = dict(module.named_parameters())
    loaded = set()

    def assign(name: str, value: np.ndarray) -> None:
        if name not in own:
            raise KeyError(f"Flax leaf maps to {name!r}, which the module does not have")
        target = own[name]
        tensor = torch.from_numpy(np.ascontiguousarray(value))
        if tuple(tensor.shape) != tuple(target.shape):
            raise ValueError(f"{name}: shape {tuple(tensor.shape)} does not fit "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(tensor.to(device=target.device, dtype=target.dtype))
        loaded.add(name)

    for path, value in _flatten(params).items():
        *scope, leaf = path
        depth_at = scope.index("block") if "block" in scope else None
        if leaf == "kernel":
            leaf = "weight"
            value = np.swapaxes(value, -1, -2)
        elif leaf == "scale":
            leaf = "weight"
        if depth_at is not None:  # scan-stacked: the leading axis is the layer
            for i in range(value.shape[0]):
                assign(".".join([*scope[:depth_at], str(i), *scope[depth_at + 1:], leaf]),
                       value[i])
        else:
            assign(".".join([*scope, leaf]), value)

    missing = sorted(set(own) - loaded)
    if missing:
        raise KeyError(f"the Flax tree fills no value for: {missing}")
    return module


def init_random_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights, drawn on the module's device: matrices from
    N(0, 1/fan_in), norm scales one, biases zero. For smoke runs and timing;
    real weights come through a converter."""
    for index, (name, p) in enumerate(module.named_parameters()):
        gen = torch.Generator(device=p.device)
        gen.manual_seed(seed * 1_000_003 + index)
        with torch.no_grad():
            if p.dim() >= 2:
                std = 1.0 / float(p.shape[1]) ** 0.5
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                                    dtype=torch.float32) * std)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
    return module
