"""The cells' weights, made by the benchmark on the card from ``--seed``.

Each model's leaves fall into groups (a block, or a top-level part, as the
reference's layout lists them); a group is one ``torch.randn`` call on the device, in the
parameters' own type, from a generator seeded by the run's seed and the
group's name. Its values follow the program's rule for random weights:
matrices (two or more axes) N(0, 1 / shape[1]), one-axis biases zero, other
one-axis leaves (norm scales) one; an unconditional embedding is zeros, as in
the original model. The names, shapes and served types come from the plain
reference's list of a model's leaves (``layouts`` of ``benchmark/reference``),
so the program's model must carry the same leaves under the same names; and
since a group's draw depends on nothing but the seed and the group, the
reference draws any group again on its own, block by block, in float32 from
the same values."""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Tuple

import torch
from torch import nn

Leaf = Tuple[str, Tuple[int, ...], torch.dtype]


def _drawn(name: str, shape) -> bool:
    return len(shape) >= 2 and not name.endswith("uncond_embedding")


def derived_seed(seed: int, model: str, group: str) -> int:
    digest = hashlib.sha256(f"{seed}/{model}/{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def draw_group(leaves: List[Leaf], seed: int, model: str, group: str,
               device: torch.device, dtype: torch.dtype = None
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(leaf name, value) of each leaf of one group, in the leaves' own types
    (or ``dtype``: the reference's float32 of the same values)."""
    drawn = [leaf for leaf in leaves if _drawn(leaf[0], leaf[1])]
    by_type: Dict[torch.dtype, torch.Tensor] = {}
    for t in {leaf[2] for leaf in drawn}:
        n = sum(torch.Size(s).numel() for _, s, d in drawn if d == t)
        gen = torch.Generator(device=device).manual_seed(derived_seed(seed, model, f"{group}/{t}"))
        by_type[t] = torch.randn(n, generator=gen, device=device, dtype=t)
    offset = {t: 0 for t in by_type}
    for name, shape, t in leaves:
        want = dtype or t
        if _drawn(name, shape):
            n = torch.Size(shape).numel()
            x = by_type[t][offset[t]:offset[t] + n].view(shape)
            offset[t] += n
            yield name, (x * (1.0 / float(shape[1]) ** 0.5)).to(want)
        elif name.endswith("bias") or name.endswith("uncond_embedding"):
            yield name, torch.zeros(shape, dtype=want, device=device)
        else:
            yield name, torch.ones(shape, dtype=want, device=device)


@torch.no_grad()
def fill(program: nn.Module, layout: Dict[str, List[Leaf]], seed: int, model: str) -> None:
    """Give the program's ``program`` model the benchmark's weights: every
    leaf of ``layout`` (the reference's list of the model's leaves in their
    served types), drawn on the program model's device and copied in by
    name."""
    params = dict(program.named_parameters())
    device = next(iter(params.values())).device
    want = {name for g in layout.values() for name, _, _ in g}
    if want != set(params):
        raise ValueError(f"{model}: the program's leaves differ from the reference's: "
                         f"{sorted(want ^ set(params))[:8]}")
    for group, leaves in layout.items():
        for name, value in draw_group(leaves, seed, model, group, device):
            p = params[name]
            if p.shape != value.shape:
                raise ValueError(f"{model}: {name} is {tuple(p.shape)} in the program, "
                                 f"{tuple(value.shape)} in the reference")
            p.copy_(value)
