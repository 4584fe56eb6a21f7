"""Device mesh and sharding policy of the port, on ``torch.distributed``.

Counterpart of followmyhold_tpu/parallel/mesh.py, with the same five names.
One process runs each rank (``torchrun``, or ``torch.multiprocessing.spawn``
as ``entry.dryrun_multichip`` does); a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dims are named as in the
``MESH_SHAPE`` spec ("dp=4,tp=2"):

- **dp**: data parallel over the image batch. ``batch_sharding(mesh)`` gives
  a rank its slice of a leading batch dimension and gathers the slices back
  in order (``GuidedSampler.run_batch(mesh=)``); the images are independent,
  so nothing else is exchanged.
- **tp**: tensor parallel over the transformer weights.
  ``shard_model_params`` takes the reference's policy (which layers are
  column-parallel, which row-parallel, chosen by their Flax names) and writes
  down what GSPMD inserted there: each rank keeps its heads' share of every
  fused projection (``[q|k|v]``, ``[q|k|v|mlp]``, ``[k|v]``, split part by
  part), the blocks read their local widths, and the collectives are autograd
  functions with the Megatron pairing (before a column-parallel layer:
  identity forward, all-reduce backward; after a row-parallel one: all-reduce
  forward, identity backward), the row-parallel bias added once after the
  all-reduce. A column- or row-parallel layer with no partner in its block
  gathers its output, or slices its replicated input, so that it stays
  correct on its own.

The device type and the backend are the caller's: ``"cuda"`` with ``"nccl"``
by default; the tests pass ``"cpu"`` with ``"gloo"``. NCCL refuses two ranks
on one card, so a run of several ranks on one card passes ``"cuda"`` with
``"gloo"``; gloo's collectives on card tensors go through host copies here.
Sums are taken in float32 and cast back to the layer's type.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from followmyhold_tpu_torch.utils.params import flax_slot

__all__ = ["parse_mesh_shape", "make_mesh", "batch_sharding", "replicate",
           "shard_model_params"]


def _world_size() -> Optional[int]:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else None


def parse_mesh_shape(spec: str, num_devices: Optional[int] = None) -> Dict[str, int]:
    """'dp=4,tp=2' -> {'dp': 4, 'tp': 2}; one axis may be -1 (= fill).
    ``num_devices`` defaults to the world size of the process group, or to the
    visible cards where there is none. A count below 1 (a host without a card
    and without a process group) raises, as does a fill that would come out 0."""
    if num_devices is None:
        num_devices = _world_size() or torch.cuda.device_count()
    if num_devices < 1:
        raise ValueError(f"no devices to lay a mesh over ({num_devices} counted)")
    axes: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"(\w+)=(-?\d+)", part)
        if not m:
            raise ValueError(f"Bad MESH_SHAPE entry: {part!r}")
        axes[m.group(1)] = int(m.group(2))
    fills = [k for k, v in axes.items() if v == -1]
    if len(fills) > 1:
        raise ValueError("Only one mesh axis may be -1")
    fixed = int(np.prod([v for v in axes.values() if v != -1])) if axes else 1
    if fills:
        if fixed > 0 and num_devices % fixed:
            raise ValueError(f"{num_devices} devices not divisible by {fixed}")
        fill = num_devices // fixed if fixed > 0 else 0
        if fill < 1:
            raise ValueError(f"mesh axis {fills[0]!r} would be filled with {fill} devices "
                             f"({num_devices} devices over the other axes' {fixed})")
        axes[fills[0]] = fill
    return axes


def _bind_device(device_type: str) -> None:
    """Bind this rank's card (its local rank modulo the visible cards), so
    that the kernels' entry points, which launch on the current device, and
    the collectives find it."""
    if device_type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda'): no CUDA device is visible")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    torch.cuda.set_device(local % torch.cuda.device_count())


def make_mesh(spec: str = "dp=-1", ranks: Optional[Sequence[int]] = None,
              device_type: str = "cuda", backend: str = "nccl") -> DeviceMesh:
    """A DeviceMesh over ``ranks`` (default: every rank of the world) with
    the spec's dims. Every rank of the world calls it, also those outside
    ``ranks`` (their coordinate is None). Without a process group it starts
    one with ``backend`` from the environment (``torchrun``'s variables);
    with one, its backend must be ``backend``. Raises when the spec does not
    cover the ranks."""
    if not dist.is_initialized():
        dist.init_process_group(backend=backend)
    elif dist.get_backend() != backend:
        raise ValueError(f"make_mesh(backend={backend!r}): the process group runs "
                         f"{dist.get_backend()!r}")
    _bind_device(device_type)
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    axes = parse_mesh_shape(spec, len(ranks))
    shape = tuple(axes.values())
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(f"Mesh {axes} does not cover {len(ranks)} devices")
    return DeviceMesh(device_type, torch.tensor(ranks, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=tuple(axes.keys()))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The mesh's extent along ``axis`` (1 where it has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(axis)] if axis in names else 1


def rank_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _host_staged(group) -> bool:
    """gloo's collectives run on host memory: card tensors are copied there."""
    return dist.get_backend(group) == dist.Backend.GLOO


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, taken in float32, in x's dtype and device."""
    buf = x.to("cpu" if _host_staged(group) else x.device, torch.float32, copy=True)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device, x.dtype)


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's x, in the group's rank order."""
    src = x.to("cpu", copy=True) if _host_staged(group) else x.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [t.to(x.device) for t in out]


# --------------------------------------------------------------------------- #
# dp: the batch
# --------------------------------------------------------------------------- #

class BatchSharding:
    """The leading (batch/image) dimension sharded over ``axis``: the
    counterpart of ``NamedSharding(mesh, P(axis))``. ``shard`` gives this
    rank its contiguous slice of a tensor or a list; ``gather`` puts the
    slices of every rank of the axis back together in order, on every rank."""

    def __init__(self, mesh: DeviceMesh, axis: str = "dp"):
        if axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"the mesh {mesh.mesh_dim_names} has no axis {axis!r}")
        if mesh.get_coordinate() is None:
            raise ValueError("this rank lies outside the mesh")
        self.mesh, self.axis = mesh, axis
        self.size = axis_size(mesh, axis)
        self.index = mesh.get_local_rank(axis)
        self.group = mesh.get_group(axis)

    def bounds(self, n: int) -> Tuple[int, int]:
        """This rank's [lo, hi) of n items; n must divide by the axis."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not divide over {self.axis}={self.size}")
        per = n // self.size
        return self.index * per, (self.index + 1) * per

    def shard(self, x):
        lo, hi = self.bounds(len(x))
        return x[lo:hi]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat(_all_gather(x, self.group)) if self.size > 1 else x

    def all_ok(self, ok: bool) -> bool:
        """Whether every rank of the axis reports ok (a collective: each rank
        calls it once, so that a rank that failed does not leave the others
        waiting in the next gather)."""
        flag = torch.tensor([1 if ok else 0], dtype=torch.int32)
        if not _host_staged(self.group):
            flag = flag.to(rank_device(self.mesh))
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        return bool(flag.item())


class Replicated:
    """Every rank holds the whole value: the counterpart of
    ``NamedSharding(mesh, P())``."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh, self.size, self.index = mesh, 1, 0

    def bounds(self, n: int) -> Tuple[int, int]:
        return 0, n

    def shard(self, x):
        return x

    def gather(self, x):
        return x

    def all_ok(self, ok: bool) -> bool:
        return ok


def batch_sharding(mesh: DeviceMesh, axis: str = "dp") -> BatchSharding:
    """Shard the leading (batch/image) dimension over ``axis``."""
    return BatchSharding(mesh, axis)


def replicate(mesh: DeviceMesh) -> Replicated:
    return Replicated(mesh)


# --------------------------------------------------------------------------- #
# tp: the collectives
# --------------------------------------------------------------------------- #

class _CopyToTP(torch.autograd.Function):
    """Before a column-parallel layer: identity forward, all-reduce backward
    (each rank's input gradient covers its own output columns only)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """After a row-parallel layer: all-reduce forward (each rank holds a
    partial sum over its input rows), identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToTP(torch.autograd.Function):
    """A replicated input into a row-parallel layer: forward keeps this
    rank's share of each part of the last dim, backward gathers every rank's
    share of the gradient back into the whole."""

    @staticmethod
    def forward(ctx, x, group, parts, rank, size):
        ctx.group, ctx.parts, ctx.size = group, parts, size
        return _take_shares(x, parts, rank, size, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _join_shares(_all_gather(g, ctx.group), ctx.parts, ctx.size, dim=-1), \
            None, None, None, None


class _GatherFromTP(torch.autograd.Function):
    """A column-parallel output that its block reads whole: forward gathers
    every rank's share of each part, backward keeps this rank's share."""

    @staticmethod
    def forward(ctx, x, group, parts, rank, size):
        ctx.parts, ctx.rank, ctx.size = parts, rank, size
        return _join_shares(_all_gather(x, group), parts, size, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _take_shares(g, ctx.parts, ctx.rank, ctx.size, dim=-1), None, None, None, None


def _take_shares(x: torch.Tensor, parts: Sequence[int], rank: int, size: int,
                 dim: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/size of each part along ``dim``, the parts
    concatenated: head-aligned wherever a part's heads divide by size."""
    out, off = [], 0
    for width in parts:
        share = width // size
        out.append(x.narrow(dim, off + rank * share, share))
        off += width
    return torch.cat(out, dim=dim) if len(out) > 1 else out[0].contiguous()


def _join_shares(shares: Sequence[torch.Tensor], parts: Sequence[int], size: int,
                 dim: int) -> torch.Tensor:
    """The inverse of ``_take_shares`` over every rank's shares."""
    out, off = [], 0
    for width in parts:
        share = width // size
        out.extend(s.narrow(dim, off, share) for s in shares)
        off += share
    return torch.cat(out, dim=dim)


class _TPGroup:
    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size


class ColumnParallelLinear(nn.Module):
    """This rank's share of a Linear's output features, part by part.
    ``gather`` makes the forward return the whole output (a layer whose
    block reads it whole)."""

    def __init__(self, linear: nn.Linear, tp: _TPGroup, parts: Sequence[int],
                 gather: bool = False):
        super().__init__()
        self.tp, self.parts, self.gather = tp, tuple(parts), gather
        with torch.no_grad():
            w = _take_shares(linear.weight, parts, tp.rank, tp.size, dim=0)
            b = None if linear.bias is None else _take_shares(linear.bias, parts, tp.rank,
                                                              tp.size, dim=0)
        self.weight = nn.Parameter(w.clone(), requires_grad=linear.weight.requires_grad)
        self.bias = None if b is None else nn.Parameter(
            b.clone(), requires_grad=linear.bias.requires_grad)
        self.in_features = linear.in_features
        self.out_features = linear.out_features if gather else w.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(_CopyToTP.apply(x, self.tp.group), self.weight, self.bias)
        if self.gather:
            y = _GatherFromTP.apply(y, self.tp.group, self.parts, self.tp.rank, self.tp.size)
        return y


class RowParallelLinear(nn.Module):
    """This rank's share of a Linear's input features, part by part; the
    partial products are summed over the group and the bias added once.
    ``scatter`` slices a replicated input to this rank's share first."""

    def __init__(self, linear: nn.Linear, tp: _TPGroup, parts: Sequence[int],
                 scatter: bool = False):
        super().__init__()
        self.tp, self.parts, self.scatter = tp, tuple(parts), scatter
        with torch.no_grad():
            w = _take_shares(linear.weight, parts, tp.rank, tp.size, dim=1)
        self.weight = nn.Parameter(w.clone(), requires_grad=linear.weight.requires_grad)
        self.bias = None if linear.bias is None else nn.Parameter(
            linear.bias.detach().clone(), requires_grad=linear.bias.requires_grad)
        self.in_features = linear.in_features if scatter else w.shape[1]
        self.out_features = linear.out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scatter:
            x = _ScatterToTP.apply(x, self.tp.group, self.parts, self.tp.rank, self.tp.size)
        y = _ReduceFromTP.apply(F.linear(x, self.weight), self.tp.group)
        return y if self.bias is None else y + self.bias


# --------------------------------------------------------------------------- #
# tp: the policy
# --------------------------------------------------------------------------- #

# the reference's name lists (followmyhold_tpu/parallel/mesh.py), matched as it
# matches them: a kernel's parent name equal to an entry or ending in one
COL_NAMES = ("qkv", "to_qkv", "to_q", "to_kv", "fc1", "ff1", "mlp1", "linear1",
             "in_layer", "kv", "q")
ROW_NAMES = ("proj", "to_out", "fc2", "ff2", "mlp2", "linear2", "out_layer",
             "img_proj", "txt_proj")


def _matches(parent: str, names: Sequence[str]) -> bool:
    return any(parent == n or parent.endswith(n) for n in names)


def tp_layout(module: nn.Module, tp: int) -> Dict[str, Optional[str]]:
    """{qualified name of every nn.Linear: "col", "row" or None}: the
    reference's choice for its kernel, by the kernel's parent name in the
    Flax tree (``utils/params.flax_slot``): column-parallel where the name is
    a column name and the output dim divides by tp, else row-parallel where it
    is a row name and the input dim divides, else whole."""
    out: Dict[str, Optional[str]] = {}
    for name, sub in module.named_modules():
        if not isinstance(sub, nn.Linear):
            continue
        path = flax_slot(module, f"{name}.weight" if name else "weight")[0]
        parent = path[-2] if len(path) >= 2 else "params"
        n_out, n_in = sub.weight.shape
        style = None
        if _matches(parent, COL_NAMES) and n_out % tp == 0:
            style = "col"
        elif _matches(parent, ROW_NAMES) and n_in % tp == 0:
            style = "row"
        out[name] = style
    return out


@dataclasses.dataclass
class _Pair:
    """Column-parallel layers and the row-parallel layers that read their
    output, in one block: each layer with its fused parts (widths along the
    split dim), the counts that must divide by tp for a head-aligned split,
    and the block's attributes that then take their local value."""

    owner: nn.Module
    cols: Dict[str, Tuple[int, ...]]
    rows: Dict[str, Tuple[int, ...]]
    counts: Tuple[int, ...]
    local: Tuple[str, ...] = ()


def _pairs(module: nn.Module) -> List[_Pair]:
    """The column/row pairs of the port's blocks."""
    from followmyhold_tpu_torch.models import hunyuan as H

    pairs = []
    for sub in module.modules():
        if isinstance(sub, H.DoubleStreamBlock):
            h, mlp = sub.hidden, sub.img_mlp1.out_features
            pairs.append(_Pair(sub, {"img_qkv": (h, h, h), "txt_qkv": (h, h, h)},
                               {"img_proj": (h,), "txt_proj": (h,)}, (sub.heads,), ("heads",)))
            for s in ("img", "txt"):
                pairs.append(_Pair(sub, {f"{s}_mlp1": (mlp,)}, {f"{s}_mlp2": (mlp,)}, (mlp,)))
        elif isinstance(sub, H.SingleStreamBlock):
            h = sub.hidden
            mlp = sub.linear1.out_features - 3 * h
            pairs.append(_Pair(sub, {"linear1": (h, h, h, mlp)}, {"linear2": (h, mlp)},
                               (sub.heads, mlp), ("heads", "hidden")))
        elif isinstance(sub, H.VAESelfBlock):
            w, mlp = sub.qkv.in_features, sub.fc1.out_features
            pairs.append(_Pair(sub, {"qkv": (w, w, w)}, {"proj": (w,)}, (sub.heads,), ("heads",)))
            pairs.append(_Pair(sub, {"fc1": (mlp,)}, {"fc2": (mlp,)}, (mlp,)))
        elif isinstance(sub, H.GeoDecoder):
            w, mlp = sub.q.out_features, sub.fc1.out_features
            # the queries' q and the latent set's [k|v] over the same heads
            pairs.append(_Pair(sub, {"q": (w,), "kv": (w, w)}, {"proj": (w,)}, (sub.heads,),
                               ("heads",)))
            pairs.append(_Pair(sub, {"fc1": (mlp,)}, {"fc2": (mlp,)}, (mlp,)))
        elif isinstance(sub, H.MlpEmbedder):
            w = sub.in_layer.out_features
            pairs.append(_Pair(sub, {"in_layer": (w,)}, {"out_layer": (w,)}, (w,)))
    return pairs


def _prefix(module: nn.Module, owner: nn.Module) -> str:
    name = next(n for n, sub in module.named_modules() if sub is owner)
    return name + "." if name else ""


def tp_plan(module: nn.Module, tp: int) -> Dict[str, Tuple[str, Tuple[int, ...], bool]]:
    """{qualified name of every Linear the reference splits: (style, parts,
    paired)}. A pair of a block is split head-aligned, part by part, where the
    reference makes its column layers "col" and its row layers "row" and its
    heads (and MLP width) divide by tp; every other "col" or "row" Linear is
    split alone, as one contiguous part (its output gathered, or its input
    sliced), so that the layout stays the reference's."""
    layout = tp_layout(module, tp)
    plan: Dict[str, Tuple[str, Tuple[int, ...], bool]] = {}
    for pair in _pairs(module):
        prefix = _prefix(module, pair.owner)
        if (all(layout[prefix + c] == "col" for c in pair.cols)
                and all(layout[prefix + r] == "row" for r in pair.rows)
                and all(n % tp == 0 for n in pair.counts)):
            for c, parts in pair.cols.items():
                plan[prefix + c] = ("col", parts, True)
            for r, parts in pair.rows.items():
                plan[prefix + r] = ("row", parts, True)
    for name, style in layout.items():
        if style is not None and name not in plan:
            sub = module.get_submodule(name)
            width = sub.out_features if style == "col" else sub.in_features
            plan[name] = (style, (width,), False)
    return plan


def shard_model_params(module: nn.Module, mesh: DeviceMesh, tp_axis: str = "tp") -> nn.Module:
    """Tensor-parallel weight layout, in place: the reference's policy
    (``tp_layout``) on the port's modules (``tp_plan``). Without a ``tp_axis``
    in the mesh it only moves the module to this rank's device. The blocks
    whose pairs are split read their local heads and widths; load or draw the
    weights before sharding."""
    module.to(rank_device(mesh))
    if axis_size(mesh, tp_axis) == 1:
        return module
    tp = _TPGroup(mesh.get_group(tp_axis), mesh.get_local_rank(tp_axis),
                  axis_size(mesh, tp_axis))
    plan = tp_plan(module, tp.size)
    for pair in _pairs(module):
        if plan.get(_prefix(module, pair.owner) + next(iter(pair.cols)), ("", (), False))[2]:
            for attr in pair.local:
                setattr(pair.owner, attr, getattr(pair.owner, attr) // tp.size)
    for name, (style, parts, paired) in plan.items():
        parent_name, _, leaf = name.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        linear = getattr(parent, leaf)
        if style == "col":
            new = ColumnParallelLinear(linear, tp, parts, gather=not paired)
        else:
            new = RowParallelLinear(linear, tp, parts, scatter=not paired)
        setattr(parent, leaf, new)
    return module
