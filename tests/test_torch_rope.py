"""The FLUX blocks' attention prologue (``followmyhold_tpu_torch/ops/rope.py``)
on the CPU.

- ``qk_norm_rope_plain`` gives the bits of the chain the blocks ran before it
  (each stream's ``QKNorm``, ``torch.cat`` of the text and image streams,
  ``apply_rope``; copied below as it was), for a single and a double block, at
  ``FLUX_TINY_TEST`` (float32, 3 heads of 16) and at FLUX.1's 24 heads of 128
  in bf16; the tiny transformer's output is the same bits through either.
- The dispatch: tensors off the card take the plain version, bf16 at FLUX.1's
  head size of 128 as well as float32 and other head sizes.
- The kernel wrapper's checks, which raise before any library is loaded.
- ``chip_smoke.py``'s check of the kernel (q and k within one bf16 ulp of their
  pair's length and few of them differing, v the same bits) on a float32
  emulation of the kernel's arithmetic, whose sum of squares adds in the
  kernel's order: the check passes it and rejects its mutants, a norm in lower
  precision among them. The kernel itself runs only on the card, in
  ``chip_smoke.py``.
- ``chip_smoke.py`` puts the rasterizer's overlay measurements on the kernels
  that made them, whatever else its list of kernels holds.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from followmyhold_tpu_torch.models import flux as F
from followmyhold_tpu_torch.models.hunyuan import _split_heads
from followmyhold_tpu_torch.ops import _kernels
from followmyhold_tpu_torch.ops import rope as R


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---- the chain the blocks ran before ops/rope, as it was ------------------- #

def _former_qk_norm(x, weight):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * weight).to(x.dtype)


def _former_apply_rope(x, cos, sin):
    xr = x.float().reshape(*x.shape[:-1], -1, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    c, s = cos[None, None], sin[None, None]
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _former_chain(streams, cos, sin, heads):
    if len(streams) == 1:   # FluxSingleBlock
        q, k, v, wq, wk = streams[0]
        return (_former_apply_rope(_former_qk_norm(_split_heads(q, heads), wq), cos, sin),
                _former_apply_rope(_former_qk_norm(_split_heads(k, heads), wk), cos, sin),
                _split_heads(v, heads))
    (tq, tk, tv, twq, twk), (q, k, v, wq, wk) = streams   # FluxDoubleBlock: [txt, img]
    q = _former_qk_norm(_split_heads(q, heads), wq)
    k = _former_qk_norm(_split_heads(k, heads), wk)
    v = _split_heads(v, heads)
    tq = _former_qk_norm(_split_heads(tq, heads), twq)
    tk = _former_qk_norm(_split_heads(tk, heads), twk)
    tv = _split_heads(tv, heads)
    return (_former_apply_rope(torch.cat([tq, q], dim=2), cos, sin),
            _former_apply_rope(torch.cat([tk, k], dim=2), cos, sin),
            torch.cat([tv, v], dim=2))


# ---- inputs ------------------------------------------------------------------ #

# (heads, head size, rope axes, dtype): the tiny test configuration and FLUX.1's
SHAPES = {"tiny_f32": (3, 16, F.FLUX_TINY_TEST.axes_dims_rope, torch.float32),
          "flux_bf16": (24, 128, F.FLUX_DEV.axes_dims_rope, torch.bfloat16)}


def _rope(n_txt, h2, w2, axes):
    """cos, sin of a Kontext joint sequence: n_txt text rows, then the noisy and
    the context latents of an h2 x w2 packed grid."""
    ids = np.concatenate([np.zeros((n_txt, 3), np.float32), F.latent_ids(h2, w2, 0),
                          F.latent_ids(h2, w2, 1)])
    return F.rope_freqs(torch.from_numpy(ids), axes)


def _streams(sizes, heads, d, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for n in sizes:
        qkv = [torch.randn((1, n, heads * d), generator=gen).to(dtype) for _ in range(3)]
        norms = [1.0 + 0.1 * torch.randn(d, generator=gen) for _ in range(2)]
        out.append((*qkv, *norms))
    return out


def _case(shape, block, n_txt=6, h2=3, w2=4, seed=0):
    heads, d, axes, dtype = SHAPES[shape]
    n_img = 2 * h2 * w2
    sizes = [n_txt + n_img] if block == "single" else [n_txt, n_img]
    cos, sin = _rope(n_txt, h2, w2, axes)
    return _streams(sizes, heads, d, dtype, seed), cos, sin, heads


# ---- the plain version ------------------------------------------------------- #

@pytest.mark.parametrize("block", ["single", "double"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_is_the_former_chain_bit_for_bit(shape, block):
    streams, cos, sin, heads = _case(shape, block)
    got = R.qk_norm_rope_plain(streams, cos, sin, heads)
    want = _former_chain(streams, cos, sin, heads)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == streams[0][0].dtype
        assert g.shape == w.shape
        assert torch.equal(g, w)


def test_tiny_transformer_is_the_former_chains_bits(monkeypatch):
    """Every block goes through ``qk_norm_rope`` once, and the transformer's
    output equals the one the former chain gives, bit for bit."""
    c = F.FLUX_TINY_TEST
    torch.manual_seed(0)
    model = F.FluxTransformer(c).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():   # norm scales away from 1
            if name.endswith(("norm_q.weight", "norm_k.weight", "added_q.weight",
                              "added_k.weight")):
                p.add_(0.1 * torch.randn_like(p))
    gen = torch.Generator().manual_seed(1)
    n_txt, h2, w2 = 7, 4, 4
    n_img = 2 * h2 * w2
    img_ids = torch.from_numpy(np.concatenate([F.latent_ids(h2, w2, 0),
                                               F.latent_ids(h2, w2, 1)]))
    inputs = (torch.randn((1, n_img, c.in_channels), generator=gen),
              torch.randn((1, n_txt, c.joint_dim), generator=gen),
              torch.randn((1, c.pooled_dim), generator=gen), torch.tensor([0.6]), img_ids,
              torch.zeros(n_txt, 3), torch.tensor([2.5]))
    calls = []

    def counted(streams, cos, sin, heads):
        calls.append(len(streams))
        return R.qk_norm_rope(streams, cos, sin, heads)

    with torch.no_grad():
        monkeypatch.setattr(F, "qk_norm_rope", counted)
        got = model(*inputs)
        monkeypatch.setattr(F, "qk_norm_rope", _former_chain)
        want = model(*inputs)
    assert calls == [2] * c.num_layers + [1] * c.num_single_layers
    assert torch.equal(got, want)


# ---- the dispatch ------------------------------------------------------------ #

@pytest.mark.parametrize("shape, head_dim", [("flux_bf16", 128), ("flux_bf16", 96),
                                             ("tiny_f32", 16), ("flux_f32", 128)])
def test_dispatch_takes_the_plain_version_on_the_cpu(monkeypatch, shape, head_dim):
    """Tensors off the card, bf16 at the kernel's head size as well as float32
    and other head sizes: the plain version, no launch."""
    heads, _, axes, dtype = SHAPES["flux_bf16" if shape == "flux_f32" else shape]
    dtype = torch.float32 if shape == "flux_f32" else dtype
    axes = axes if head_dim == sum(axes) else (16, 40, 40)   # 96 = 16 + 40 + 40
    cos, sin = _rope(4, 2, 3, axes)
    streams = _streams([4, 12], heads, head_dim, dtype, seed=3)

    def no_kernel(*args, **kwargs):
        raise AssertionError("the kernel path was taken")

    monkeypatch.setattr(R, "qk_norm_rope_forward", no_kernel)
    before = _kernels.launch_counts()["qk_norm_rope"]
    got = R.qk_norm_rope(streams, cos, sin, heads)
    want = R.qk_norm_rope_plain(streams, cos, sin, heads)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _kernels.launch_counts()["qk_norm_rope"] == before


# ---- the kernel wrapper -------------------------------------------------------- #

def _joint_out(B, heads, n_joint, d):
    return tuple(torch.empty((B, heads, n_joint, d), dtype=torch.bfloat16) for _ in range(3))


@pytest.mark.parametrize("fault, error", [
    ("offset past the end", ValueError),
    ("negative offset", ValueError),
    ("head size 16", NotImplementedError),
    ("float32 projections", ValueError),
    ("cos rows", ValueError),
    ("norm scale size", ValueError),
    ("strided output", ValueError),
    ("float16 projections", ValueError),
    ("row stride 260", ValueError),
    ("misaligned rows", ValueError),
    ("row strides differ", ValueError),
    ("strided columns", ValueError),
    ("float64 norm scale", ValueError),
    ("transposed sin", ValueError),
])
def test_wrapper_raises_before_any_launch(monkeypatch, fault, error):
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_kernels, "load_library", no_library)
    heads, d, n_txt, n_img = 2, 128, 8, 24
    stream = _streams([n_img], heads, d, torch.bfloat16, seed=4)[0]
    cos, sin = torch.zeros(n_txt + n_img, d // 2), torch.zeros(n_txt + n_img, d // 2)
    out, offset = _joint_out(1, heads, n_txt + n_img, d), n_txt
    if fault == "offset past the end":
        offset = n_txt + 1
    elif fault == "negative offset":
        offset = -1
    elif fault == "head size 16":
        heads = 8
        out = _joint_out(1, heads, n_txt + n_img, 16)
    elif fault == "float32 projections":
        stream = (stream[0].float(), *stream[1:])
    elif fault == "cos rows":
        cos = cos[1:]
    elif fault == "norm scale size":
        stream = (*stream[:3], stream[3][:-1], stream[4])
    elif fault == "strided output":
        wide = torch.empty((1, heads, n_txt + n_img, 2 * d), dtype=torch.bfloat16)
        out = (wide[..., :d], *out[1:])
    elif fault == "float16 projections":
        stream = tuple(x.half() if i < 3 else x for i, x in enumerate(stream))
    elif fault == "row stride 260":   # not a multiple of 8 elements
        rows = torch.zeros((3, 1, n_img, heads * d + 4), dtype=torch.bfloat16)
        stream = (*rows[..., :heads * d], *stream[3:])
    elif fault == "misaligned rows":
        flat = torch.zeros(n_img * heads * d + 1, dtype=torch.bfloat16)
        stream = (flat[1:].view(1, n_img, heads * d), *stream[1:])
    elif fault == "row strides differ":
        wide = torch.zeros((1, n_img, heads * d + 64), dtype=torch.bfloat16)
        stream = (*stream[:2], wide[..., :heads * d], *stream[3:])
    elif fault == "strided columns":
        wide = torch.zeros((1, n_img, 2 * heads * d), dtype=torch.bfloat16)
        stream = (wide[..., ::2], *stream[1:])
    elif fault == "float64 norm scale":
        stream = (*stream[:3], stream[3].double(), stream[4])
    elif fault == "transposed sin":
        sin = torch.zeros(d // 2, n_txt + n_img).t()
    with pytest.raises(error):
        R.qk_norm_rope_into(stream, cos, sin, heads, out, offset)


# ---- chip_smoke.py's check, on an emulation of the kernel -------------------- #

def _emulated_norm(x, weight, heads, lowered=None):
    """csrc/qk_norm_rope.cu's RMS-norm of x [B, n, H * D] in float32: each
    thread sums the squares of its 8 columns in order, then the D / 8 threads
    of a head fold their sums by xor shuffles (halves added, in float32).
    ``lowered``: "sum" or "rsqrt" rounds that value to bf16, a norm in lower
    precision."""
    B, n, width = x.shape
    d = width // heads
    xf = _split_heads(x, heads).float()
    sq = (xf * xf).reshape(B, heads, n, d // 8, 8)
    acc = sq[..., 0]
    for j in range(1, 8):
        acc = acc + sq[..., j]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    if lowered == "sum":
        acc = acc.to(torch.bfloat16).float()
    r = torch.rsqrt(acc * (1.0 / d) + R.QK_NORM_EPS)
    if lowered == "rsqrt":
        r = r.to(torch.bfloat16).float()
    return (xf * r * weight).to(x.dtype)


def _emulated_kernel(streams, cos, sin, heads, offsets=None, lowered=None):
    """The kernel path, one stream at a time into joint buffers (zeros), each
    at its offset (by default one after another)."""
    B, width = streams[0][0].shape[0], streams[0][0].shape[2]
    n_joint, d = cos.shape[0], width // heads
    out = [torch.zeros((B, heads, n_joint, d), dtype=torch.bfloat16) for _ in range(3)]
    at = 0
    for s, (q, k, v, wq, wk) in enumerate(streams):
        n = q.shape[1]
        o = at if offsets is None else offsets[s]
        c, si = cos[o:o + n], sin[o:o + n]
        out[0][:, :, o:o + n] = R.apply_rope(_emulated_norm(q, wq, heads, lowered), c, si)
        out[1][:, :, o:o + n] = R.apply_rope(_emulated_norm(k, wk, heads, lowered), c, si)
        out[2][:, :, o:o + n] = _split_heads(v, heads)
        at += n
    return tuple(out)


def _check_case(block):
    """24 x 128 heads, 128 text rows and two 16 x 16 latent grids (640 joint
    rows), with inputs 4x the unit scale so the sums of squares carry
    rounding."""
    streams, cos, sin, heads = _case("flux_bf16", block, n_txt=128, h2=16, w2=16, seed=5)
    streams = [tuple(x * 4 if i < 3 else x for i, x in enumerate(s)) for s in streams]
    return streams, cos, sin, heads


@pytest.mark.parametrize("block", ["single", "double"])
def test_chip_check_holds_the_kernels_rounding(block):
    """The emulated kernel within one ulp of each pair's length, few of its q
    and k elements differing, v exact."""
    cs = _chip_smoke()
    streams, cos, sin, heads = _check_case(block)
    want = R.qk_norm_rope_plain(streams, cos, sin, heads)
    got = _emulated_kernel(streams, cos, sin, heads)
    assert cs._prologue_faults(got, want) == []
    assert max(cs.rope_pair_ulps(g, w).max().item() for g, w in zip(got[:2], want[:2])) <= 1.0
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("block, mutant", [
    ("single", "sign flipped"), ("double", "sign flipped"),
    ("double", "image rows one early"),
    ("single", "sum of squares in bf16"), ("double", "sum of squares in bf16"),
    ("single", "rsqrt in bf16"), ("double", "rsqrt in bf16"),
    ("single", "chip_smoke's 1/rms in bf16"), ("double", "chip_smoke's 1/rms in bf16"),
])
def test_chip_check_rejects_its_mutants(block, mutant):
    """One pair's rotation sign flipped, the image rows written one row early,
    and a norm in lower precision (the emulated kernel's sum of squares or
    1/rms rounded to bf16; chip_smoke.py's own mutant of that kind on the plain
    version) all fail the check."""
    cs = _chip_smoke()
    streams, cos, sin, heads = _check_case(block)
    want = R.qk_norm_rope_plain(streams, cos, sin, heads)
    if mutant == "sign flipped":
        flipped_sin = sin.clone()
        flipped_sin[:, 5] = -flipped_sin[:, 5]
        got = R.qk_norm_rope_plain(streams, cos, flipped_sin, heads)
    elif mutant == "image rows one early":
        got = _emulated_kernel(streams, cos, sin, heads, offsets=[0, 127])
    elif mutant == "sum of squares in bf16":
        got = _emulated_kernel(streams, cos, sin, heads, lowered="sum")
    elif mutant == "rsqrt in bf16":
        got = _emulated_kernel(streams, cos, sin, heads, lowered="rsqrt")
    else:
        got = cs.prologue_norm_lowered(streams, cos, sin, heads)
    assert cs._prologue_faults(got, want)


def test_pair_ulps_are_a_bf16_ulp_of_the_pairs_length():
    cs = _chip_smoke()
    want = torch.tensor([[3.0, 4.0, 0.0, 0.0]])           # lengths 5 and 0
    got = want + torch.tensor([[2.0 ** -5, 0.0, 0.0, 2.0 ** -140]])
    ulps = cs.rope_pair_ulps(got, want)
    # 5 lies in [4, 8): a bf16 ulp of 2^-5; the zero pair is held to the least subnormal
    assert ulps[0, :2].tolist() == [1.0, 0.0]
    assert ulps[0, 3].item() == pytest.approx(2.0 ** -7)


def test_overlays_land_on_the_rasterizer_kernels():
    """Whatever precedes or follows them in the list, raster_fwd and raster_bwd
    get their own overlay measurements and no other kernel gets any."""
    cs = _chip_smoke()
    names = ["flash_attention_fwd", "flash_attention_bwd", "raster_chunk_plan", "raster_fwd",
             "raster_bwd", "scatter_rows_add", "qk_norm_rope"]
    kernels = [{"name": n} for n in names]
    cs.attach_raster_overlays(kernels, ("fwd", "bwd"), ("multi fwd", "multi bwd"))
    by_name = {k["name"]: k for k in kernels}
    assert by_name["raster_fwd"] == {"name": "raster_fwd", "overlay_mesh": "fwd",
                                     "multi_hand_overlay_mesh": "multi fwd"}
    assert by_name["raster_bwd"] == {"name": "raster_bwd", "overlay_mesh": "bwd",
                                     "multi_hand_overlay_mesh": "multi bwd"}
    assert all(set(k) == {"name"} for k in kernels if k["name"] not in ("raster_fwd",
                                                                         "raster_bwd"))
