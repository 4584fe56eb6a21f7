"""How far the rasterizer's float32 gradients are from a float64 run.

    python3 -m followmyhold_tpu_torch.tools.raster_bwd_float64

On the synthetic hand scene at 512x512, with random upstream gradients, compare
three gradients of (w1, w2, vis) to the packed face coordinates: the backward
kernel (closed forms, float32), autograd of the plain version in float32, and
autograd of the plain version in float64. The kernel test's tolerance rests on
this: at pixels whose centre lies within float32 rounding of an edge's line,
both float32 versions leave the float64 answer by the same order.
"""

from __future__ import annotations

import torch

from followmyhold_tpu_torch.ops import rasterizer as R
from followmyhold_tpu_torch.tools._scene import hand_scene


def main() -> None:
    dev = torch.device("cuda:0")
    mano, verts, camera, _ = hand_scene(dev)
    packed = R.bin_and_pack(camera, verts, mano.faces,
                            torch.ones(mano.faces.shape[0], device=dev), 0.7, 2048)
    geom, tile_start, meta = packed.geom, packed.tile_start, packed.meta
    got = R.raster_tiles_forward(geom, tile_start, meta)
    gen = torch.Generator(device=dev).manual_seed(7)
    ups = [torch.randn(got[0].shape, generator=gen, device=dev) for _ in range(3)]
    parts = {"all": ups,
             "winner (w1, w2)": [ups[0], ups[1], torch.zeros_like(ups[2])],
             "coverage (vis)": [torch.zeros_like(ups[0]), torch.zeros_like(ups[1]), ups[2]]}
    print(torch.cuda.get_device_name(0))
    for name, (gw1, gw2, gvis) in parts.items():
        kernel = R.raster_tiles_backward(geom, tile_start, got[2], got[3], gw1, gw2, gvis,
                                         meta).double()
        ref = {}
        for dtype in (torch.float32, torch.float64):
            g = geom.to(dtype).clone().requires_grad_(True)
            out = R.raster_tiles_plain(g, tile_start, meta)
            loss = ((out[0] * gw1.to(dtype)).sum() + (out[1] * gw2.to(dtype)).sum()
                    + (out[3] * gvis.to(dtype)).sum())
            ref[dtype] = torch.autograd.grad(loss, g)[0].double()
        f32, f64 = ref[torch.float32], ref[torch.float64]
        print(f"{name}: max|f64| {f64.abs().max().item():.4e}  kernel-f64 "
              f"{(kernel - f64).abs().max().item():.3e}  plain32-f64 "
              f"{(f32 - f64).abs().max().item():.3e}  kernel-plain32 "
              f"{(kernel - f32).abs().max().item():.3e}")


if __name__ == "__main__":
    main()
