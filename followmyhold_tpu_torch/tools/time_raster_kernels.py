"""Time the rasterizer kernels (K3 forward, K4 backward) on the card at the
main path's shapes, for comparing two versions of the package in one call.

    PYTHONPATH=<checkout> python3 followmyhold_tpu_torch/tools/time_raster_kernels.py --label L

Uses only the wrappers' common signatures (``raster_tiles_forward(geom,
tile_start, meta)``, ``raster_tiles_backward(geom, tile_start, slot, vis, gw1,
gw2, gvis, meta)``), so one checkout's copy of this script times another
checkout's kernels: run it by its path (not with ``-m``, which would put the
working directory first) with that checkout on ``PYTHONPATH``. Shapes:
the synthetic MANO hand (1,538 faces) and a 60,912-face sphere from marching
tets, both at 512x512, binned as ``chip_smoke.py`` bins them. Each wrapper
call is timed twice: eagerly (CUDA events around 50 calls, which includes any
host time the call spends when that exceeds its device time) and as the
replay of a CUDA graph of 20 calls (device time only). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch


def _events_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_call(fn, eager_iters: int = 50, graph_calls: int = 20, replays: int = 5) -> dict:
    """Eager and CUDA-graph milliseconds per call of ``fn``."""
    for _ in range(3):
        fn()
    eager = _events_ms(fn, eager_iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(graph_calls):
            fn()
    graph.replay()
    replayed = _events_ms(graph.replay, replays) / graph_calls
    del graph
    return dict(eager_ms=eager, graph_ms=replayed)


def _shapes(dev):
    from followmyhold_tpu_torch.ops.grid import generate_dense_grid_points
    from followmyhold_tpu_torch.ops.rasterizer import bin_and_pack
    from followmyhold_tpu_torch.ops.surface import marching_tets
    from followmyhold_tpu_torch.tools._scene import hand_scene

    mano, verts, camera, _ = hand_scene(dev, 512)
    yield "hand", bin_and_pack(camera, verts, mano.faces,
                               torch.ones(mano.faces.shape[0], device=dev), 0.7, 2048)
    xyz, _, _ = generate_dense_grid_points([-1.1] * 3, [1.1] * 3, 64, device=dev)
    sphere = marching_tets(xyz.norm(dim=-1) - 0.8, [-1.1] * 3, [1.1] * 3, 64)
    nf = sphere.num_faces
    obj_verts = sphere.verts * 0.25 + torch.tensor([0.0, 0.0, -0.8], device=dev)
    yield "object", bin_and_pack(camera, obj_verts, sphere.faces[:nf],
                                 torch.ones(nf, device=dev), 0.7, 24576)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels are timed on a GPU only")
    from followmyhold_tpu_torch.ops import rasterizer as R

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    result = dict(label=args.label, source=R.__file__, device=smi)
    gen = torch.Generator(device=dev).manual_seed(7)
    for tag, packed in _shapes(dev):
        geom, tile_start, meta = packed.geom, packed.tile_start, packed.meta
        w1, w2, slot, vis = R.raster_tiles_forward(geom, tile_start, meta)
        gw1, gw2, gvis = (torch.randn(w1.shape, generator=gen, device=dev) for _ in range(3))
        result[tag] = dict(
            columns=int(geom.shape[1]),
            fwd=time_call(lambda: R.raster_tiles_forward(geom, tile_start, meta)),
            bwd=time_call(lambda: R.raster_tiles_backward(geom, tile_start, slot, vis, gw1, gw2,
                                                          gvis, meta)))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
