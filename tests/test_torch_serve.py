"""Serving, the host utilities and the entry step of the PyTorch port
against the JAX package: ``serve.py`` over real HTTP on 127.0.0.1 (the
routes, ``/segment`` with the heuristic bundle against the JAX ``Handler``,
``/reconstruct`` with ``run_pipeline`` stubbed: its env file, the PLYs in
base64 and the lock), ``utils/dataloader.prefetch_map``,
``utils/profiling``, and ``entry()``'s CFG denoise step at a tiny DiT
against the JAX ``HunyuanDiT`` and ``scheduler.step`` composed as
``__graft_entry__.entry`` composes them.

Tolerances: the masks equal (the heuristic bundle is the same cv2 code on the
same pixels); the denoise step 1e-5 of the largest |latent| (float32 on
both sides; measured 9.9e-8 of it).
"""

import base64
import contextlib
import dataclasses
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from followmyhold_tpu import serve as JSV
from followmyhold_tpu.diffusion import scheduler as JSCH
from followmyhold_tpu.models import hunyuan as JH
from followmyhold_tpu.utils import dataloader as JDL
from followmyhold_tpu_torch import entry as TEN
from followmyhold_tpu_torch import serve as TSV
from followmyhold_tpu_torch.models.hunyuan import DIT_TINY
from followmyhold_tpu_torch.tools._scene import hoi_photo
from followmyhold_tpu_torch.utils import dataloader as TDL
from followmyhold_tpu_torch.utils import profiling as TP
from followmyhold_tpu_torch.utils.params import flax_to_torch

from _torch_detector_models import random_params


@contextlib.contextmanager
def _serving(server):
    """``server`` answering in a thread for the block -> its base URL."""
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_port}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _request(url, payload=None):
    """-> (status, the JSON body)."""
    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png_b64(rgb):
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _decode_png(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def test_healthz_unknown_paths_and_bad_requests(tmp_path, monkeypatch):
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path))
    with _serving(TSV.make_server("127.0.0.1", 0, device="cpu")) as url:
        assert _request(url + "/healthz") == (200, {"status": "ok"})
        assert _request(url + "/nowhere") == (404, {"error": "unknown path"})
        assert _request(url + "/nowhere", {"image": ""}) == (404, {"error": "unknown path"})
        code, body = _request(url + "/segment", {"prompt": "object"})      # no image
        assert code == 500 and "image" in body["error"]


def test_segment_matches_the_reference_handler(tmp_path, monkeypatch):
    """The heuristic bundle (no converted detector files), resident after the
    first request: the same mask as the JAX server's for each prompt."""
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path))
    monkeypatch.setattr(JSV._State, "bundle", None)
    photo = hoi_photo(240, 320, seed=3)
    server = TSV.make_server("127.0.0.1", 0, device="cpu")
    with _serving(server) as url, _serving(JSV.ThreadingHTTPServer(("127.0.0.1", 0),
                                                                  JSV.Handler)) as jurl:
        for prompt in ("object", "only hand"):
            code, got = _request(url + "/segment", {"image": _png_b64(photo), "prompt": prompt})
            jcode, want = _request(jurl + "/segment", {"image": _png_b64(photo),
                                                       "prompt": prompt})
            assert code == jcode == 200
            mask = _decode_png(got["mask"])
            np.testing.assert_array_equal(mask, _decode_png(want["mask"]))
            assert mask.shape == (240, 320) and 0 < (mask > 0).mean() < 1
    assert type(server.state.bundle).__name__ == "HeuristicBundle"


def _stub_pipeline(log, lock, pause=0.0):
    """A run_pipeline that records its configuration and span and writes the
    two PLYs where stage 9 writes them."""
    def run_pipeline(cfg, device=None):
        start = time.perf_counter()
        time.sleep(pause)
        os.makedirs(cfg.guidance_out_path, exist_ok=True)
        for name in ("obj", "hand"):
            with open(os.path.join(cfg.guidance_out_path, f"query_{name}.ply"), "wb") as f:
                f.write(f"ply {name} {cfg.image_path}".encode())
        with lock:
            log.append((cfg, device, start, time.perf_counter()))
    return run_pipeline


def _fields(cfg):
    """The configuration with its temporary workspace replaced by <td>."""
    root = cfg.project_root
    return {k: (v.replace(root, "<td>") if isinstance(v, str) else v)
            for k, v in dataclasses.asdict(cfg).items()}


def test_reconstruct_writes_the_reference_env_and_returns_both_plys(tmp_path, monkeypatch):
    import followmyhold_tpu.main as jmain
    import followmyhold_tpu_torch.main as tmain

    log, lock = {"jax": [], "torch": []}, threading.Lock()
    monkeypatch.setattr(jmain, "run_pipeline", _stub_pipeline(log["jax"], lock))
    monkeypatch.setattr(tmain, "run_pipeline", _stub_pipeline(log["torch"], lock))
    photo = hoi_photo(60, 80, seed=4)
    server = TSV.make_server("127.0.0.1", 0, device="cpu")
    with _serving(server) as url, _serving(JSV.ThreadingHTTPServer(("127.0.0.1", 0),
                                                                  JSV.Handler)) as jurl:
        code, got = _request(url + "/reconstruct", {"image": _png_b64(photo)})
        jcode, want = _request(jurl + "/reconstruct", {"image": _png_b64(photo)})
    assert code == jcode == 200 and sorted(got) == sorted(want) == ["hand_ply", "obj_ply"]
    (tcfg, device, _, _), (jcfg, _, _, _) = log["torch"][0], log["jax"][0]
    assert device == torch.device("cpu")
    assert _fields(tcfg) == _fields(jcfg)
    for name in ("obj", "hand"):
        assert base64.b64decode(got[f"{name}_ply"]).decode() == f"ply {name} {tcfg.image_path}"
    assert not os.path.exists(tcfg.project_root)            # the workspace is gone


def test_reconstruct_and_segment_share_one_lock(tmp_path, monkeypatch):
    """Two concurrent /reconstruct requests and a /segment never overlap."""
    import followmyhold_tpu_torch.main as tmain
    from followmyhold_tpu_torch.preprocess.detectors import HeuristicBundle

    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path))
    log, lock = [], threading.Lock()
    monkeypatch.setattr(tmain, "run_pipeline", _stub_pipeline(log, lock, pause=0.3))
    spans = []

    class TimedBundle(HeuristicBundle):
        def segment(self, image_rgb, prompt):
            start = time.perf_counter()
            time.sleep(0.3)
            spans.append((start, time.perf_counter()))
            return super().segment(image_rgb, prompt)

    server = TSV.make_server("127.0.0.1", 0, device="cpu", bundle=TimedBundle())
    photo = _png_b64(hoi_photo(60, 80, seed=5))
    results = []
    with _serving(server) as url:
        threads = [threading.Thread(target=lambda path=path: results.append(
            _request(url + path, {"image": photo})[0]))
            for path in ("/reconstruct", "/reconstruct", "/segment")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    assert results == [200, 200, 200] and len(log) == 2 and len(spans) == 1
    intervals = sorted([(s, e) for _, _, s, e in log] + spans)
    assert all(a[1] <= b[0] for a, b in zip(intervals, intervals[1:])), intervals


@pytest.mark.parametrize("workers,prefetch", [(1, 0), (2, 4), (4, 1)])
def test_prefetch_map_keeps_the_reference_order_and_exceptions(workers, prefetch):
    def fn(x):
        time.sleep(0.002 * ((7 * x) % 5))                   # out-of-order completion
        if x % 6 == 5:
            raise ValueError(f"item {x}")
        return x * x

    def drain(prefetch_map):
        out = []
        it = prefetch_map(fn, range(20), num_workers=workers, prefetch=prefetch)
        while True:
            try:
                out.append(next(it))
            except ValueError as e:
                out.append(str(e))
                break
            except StopIteration:
                break
        return out

    got, want = drain(TDL.prefetch_map), drain(JDL.prefetch_map)
    assert got == want == [0, 1, 4, 9, 16, "item 5"]
    assert list(TDL.prefetch_map(fn, [0, 1, 2, 3, 4], num_workers=workers)) == [0, 1, 4, 9, 16]
    assert list(TDL.prefetch_map(fn, [])) == []


def test_span_summary_reset_and_device_trace(tmp_path, monkeypatch):
    TP.reset()
    for _ in range(3):
        with TP.span("decode"):
            with TP.span("inner"):
                time.sleep(0.004)
            time.sleep(0.01)
    with pytest.raises(KeyError):
        with TP.span("failing"):
            raise KeyError("x")
    text = TP.summary()
    lines = {line.split()[0]: line.split()[1:] for line in text.splitlines()[1:]}
    assert text.splitlines()[0].split() == ["span", "calls", "host_s", "device_s", "self_ms"]
    assert lines["decode"][0] == "3" and float(lines["decode"][1]) >= 0.042
    # without a card the device interval is the host's; self time leaves out the child
    assert float(lines["decode"][2]) == pytest.approx(float(lines["decode"][1]), abs=2e-3)
    assert 10.0 <= float(lines["decode"][3]) < float(lines["decode"][1]) / 3 * 1e3 - 3.0
    assert lines["inner"][0] == "3" and float(lines["inner"][3]) >= 4.0
    assert lines["failing"][0] == "1"
    assert list(lines) == ["decode", "inner", "failing"]   # the longest host total first
    TP.reset()
    assert TP.summary().splitlines()[1:] == []

    monkeypatch.delenv("FOHO_TPU_TRACE_DIR", raising=False)
    with TP.device_trace("off"):
        torch.ones(4).sum()
    assert not os.listdir(tmp_path)
    monkeypatch.setenv("FOHO_TPU_TRACE_DIR", str(tmp_path / "traces"))
    with TP.device_trace("step"):
        torch.ones(4).sum()
    with open(tmp_path / "traces" / "step.pt.trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_entry_step_matches_the_reference_composition():
    """entry()'s (fn, args) at a tiny DiT: the full-size inputs' shapes and
    types, and fn on small inputs against the JAX HunyuanDiT (bridged
    weights) and scheduler.step composed as __graft_entry__.entry does."""
    fn, (dit, latents, cond, i) = TEN.entry(DIT_TINY, device="cpu")
    assert latents.shape == (1, 3072, 64) and latents.dtype == torch.float32
    assert cond.shape == (2, 1370, DIT_TINY.context_dim) and cond.dtype == torch.bfloat16
    assert i == 0

    jcfg = dataclasses.replace(JH.DIT_TINY)
    jdit = JH.HunyuanDiT(jcfg)
    rng = np.random.default_rng(7)
    lat = rng.normal(size=(1, 40, 64)).astype(np.float32)
    cnd = rng.normal(size=(2, 12, jcfg.context_dim)).astype(np.float32)
    params = random_params(lambda k: jdit.init(k, jnp.asarray(lat), jnp.zeros(1),
                                               jnp.asarray(cnd[:1])), 8)
    flax_to_torch(params, dit)
    sched = JSCH.make_schedule(sigmas=np.linspace(0, 1, 20))

    @jax.jit
    def denoise_step(params, latents, cond, i):
        t = sched.timesteps[i] / sched.num_train_timesteps
        lat_in = jnp.concatenate([latents, latents], axis=0)
        eps = jdit.apply(params, lat_in, jnp.full((2,), t, latents.dtype), cond)
        eps_c, eps_u = jnp.split(eps, 2, axis=0)
        new_latents, _ = JSCH.step(sched, i, eps_u + 5.0 * (eps_c - eps_u), latents)
        return new_latents

    for step_index in (0, 7):
        with jax.default_matmul_precision("highest"):
            want = np.asarray(denoise_step(params, jnp.asarray(lat), jnp.asarray(cnd),
                                           jnp.asarray(step_index)))
        got = fn(dit, torch.from_numpy(lat), torch.from_numpy(cnd), step_index).numpy()
        assert got.shape == want.shape == lat.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), step_index
