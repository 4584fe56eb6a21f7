"""HTTP serving with the models resident on the card.

Counterpart of followmyhold_tpu/serve.py: a standard-library threaded HTTP
server with the reference's routes and JSON,

  POST /segment      {image: b64 png, prompt: str} -> {mask: b64 png}
  POST /reconstruct  {image: b64 png}              -> {obj_ply: b64, hand_ply: b64}
  GET  /healthz                                    -> {status: "ok"}

``/segment`` runs the detector bundle (``preprocess.detectors.default_bundle``
on the server's device: the learned stack where its four converted files
exist), built at the first request and kept. ``/reconstruct`` runs the whole
pipeline (``main.run_pipeline``) on the photo in a fresh temporary workspace
with its own env file, and returns the two PLYs that stage 9 writes.

Both routes take one lock, where the reference locks only ``/segment``:
``run_pipeline`` sets the process-wide FOHO_PROJECT_ROOT and FOHO_TPU_ASSETS,
and one pipeline peaks near half of an 80 GB card, so two at once would not
fit beside each other.

    python -m followmyhold_tpu_torch.serve --port 8080 [--host 127.0.0.1] [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import sys
import tempfile
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device


class ServeState:
    """What the server keeps between requests: its device, the resident
    detector bundle (built at the first ``/segment`` where none is given) and
    the lock that every route's work takes."""

    def __init__(self, device: DeviceLike = "cuda", bundle=None):
        self.device = resolve_device(device)
        self.bundle = bundle
        self.lock = threading.Lock()

    def segment(self, image_rgb: np.ndarray, prompt: str) -> np.ndarray:
        from followmyhold_tpu_torch.preprocess.detectors import default_bundle

        with self.lock:
            if self.bundle is None:
                self.bundle = default_bundle(self.device)
            return self.bundle.segment(image_rgb, prompt)

    def reconstruct(self, image_rgb: np.ndarray) -> dict:
        with self.lock:
            return _reconstruct(image_rgb, self.device)


def _reconstruct(image_rgb: np.ndarray, device) -> dict:
    """The whole pipeline on one photo in a fresh temporary workspace (the
    image id "query") -> the exported PLYs in base64, those that exist."""
    from PIL import Image

    from followmyhold_tpu_torch.configs.pipeline import load_config
    from followmyhold_tpu_torch.main import run_pipeline

    with tempfile.TemporaryDirectory() as td:
        img_path = os.path.join(td, "query.png")
        Image.fromarray(image_rgb).save(img_path)
        cfg_path = os.path.join(td, "pipeline.env")
        with open(cfg_path, "w", encoding="utf-8") as f:
            f.write(f"PROJECT_ROOT={td}\nBASE_DIR={td}/out\nIMAGE_PATH={img_path}\n")
        cfg = load_config(cfg_path)
        run_pipeline(cfg, device=device)
        out = {}
        for name, path in (("obj_ply", f"{cfg.guidance_out_path}/query_obj.ply"),
                           ("hand_ply", f"{cfg.guidance_out_path}/query_hand.ply")):
            if os.path.exists(path):
                with open(path, "rb") as f:
                    out[name] = base64.b64encode(f.read()).decode("ascii")
        return out


class Handler(BaseHTTPRequestHandler):
    """The routes; the server's ``state`` (a ``ServeState``) does the work."""

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            self._json(200, {"status": "ok"})
        else:
            self._json(404, {"error": "unknown path"})

    def do_POST(self):  # noqa: N802
        from PIL import Image

        if self.path not in ("/segment", "/reconstruct"):
            self._json(404, {"error": "unknown path"})
            return
        state = self.server.state
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length))
            img = np.asarray(Image.open(io.BytesIO(base64.b64decode(req["image"]))).convert("RGB"))
            if self.path == "/segment":
                mask = state.segment(img, req.get("prompt", "object"))
                buf = io.BytesIO()
                Image.fromarray((mask * 255).astype(np.uint8)).save(buf, "PNG")
                self._json(200, {"mask": base64.b64encode(buf.getvalue()).decode()})
            else:
                self._json(200, state.reconstruct(img))
        except Exception as e:  # noqa: BLE001 - the server answers and keeps serving
            traceback.print_exception(type(e), e, e.__traceback__, file=sys.stderr)
            self._json(500, {"error": str(e)})

    def log_message(self, fmt, *args):  # quiet
        pass


def make_server(host: str = "127.0.0.1", port: int = 8080, device: DeviceLike = "cuda",
                bundle=None) -> ThreadingHTTPServer:
    """A server bound to (host, port) (port 0: any free port) whose state
    runs on ``device``, with ``bundle`` resident where given."""
    state = ServeState(device, bundle)
    server = ThreadingHTTPServer((host, port), Handler)
    server.state = state
    return server


def main() -> None:
    parser = argparse.ArgumentParser(description="HTTP serving of the port")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    server = make_server(args.host, args.port, args.device)
    print(f"serving on http://{args.host}:{server.server_port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
