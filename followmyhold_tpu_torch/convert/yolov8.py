"""Ultralytics YOLOv8 checkpoint -> the ``yolov8_wilor`` parameter file (the
WiLoR hand detector; the port's copy of the reference's
``convert/yolov8.py``).

Conv+BatchNorm pairs are FUSED at conversion time (inference-only):
    w' = w * gamma / sqrt(var + eps);  b' = beta - gamma * mean / sqrt(var + eps)

The WiLoR detector.pt pickles an ultralytics Model object; extract its state
dict on any machine with ultralytics via

    torch.save(torch.load('detector.pt')['model'].float().state_dict(), 'sd.pt')

or let --ckpt try a permissive unpickler that stubs the ultralytics classes
(it runs the file's pickle: convert only a checkpoint you trust).

    python -m followmyhold_tpu_torch.convert.yolov8 --ckpt sd.pt --width 16
"""

from __future__ import annotations

import argparse
import re
from typing import Any, Dict

import torch

from followmyhold_tpu_torch.convert.common import (
    ConversionReport,
    as_tensor,
    conv_kernel,
    filled,
    put,
)
from followmyhold_tpu_torch.models.yolov8 import YoloV8, YoloV8Config
from followmyhold_tpu_torch.utils.params import save_params, torch_to_flax


def fuse_conv_bn(w, gamma, beta, mean, var, eps=1e-3):
    """torch conv weight [out,in,kh,kw] + BN stats -> (fused w, bias), in
    float64 and rounded once to float32."""
    w = as_tensor(w).double()
    scale = as_tensor(gamma).double() / torch.sqrt(as_tensor(var).double() + eps)
    wf = w * scale[:, None, None, None]
    bf = as_tensor(beta).double() - scale * as_tensor(mean).double()
    return wf.float(), bf.float()


def _map_name(torch_mod: str) -> str:
    """'2.m.0.cv1' -> 'm2/m0/cv1'; '22.cv2.1.0' -> 'm22/cv2_1_0'."""
    parts = torch_mod.split(".")
    out = [f"m{parts[0]}"]
    i = 1
    while i < len(parts):
        p = parts[i]
        if p == "m" and i + 1 < len(parts):
            out.append(f"m{parts[i + 1]}")
            i += 2
        elif p in ("cv2", "cv3") and out[0] == "m22" and i + 2 <= len(parts) - 1:
            out.append(f"{p}_{parts[i + 1]}_{parts[i + 2]}")
            i += 3
        else:
            out.append(p)
            i += 1
    return "/".join(out)


def convert_yolov8(torch_sd: Dict[str, Any], cfg: YoloV8Config | None = None):
    cfg = cfg or YoloV8Config()
    model = YoloV8(cfg, device="meta")
    params = torch_to_flax(model)
    report = ConversionReport()
    sd = {re.sub(r"^model\.(model\.)?", "", k): as_tensor(v)
          for k, v in torch_sd.items()}
    # drop the DFL integral conv (a fixed arange; the model implements it in
    # math) and BN's num_batches_tracked counters
    sd = {k: v for k, v in sd.items()
          if "dfl" not in k and not k.endswith("num_batches_tracked")}

    mods = sorted({k.rsplit(".", 1)[0] for k in sd if k.endswith(".weight")})
    for mod in mods:
        if mod.endswith(".bn"):
            continue                      # handled with its conv
        if mod.endswith(".conv") and f"{mod[:-5]}.bn.weight" in sd:
            base = mod[:-5]
            wf, bf = fuse_conv_bn(
                sd.pop(f"{base}.conv.weight"), sd.pop(f"{base}.bn.weight"),
                sd.pop(f"{base}.bn.bias"), sd.pop(f"{base}.bn.running_mean"),
                sd.pop(f"{base}.bn.running_var"))
            dst = _map_name(base)
            put(params, f"params/{dst}/conv/kernel", conv_kernel(wf), report)
            put(params, f"params/{dst}/conv/bias", bf, report)
        else:
            # plain conv (Detect head's final 1x1s)
            dst = _map_name(mod)
            put(params, f"params/{dst}/kernel",
                conv_kernel(sd.pop(f"{mod}.weight")), report)
            if f"{mod}.bias" in sd:
                put(params, f"params/{dst}/bias", sd.pop(f"{mod}.bias"), report)

    report.unused_src.extend(sd.keys())
    return filled(params, model), report


def load_ultralytics_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Best-effort load: a plain state dict, or an ultralytics checkpoint
    unpickled with stubbed classes."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and all(isinstance(v, torch.Tensor)
                                         for v in obj.values()):
            return dict(obj)
    except Exception:
        pass

    import pickle
    import types
    import zipfile

    class _Stub:
        def __init__(self, *a, **k):
            pass

        def __setstate__(self, state):
            self.__dict__.update(state if isinstance(state, dict) else {})

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith(("ultralytics", "models", "nn")):
                return type(name, (_Stub,), {})
            return super().find_class(module, name)

    with open(path, "rb") as f:
        if zipfile.is_zipfile(path):
            obj = torch.load(path, map_location="cpu", weights_only=False,
                             pickle_module=types.SimpleNamespace(
                                 Unpickler=_Unpickler, load=pickle.load))
        else:
            obj = _Unpickler(f).load()
    model = obj.get("model", obj) if isinstance(obj, dict) else obj
    sd = getattr(model, "state_dict", None)
    if callable(sd):
        return dict(sd())
    raise ValueError("Could not extract a state dict; export it with "
                     "ultralytics first (see module docstring)")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--width", type=int, default=16)
    parser.add_argument("--depth_mult", type=float, default=0.33)
    parser.add_argument("--num_classes", type=int, default=2)
    args = parser.parse_args(argv)
    sd = load_ultralytics_state_dict(args.ckpt)
    cfg = YoloV8Config(base_width=args.width, depth_mult=args.depth_mult,
                       num_classes=args.num_classes)
    params, report = convert_yolov8(sd, cfg)
    print(report.summary())
    print("saved ->", save_params("yolov8_wilor", params))
    if report.missing_src or report.unused_src:
        print("naming drift:", report.missing_src[:8], report.unused_src[:8])


if __name__ == "__main__":
    main()
