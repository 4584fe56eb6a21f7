"""The hand-removal inpainting stage (stage 3).

Counterpart of followmyhold_tpu/preprocess/inpaint.py, with the same inputs,
files and skips: per cropped HOI image {id}_cropped_hoi_{0|1}.png, remove the
hand and keep the object, writing {id}_inpainted_{0|1}.png under save_dir; an
existing output is skipped. The hand mask is
{mask_dir}/{id}_cropped_hand_mask.png (default: cropped_hand_masks beside the
crops' directory); the object's name comes from the Gemini CSV's third column.

Backends, as the reference chooses them:

- FLUX.1-Kontext (``FluxKontextInpainter``: FLUX.1-Kontext-dev, the FLUX VAE,
  CLIP-L and T5-XXL; prompt "Remove hands but keep the {object}.", 28 steps,
  guidance 2.5, the same noise for every image). ``run(models=...)`` and
  ``inpaint_hand(models=...)`` take a built inpainter on the card; with one,
  the FLUX path runs or raises. ``build_inpainter`` makes one with seeded
  random weights at the published widths and depths, built on the device in
  bf16.
- Without ``models``, the reference's choice: where the four converted
  parameter files exist (``utils.params.has_params``) they are loaded
  (``_learned_inpainter``); where any is absent, the classical Telea fill
  over the dilated hand mask (``cv2``, imported there).

    python -m followmyhold_tpu_torch.preprocess.inpaint --save_dir <dir> \\
        --cropped_img_dir <crops> [--mask_dir <masks>] [--gemini_responses <csv>]

The command line takes the reference's choice of backend: it has no models to
pass.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Mapping, Optional

import numpy as np
import torch
from PIL import Image

from followmyhold_tpu_torch.models.clip_text import CLIP_L, ClipTextConfig, ClipTextModel
from followmyhold_tpu_torch.models.flux import (
    FLUX_DEV,
    FLUX_VAE,
    FluxConfig,
    FluxTransformer,
    FluxVae,
    FluxVaeConfig,
    kontext_edit,
)
from followmyhold_tpu_torch.models.t5 import T5_XXL, T5Config, T5Encoder
from followmyhold_tpu_torch.preprocess.gemini_objname import read_names
from followmyhold_tpu_torch.utils.artifacts import parse_cropped_hoi_name
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device
from followmyhold_tpu_torch.utils.params import has_params, init_random_, load_params
from followmyhold_tpu_torch.utils.profiling import anchor, span
from followmyhold_tpu_torch.utils.prng import SEED_INPAINT, stage_generator


def tokenize_flux_prompt(prompt: str, clip_cfg: ClipTextConfig, t5_cfg: T5Config,
                         t5_max_len: int = 512):
    """(clip_ids [1,77], t5_ids [1,512]) int64 via the checkpoint tokenizers.

    As diffusers FluxKontextPipeline.encode_prompt: CLIP BPE padded to 77 with
    EOS, T5 unigram padded to max_sequence_length=512 (no attention mask:
    padded slots attend, as in the reference). Without the vocabularies
    (assets tokenizers/flux_clip and tokenizers/flux_t5) it falls back to
    hashed ids (``text.tokenizers.simple_tokenize``, a stable hash), but fails
    where converted text-tower parameters exist (FOHO_ALLOW_HASH_TOKENIZER=1
    overrides)."""
    from followmyhold_tpu_torch.text.tokenizers import (
        load_clip_tokenizer,
        load_t5_tokenizer,
        simple_tokenize,
        stable_hash,
    )

    clip_tok = load_clip_tokenizer()
    t5_tok = load_t5_tokenizer()
    if clip_tok is not None and t5_tok is not None:
        return (clip_tok.encode(prompt, max_len=77),
                t5_tok.encode(prompt, max_len=t5_max_len, pad_to_max=True))
    if ((has_params("flux_clip") or has_params("flux_t5"))
            and not os.environ.get("FOHO_ALLOW_HASH_TOKENIZER")):
        raise RuntimeError(
            "converted FLUX text-tower params exist but tokenizer vocabs are "
            "missing (expected assets tokenizers/flux_clip/{vocab.json,"
            "merges.txt} + tokenizers/flux_t5/{tokenizer.json|spiece.model}, "
            "or set FOHO_ALLOW_HASH_TOKENIZER=1 to knowingly use garbage ids)")
    t5_ids = simple_tokenize(prompt, 64, t5_cfg.vocab_size)
    words = prompt.lower().split()[:20]
    span = max(clip_cfg.vocab_size - 1000, 1)
    clip_ids = np.asarray(
        [[clip_cfg.eos_token_id - 1]
         + [1000 + stable_hash(w) % (span - 2) for w in words]
         + [clip_cfg.eos_token_id]], np.int64)
    return clip_ids, t5_ids


class FluxKontextInpainter:
    """FLUX.1-Kontext hand removal: the transformer, the VAE and the CLIP and
    T5 text towers, on one device."""

    REQUIRED = ("flux_transformer", "flux_vae", "flux_clip", "flux_t5")

    def __init__(self, transformer: FluxTransformer, vae: FluxVae, clip: ClipTextModel,
                 t5: T5Encoder):
        self.transformer = transformer
        self.vae = vae
        self.clip = clip
        self.t5 = t5

    @property
    def device(self) -> torch.device:
        return self.transformer.proj_out.weight.device

    def __call__(self, image_rgb: np.ndarray, prompt: str,
                 initial_noise=None) -> np.ndarray:
        """[H,W,3] uint8 -> [H,W,3] uint8. The noise is ``initial_noise`` (the
        packed latents' shape) or the stage's: one generator of
        (SEED_INPAINT, "inpaint"), the same for every image, as the reference
        draws it from one key. Spans (``utils.profiling``): the whole call
        (``inpaint.call``), ``inpaint.tokenize``, ``inpaint.text`` (T5 and
        CLIP), ``kontext_edit``'s, and ``inpaint.readback``, where the host
        waits for the card, so that it anchors the call's device clock."""
        with span("inpaint.call"):
            dev = self.device
            with span("inpaint.tokenize"):
                clip_ids, t5_ids = tokenize_flux_prompt(prompt, self.clip.cfg, self.t5.cfg)
            with torch.no_grad():
                with span("inpaint.text"):
                    t5_states = self.t5(torch.from_numpy(t5_ids).to(dev))
                    _, pooled = self.clip(torch.from_numpy(clip_ids).to(dev))
                img = torch.from_numpy(np.asarray(image_rgb, np.float32))[None].to(dev) / 255.0
                gen = (stage_generator(SEED_INPAINT, "inpaint", device=dev)
                       if initial_noise is None else None)
                out = kontext_edit(self.transformer, self.vae, t5_states, pooled, img, gen,
                                   num_steps=28, guidance=2.5, initial_noise=initial_noise)
            with span("inpaint.readback"):
                out = (out[0].cpu().numpy() * 255).astype(np.uint8)
                anchor()
            return out


def _models(cfgs) -> tuple:
    """(class, configuration, parameter file name) of each of the four models."""
    return tuple(zip((FluxTransformer, FluxVae, ClipTextModel, T5Encoder), cfgs,
                     FluxKontextInpainter.REQUIRED))


def build_inpainter(seed: int = 0, device: DeviceLike = "cuda",
                    transformer_cfg: FluxConfig = FLUX_DEV, vae_cfg: FluxVaeConfig = FLUX_VAE,
                    clip_cfg: ClipTextConfig = CLIP_L,
                    t5_cfg: T5Config = T5_XXL) -> FluxKontextInpainter:
    """The inpainter with seeded random weights (``utils.params.init_random_``),
    each model built on ``device`` in its own type (bf16 at full size: ~34 GB
    for the four), in eval mode, without gradients to the weights."""
    dev = resolve_device(device)
    models = [init_random_(cls(cfg, device=dev), seed * 4 + k).eval().requires_grad_(False)
              for k, (cls, cfg, _) in enumerate(_models((transformer_cfg, vae_cfg, clip_cfg,
                                                         t5_cfg)))]
    return FluxKontextInpainter(*models)


def _learned_inpainter(device: DeviceLike = "cuda", transformer_cfg: FluxConfig = FLUX_DEV,
                       vae_cfg: FluxVaeConfig = FLUX_VAE, clip_cfg: ClipTextConfig = CLIP_L,
                       t5_cfg: T5Config = T5_XXL) -> Optional[FluxKontextInpainter]:
    """The inpainter with the four converted checkpoints
    (``FluxKontextInpainter.REQUIRED``) loaded on ``device``, in eval mode;
    None where any of the files is absent (the Telea fill runs), as in the
    reference."""
    if not all(has_params(n) for n in FluxKontextInpainter.REQUIRED):
        return None
    dev = resolve_device(device)
    return FluxKontextInpainter(*[
        load_params(name, cls(cfg, device=dev)).eval().requires_grad_(False)
        for cls, cfg, name in _models((transformer_cfg, vae_cfg, clip_cfg, t5_cfg))])


def inpaint_hand(image_rgb: np.ndarray, hand_mask: np.ndarray, radius: int = 7,
                 object_name: str = "object",
                 models: Optional[FluxKontextInpainter] = None,
                 initial_noise=None, device: DeviceLike = "cuda") -> np.ndarray:
    """Remove the hand region: FLUX.1-Kontext with ``models`` (prompt "Remove
    hands but keep the {object}."); without, the reference's choice (see the
    module's docstring): the converted checkpoints loaded on ``device``, or,
    without them, the 9x9-dilated mask filled with Telea."""
    if models is None:
        models = _learned_inpainter(device)
    if models is not None:
        return models(image_rgb, f"Remove hands but keep the {object_name}.",
                      initial_noise=initial_noise)

    import cv2

    mask = hand_mask.astype(np.uint8) * 255
    mask = cv2.dilate(mask, np.ones((9, 9), np.uint8))
    return cv2.inpaint(image_rgb, mask, radius, cv2.INPAINT_TELEA)


def run(
    save_dir: str,
    cropped_img_dir: str,
    gemini_responses: Optional[str] = None,
    mask_dir: Optional[str] = None,
    models: Optional[FluxKontextInpainter] = None,
    initial_noise: Optional[Mapping[str, np.ndarray]] = None,
    device: DeviceLike = "cuda",
) -> None:
    """Every crop of ``cropped_img_dir`` through ``inpaint_hand``. ``models``
    is a built inpainter on ``device``; without it the backend is chosen (and
    converted weights loaded) at the first crop whose output is missing, as
    the reference loads them. ``initial_noise`` maps an image id to its
    packed noise (for tests; the stage's own noise otherwise)."""
    dev = resolve_device(device)
    if models is not None and models.device != torch.empty(0, device=dev).device:
        raise ValueError(f"the inpainter lies on {models.device}, not on {dev}")
    os.makedirs(save_dir, exist_ok=True)
    names = read_names(gemini_responses)

    images = sorted(glob.glob(os.path.join(cropped_img_dir, "*.png")))
    if not images:
        print(f"No images found in {cropped_img_dir}")
        return
    chosen = False
    if mask_dir is None:
        mask_dir = os.path.join(os.path.dirname(cropped_img_dir.rstrip("/")),
                                "cropped_hand_masks")

    for img_path in images:
        image_id, is_right = parse_cropped_hoi_name(img_path)
        rid = int(is_right)
        out_path = os.path.join(save_dir, f"{image_id}_inpainted_{rid}.png")
        if os.path.exists(out_path):
            print(f"{image_id} exists, skipping")
            continue

        if not chosen:
            if models is None:
                models = _learned_inpainter(dev)
            chosen = True
            print("inpaint: " + (f"FLUX.1-Kontext on {dev}" if models is not None
                                 else "the Telea fill (no converted FLUX weights)"))
        img = np.asarray(Image.open(img_path).convert("RGB"))
        mask_path = os.path.join(mask_dir, f"{image_id}_cropped_hand_mask.png")
        if os.path.exists(mask_path):
            hand_mask = np.asarray(Image.open(mask_path).convert("L")) > 0
        else:
            hand_mask = np.zeros(img.shape[:2], bool)

        result = inpaint_hand(img, hand_mask, object_name=names.get(image_id, "object"),
                              models=models,
                              initial_noise=(initial_noise or {}).get(image_id), device=dev)
        with span("inpaint.png"):
            Image.fromarray(result).save(out_path)
        print(f"Inpainted {image_id}")


def main() -> None:
    parser = argparse.ArgumentParser(description="Hand-removal inpainting (stage 3)")
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--cropped_img_dir", required=True)
    parser.add_argument("--gemini_responses", default=None)
    parser.add_argument("--mask_dir", default=None)
    args = parser.parse_args()
    run(args.save_dir, args.cropped_img_dir, args.gemini_responses, args.mask_dir)


if __name__ == "__main__":
    main()
