"""The synthetic inputs of the inpainting cells, frozen here so that a change
to the program cannot move them: one photo's HOI crops with their hand masks,
and the vocabulary files of FLUX's two checkpoint tokenizers (a byte-level
CLIP vocabulary whose start and end of text keep their published ids, and a
small Unigram T5 vocabulary). Builders after the program's
``tools/_scene.py``."""

from __future__ import annotations

import json
import os

import numpy as np

from benchmark.reference.tokenizers import _bytes_to_unicode

# CLIP-L's start- and end-of-text ids: transformers pools this checkpoint's
# text at the highest id, the end of text
CLIP_BOS_ID, CLIP_EOS_ID = 49406, 49407

# the pieces of a small T5 Unigram vocabulary: the specials, the inpainting
# prompt's words, single letters and punctuation
_T5_PIECES = ([("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -2.0)]
              + [("▁" + w, -4.0 - 0.1 * k) for k, w in enumerate(
                  ("Remove", "hands", "but", "keep", "the", "object", "water", "bottle"))]
              + [(c, -6.0) for c in "abcdefghijklmnopqrstuvwxyz.,"])


def write_flux_tokenizers(assets_dir: str) -> None:
    """tokenizers/flux_clip/{vocab.json, merges.txt} (every byte alone and at
    a word's end, no merges) and tokenizers/flux_t5/tokenizer.json under
    ``assets_dir``."""
    clip_dir = os.path.join(assets_dir, "tokenizers", "flux_clip")
    t5_dir = os.path.join(assets_dir, "tokenizers", "flux_t5")
    os.makedirs(clip_dir, exist_ok=True)
    os.makedirs(t5_dir, exist_ok=True)
    chars = list(_bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars + [c + "</w>" for c in chars])}
    vocab["<|startoftext|>"] = CLIP_BOS_ID
    vocab["<|endoftext|>"] = CLIP_EOS_ID
    with open(os.path.join(clip_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(clip_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
    with open(os.path.join(t5_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump({"model": {"type": "Unigram", "unk_id": 2, "vocab": _T5_PIECES}}, f,
                  ensure_ascii=False)


def hoi_crop(size: int = 512, seed: int = 0):
    """One HOI crop as the stages after detection get it, in memory: a noise
    image [size, size, 3] uint8 and its hand mask [size, size] bool."""
    rng = np.random.default_rng(seed)
    s = size / 512.0
    img = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
    hand = np.zeros((size, size), bool)
    hand[int(160 * s):int(320 * s), int(160 * s):int(320 * s)] = True
    return img, hand
