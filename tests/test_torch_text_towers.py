"""The text side of the inpainting stage in the PyTorch port (stage 3:
``text/tokenizers.py``, ``preprocess/inpaint.tokenize_flux_prompt``,
``models/clip_text.py``, ``models/t5.py``) against the JAX package, on the
same inputs and, through ``flax_to_torch``, the same weights.

Tolerances (measured on the CPU with these seeds):
- the tokenizers (WordPiece, CLIP BPE, Unigram from tokenizer.json and from a
  hand-built spiece.model) and ``tokenize_flux_prompt``: the same ids;
- the hashed-id fallback: the reference's formula with a stable hash in place
  of Python's salted ``hash`` (the same ids in a process with another hash
  seed), so its ids are not compared with the JAX package's;
- ``relative_position_bucket``: exactly;
- CLIP's last hidden state and pooled output, T5's encoder: 1e-5 of each
  output's largest entry, float32 on both sides (the same products summed in
  another order; measured 6.4e-7 and 2.8e-7 for CLIP, 2.2e-6 for T5).
"""

import dataclasses
import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flux import random_params

import followmyhold_tpu.ops.attention  # noqa: F401  (imported before any jit traces it)
from followmyhold_tpu.models import clip_text as JC
from followmyhold_tpu.models import t5 as JT5
from followmyhold_tpu.preprocess import inpaint as JI
from followmyhold_tpu.text import tokenizers as JTok
from followmyhold_tpu_torch.models import clip_text as TC
from followmyhold_tpu_torch.models import t5 as TT5
from followmyhold_tpu_torch.preprocess import inpaint as TI
from followmyhold_tpu_torch.text import tokenizers as TTok
from followmyhold_tpu_torch.utils.params import flax_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROMPTS = [
    "Remove hands but keep the water bottle.",
    "a photo of a HAND!! holding a mug, top-down",
    "naive café glaß 杯子 test",
    "123 4.5 no6 'll 'd",
    "  double  spaces\tand\nnewlines ",
    "x " * 40 + "end",
]


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


# ---- vocabularies --------------------------------------------------------- #

BERT_VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] water bottle . remove hands but keep the "
              "only hand a photo of holding mug , ! - top down naive cafe glas ##s 杯 "
              "x end 1 ##2 ##3 4 5 no ##6 double spaces and newlines re ##move".split())

CLIP_MERGES = [("h", "e"), ("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"),
               ("h", "and</w>"), ("e", "r</w>"), ("w", "at"), ("a", "t"), ("wat", "er</w>"),
               ("b", "o"), ("t", "t"), ("bo", "tt"), ("l", "e</w>"), ("bott", "le</w>"),
               ("o", "f</w>"), ("1", "2")]

T5_VOCAB = [
    ("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0),
    ("▁Remove", -4.1), ("▁hands", -5.2), ("▁but", -3.3), ("▁keep", -4.7),
    ("▁the", -2.1), ("▁water", -4.9), ("▁bottle", -5.5), ("▁", -2.0),
    ("▁a", -2.5), ("▁photo", -6.1), ("▁of", -2.9), ("ing", -3.5), ("▁hand", -5.0),
    ("s", -2.2), ("▁no", -4.0), ("1", -5.1), ("2", -5.15), ("3", -5.2), (".", -3.0),
    ("▁x", -4.4), ("▁end", -6.2), ("e", -2.4), ("r", -2.6), ("t", -2.3), ("o", -2.35),
    ("p", -3.2), ("▁down", -6.3), ("!", -3.4), (",", -3.05), ("-", -3.1),
]


def write_clip_vocab(d, merges=CLIP_MERGES):
    """vocab.json (every byte symbol, alone and with </w>, the merges, the two
    specials) and merges.txt -> the vocabulary."""
    os.makedirs(d, exist_ok=True)
    chars = list(TTok._bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.writelines(f"{a} {b}\n" for a, b in merges)
    return vocab


def write_t5_vocab(d):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump({"model": {"type": "Unigram", "unk_id": 2, "vocab": T5_VOCAB}}, f,
                  ensure_ascii=False)


def _spiece_model(pieces):
    """A sentencepiece ModelProto in its wire format, built by hand."""
    def varint(n):
        out = b""
        while True:
            b7, n = n & 0x7F, n >> 7
            out += bytes([b7 | (0x80 if n else 0)])
            if not n:
                return out

    blob = b""
    for piece, score, ptype in pieces:
        pb = piece.encode("utf-8")
        sub = (b"\x0a" + varint(len(pb)) + pb + b"\x15" + struct.pack("<f", score)
               + b"\x18" + varint(ptype))
        blob += b"\x0a" + varint(len(sub)) + sub
    return blob + b"\x12" + bytes([3]) + b"abc"    # a trainer_spec to skip


# ---- the tokenizers, id for id -------------------------------------------- #

@pytest.mark.parametrize("text", PROMPTS)
def test_wordpiece_ids_match(tmp_path, text):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(BERT_VOCAB) + "\n", encoding="utf-8")
    got = TTok.WordPieceTokenizer.from_vocab_file(str(path)).encode(text, max_len=32)
    want = JTok.WordPieceTokenizer.from_vocab_file(str(path)).encode(text, max_len=32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("text", PROMPTS)
def test_clip_bpe_ids_match(tmp_path, text):
    write_clip_vocab(str(tmp_path))
    files = (str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    got = TTok.ClipBpeTokenizer.from_files(*files)
    want = JTok.ClipBpeTokenizer.from_files(*files)
    assert got.tokenize(text) == want.tokenize(text)
    np.testing.assert_array_equal(got.encode(text, max_len=77), want.encode(text, max_len=77))


@pytest.mark.parametrize("source", ["tokenizer.json", "spiece.model"])
def test_unigram_ids_match(tmp_path, source):
    if source == "tokenizer.json":
        write_t5_vocab(str(tmp_path))
        load = "from_tokenizer_json"
    else:
        pieces = [(p, s, 3 if p in ("<pad>", "</s>") else 2 if p == "<unk>" else 1)
                  for p, s in T5_VOCAB]
        (tmp_path / source).write_bytes(_spiece_model(pieces))
        load = "from_spiece_model"
    path = str(tmp_path / source)
    got, want = getattr(TTok.UnigramTokenizer, load)(path), getattr(JTok.UnigramTokenizer,
                                                                    load)(path)
    assert got.unk_id == want.unk_id == 2
    for text in PROMPTS:
        assert got.tokenize(text) == want.tokenize(text)
        np.testing.assert_array_equal(got.encode(text, max_len=512, pad_to_max=True),
                                      want.encode(text, max_len=512, pad_to_max=True))


# ---- tokenize_flux_prompt ------------------------------------------------- #

@pytest.fixture
def assets(tmp_path, monkeypatch):
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path))
    monkeypatch.delenv("FOHO_ALLOW_HASH_TOKENIZER", raising=False)
    return str(tmp_path)


def test_tokenize_flux_prompt_matches_with_vocabularies(assets):
    vocab = write_clip_vocab(os.path.join(assets, "tokenizers", "flux_clip"))
    write_t5_vocab(os.path.join(assets, "tokenizers", "flux_t5"))
    prompt = "Remove hands but keep the water bottle."
    clip_ids, t5_ids = TI.tokenize_flux_prompt(prompt, TC.CLIP_L, TT5.T5_XXL)
    want = JI.tokenize_flux_prompt(prompt, JC.CLIP_L, JT5.T5_XXL)
    assert clip_ids.shape == (1, 77) and t5_ids.shape == (1, 512)
    assert clip_ids.dtype == t5_ids.dtype == np.int64
    np.testing.assert_array_equal(clip_ids, want[0])
    np.testing.assert_array_equal(t5_ids, want[1])
    assert clip_ids[0, 0] == vocab["<|startoftext|>"]
    assert t5_ids[0, :4].tolist() == [3, 4, 5, 6] and t5_ids[0, -1] == 0


def test_tokenize_flux_prompt_fails_with_params_and_no_vocabulary(assets, monkeypatch):
    os.makedirs(os.path.join(assets, "params"))
    with open(os.path.join(assets, "params", "flux_t5.msgpack"), "wb") as f:
        f.write(b"x")
    for tokenize, clip_cfg, t5_cfg in ((TI.tokenize_flux_prompt, TC.CLIP_L, TT5.T5_XXL),
                                       (JI.tokenize_flux_prompt, JC.CLIP_L, JT5.T5_XXL)):
        with pytest.raises(RuntimeError, match="tokenizer"):
            tokenize("remove hands", clip_cfg, t5_cfg)
    monkeypatch.setenv("FOHO_ALLOW_HASH_TOKENIZER", "1")
    clip_ids, t5_ids = TI.tokenize_flux_prompt("remove hands", TC.CLIP_L, TT5.T5_XXL)
    assert clip_ids.shape == (1, 4) and t5_ids.shape == (1, 4)


def test_hash_fallback_formula_and_shapes(assets):
    prompt = "Remove hands but keep the mug."
    clip_ids, t5_ids = TI.tokenize_flux_prompt(prompt, TC.CLIP_L, TT5.T5_XXL)
    words = prompt.lower().split()
    span = TC.CLIP_L.vocab_size - 1000
    assert clip_ids.tolist() == [[TC.CLIP_L.eos_token_id - 1]
                                 + [1000 + TTok.stable_hash(w) % (span - 2) for w in words]
                                 + [TC.CLIP_L.eos_token_id]]
    # T5: [CLS] words, the full stop on its own, [SEP]; hashed into [1100, vocab)
    assert t5_ids.shape == (1, len(words) + 3)
    assert t5_ids[0, 0] == 101 and t5_ids[0, -1] == 102 and t5_ids[0, -2] == 1012
    hashed = t5_ids[0, 1:-2]
    assert ((hashed >= 1100) & (hashed < TT5.T5_XXL.vocab_size)).all()
    assert hashed.tolist() == [1100 + TTok.stable_hash(w) % (TT5.T5_XXL.vocab_size - 1100)
                               for w in prompt.lower().replace(".", " . ").split()[:-1]]
    assert TTok.simple_tokenize("a " * 100, max_len=64).shape == (1, 64)
    # the same ids under another hash seed (Python's own hash would change them)
    code = ("from followmyhold_tpu_torch.text.tokenizers import simple_tokenize;"
            "print(simple_tokenize('remove hands but keep the mug', 64, 32128).tolist())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, env=dict(os.environ, PYTHONHASHSEED="12345"))
    assert out.stdout.strip() == str(
        TTok.simple_tokenize("remove hands but keep the mug", 64, 32128).tolist())


# ---- the towers ------------------------------------------------------------ #

def test_embed_leaf_bridges_to_embedding_weight():
    table = np.random.default_rng(3).normal(size=(7, 5)).astype(np.float32)
    module = torch.nn.Module()
    module.shared = torch.nn.Embedding(7, 5)
    flax_to_torch({"params": {"shared": {"embedding": table}}}, module)
    np.testing.assert_array_equal(module.shared.weight.detach().numpy(), table)


def test_relative_position_bucket_is_exact():
    rel = np.arange(600)[None, :] - np.arange(600)[:, None]
    for buckets, distance in ((32, 128), (16, 40)):
        got = TT5.relative_position_bucket(rel, buckets, distance)
        np.testing.assert_array_equal(got, JT5.relative_position_bucket(rel, buckets, distance))
        assert got.min() == 0 and got.max() == buckets - 1


def test_clip_text_matches_jax():
    cfg_j = dataclasses.replace(JC.CLIP_TINY_TEST, max_position_embeddings=77)
    cfg_t = dataclasses.replace(TC.CLIP_TINY_TEST, max_position_embeddings=77)
    model = JC.ClipTextModel(cfg_j)
    params = random_params(lambda k: model.init(k, jnp.zeros((1, 8), jnp.int32)), 1)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg_j.vocab_size - 1, (2, 77))
    ids[0, 9], ids[0, 30], ids[1, 76] = 999, 999, 999      # the first EOS is pooled
    want_x, want_pooled = jax.jit(model.apply)(params, jnp.asarray(ids, jnp.int32))
    port = flax_to_torch(params, TC.ClipTextModel(cfg_t, device="cpu"))
    with torch.no_grad():
        got_x, got_pooled = port(torch.from_numpy(ids))
    assert got_x.dtype == got_pooled.dtype == torch.float32
    _close(got_x.numpy(), want_x)
    _close(got_pooled.numpy(), want_pooled)
    np.testing.assert_array_equal(got_pooled.numpy(), got_x.numpy()[[0, 1], [9, 76]])


def test_t5_encoder_matches_jax():
    model = JT5.T5Encoder(JT5.T5_TINY_TEST)
    params = random_params(lambda k: model.init(k, jnp.zeros((1, 8), jnp.int32)), 4)
    ids = np.random.default_rng(5).integers(0, 500, (2, 160))
    want = jax.jit(model.apply)(params, jnp.asarray(ids, jnp.int32))
    port = flax_to_torch(params, TT5.T5Encoder(TT5.T5_TINY_TEST, device="cpu"))
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    _close(got.numpy(), want)
