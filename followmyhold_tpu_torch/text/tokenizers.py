"""Pure-Python tokenizers for the three text towers the pipeline drives.

The port's copy of followmyhold_tpu/text/tokenizers.py (pure Python, taken
whole; the port imports nothing of the JAX package). The original pipeline
gets tokenization from HF ``transformers``/``diffusers``: BERT WordPiece for
GroundingDINO, CLIP BPE + T5 SentencePiece for FLUX.1-Kontext. This module
implements those three algorithms so converted checkpoints can be driven
offline with bit-identical input_ids:

- WordPieceTokenizer   — BasicTokenizer + greedy-longest-match WordPiece,
  matching transformers BertTokenizer (do_lower_case=True).
- ClipBpeTokenizer     — byte-to-unicode BPE with the </w> end-of-word marker
  and CLIP's regex pre-tokenizer, matching transformers CLIPTokenizer on its
  no-ftfy path (BasicTokenizer whitespace/lower cleanup).
- UnigramTokenizer     — SentencePiece unigram Viterbi with Metaspace
  pre-tokenization, matching T5TokenizerFast (the `tokenizers` Unigram model);
  loads vocab from either HF tokenizer.json or a raw spiece.model protobuf
  (minimal wire-format parser, no sentencepiece dependency).
- simple_tokenize      — the hashed-id fallback for runs without vocabulary
  files (the reference's ``models/gdino.simple_tokenize``), on a stable hash.

Vocab files live under assets_root()/tokenizers/<name>/ (the port's
``configs/paths.assets_root``: ``FOHO_TPU_ASSETS`` or ``assets/``).

Parity tests: tests/test_torch_text_towers.py holds every tokenizer here
against the JAX package's on synthesized vocabs.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from followmyhold_tpu_torch.configs.paths import assets_root


def tokenizer_dir(name: str) -> str:
    return os.path.join(assets_root(), "tokenizers", name)


def has_tokenizer(name: str) -> bool:
    d = tokenizer_dir(name)
    return os.path.isdir(d) and len(os.listdir(d)) > 0


# ---------------------------------------------------------------------------
# shared text cleanup (BertTokenizer's BasicTokenizer semantics)
# ---------------------------------------------------------------------------

def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alnum ranges count as punctuation even when unicode says
    # otherwise (e.g. "$", "^") — BERT convention.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting + optional lower/strip-accents."""

    def __init__(self, do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None,
                 do_split_on_punc: bool = True):
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.do_split_on_punc = do_split_on_punc

    def _clean_text(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _tokenize_chinese_chars(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    def _split_on_punc(self, token: str) -> List[str]:
        if not self.do_split_on_punc:
            return [token]
        out: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]

    def tokenize(self, text: str) -> List[str]:
        text = self._tokenize_chinese_chars(self._clean_text(text))
        text = unicodedata.normalize("NFC", text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                if self.strip_accents is not False:
                    tok = self._strip_accents(tok)
            elif self.strip_accents:
                tok = self._strip_accents(tok)
            tokens.extend(self._split_on_punc(tok))
        return [t for t in " ".join(tokens).split() if t]


# ---------------------------------------------------------------------------
# BERT WordPiece (GroundingDINO's text tower)
# ---------------------------------------------------------------------------

class WordPieceTokenizer:
    """transformers BertTokenizer equivalent (vocab.txt, lowercased)."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.basic = BasicTokenizer(do_lower_case=do_lower_case)
        self.unk_token = unk_token
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab.get(pad_token, 0)
        self.unk_id = vocab[unk_token]
        self.max_chars = max_input_chars_per_word

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str, max_len: Optional[int] = None) -> np.ndarray:
        """[1, T] int64 ids: [CLS] pieces [SEP] (BertTokenizer contract)."""
        ids = [self.cls_id] + [self.vocab.get(t, self.unk_id)
                               for t in self.tokenize(text)] + [self.sep_id]
        if max_len is not None:
            ids = ids[:max_len]
        return np.asarray([ids], np.int64)


# ---------------------------------------------------------------------------
# CLIP byte-level BPE (FLUX text_encoder / openai CLIP-L)
# ---------------------------------------------------------------------------

def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte->printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ClipBpeTokenizer:
    """transformers CLIPTokenizer equivalent (vocab.json + merges.txt).

    Matches the no-ftfy path: BasicTokenizer(strip_accents=False,
    do_split_on_punc=False) cleanup, regex pre-tokenizer, byte-level BPE with
    the `</w>` word suffix (tokenization_clip.py in HF transformers).
    """

    PAT = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
           r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")

    def __init__(self, encoder: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 bos_token: str = "<|startoftext|>",
                 eos_token: str = "<|endoftext|>"):
        import regex

        self.encoder = encoder
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.nlp = BasicTokenizer(strip_accents=False, do_split_on_punc=False)
        self.pat = regex.compile(self.PAT, regex.IGNORECASE)
        self.bos_id = encoder[bos_token]
        self.eos_id = encoder[eos_token]
        self.unk_id = encoder[eos_token]
        self.cache = {bos_token: bos_token, eos_token: eos_token}

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw) -> "ClipBpeTokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            encoder = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines]
        return cls(encoder, merges, **kw)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return token + "</w>"
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        text = " ".join(self.nlp.tokenize(text))
        out: List[str] = []
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            out.extend(self._bpe(token).split(" "))
        return out

    def encode(self, text: str, max_len: int = 77,
               pad_to_max: bool = True) -> np.ndarray:
        """[1, T] int64: <|startoftext|> bpe <|endoftext|> [pad=eos]*."""
        ids = [self.bos_id] + [self.encoder.get(t, self.unk_id)
                               for t in self.tokenize(text)]
        ids = ids[:max_len - 1] + [self.eos_id]
        if pad_to_max:
            ids = ids + [self.eos_id] * (max_len - len(ids))
        return np.asarray([ids], np.int64)


# ---------------------------------------------------------------------------
# SentencePiece Unigram (T5 / FLUX text_encoder_2)
# ---------------------------------------------------------------------------

def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def parse_sentencepiece_model(data: bytes) -> List[Tuple[str, float, int]]:
    """Minimal protobuf wire parser for sentencepiece ModelProto.

    Extracts the repeated `pieces` field (#1): each SentencePiece message has
    piece:string(#1), score:float(#2), type:enum(#3, default NORMAL=1). No
    sentencepiece/protobuf dependency needed — the wire format is stable.
    """
    pieces: List[Tuple[str, float, int]] = []
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:           # repeated SentencePiece
            ln, pos = _read_varint(data, pos)
            sub = data[pos:pos + ln]
            pos += ln
            piece, score, ptype = "", 0.0, 1
            sp = 0
            while sp < len(sub):
                stag, sp = _read_varint(sub, sp)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 2:
                    sln, sp = _read_varint(sub, sp)
                    piece = sub[sp:sp + sln].decode("utf-8")
                    sp += sln
                elif sfield == 2 and swire == 5:
                    (score,) = struct.unpack("<f", sub[sp:sp + 4])
                    sp += 4
                elif sfield == 3 and swire == 0:
                    ptype, sp = _read_varint(sub, sp)
                else:                          # skip unknown subfield
                    if swire == 0:
                        _, sp = _read_varint(sub, sp)
                    elif swire == 2:
                        sln, sp = _read_varint(sub, sp)
                        sp += sln
                    elif swire == 5:
                        sp += 4
                    elif swire == 1:
                        sp += 8
                    else:
                        raise ValueError(f"bad wire type {swire}")
            pieces.append((piece, float(score), ptype))
        else:                                  # skip other top-level fields
            if wire == 0:
                _, pos = _read_varint(data, pos)
            elif wire == 2:
                ln, pos = _read_varint(data, pos)
                pos += ln
            elif wire == 5:
                pos += 4
            elif wire == 1:
                pos += 8
            else:
                raise ValueError(f"bad wire type {wire}")
    return pieces


_SPM_UNK_PENALTY = 10.0


class UnigramTokenizer:
    """T5TokenizerFast-equivalent unigram Viterbi tokenizer.

    Pre-tokenization is HF Metaspace (replace " "->"▁", prepend "▁", split
    keeping "▁" attached to the following word), then per-pretoken Viterbi
    over the unigram log-probs; positions no piece covers get single-char
    <unk> nodes at min_score - 10 and consecutive unks fuse (the `tokenizers`
    Unigram model semantics). Normalization: NFKC + whitespace collapse —
    an offline approximation of sentencepiece's precompiled NMT-NFKC charsmap
    (identical on ASCII prompts like the reference's inpainting prompt,
    src/foho/preprocess/inpaint.py:66-67).
    """

    SPACE = "▁"

    def __init__(self, vocab: Sequence[Tuple[str, float]], unk_id: int = 2,
                 eos_piece: str = "</s>", pad_id: int = 0):
        self.vocab = {p: (i, s) for i, (p, s) in enumerate(vocab)}
        self.id_to_piece = [p for p, _ in vocab]
        self.unk_id = unk_id
        self.pad_id = pad_id
        self.eos_id = self.vocab[eos_piece][0] if eos_piece in self.vocab else 1
        self.min_score = min((s for _, s in vocab), default=0.0)
        self.max_piece_len = max((len(p) for p, _ in vocab), default=1)

    @classmethod
    def from_spiece_model(cls, path: str, **kw) -> "UnigramTokenizer":
        with open(path, "rb") as f:
            pieces = parse_sentencepiece_model(f.read())
        unk_id = next((i for i, (_, _, t) in enumerate(pieces) if t == 2), 2)
        return cls([(p, s) for p, s, _ in pieces], unk_id=unk_id, **kw)

    @classmethod
    def from_tokenizer_json(cls, path: str, **kw) -> "UnigramTokenizer":
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "Unigram":
            raise ValueError(f"expected Unigram tokenizer.json, got {model.get('type')}")
        return cls([(p, float(s)) for p, s in model["vocab"]],
                   unk_id=int(model.get("unk_id", 2)), **kw)

    def _normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        while "  " in text:
            text = text.replace("  ", " ")
        return text

    def _pretokenize(self, text: str) -> List[str]:
        text = self.SPACE + text.replace(" ", self.SPACE)
        words: List[str] = []
        cur = ""
        for ch in text:
            if ch == self.SPACE and cur:
                words.append(cur)
                cur = ch
            else:
                cur += ch
        if cur:
            words.append(cur)
        return words

    def _viterbi(self, word: str) -> List[int]:
        n = len(word)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        unk_score = self.min_score - _SPM_UNK_PENALTY
        for end in range(1, n + 1):
            lo = max(0, end - self.max_piece_len)
            for start in range(lo, end):
                if best[start] <= NEG:
                    continue
                ent = self.vocab.get(word[start:end])
                if ent is not None:
                    sc = best[start] + ent[1]
                    if sc > best[end]:
                        best[end] = sc
                        back[end] = (start, ent[0])
            # single-char unk node when nothing covers [end-1, end)
            if best[end] <= NEG and best[end - 1] > NEG:
                best[end] = best[end - 1] + unk_score
                back[end] = (end - 1, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            ids.append(pid)
            pos = start
        ids.reverse()
        fused: List[int] = []
        for pid in ids:                         # fuse consecutive unks
            if pid == self.unk_id and fused and fused[-1] == self.unk_id:
                continue
            fused.append(pid)
        return fused

    def tokenize(self, text: str) -> List[str]:
        return [self.id_to_piece[i] for i in self.encode_ids(text)]

    def encode_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self._pretokenize(self._normalize(text)):
            ids.extend(self._viterbi(word))
        return ids

    def encode(self, text: str, max_len: Optional[int] = 512,
               pad_to_max: bool = False) -> np.ndarray:
        """[1, T] int64: pieces </s> (T5 single-sequence template)."""
        ids = self.encode_ids(text)
        if max_len is not None:
            ids = ids[:max_len - 1]
        ids = ids + [self.eos_id]
        if pad_to_max and max_len is not None:
            ids = ids + [self.pad_id] * (max_len - len(ids))
        return np.asarray([ids], np.int64)


# ---------------------------------------------------------------------------
# asset-dir loaders (converters drop vocab files here)
# ---------------------------------------------------------------------------

def load_gdino_tokenizer() -> Optional[WordPieceTokenizer]:
    path = os.path.join(tokenizer_dir("gdino"), "vocab.txt")
    return WordPieceTokenizer.from_vocab_file(path) if os.path.exists(path) else None


def load_clip_tokenizer() -> Optional[ClipBpeTokenizer]:
    d = tokenizer_dir("flux_clip")
    vocab, merges = os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")
    if os.path.exists(vocab) and os.path.exists(merges):
        return ClipBpeTokenizer.from_files(vocab, merges)
    return None


def load_t5_tokenizer() -> Optional[UnigramTokenizer]:
    d = tokenizer_dir("flux_t5")
    tj = os.path.join(d, "tokenizer.json")
    if os.path.exists(tj):
        return UnigramTokenizer.from_tokenizer_json(tj)
    sp = os.path.join(d, "spiece.model")
    if os.path.exists(sp):
        return UnigramTokenizer.from_spiece_model(sp)
    return None


def install_tokenizer_files(name: str, files: Dict[str, str]) -> str:
    """Copy checkpoint-side vocab files into assets (dst_name -> src_path)."""
    import shutil

    d = tokenizer_dir(name)
    os.makedirs(d, exist_ok=True)
    for dst, src in files.items():
        shutil.copyfile(src, os.path.join(d, dst))
    return d


# ---------------------------------------------------------------------------
# hashed-id fallback (no vocabulary files)
# ---------------------------------------------------------------------------

def stable_hash(word: str) -> int:
    """A hash of ``word`` that is the same in every process: the first 8
    bytes of its sha256, little-endian. The reference uses Python's ``hash``,
    which is salted per process, so its fallback ids change from run to run."""
    return int.from_bytes(hashlib.sha256(word.encode("utf-8")).digest()[:8], "little")


def simple_tokenize(text: str, max_len: int = 64,
                    vocab_size: int = 30522) -> np.ndarray:
    """Offline fallback tokenizer: hashed word pieces in the BERT id space,
    [1, T] int64, ``[CLS] words [SEP]`` cut to ``max_len``, no padding.

    The reference's formula (followmyhold_tpu/models/gdino.py:674-688) with
    ``stable_hash`` in place of the salted ``hash``. Real runs use the
    checkpoint's vocabulary; this keeps the graph drivable without one."""
    words = text.lower().replace(".", " . ").split()
    base = min(1100, max(vocab_size - 8, 1))
    span = max(vocab_size - base, 1)
    ids = [101] + [base + (stable_hash(w) % span) if w != "." else 1012
                   for w in words] + [102]
    ids = [min(i, vocab_size - 1) for i in ids][:max_len]
    return np.asarray([ids], np.int64)
