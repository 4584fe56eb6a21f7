"""Tokenizers (the port's copy of followmyhold_tpu/text)."""

from followmyhold_tpu_torch.text.tokenizers import (
    ClipBpeTokenizer,
    UnigramTokenizer,
    WordPieceTokenizer,
    has_tokenizer,
    simple_tokenize,
    tokenizer_dir,
)

__all__ = [
    "WordPieceTokenizer",
    "ClipBpeTokenizer",
    "UnigramTokenizer",
    "simple_tokenize",
    "tokenizer_dir",
    "has_tokenizer",
]
