"""CLIP BPE tokenizer (pure Python, offline) -- the port's own copy of
dalle2_video_tpu/data/tokenizer.py.

Equivalent of ``clip.tokenize(truncate=True)`` (reference usage:
preprocess.py:121-124, train_clip.py:135, eval_clip.py:70): produces fixed
``(N, 77)`` int32 arrays with SOT/EOT framing over a 49408-token BPE vocab.

The BPE merges file (``bpe_simple_vocab_16e6.txt.gz``, the standard OpenAI
CLIP asset) is loaded from disk when available; this environment has no
network egress, so a deterministic byte-level fallback with the same output
contract is provided for tests and smoke runs. Embeddings produced with the
fallback are NOT CLIP-compatible — supply the real vocab for parity.
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import List, Optional, Sequence, Union

import re
from pathlib import Path

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = 49406
EOT = 49407

_PAT_SRC = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
)


@lru_cache()
def bytes_to_unicode():
    """GPT-2 byte<->unicode table (same as OpenAI CLIP's simple tokenizer)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer:
    """Byte-pair-encoding tokenizer matching OpenAI CLIP's SimpleTokenizer,
    given the standard merges file."""

    def __init__(self, bpe_path: str):
        # the third-party `regex` module (Unicode classes) is needed only by
        # the real BPE vocab; the byte fallback uses the standard library
        import regex

        self._pat = regex.compile(_PAT_SRC, regex.IGNORECASE)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for tok in self._pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return tokens


class ByteFallbackTokenizer:
    """Deterministic vocab-free stand-in with the same (N,77) contract:
    UTF-8 bytes shifted past the byte-vocab region. NOT CLIP-compatible."""

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        return [1 + b for b in text.encode("utf-8")]


# the repository's data/ directory (git-ignored; holds the vocab when present)
_DEFAULT_BPE_PATHS = (
    str(Path(__file__).resolve().parents[2] / "data" / "bpe_simple_vocab_16e6.txt.gz"),
)


def get_tokenizer(bpe_path: Optional[str] = None):
    paths = (bpe_path,) if bpe_path else _DEFAULT_BPE_PATHS
    for p in paths:
        if p and os.path.exists(p):
            return ClipBPETokenizer(p)
    return ByteFallbackTokenizer()


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = True,
    tokenizer=None,
) -> np.ndarray:
    """texts -> (N, context_length) int32 with SOT/EOT (clip.tokenize spec)."""
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer if tokenizer is not None else get_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [SOT] + tok.encode(text) + [EOT]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"input {i} is too long for context length {context_length}"
                )
            ids = ids[:context_length]
            ids[-1] = EOT
        result[i, : len(ids)] = ids
    return result
