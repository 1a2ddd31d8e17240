"""CLIP BPE tokenization with prompt weighting.

Counterpart of stable_renderer_tpu/models/tokenizer.py (reference
comfy/sd1_clip.py:208-484). The JAX package runs transformers'
CLIPTokenizer; the port carries its own byte-level BPE (``CLIPBPE``), which
reads the same vocab and merges files in place from
``stable_renderer_tpu/assets/clip_tokenizer/`` and reproduces that
tokenizer's text cleanup (no ftfy: control-character removal, whitespace
normalization, CJK spacing, NFC, lower case) and its pre-tokenizer pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+``
by Unicode category.

Weighting grammar: ``(word)`` multiplies the weight by 1.1 per nesting level,
``(word:1.3)`` sets it, ``\\(`` / ``\\)`` escape literal parens. Textual
inversion (``embedding:name``) is not ported yet.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "stable_renderer_tpu", "assets", "clip_tokenizer")

_SPECIAL = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The reversible byte -> printable-character table of byte-level BPE."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def clean_text(text: str) -> List[str]:
    """The BasicTokenizer cleanup the reference tokenizer runs without ftfy:
    drop control characters, map whitespace to spaces, space out CJK
    ideographs, NFC-normalize, split on whitespace, lower-case."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    return [w.lower() for w in unicodedata.normalize("NFC", "".join(out)).split()]


def _cat(ch: str) -> str:
    c = unicodedata.category(ch)[0]
    return c if c in "LN" else ("S" if ch.isspace() else "P")


def pre_tokenize(text: str) -> List[str]:
    """The CLIP pre-tokenizer pattern, matched left to right by category."""
    pieces, i, n = [], 0, len(text)
    low = text.lower()
    while i < n:
        for tok in _SPECIAL + _CONTRACTIONS:
            if low.startswith(tok, i):
                pieces.append(text[i:i + len(tok)])
                i += len(tok)
                break
        else:
            kind = _cat(text[i])
            if kind == "S":
                i += 1
                continue
            j = i + 1
            if kind == "L":
                while j < n and _cat(text[j]) == "L":
                    j += 1
            elif kind == "P":
                while j < n and _cat(text[j]) == "P":
                    j += 1
            pieces.append(text[i:j])
            i = j
    return pieces


class CLIPBPE:
    """Byte-level BPE over the CLIP vocab: ``__call__(text)`` returns the ids
    with BOS/EOS, like ``CLIPTokenizer(text)["input_ids"]``."""

    def __init__(self, path: Optional[str] = None):
        path = path or ASSET_DIR
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1: 49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        self.cache: Dict[str, List[str]] = {s: [s] for s in _SPECIAL}

    def bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            first, second = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if (first, second) not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self.cache[token] = list(word)
        return self.cache[token]

    def encode(self, text: str) -> List[int]:
        """text -> ids without BOS/EOS."""
        unk = self.eos
        ids: List[int] = []
        for piece in pre_tokenize(" ".join(clean_text(text))):
            if piece.lower() in _SPECIAL:
                ids.append(self.encoder[piece.lower()])
                continue
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder.get(t, unk) for t in self.bpe(mapped))
        return ids

    def __call__(self, text: str) -> List[int]:
        return [self.bos] + self.encode(text) + [self.eos]


def parse_parentheses(string: str) -> List[str]:
    """Split into top-level segments, keeping parenthesized groups intact."""
    result, current, depth = [], "", 0
    for char in string:
        if char == "(":
            if depth == 0 and current:
                result.append(current)
                current = ""
            current += char
            depth += 1
        elif char == ")":
            depth -= 1
            current += char
            if depth == 0:
                result.append(current)
                current = ""
        else:
            current += char
    if current:
        result.append(current)
    return result


def token_weights(string: str, current_weight: float) -> List[Tuple[str, float]]:
    """Recursive (text, weight) expansion: nesting multiplies by 1.1, a trailing
    ``:N`` inside parens sets the weight."""
    out: List[Tuple[str, float]] = []
    for x in parse_parentheses(string):
        weight = current_weight
        if len(x) >= 2 and x[-1] == ")" and x[0] == "(":
            x = x[1:-1]
            xx = x.rfind(":")
            weight *= 1.1
            if xx > 0:
                try:
                    weight = float(x[xx + 1:])
                    x = x[:xx]
                except ValueError:
                    pass
            out += token_weights(x, weight)
        else:
            out.append((x, current_weight))
    return out


def escape_important(text: str) -> str:
    return text.replace("\\)", "\0\1").replace("\\(", "\0\2")


def unescape_important(text: str) -> str:
    return text.replace("\0\1", ")").replace("\0\2", "(")


class SDTokenizer:
    """Reference-parity prompt tokenizer (sd1_clip.py:358-484):
    ``tokenize_with_weights`` returns 77-long chunks of (token_id, weight)
    pairs with BOS/EOS and padding. Words shorter than ``max_word_length``
    tokens wrap whole to the next chunk; longer ones may split."""

    def __init__(self, tokenizer_path: Optional[str] = None, max_length: int = 77,
                 pad_with_end: bool = True, pad_to_max_length: bool = True):
        self.tokenizer = CLIPBPE(tokenizer_path)
        self.max_length = max_length
        self.start_token = self.tokenizer.bos
        self.end_token = self.tokenizer.eos
        self.pad_with_end = pad_with_end
        self.pad_to_max_length = pad_to_max_length
        self.max_word_length = 8

    def tokenize_with_weights(self, text: str):
        pad_token = self.end_token if self.pad_with_end else 0
        tokens: List[List[Tuple[int, float]]] = []
        for segment, weight in token_weights(escape_important(text), 1.0):
            for word in unescape_important(segment).replace("\n", " ").split(" "):
                if word:
                    tokens.append([(t, weight) for t in self.tokenizer.encode(word)])

        batch = [(self.start_token, 1.0)]
        batched = [batch]
        for t_group in tokens:
            is_large = len(t_group) >= self.max_word_length
            while t_group:
                if len(t_group) + len(batch) > self.max_length - 1:
                    remaining = self.max_length - len(batch) - 1
                    if is_large:
                        batch.extend(t_group[:remaining])
                        batch.append((self.end_token, 1.0))
                        t_group = t_group[remaining:]
                    else:
                        batch.append((self.end_token, 1.0))
                        if self.pad_to_max_length:
                            batch.extend([(pad_token, 1.0)] * remaining)
                    batch = [(self.start_token, 1.0)]
                    batched.append(batch)
                else:
                    batch.extend(t_group)
                    t_group = []
        batch.append((self.end_token, 1.0))
        if self.pad_to_max_length:
            batch.extend([(pad_token, 1.0)] * (self.max_length - len(batch)))
        return batched


def pack_chunks(chunks) -> Tuple[np.ndarray, np.ndarray, None]:
    """tokenize_with_weights output -> (ids (n_chunks, L) int32,
    weights (n_chunks, L) f32, custom_embeds None)."""
    ids = np.asarray([[t for t, _ in c] for c in chunks], np.int32)
    weights = np.asarray([[w for _, w in c] for c in chunks], np.float32)
    return ids, weights, None
