"""CLIP BPE tokenization with prompt weighting.

Counterpart of stable_renderer_tpu/models/tokenizer.py (reference
comfy/sd1_clip.py:208-484). The JAX package runs transformers'
CLIPTokenizer; the port carries its own byte-level BPE (``CLIPBPE``), which
reads its own copy of the same vocab and merges files
(``stable_renderer_tpu_torch/assets/clip_tokenizer/``, read as data) and reproduces that
tokenizer's text cleanup (no ftfy: control-character removal, whitespace
normalization, CJK spacing, NFC, lower case) and its pre-tokenizer pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+``
by Unicode category.

Weighting grammar: ``(word)`` multiplies the weight by 1.1 per nesting level,
``(word:1.3)`` sets it, ``\\(`` / ``\\)`` escape literal parens.
``embedding:name`` words load a textual-inversion embedding from the
embedding directory (``load_embed``) and splice its vectors into the token
stream; ``pack_chunks`` turns them into negative ids -(k+1) into a table of
custom embeddings, which ``CLIPTextModel.apply`` reads.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from benchmark.reference.plain.utils.log import get_logger

logger = get_logger("sr_tpu.tokenizer")

# the CLIP vocab files, read as raw data from where the port keeps them
# (stable_renderer_tpu_torch/assets/clip_tokenizer/PROVENANCE.md)
ASSET_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), *([os.pardir] * 4),
    "stable_renderer_tpu_torch", "assets", "clip_tokenizer")

_SPECIAL = ("<|startoftext|>", "<|endoftext|>")
# the tower an embedding file's per-tower entry is read from (SD1.x's one)
EMBEDDING_KEY = "clip_l"
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


def _embed_file(embedding_name: str, directories: Sequence[str]) -> Optional[str]:
    """The embedding's file: ``name`` itself or with a .safetensors, .pt or
    .bin suffix, in the first directory that has one; a name that resolves
    outside its directory is refused (the reference's path traversal guard)."""
    for embed_dir in directories:
        embed_dir = os.path.abspath(embed_dir)
        embed_path = os.path.abspath(os.path.join(embed_dir, embedding_name))
        try:
            if os.path.commonpath((embed_dir, embed_path)) != embed_dir:
                continue
        except ValueError:
            continue
        if os.path.isfile(embed_path):
            return embed_path
        for ext in (".safetensors", ".pt", ".bin"):
            if os.path.isfile(embed_path + ext):
                return embed_path + ext
    return None


def load_embed(
    embedding_name: str,
    embedding_directory: Union[str, Sequence[str], None],
    embedding_size: int,
    embed_key: Optional[str] = None,
) -> Optional[np.ndarray]:
    """A textual-inversion embedding as (n_vectors, embedding_size) f32, or
    None (no such file, a file that does not load, or another width).

    Reads .safetensors (the port's reader) and torch .pt / .bin files
    (``torch.load(weights_only=True)``, as the reference loads them) with a
    raw tensor, {'string_to_param': {'*': t}}, {'emb_params': t} or per-tower
    keys {'clip_l': t, 'clip_g': t} (sd1_clip.py:286-356)."""
    if embedding_directory is None:
        return None
    if isinstance(embedding_directory, (str, os.PathLike)):
        embedding_directory = [str(embedding_directory)]
    valid_file = _embed_file(embedding_name, embedding_directory)
    if valid_file is None:
        return None
    try:
        if valid_file.endswith(".safetensors"):
            from benchmark.reference.plain.models.weights import read_safetensors

            data = read_safetensors(valid_file)
        else:
            data = torch.load(valid_file, map_location="cpu", weights_only=True)
            if isinstance(data, dict) and "string_to_param" in data:
                data = data["string_to_param"]
            if isinstance(data, torch.Tensor):
                data = {"emb_params": data}
        embed = {k: v.detach().float().numpy() for k, v in data.items()
                 if isinstance(v, torch.Tensor)}
    except Exception as e:  # a corrupt file: warn and skip, as the reference
        logger.warning(f"could not load embedding {valid_file}: {e}")
        return None
    values = None
    if embed_key is not None and embed_key in embed:
        values = embed[embed_key]
    elif "emb_params" in embed:
        values = embed["emb_params"]
    elif "*" in embed:
        values = embed["*"]
    elif len(embed) == 1:
        values = next(iter(embed.values()))
    else:  # per-tower keys: the entry of this tower's width
        for v in embed.values():
            if v.ndim and v.shape[-1] == embedding_size:
                values = v
                break
    if values is None:
        return None
    values = np.asarray(values, np.float32)
    if values.ndim == 1:
        values = values[None]
    if values.shape[-1] != embedding_size:
        logger.warning(f"embedding {embedding_name} has dim {values.shape[-1]}, expected "
                       f"{embedding_size}; ignoring")
        return None
    return values


class SDTokenizer:
    """Reference-parity prompt tokenizer (sd1_clip.py:358-484):
    ``tokenize_with_weights`` returns 77-long chunks of (token_id or
    embedding vector, weight) pairs with BOS/EOS and padding. Words shorter
    than ``max_word_length`` tokens wrap whole to the next chunk; longer ones
    may split. ``embedding:name`` words read ``name`` from
    ``embedding_directory`` (``load_embed``)."""

    def __init__(self, tokenizer_path: Optional[str] = None, max_length: int = 77,
                 pad_with_end: bool = True, pad_to_max_length: bool = True,
                 embedding_directory: Union[str, Sequence[str], None] = None,
                 embedding_size: int = 768):
        self.tokenizer = CLIPBPE(tokenizer_path)
        self.max_length = max_length
        self.start_token = self.tokenizer.bos
        self.end_token = self.tokenizer.eos
        self.pad_with_end = pad_with_end
        self.pad_to_max_length = pad_to_max_length
        self.max_word_length = 8
        self.embedding_directory = embedding_directory
        self.embedding_identifier = "embedding:"
        self.embedding_size = embedding_size
        self.inv_vocab = {v: k for k, v in self.tokenizer.encoder.items()}

    def _try_get_embedding(self, name: str):
        """(vectors or None, what is left of the word): a name that loads
        nothing is tried again without its trailing commas, which are then
        tokenized as text."""
        embed = load_embed(name, self.embedding_directory, self.embedding_size,
                           EMBEDDING_KEY)
        if embed is None:
            stripped = name.strip(",")
            if len(stripped) < len(name):
                embed = load_embed(stripped, self.embedding_directory, self.embedding_size,
                                   EMBEDDING_KEY)
                return embed, name[len(stripped):]
        return embed, ""

    def tokenize_with_weights(self, text: str):
        pad_token = self.end_token if self.pad_with_end else 0
        tokens: list = []
        for segment, weight in token_weights(escape_important(text), 1.0):
            for word in unescape_important(segment).replace("\n", " ").split(" "):
                if not word:
                    continue
                if (word.startswith(self.embedding_identifier)
                        and self.embedding_directory is not None):
                    name = word[len(self.embedding_identifier):].strip("\n")
                    embed, leftover = self._try_get_embedding(name)
                    if embed is None:
                        logger.warning(f"embedding:{name} does not exist, ignoring")
                    else:
                        tokens.append([(embed[x], weight) for x in range(embed.shape[0])])
                    if not leftover:
                        continue
                    word = leftover
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


    def untokenize(self, token_weight_pairs):
        """[(token string, weight)] for the integer ids of ``token_weight_pairs``
        (embedding vectors are left out; an id outside the vocab stays as it
        is)."""
        return [(self.inv_vocab.get(t, t), w) for t, w in token_weight_pairs
                if isinstance(t, int)]


def pack_chunks(chunks) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """tokenize_with_weights output -> (ids (n_chunks, L) int32, weights
    (n_chunks, L) f32, custom_embeds (K, D) f32 or None). Embedding vectors
    become negative ids -(k+1) into custom_embeds (the counterpart of
    sd1_clip.py:125-162 set_up_textual_embeddings)."""
    n = len(chunks)
    length = len(chunks[0]) if n else 0
    ids = np.zeros((n, length), np.int32)
    weights = np.ones((n, length), np.float32)
    custom: List[np.ndarray] = []
    for ci, chunk in enumerate(chunks):
        for ti, (tok, w) in enumerate(chunk):
            if isinstance(tok, np.ndarray):
                custom.append(np.asarray(tok, np.float32))
                ids[ci, ti] = -len(custom)
            else:
                ids[ci, ti] = int(tok)
            weights[ci, ti] = float(w)
    return ids, weights, np.stack(custom) if custom else None
