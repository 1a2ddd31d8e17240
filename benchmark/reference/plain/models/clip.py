"""The text towers (SD1.x's CLIP-L, SD2's OpenCLIP-H, SDXL's CLIP-L + OpenCLIP-G)
and the tokenizer.

Counterpart of stable_renderer_tpu/models/clip.py (reference comfy/sd.py CLIP,
comfy/sd1_clip.py SDClipModel / SDTokenizer, sd2_clip.py, sdxl_clip.py). The
CLIP-L tree mirrors the transformers CLIPTextModel layout
(``cond_stage_model.transformer.text_model.*``); the OpenCLIP trees mirror
open_clip's (``cond_stage_model.model.*`` for SD2,
``conditioner.embedders.N.model.*`` for SDXL).

clip_skip follows comfy CLIPTextEncode: -1 = final hidden state, -2 =
penultimate, with the final LayerNorm applied after truncation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.plain.models.layers import attention, gelu_quick, layer_norm, linear


@dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 49408
    max_length: int = 77
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    bos_token: int = 49406
    eos_token: int = 49407


SD15_CLIP_CONFIG = CLIPConfig()
TINY_CLIP_CONFIG = CLIPConfig(
    vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128
)


class CLIPTextModel:
    def __init__(self, config: CLIPConfig = SD15_CLIP_CONFIG):
        self.config = config

    def apply(
        self,
        params: dict,
        tokens: torch.Tensor,  # (B, 77) integer ids; negative ids index custom_embeds
        clip_skip: int = -1,
        final_norm: bool = True,
        custom_embeds: Optional[torch.Tensor] = None,  # (K, hidden) textual inversion
    ) -> torch.Tensor:
        """tokens -> (B, 77, hidden) conditioning. Textual-inversion vectors
        ride in as negative ids -(k+1) into ``custom_embeds``."""
        cfg = self.config
        tm = params["text_model"]
        tokens = tokens.long()
        x = tm["embeddings"]["token_embedding"]["weight"][torch.clamp(tokens, min=0)]
        if custom_embeds is not None:
            cidx = torch.clamp(-tokens - 1, min=0)
            x = torch.where((tokens < 0)[..., None], custom_embeds[cidx].to(x.dtype), x)
        x = x + tm["embeddings"]["position_embedding"]["weight"][: tokens.shape[1]][None]

        causal = _causal_mask(tokens.shape[1], tokens.device)

        n_layers = cfg.num_layers if clip_skip == -1 else cfg.num_layers + 1 + clip_skip
        for i in range(n_layers):
            x = encoder_layer(tm["encoder"]["layers"][str(i)], x, cfg.num_heads, causal)
        if not final_norm:
            return x
        return layer_norm(tm["final_layer_norm"], x)

    def pooled(self, params: dict, tokens: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        """EOS-token pooled embedding (first EOS position per row)."""
        eos_pos = torch.argmax((tokens == self.config.eos_token).int(), dim=1)
        return hidden[torch.arange(tokens.shape[0], device=hidden.device), eos_pos]

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        cfg = self.config

        def randn(*shape):
            return (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)

        def lin(i, o):
            return {"weight": randn(o, i), "bias": torch.zeros(o, dtype=dtype, device=device)}

        def norm(c):
            return {"weight": torch.ones(c, dtype=dtype, device=device),
                    "bias": torch.zeros(c, dtype=dtype, device=device)}

        h = cfg.hidden_size
        layers = {
            str(i): {
                "layer_norm1": norm(h),
                "layer_norm2": norm(h),
                "self_attn": {"q_proj": lin(h, h), "k_proj": lin(h, h), "v_proj": lin(h, h),
                              "out_proj": lin(h, h)},
                "mlp": {"fc1": lin(h, cfg.intermediate_size),
                        "fc2": lin(cfg.intermediate_size, h)},
            }
            for i in range(cfg.num_layers)
        }
        return {"text_model": {
            "embeddings": {
                "token_embedding": {"weight": randn(cfg.vocab_size, h)},
                "position_embedding": {"weight": randn(cfg.max_length, h)},
            },
            "encoder": {"layers": layers},
            "final_layer_norm": norm(h),
        }}


def encoder_layer(lp: dict, x: torch.Tensor, heads: int, causal: torch.Tensor) -> torch.Tensor:
    """One pre-norm CLIP encoder layer: causal self-attention, then the
    quick-gelu MLP, each with its residual."""
    h = layer_norm(lp["layer_norm1"], x)
    q = linear(lp["self_attn"]["q_proj"], h)
    k = linear(lp["self_attn"]["k_proj"], h)
    v = linear(lp["self_attn"]["v_proj"], h)
    h = attention(q, k, v, heads, mask=causal)
    x = x + linear(lp["self_attn"]["out_proj"], h)
    h = gelu_quick(linear(lp["mlp"]["fc1"], layer_norm(lp["layer_norm2"], x)))
    return x + linear(lp["mlp"]["fc2"], h)


def _causal_mask(length: int, device) -> torch.Tensor:
    """(1, 1, L, L) f32: 0 on and below the diagonal, -inf above."""
    ar = torch.arange(length, device=device)
    causal = torch.zeros((length, length), dtype=torch.float32, device=device)
    return causal.masked_fill(ar[None, :] > ar[:, None], float("-inf"))[None, None]


@dataclass(frozen=True)
class OpenCLIPConfig:
    """An OpenCLIP text tower (SDXL's second encoder ViT-bigG, SD2's ViT-H)."""

    vocab_size: int = 49408
    max_length: int = 77
    width: int = 1280
    num_layers: int = 32
    num_heads: int = 20
    mlp_ratio: int = 4
    projection_dim: int = 1280


SDXL_CLIP_G_CONFIG = OpenCLIPConfig()
TINY_CLIP_G_CONFIG = OpenCLIPConfig(vocab_size=1000, width=64, num_layers=2, num_heads=2,
                                    projection_dim=32)
SD2_CLIP_H_CONFIG = OpenCLIPConfig(width=1024, num_layers=24, num_heads=16, projection_dim=1024)
TINY_CLIP_H_CONFIG = OpenCLIPConfig(vocab_size=1000, width=64, num_layers=3, num_heads=2,
                                    projection_dim=64)


class OpenCLIPTextModel:
    """The OpenCLIP text transformer in the checkpoint layout (token_embedding,
    positional_embedding, transformer.resblocks.N.{ln_1, attn.in_proj_*,
    attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}, ln_final, text_projection)
    with comfy sdxl_clip.py's semantics: the exact GELU (not CLIP-L's quick
    GELU), the fused in_proj split into q, k and v at apply time, and
    ``text_projection`` a bare (width, proj) matrix multiplied from the
    right."""

    def __init__(self, config: OpenCLIPConfig = SDXL_CLIP_G_CONFIG):
        self.config = config

    def apply(self, params: dict, tokens: torch.Tensor, clip_skip: int = -2):
        """tokens -> (hidden (B, L, width) after layer ``clip_skip`` (-1 the
        last, -2 the penultimate), pooled (B, proj)): the final-normed state
        at the first EOS (49407 modulo the vocab), through the projection.
        Negative (textual-inversion) ids are clamped to 0: the G tower has no
        table of its own."""
        cfg = self.config
        m = params["model"] if "model" in params else params
        tokens = torch.clamp(tokens.long(), min=0)
        x = m["token_embedding"]["weight"][tokens]
        x = x + m["positional_embedding"][: tokens.shape[1]][None]
        causal = _causal_mask(tokens.shape[1], tokens.device)
        n_layers = cfg.num_layers if clip_skip == -1 else cfg.num_layers + 1 + clip_skip
        hidden = x
        for i in range(cfg.num_layers):
            blk = m["transformer"]["resblocks"][str(i)]
            attn = blk["attn"]
            h = linear({"weight": attn["in_proj_weight"], "bias": attn["in_proj_bias"]},
                       layer_norm(blk["ln_1"], x))
            q, k, v = h.chunk(3, dim=-1)
            x = x + linear(attn["out_proj"], attention(q, k, v, cfg.num_heads, mask=causal))
            h = F.gelu(linear(blk["mlp"]["c_fc"], layer_norm(blk["ln_2"], x)))
            x = x + linear(blk["mlp"]["c_proj"], h)
            if i + 1 == n_layers:
                hidden = x
        final = layer_norm(m["ln_final"], x)
        eos_pos = torch.argmax((tokens == 49407 % cfg.vocab_size).int(), dim=1)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        return hidden, final[rows, eos_pos] @ m["text_projection"]

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        """Random init in the checkpoint layout: N(0, 0.02^2) weights (the
        positional table N(0, 0.01^2)), zero biases, unit norm scales."""
        cfg = self.config

        def randn(std, *shape):
            return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

        def zeros(n):
            return torch.zeros(n, dtype=dtype, device=device)

        def lin(i, o):
            return {"weight": randn(0.02, o, i), "bias": zeros(o)}

        def norm(c):
            return {"weight": torch.ones(c, dtype=dtype, device=device), "bias": zeros(c)}

        w = cfg.width
        blocks = {
            str(i): {
                "ln_1": norm(w),
                "ln_2": norm(w),
                "attn": {"in_proj_weight": randn(0.02, 3 * w, w), "in_proj_bias": zeros(3 * w),
                         "out_proj": lin(w, w)},
                "mlp": {"c_fc": lin(w, w * cfg.mlp_ratio), "c_proj": lin(w * cfg.mlp_ratio, w)},
            }
            for i in range(cfg.num_layers)
        }
        return {"model": {
            "token_embedding": {"weight": randn(0.02, cfg.vocab_size, w)},
            "positional_embedding": randn(0.01, cfg.max_length, w),
            "transformer": {"resblocks": blocks},
            "ln_final": norm(w),
            "text_projection": randn(0.02, w, cfg.projection_dim),
        }}


class SD2ClipH:
    """SD2.x's text tower: OpenCLIP-H in the checkpoint layout
    ``cond_stage_model.model.*`` behind CLIPTextModel's interface (comfy
    sd2_clip.py SD2ClipHModel: the penultimate hidden state with ``ln_final``
    applied). ``config`` is the CLIPConfig facade the tokenizer and the
    weighted encoders read."""

    def __init__(self, ocfg: OpenCLIPConfig = SD2_CLIP_H_CONFIG):
        self._inner = OpenCLIPTextModel(ocfg)
        self.config = CLIPConfig(vocab_size=ocfg.vocab_size, max_length=ocfg.max_length,
                                 hidden_size=ocfg.width, num_layers=ocfg.num_layers,
                                 num_heads=ocfg.num_heads,
                                 intermediate_size=ocfg.width * ocfg.mlp_ratio)

    def apply(self, params: dict, tokens: torch.Tensor, clip_skip: int = -1,
              final_norm: bool = True,
              custom_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """clip_skip -1 reads the penultimate layer (SD2's default); textual
        inversion has no table here, so ``custom_embeds`` is not read."""
        hidden, _ = self._inner.apply(params, tokens, clip_skip=-2 if clip_skip == -1
                                      else clip_skip)
        if final_norm:
            m = params["model"] if "model" in params else params
            hidden = layer_norm(m["ln_final"], hidden)
        return hidden

    def pooled(self, params: dict, tokens: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        return self._inner.apply(params, tokens, clip_skip=-1)[1]

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        return self._inner.init(generator, dtype=dtype, device=device)


class SDXLClip:
    """SDXL's dual-tower conditioning (comfy sdxl_clip.py SDXLClipModel):
    context = [CLIP-L penultimate without the final norm (768) | CLIP-G
    penultimate (1280)] = 2048 wide; pooled = CLIP-G's projection."""

    def __init__(self, clip_l: "CLIPTextModel", clip_g: OpenCLIPTextModel):
        self.clip_l = clip_l
        self.clip_g = clip_g

    def apply(self, params_l: dict, params_g: dict, tokens: torch.Tensor):
        hidden_l = self.clip_l.apply(params_l, tokens, clip_skip=-2, final_norm=False)
        hidden_g, pooled = self.clip_g.apply(params_g, tokens, clip_skip=-2)
        return torch.cat([hidden_l, hidden_g], dim=-1), pooled


class Tokenizer:
    """The CLIP BPE tokenizer over the bundled vocab, with ``(word:1.2)``
    weighting and ``embedding:name`` textual inversion from
    ``embedding_directory`` (models/tokenizer.py). Tiny test configs
    (vocab_size < 49408) use the JAX package's deterministic hash tokenizer,
    which is Python's ``hash`` and so agrees with it within one process."""

    def __init__(self, config: CLIPConfig = SD15_CLIP_CONFIG, vocab_path: Optional[str] = None,
                 embedding_directory=None):
        self.config = config
        self._sd = None
        if config.vocab_size >= 49408:
            from benchmark.reference.plain.models.tokenizer import SDTokenizer

            self._sd = SDTokenizer(tokenizer_path=vocab_path, max_length=config.max_length,
                                   embedding_directory=embedding_directory,
                                   embedding_size=config.hidden_size)

    def encode(self, text: str) -> np.ndarray:
        """text -> (77,) int32 with BOS/EOS + EOS padding (first chunk only)."""
        cfg = self.config
        if self._sd is not None:
            return np.asarray([t for t, _ in self._sd.tokenize_with_weights(text)[0]], np.int32)
        body = [(hash(w) % (cfg.vocab_size - 2 - 1)) + 1 for w in text.lower().split()]
        body = body[: cfg.max_length - 2]
        eos = cfg.eos_token % cfg.vocab_size
        ids = [cfg.bos_token % cfg.vocab_size] + body + [eos]
        ids += [eos] * (cfg.max_length - len(ids))
        return np.asarray(ids, np.int32)

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        """texts -> (B, 77) int32, ``encode`` of each."""
        return np.stack([self.encode(t) for t in texts])

    def tokenize_weighted(self, text: str):
        """text -> (ids (n_chunks, 77) i32, weights (n_chunks, 77) f32,
        custom_embeds (K, hidden) f32 or None)."""
        from benchmark.reference.plain.models.tokenizer import pack_chunks

        if self._sd is not None:
            return pack_chunks(self._sd.tokenize_with_weights(text))
        ids = self.encode(text)[None]
        return ids, np.ones_like(ids, np.float32), None

    def tokenize_weighted_batch(self, texts: Sequence[str]):
        """texts -> (ids (B, C, 77), weights (B, C, 77), custom (K, hidden) or
        None): every prompt is padded to the same chunk count C with empty
        chunks; the prompts' textual-inversion vectors join one table, their
        ids renumbered into it."""
        cfg = self.config
        packed = [self.tokenize_weighted(t) for t in texts]
        c = max(p[0].shape[0] for p in packed)
        ids = np.full((len(texts), c, cfg.max_length), cfg.eos_token % cfg.vocab_size, np.int32)
        ids[:, :, 0] = cfg.bos_token % cfg.vocab_size
        weights = np.ones((len(texts), c, cfg.max_length), np.float32)
        customs = []
        offset = 0
        for bi, (pid, pw, pc) in enumerate(packed):
            if pc is not None:
                pid = np.where(pid < 0, pid - offset, pid)  # -(k+1) -> -(offset+k+1)
                customs.append(pc)
                offset += pc.shape[0]
            ids[bi, : pid.shape[0]] = pid
            weights[bi, : pw.shape[0]] = pw
        return ids, weights, np.concatenate(customs, axis=0) if customs else None


def encode_token_weights_batch(
    model: CLIPTextModel,
    params: dict,
    ids: torch.Tensor,      # (B, C, L) integer ids
    weights: torch.Tensor,  # (B, C, L) f32
    custom_embeds: Optional[torch.Tensor] = None,
    clip_skip: int = -1,
    final_norm: bool = True,
):
    """Weighted multi-chunk encoding (ClipTokenWeightEncoder,
    sd1_clip.py:25-60): all B*C chunks plus one empty chunk run as one batch;
    ``z = (z - z_empty) * w + z_empty``. Returns (context (B, C*L, hidden),
    pooled (B, hidden))."""
    cfg = model.config
    b, c, length = ids.shape
    flat = ids.reshape(b * c, length)
    empty = torch.full((1, length), cfg.eos_token % cfg.vocab_size, dtype=ids.dtype,
                       device=ids.device)
    empty[0, 0] = cfg.bos_token % cfg.vocab_size
    out = model.apply(params, torch.cat([flat, empty], 0), clip_skip=clip_skip,
                      final_norm=final_norm, custom_embeds=custom_embeds)
    z, z_empty = out[: b * c], out[b * c]
    z = (z - z_empty[None]) * weights.reshape(b * c, length)[..., None] + z_empty[None]
    pooled = model.pooled(params, flat[::c], out[: b * c: c])
    return z.reshape(b, c * length, -1), pooled


def clip_g_pad_ids(ids: torch.Tensor, eos: int = 49407) -> torch.Tensor:
    """The G tower's ids from the L tower's: SDXLClipGTokenizer pads with 0
    after the first EOS (pad_with_end=False, comfy sdxl_clip.py)."""
    first_eos = torch.argmax((ids == eos).int(), dim=-1)
    after = torch.arange(ids.shape[-1], device=ids.device) > first_eos[..., None]
    return torch.where(after, torch.zeros_like(ids), ids)


def _encode_g(clip_g: OpenCLIPTextModel, params_g: dict, ids: torch.Tensor,
              weights: torch.Tensor, bos: int, eos: int, clip_skip: int):
    """The G tower's weighted encoding of (B, C, L) L-tower ids: (context
    (B, C*L, width), pooled of each prompt's first chunk (B, proj)). The G
    ids and the empty chunk [BOS, EOS, 0...] are padded with 0."""
    b, c, length = ids.shape
    ids_g = clip_g_pad_ids(ids.reshape(b * c, length), eos)
    empty = torch.zeros((1, length), dtype=ids.dtype, device=ids.device)
    empty[0, 0], empty[0, 1] = bos, eos
    hidden, pooled = clip_g.apply(params_g, torch.cat([ids_g, empty], 0), clip_skip=clip_skip)
    zg, zg_empty = hidden[: b * c], hidden[b * c]
    zg = (zg - zg_empty[None]) * weights.reshape(b * c, length)[..., None] + zg_empty[None]
    return zg.reshape(b, c * length, -1), pooled[: b * c: c]


def encode_token_weights_batch_g(
    clip_g: OpenCLIPTextModel,
    params_g: dict,
    ids: torch.Tensor,      # (B, C, L) L-tower ids; the G ids are derived
    weights: torch.Tensor,  # (B, C, L) f32
    clip_skip: int = -2,
):
    """The SDXL refiner's single-tower encoding (comfy sdxl_clip.py
    SDXLRefinerClipModel): the refiner carries only CLIP-G, so the context is
    G's penultimate hidden state (1280 wide) and pooled G's projection."""
    vocab = clip_g.config.vocab_size
    return _encode_g(clip_g, params_g, ids, weights, 49406 % vocab, 49407 % vocab, clip_skip)


def encode_token_weights_batch_xl(
    clip_l: CLIPTextModel,
    clip_g: OpenCLIPTextModel,
    params_l: dict,
    params_g: dict,
    ids: torch.Tensor,      # (B, C, L) L-tower ids; the G ids are derived
    weights: torch.Tensor,  # (B, C, L) f32
    custom_embeds: Optional[torch.Tensor] = None,
    clip_skip: int = -2,
):
    """SDXL's dual-tower weighted encoding (comfy sdxl_clip.py SDXLClipModel):
    context = [CLIP-L hidden without the final norm | CLIP-G hidden] a chunk,
    pooled = CLIP-G's projection of each prompt's first chunk. Both towers
    take ClipTokenWeightEncoder's ``(z - z_empty) * w + z_empty``."""
    cfg_l = clip_l.config
    z_l, _ = encode_token_weights_batch(clip_l, params_l, ids, weights,
                                        custom_embeds=custom_embeds, clip_skip=clip_skip,
                                        final_norm=False)
    vocab = clip_g.config.vocab_size
    z_g, pooled = _encode_g(clip_g, params_g, ids, weights, cfg_l.bos_token % vocab,
                            cfg_l.eos_token % vocab, clip_skip)
    return torch.cat([z_l, z_g], dim=-1), pooled
