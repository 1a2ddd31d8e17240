"""CLIP text encoder (SD1.5's conditioner) + tokenizer.

Counterpart of stable_renderer_tpu/models/clip.py (reference comfy/sd.py CLIP,
comfy/sd1_clip.py SDClipModel / SDTokenizer). The param tree mirrors the
transformers CLIPTextModel layout (``cond_stage_model.transformer.text_model.*``).

clip_skip follows comfy CLIPTextEncode: -1 = final hidden state, -2 =
penultimate, with the final LayerNorm applied after truncation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from stable_renderer_tpu_torch.models.layers import attention, gelu_quick, layer_norm, linear


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
        tokens: torch.Tensor,  # (B, 77) integer ids
        clip_skip: int = -1,
        final_norm: bool = True,
        custom_embeds: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """tokens -> (B, 77, hidden) conditioning."""
        if custom_embeds is not None:
            raise NotImplementedError("textual-inversion embeddings are not ported yet")
        cfg = self.config
        tm = params["text_model"]
        tokens = tokens.long()
        x = tm["embeddings"]["token_embedding"]["weight"][torch.clamp(tokens, min=0)]
        x = x + tm["embeddings"]["position_embedding"]["weight"][: tokens.shape[1]][None]

        l = tokens.shape[1]  # noqa: E741
        ar = torch.arange(l, device=tokens.device)
        causal = torch.zeros((l, l), dtype=torch.float32, device=tokens.device)
        causal = causal.masked_fill(ar[None, :] > ar[:, None], float("-inf"))[None, None]

        n_layers = cfg.num_layers if clip_skip == -1 else cfg.num_layers + 1 + clip_skip
        for i in range(n_layers):
            lp = tm["encoder"]["layers"][str(i)]
            h = layer_norm(lp["layer_norm1"], x)
            q = linear(lp["self_attn"]["q_proj"], h)
            k = linear(lp["self_attn"]["k_proj"], h)
            v = linear(lp["self_attn"]["v_proj"], h)
            h = attention(q, k, v, cfg.num_heads, mask=causal)
            x = x + linear(lp["self_attn"]["out_proj"], h)
            h = gelu_quick(linear(lp["mlp"]["fc1"], layer_norm(lp["layer_norm2"], x)))
            x = x + linear(lp["mlp"]["fc2"], h)
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


class Tokenizer:
    """The CLIP BPE tokenizer over the bundled vocab, with ``(word:1.2)``
    weighting (models/tokenizer.py). Tiny test configs (vocab_size < 49408)
    use the JAX package's deterministic hash tokenizer, which is Python's
    ``hash`` and so agrees with it within one process."""

    def __init__(self, config: CLIPConfig = SD15_CLIP_CONFIG, vocab_path: Optional[str] = None):
        self.config = config
        self._sd = None
        if config.vocab_size >= 49408:
            from stable_renderer_tpu_torch.models.tokenizer import SDTokenizer

            self._sd = SDTokenizer(tokenizer_path=vocab_path, max_length=config.max_length)

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

    def tokenize_weighted(self, text: str):
        """text -> (ids (n_chunks, 77) i32, weights (n_chunks, 77) f32, None)."""
        from stable_renderer_tpu_torch.models.tokenizer import pack_chunks

        if self._sd is not None:
            return pack_chunks(self._sd.tokenize_with_weights(text))
        ids = self.encode(text)[None]
        return ids, np.ones_like(ids, np.float32), None

    def tokenize_weighted_batch(self, texts: Sequence[str]):
        """texts -> (ids (B, C, 77), weights (B, C, 77), None): every prompt is
        padded to the same chunk count C with empty chunks."""
        cfg = self.config
        packed = [self.tokenize_weighted(t) for t in texts]
        c = max(p[0].shape[0] for p in packed)
        ids = np.full((len(texts), c, cfg.max_length), cfg.eos_token % cfg.vocab_size, np.int32)
        ids[:, :, 0] = cfg.bos_token % cfg.vocab_size
        weights = np.ones((len(texts), c, cfg.max_length), np.float32)
        for bi, (pid, pw, _) in enumerate(packed):
            ids[bi, : pid.shape[0]] = pid
            weights[bi, : pw.shape[0]] = pw
        return ids, weights, None


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
