"""AutoencoderKL (the SD1.5 VAE) over a checkpoint-layout param dict.

Counterpart of stable_renderer_tpu/models/vae.py (reference comfy/sd.py VAE,
ldm/modules/diffusionmodules/model.py Encoder/Decoder). The param tree
mirrors ``first_stage_model.``: encoder.*, decoder.*, quant_conv,
post_quant_conv. latent = scale_factor * mean(encode(x)) and
decode(latent / scale_factor). NHWC activations; the mid-block attention is
one head over H*W tokens (4096 at 512 x 512, which goes to the flash-attention
kernel with d = 512).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.plain.models.layers import (
    attention,
    conv2d,
    group_norm,
    norm_act_conv,
    silu,
    upsample_nearest_2x,
)


@dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    scale_factor: float = 0.18215


SD15_VAE_CONFIG = VAEConfig()
# the same topology at SDXL's latent scale (comfy latent_formats.py SDXL.scale_factor)
SDXL_VAE_CONFIG = VAEConfig(scale_factor=0.13025)
TINY_VAE_CONFIG = VAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1)


def _resnet(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = norm_act_conv(p["norm1"], p["conv1"], x)
    h = norm_act_conv(p["norm2"], p["conv2"], h)
    if "nin_shortcut" in p:
        x = conv2d(p["nin_shortcut"], x)
    return x + h


def _attn_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    n = group_norm(p["norm"], x)
    # q/k/v are 1x1 convs in the checkpoint
    q = conv2d(p["q"], n).reshape(b, h * w, c)
    k = conv2d(p["k"], n).reshape(b, h * w, c)
    v = conv2d(p["v"], n).reshape(b, h * w, c)
    out = attention(q, k, v, heads=1).reshape(b, h, w, c)
    return x + conv2d(p["proj_out"], out)


class VAE:
    def __init__(self, config: VAEConfig = SD15_VAE_CONFIG):
        self.config = config

    def encode_moments(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) in [-1, 1] -> moments (B, H/f, W/f, 2*z)."""
        cfg = self.config
        e = params["encoder"]
        h = conv2d(e["conv_in"], x, padding=1)
        for level in range(len(cfg.ch_mult)):
            lvl = e["down"][str(level)]
            for i in range(cfg.num_res_blocks):
                h = _resnet(lvl["block"][str(i)], h)
            if level != len(cfg.ch_mult) - 1:
                # asymmetric pad (0, 1) then stride-2 conv (model.py Downsample)
                h = conv2d(lvl["downsample"]["conv"], F.pad(h, (0, 0, 0, 1, 0, 1)), stride=2)
        h = _resnet(e["mid"]["block_1"], h)
        h = _attn_block(e["mid"]["attn_1"], h)
        h = _resnet(e["mid"]["block_2"], h)
        h = conv2d(e["conv_out"], silu(group_norm(e["norm_out"], h)), padding=1)
        return conv2d(params["quant_conv"], h)

    def encode(self, params: dict, x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """pixels -> scaled latent (posterior mean; sampled when a generator is given)."""
        mean, logvar = self.encode_moments(params, x).chunk(2, dim=-1)
        if generator is not None:
            std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
            mean = mean + std * torch.randn(mean.shape, generator=generator,
                                            device=mean.device, dtype=mean.dtype)
        return mean * self.config.scale_factor

    def decode(self, params: dict, z: torch.Tensor) -> torch.Tensor:
        """scaled latent (B, h, w, z) -> pixels (B, f*h, f*w, 3) in [-1, 1]."""
        cfg = self.config
        z = z / cfg.scale_factor
        d = params["decoder"]
        h = conv2d(params["post_quant_conv"], z)
        h = conv2d(d["conv_in"], h, padding=1)
        h = _resnet(d["mid"]["block_1"], h)
        h = _attn_block(d["mid"]["attn_1"], h)
        h = _resnet(d["mid"]["block_2"], h)
        for level in reversed(range(len(cfg.ch_mult))):
            lvl = d["up"][str(level)]
            for i in range(cfg.num_res_blocks + 1):
                h = _resnet(lvl["block"][str(i)], h)
            if level != 0:
                h = conv2d(lvl["upsample"]["conv"], upsample_nearest_2x(h), padding=1)
        return conv2d(d["conv_out"], silu(group_norm(d["norm_out"], h)), padding=1)

    # --- tiled variants (reference comfy/sd.py VAE tiled fallback) ----------

    def _tiled(self, fn, x: torch.Tensor, tile: int, overlap: int, scale: float,
               channels: int) -> torch.Tensor:
        """Run ``fn`` over overlapping (tile x tile) windows of ``x`` (B, H, W,
        C) and blend the outputs, whose sides are ``scale`` times the
        window's, with linear ramps of ``overlap * scale`` pixels and the
        JAX package's tile walk and 1e-6 weight floor. The sums stay on the
        tensors' device in f32."""
        b, h, w, _ = x.shape
        oh, ow = int(h * scale), int(w * scale)
        out = torch.zeros((b, oh, ow, channels), dtype=torch.float32, device=x.device)
        weight = torch.zeros((1, oh, ow, 1), dtype=torch.float32, device=x.device)
        n = int(tile * scale)
        ramp = torch.clamp(torch.arange(1, n + 1, dtype=torch.float64)
                           / max(int(overlap * scale), 1), max=1.0)
        tile_w = torch.minimum(ramp, ramp.flip(0)).float().to(x.device)
        step = max(tile - overlap, 1)
        y = 0
        while y < h:
            y0 = min(y, max(h - tile, 0))
            xc = 0
            while xc < w:
                x0 = min(xc, max(w - tile, 0))
                part = fn(x[:, y0: y0 + tile, x0: x0 + tile]).float()
                th, tw = part.shape[1], part.shape[2]
                wgt = (tile_w[:th, None] * tile_w[None, :tw])[None, ..., None]
                oy, ox = int(y0 * scale), int(x0 * scale)
                out[:, oy: oy + th, ox: ox + tw] += part * wgt
                weight[:, oy: oy + th, ox: ox + tw] += wgt
                xc += step
            y += step
        return out / torch.clamp(weight, min=1e-6)

    def decode_tiled(self, params: dict, z: torch.Tensor, tile: int = 64,
                     overlap: int = 16) -> torch.Tensor:
        """Decode in overlapping latent tiles with a linear blend, f32 (the
        reference's out-of-memory fallback, comfy/sd.py:245-280)."""
        f = 2 ** (len(self.config.ch_mult) - 1)
        overlap = min(overlap, tile // 2)  # keep the stride positive
        return self._tiled(lambda zt: self.decode(params, zt), z, tile, overlap, f, 3)

    def encode_tiled(self, params: dict, x: torch.Tensor, tile: int = 512,
                     overlap: int = 64) -> torch.Tensor:
        """Encode in overlapping pixel tiles, f32 (comfy/sd.py encode_tiled)."""
        f = 2 ** (len(self.config.ch_mult) - 1)
        overlap = min(overlap, tile // 2)
        return self._tiled(lambda xt: self.encode(params, xt), x, tile, overlap, 1.0 / f,
                           self.config.embed_dim)

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        """Random init with the checkpoint param tree and shapes."""
        cfg = self.config

        def conv(i, o, k=3):
            w = torch.randn((o, i, k, k), generator=generator, device=device) / math.sqrt(i * k * k)
            return {"weight": w.to(dtype), "bias": torch.zeros(o, dtype=dtype, device=device)}

        def norm(c):
            return {"weight": torch.ones(c, dtype=dtype, device=device),
                    "bias": torch.zeros(c, dtype=dtype, device=device)}

        def resnet(i, o):
            p = {"norm1": norm(i), "conv1": conv(i, o), "norm2": norm(o), "conv2": conv(o, o)}
            if i != o:
                p["nin_shortcut"] = conv(i, o, 1)
            return p

        def attn(c):
            return {"norm": norm(c), "q": conv(c, c, 1), "k": conv(c, c, 1),
                    "v": conv(c, c, 1), "proj_out": conv(c, c, 1)}

        z = cfg.z_channels
        enc: dict = {"conv_in": conv(3, cfg.ch), "down": {}}
        ch = cfg.ch
        for level, mult in enumerate(cfg.ch_mult):
            out_ch = cfg.ch * mult
            lvl: dict = {"block": {}}
            for i in range(cfg.num_res_blocks):
                lvl["block"][str(i)] = resnet(ch, out_ch)
                ch = out_ch
            if level != len(cfg.ch_mult) - 1:
                lvl["downsample"] = {"conv": conv(ch, ch)}
            enc["down"][str(level)] = lvl
        enc["mid"] = {"block_1": resnet(ch, ch), "attn_1": attn(ch), "block_2": resnet(ch, ch)}
        enc["norm_out"] = norm(ch)
        enc["conv_out"] = conv(ch, 2 * z)
        dec: dict = {"conv_in": conv(z, ch)}
        dec["mid"] = {"block_1": resnet(ch, ch), "attn_1": attn(ch), "block_2": resnet(ch, ch)}
        dec["up"] = {}
        for level in reversed(range(len(cfg.ch_mult))):
            out_ch = cfg.ch * cfg.ch_mult[level]
            lvl = {"block": {}}
            for i in range(cfg.num_res_blocks + 1):
                lvl["block"][str(i)] = resnet(ch, out_ch)
                ch = out_ch
            if level != 0:
                lvl["upsample"] = {"conv": conv(ch, ch)}
            dec["up"][str(level)] = lvl
        dec["norm_out"] = norm(ch)
        dec["conv_out"] = conv(ch, 3)
        return {"encoder": enc, "decoder": dec, "quant_conv": conv(2 * z, 2 * z, 1),
                "post_quant_conv": conv(z, z, 1)}
