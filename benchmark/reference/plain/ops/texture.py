"""Texture sampling as tensor gathers — replaces GL samplers.

Counterpart of stable_renderer_tpu/ops/texture.py. A texture is an (H, W, C)
tensor; UVs follow GL (u right, v up), so v is flipped into image rows here.
"""

from __future__ import annotations

from typing import Optional

import torch


def _uv_to_xy(uv: torch.Tensor, h: int, w: int):
    u = torch.clamp(uv[..., 0], 0.0, 1.0)
    v = torch.clamp(uv[..., 1], 0.0, 1.0)
    return u * (w - 1), (1.0 - v) * (h - 1)  # GL v-up -> image row


def sample_nearest(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest sample of tex (H, W, C) at uv (..., 2) in [0,1]. Returns (..., C)."""
    x, y = _uv_to_xy(uv, tex.shape[0], tex.shape[1])
    return tex[torch.round(y).long(), torch.round(x).long()]


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of tex (H, W, C) at uv (..., 2) in [0,1]. Returns (..., C)."""
    h, w = tex.shape[0], tex.shape[1]
    x, y = _uv_to_xy(uv, h, w)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    top = tex[y0, x0] * (1 - fx) + tex[y0, x1] * fx
    bot = tex[y1, x0] * (1 - fx) + tex[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def noise_texture(generator: Optional[torch.Generator], height: int, width: int,
                  channels: int = 4, device=None) -> torch.Tensor:
    """A (height, width, channels) f32 standard-normal noise texture drawn
    from ``generator`` (the reference's Texture.CreateNoiseTex,
    texture.py:506-569): per-object latent noise rendered into the
    G-buffer. The JAX package draws it from a key; the two draws differ."""
    return torch.randn((height, width, channels), generator=generator, device=device,
                       dtype=torch.float32)
