"""Defer + post-process stages — the last two GL passes of the reference.

Counterpart of stable_renderer_tpu/ops/postprocess.py:
default_defer_render.frag.glsl (bake-mode correspondence overlay) and
default_post_process.frag.glsl (gamma / exposure / saturation / brightness /
contrast / HDR tonemap), elementwise over (..., H, W, 4).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from stable_renderer_tpu_torch.data.framebuffers import NON_AI_MAP_INDEX

BAKING_VISUAL_VAL = 512  # default_defer_render.frag.glsl:3


@dataclass(frozen=True)
class PostProcessParams:
    """default_post_process uniforms (defaults = no-op, matching the shader)."""

    enable_gamma: bool = False
    enable_hdr: bool = False
    gamma: float = 1.0
    exposure: float = 1.0
    saturation: float = 1.0
    brightness: float = 1.0
    contrast: float = 1.0


def defer_render(color: torch.Tensor, ids: torch.Tensor, is_baking: bool = False) -> torch.Tensor:
    """default_defer_render.frag.glsl: passthrough color; in bake mode, overlay
    a rainbow vertex-id visualization on AI-object pixels (10% blend)."""
    if not is_baking:
        return color
    exists = ids.sum(-1) > 0
    is_ai = ids[..., 2] != NON_AI_MAP_INDEX
    ratio = 1.0 - torch.clamp(
        ids[..., 3].float() / float(BAKING_VISUAL_VAL * BAKING_VISUAL_VAL), 0.0, 1.0)
    # six-segment rainbow (frag:29-56)
    seg = torch.clamp((ratio * 6.0).to(torch.int32), 0, 5)
    f = ratio * 6.0 - seg
    one, zero = torch.ones_like(f), torch.zeros_like(f)
    table_r = torch.stack([one, 1.0 - f, zero, zero, f, one], dim=-1)
    table_g = torch.stack([f, one, one, 1.0 - f, zero, zero], dim=-1)
    table_b = torch.stack([zero, zero, f, one, one, 1.0 - f], dim=-1)
    sel = seg.long()[..., None]
    overlay = torch.cat([torch.gather(t, -1, sel) for t in (table_r, table_g, table_b)], dim=-1)
    mixed = color[..., :3] * 0.9 + overlay * 0.1
    ai = (exists & is_ai)
    rgb = torch.where(ai[..., None], mixed, color[..., :3])
    alpha = torch.where(ai, torch.ones_like(color[..., 3]), color[..., 3])
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def post_process(color: torch.Tensor, params: PostProcessParams = PostProcessParams()) -> torch.Tensor:
    """default_post_process.frag.glsl, applied in shader order."""
    rgb = color[..., :3]
    p = params
    if p.enable_gamma:
        rgb = torch.pow(torch.clamp(rgb, min=1e-8), 1.0 / p.gamma)
    rgb = rgb * p.exposure
    rgb = 0.5 * (1.0 - p.saturation) + rgb * p.saturation  # mix(vec3(0.5), rgb, sat)
    rgb = rgb * p.brightness
    rgb = (rgb - 0.5) * p.contrast + 0.5
    if p.enable_hdr:
        rgb = rgb / (rgb + 1.0)
    return torch.cat([rgb, color[..., 3:]], dim=-1)
