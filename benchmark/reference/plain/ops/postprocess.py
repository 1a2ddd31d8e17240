"""Defer + post-process stages — the last two GL passes of the reference.

Counterpart of stable_renderer_tpu/ops/postprocess.py:
default_defer_render.frag.glsl (bake-mode correspondence overlay), the
defer stage's Lambert lighting from the engine's Light components, and
default_post_process.frag.glsl (gamma / exposure / saturation / brightness /
contrast / HDR tonemap), elementwise over (..., H, W, 4).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference.plain.data.framebuffers import NON_AI_MAP_INDEX

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


LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2


def apply_lights(
    color: torch.Tensor,       # (H, W, 4) display color
    normal_enc: torch.Tensor,  # (H, W, 3) encoded view-space normal in [0,1]
    pos: torch.Tensor,         # (H, W, 3) view-space position
    lights: torch.Tensor,      # (L, 16) packed rows (Light.pack_lights):
    # [type, r, g, b, intensity, px, py, pz, dx, dy, dz,
    #  att_const, att_lin, att_quad, cos_angle, ambient]
) -> torch.Tensor:
    """Defer-stage diffuse lighting from the engine's Light components.

    The reference maps Light components into shader UBO structs
    (engine/runtime/components/light/light.py:13-80: position/color/intensity +
    const/linear/quadratic attenuation) but its defer shader never consumed
    them (shadow maps TODO, renderManager.py:452-461); the defer stage
    applies the Lambert term those structs describe. Pixels with no geometry
    (zero encoded normal) are left untouched. The light type is selected per
    row on the device, as in the JAX package, so no row is read back."""
    has_geom = normal_enc.sum(-1) > 0.0  # cleared G-buffer = 0
    n = normal_enc * 2.0 - 1.0
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-6)
    diffuse = torch.zeros_like(color[..., :3])
    ambient = torch.zeros((), dtype=color.dtype, device=color.device)
    for i in range(lights.shape[0]):
        row = lights[i]
        ltype = row[0]
        lcol = row[1:4] * row[4]
        lpos, ldir = row[5:8], row[8:11]
        att_c, att_l, att_q = row[11], row[12], row[13]
        cos_angle = row[14]
        ambient = torch.maximum(ambient, row[15])
        to_light = lpos - pos
        dist = torch.clamp(torch.linalg.vector_norm(to_light, dim=-1, keepdim=True), min=1e-6)
        l_point = to_light / dist
        l_dir = -ldir / torch.clamp(torch.linalg.vector_norm(ldir), min=1e-6)
        directional = ltype == LIGHT_DIRECTIONAL
        l_vec = torch.where(directional, l_dir, l_point)
        lambert = torch.clamp((n * l_vec).sum(-1, keepdim=True), min=0.0)
        atten = torch.where(
            directional, 1.0,
            1.0 / torch.clamp(att_c + att_l * dist + att_q * dist * dist, min=1e-6))
        # spot cone falloff: zero outside the half-angle
        in_cone = (-l_point * l_dir).sum(-1, keepdim=True) >= cos_angle
        spot = torch.where(ltype == LIGHT_SPOT, in_cone.to(color.dtype), 1.0)
        diffuse = diffuse + lcol * lambert * atten * spot
    lit = color[..., :3] * (ambient + diffuse)
    rgb = torch.where(has_geom[..., None], lit, color[..., :3])
    return torch.cat([rgb, color[..., 3:]], dim=-1)


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
