"""Deferred G-buffer shading — the default_Gbuffer.frag.glsl equivalent.

Counterpart of stable_renderer_tpu/ops/gbuffer.py: consumes a
VisibilityBuffer plus per-vertex attributes and per-draw uniforms, and
produces / composes the 6-attachment GBuffer:

  * ID packing (spriteID, materialID, map_index, vertexID)        frag:125-147
  * view-angle -> map_index binning for AI objects (k*k bins)     frag:150-162
  * texcoord-as-vertexID option                                   frag:128-147
  * normal-angle canny edges (80 degree threshold)                frag:186-190
  * BAKED-mode color lookup from the CorrespondMap array          frag:176-205
  * manual blending against the previous draw's G-buffer          frag:194-233
  * inverted depth (closer = white)                               frag:110

Render modes: 0 = NORMAL, 1 = BAKED (sample corrmap), 2 = BAKING (shades
like NORMAL but packs view-binned AI ids, the net semantics of the
reference's two-pass bake). A user fragment shader (engine/shader.py)
replaces the color stage on the pixels a draw covers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from stable_renderer_tpu_torch.data.framebuffers import NON_AI_MAP_INDEX, GBuffer
from stable_renderer_tpu_torch.ops.raster import VisibilityBuffer, flat_vertex, interpolate
from stable_renderer_tpu_torch.ops.texture import sample_bilinear, sample_nearest

RENDER_MODE_NORMAL = 0
RENDER_MODE_BAKED = 1
RENDER_MODE_BAKING = 2


@dataclass(frozen=True)
class DrawUniforms:
    """Per-draw shader uniforms (reference frag uniforms, frag:83-97)."""

    sprite_id: int = 0
    material_id: int = 0
    render_mode: int = RENDER_MODE_NORMAL
    corrmap_k: int = 3
    use_texcoord_as_id: bool = False
    has_vertex_color: bool = True
    default_id_size: Tuple[int, int] = (512, 512)  # (H, W) for texcoord-as-id


def _where(mask: torch.Tensor, a: torch.Tensor, b) -> torch.Tensor:
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.where(mask, a, b)


def view_angle_map_index(view_normal: torch.Tensor, k: int) -> torch.Tensor:
    """View-direction binning: which of the k*k corrmap layers a pixel belongs
    to. The reference's math (frag:150-162) kept verbatim: the 'angles' are
    cosines fed through ``PI/2 - cos``."""
    n = view_normal
    eps = 1e-8
    yz_len = torch.linalg.norm(torch.cat([torch.zeros_like(n[..., :1]), n[..., 1:3]], -1),
                               dim=-1, keepdim=True)
    yz = n[..., 1:3] / torch.clamp(yz_len, min=eps)
    theta = math.pi / 2 - yz[..., 0]
    xz = torch.stack([n[..., 0], n[..., 2]], dim=-1)
    xz = xz / torch.clamp(torch.linalg.norm(xz, dim=-1, keepdim=True), min=eps)
    phi = math.pi / 2 - xz[..., 0]
    angle_step = math.pi / k
    x_index = torch.clamp((theta / angle_step).to(torch.int32), 0, k - 1)
    y_index = torch.clamp((phi / angle_step).to(torch.int32), 0, k - 1)
    return x_index + (k - 1 - y_index) * k


def texcoord_vertex_id(uv: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """vertexID = int(v * H * W + u * W) (reference frag:128-147)."""
    return (uv[..., 1] * height * width + uv[..., 0] * width).to(torch.int32)


def canny_from_normal(view_normal: torch.Tensor) -> torch.Tensor:
    """Normal-angle edges: white where the surface grazes the view direction
    (cos between view normal and +Z in (0, cos 80deg)), reference frag:186-190."""
    cos_v = view_normal[..., 2]
    edge = (cos_v < math.cos(math.pi * 4 / 9)) & (cos_v > 0.0)
    return edge[..., None].float().expand(*edge.shape, 3)


def shade_draw(
    vis: VisibilityBuffer,
    tris: torch.Tensor,
    view_pos: torch.Tensor,      # (V, 3)
    view_normal: torch.Tensor,   # (V, 3)
    uv: torch.Tensor,            # (V, 2)
    vertex_color: torch.Tensor,  # (V, 3)
    vertex_ids: torch.Tensor,    # (V,) int32
    uniforms: DrawUniforms,
    diffuse_tex: Optional[torch.Tensor] = None,    # (Ht, Wt, 4)
    noise_tex: Optional[torch.Tensor] = None,      # (Hn, Wn, 4)
    corrmap_values: Optional[torch.Tensor] = None,  # (k*k, Hc*Wc, C)
    corrmap_size: Tuple[int, int] = (512, 512),
    fragment_fn=None,  # a user shader's fragment stage (engine/shader.py)
) -> GBuffer:
    """Shade one draw into a standalone GBuffer (no composition yet).
    ``fragment_fn(FragmentInputs) -> (H, W, 4 or 3)`` replaces the fixed
    color on the covered pixels."""
    covered = vis.tri_id >= 0
    cov3 = covered[..., None]
    h, w = vis.z.shape
    dev = vis.z.device
    u = uniforms

    pos = interpolate(vis, tris, view_pos)
    n = interpolate(vis, tris, view_normal)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-8)
    uv_px = interpolate(vis, tris, uv)
    vcol = interpolate(vis, tris, vertex_color)

    inv_depth = _where(covered, 1.0 - vis.z, 0.0)
    normal_depth = _where(cov3, torch.cat([n * 0.5 + 0.5, inv_depth[..., None]], dim=-1), 0.0)

    if noise_tex is not None:
        noise = sample_nearest(noise_tex, uv_px)
    else:
        noise = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    noise = _where(cov3, noise, 0.0)

    if u.use_texcoord_as_id:
        if diffuse_tex is not None:
            id_h, id_w = diffuse_tex.shape[0], diffuse_tex.shape[1]
        elif corrmap_values is not None:
            id_h, id_w = corrmap_size
        else:
            id_h, id_w = u.default_id_size
        pix_vid = texcoord_vertex_id(uv_px, id_h, id_w)
    else:
        pix_vid = flat_vertex(vis, tris, vertex_ids, mode="nearest")

    if u.render_mode == RENDER_MODE_NORMAL:
        map_index = torch.full((h, w), NON_AI_MAP_INDEX, dtype=torch.int32, device=dev)
    else:
        map_index = view_angle_map_index(n, u.corrmap_k)

    def const(v):
        return torch.full((h, w), v, dtype=torch.int32, device=dev)

    ids = torch.stack([const(u.sprite_id), const(u.material_id), map_index,
                       pix_vid.to(torch.int32)], dim=-1)
    ids = _where(cov3, ids, 0)

    if u.render_mode == RENDER_MODE_BAKED and corrmap_values is not None:
        ch, cw = corrmap_size
        c = corrmap_values.shape[-1]
        if u.use_texcoord_as_id:
            # the reference samples texture(corrmap, vec3(uv.y, uv.x, map)) —
            # swapped axes (frag:181-187), kept for baked-map interchange
            cu = torch.clamp(uv_px[..., 1], 0.0, 1.0)
            cv = torch.clamp(uv_px[..., 0], 0.0, 1.0)
            cx = torch.clamp((cu * cw).long(), max=cw - 1)
            cy = torch.clamp(((1.0 - cv) * ch).long(), max=ch - 1)
            cell = cy * cw + cx
        else:
            cell = torch.clamp(pix_vid.long(), 0, ch * cw - 1)
        layer = torch.clamp(map_index.long(), 0, corrmap_values.shape[0] - 1)
        color = corrmap_values[layer, cell]
        if c == 3:
            color = torch.cat([color, torch.ones_like(color[..., :1])], dim=-1)
    elif diffuse_tex is not None:
        color = sample_bilinear(diffuse_tex, uv_px)
        if color.shape[-1] == 3:
            color = torch.cat([color, torch.ones_like(color[..., :1])], dim=-1)
    elif u.has_vertex_color:
        color = torch.cat([vcol, torch.ones_like(vcol[..., :1])], dim=-1)
    elif u.render_mode == RENDER_MODE_BAKED:
        # pink = baked object without corrmap or texture (frag:196-199)
        color = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev).expand(h, w, 4)
    else:
        color = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    color = _where(cov3, color, 0.0)

    if fragment_fn is not None:
        from stable_renderer_tpu_torch.engine.shader import FragmentInputs

        user = fragment_fn(FragmentInputs(view_pos=pos, normal=n, uv=uv_px, vertex_color=vcol,
                                          color=color, covered=covered))
        if user.shape[-1] == 3:
            user = torch.cat([user, torch.ones_like(user[..., :1])], dim=-1)
        color = _where(cov3, user, 0.0)

    canny = _where(cov3, canny_from_normal(n), 0.0)
    pos = _where(cov3, pos, 0.0)
    return GBuffer(color=color, id=ids, pos=pos, normal_depth=normal_depth, noise=noise,
                   canny=canny)


def compose_draw(
    prev: GBuffer,
    prev_zbuf: torch.Tensor,  # (H, W) window z (less = closer), 1.0 = empty
    new: GBuffer,
    vis: VisibilityBuffer,
    render_mode: int,
) -> Tuple[GBuffer, torch.Tensor]:
    """Depth-test + manual blend of one draw over the accumulated G-buffer
    (reference blend block, frag:194-233, with the GL depth test explicit)."""
    covered = vis.tri_id >= 0
    visible = covered & (vis.z < prev_zbuf)
    vis3 = visible[..., None]
    zbuf = torch.where(visible, vis.z, prev_zbuf)

    alpha = new.color[..., 3]
    if render_mode == RENDER_MODE_BAKED:
        # a BAKED fragment whose corrmap cell is unwritten (alpha == 0) keeps
        # all previous data, including IDs (frag:197-205)
        case_a = visible & (alpha == 0.0)
    else:
        case_a = torch.zeros_like(visible)
    keep_prev = case_a[..., None]
    color = torch.where(keep_prev, prev.color, new.color)
    pos = torch.where(keep_prev, prev.pos, new.pos)
    normal_depth = torch.where(keep_prev, prev.normal_depth, new.normal_depth)
    canny = torch.where(keep_prev, prev.canny, new.canny)
    ids = torch.where(keep_prev, prev.id, new.id)
    noise = new.noise

    # alpha blending for partially transparent fragments (frag:207-224)
    case_b = visible & ~case_a & (alpha < 1.0)
    prev_inv_depth = prev.normal_depth[..., 3]
    new_on_top = (prev_inv_depth < new.normal_depth[..., 3])[..., None]
    a = alpha[..., None]
    pa = prev.color[..., 3:4]
    blend_top = torch.cat([new.color[..., :3] * a + prev.color[..., :3] * (1 - a), a], dim=-1)
    blend_under = torch.cat([prev.color[..., :3] * pa + new.color[..., :3] * (1 - pa), pa], dim=-1)
    b_color = torch.where(new_on_top, blend_top, blend_under)
    prev_has_noise = prev.noise.sum(-1, keepdim=True) > 1e-3
    noise_top = torch.where(prev_has_noise, new.noise * a + prev.noise * (1 - a), new.noise)
    noise_under = torch.where(prev_has_noise, prev.noise * pa + new.noise * (1 - pa), new.noise)
    b_noise = torch.where(new_on_top, noise_top, noise_under)
    nd_under = new.normal_depth.clone()
    nd_under[..., 3] = prev_inv_depth
    b_nd = torch.where(new_on_top, new.normal_depth, nd_under)

    cb = case_b[..., None]
    color = torch.where(cb, b_color, color)
    noise = torch.where(cb, b_noise, noise)
    normal_depth = torch.where(cb, b_nd, normal_depth)

    out = GBuffer(
        color=torch.where(vis3, color, prev.color),
        id=torch.where(vis3, ids, prev.id),
        pos=torch.where(vis3, pos, prev.pos),
        normal_depth=torch.where(vis3, normal_depth, prev.normal_depth),
        noise=torch.where(vis3, noise, prev.noise),
        canny=torch.where(vis3, canny, prev.canny),
    )
    return out, zbuf
