"""Draw execution + frame packing around the raster pass.

Counterpart of stable_renderer_tpu/engine/render_exec.py (the compute half of
the reference's RenderManager.on_frame_run, renderManager.py:950-1047 and
_save_frame_data :877-948): one draw = vertex stage + rasterize + shade +
compose; mesh buffers are cached on the device per Mesh object; frame packing
is the 8x8 noise mean-pool + AdaIN renorm + background noise fill + masks.
"""

from __future__ import annotations

from typing import Optional

import torch

from stable_renderer_tpu_torch.data.framebuffers import GBuffer
from stable_renderer_tpu_torch.device import resolve_device
from stable_renderer_tpu_torch.engine.mesh import Mesh
from stable_renderer_tpu_torch.ops.gbuffer import compose_draw, shade_draw
from stable_renderer_tpu_torch.ops.math import adain, downsample_mean
from stable_renderer_tpu_torch.ops.raster import rasterize_auto, vertex_stage

_mesh_cache: dict = {}


def mesh_device_buffers(mesh: Mesh, device=None) -> dict:
    """(positions/normals/uvs/colors/vertex_ids/tris) as tensors on ``device``
    (default: the card), uploaded once per (mesh, device). The cache holds the
    mesh itself, so its id cannot be reused by another mesh while the entry
    lives."""
    device = resolve_device(device)
    key = (id(mesh), str(device))
    hit = _mesh_cache.get(key)
    if hit is None:
        bufs = {name: torch.as_tensor(getattr(mesh, name)).to(device)
                for name in ("positions", "normals", "uvs", "colors", "vertex_ids", "tris")}
        hit = _mesh_cache[key] = (mesh, bufs)
    return hit[1]


def _draw_pass(
    prev: GBuffer,
    prev_zbuf: torch.Tensor,
    buffers: dict,
    mv: torch.Tensor,
    proj: torch.Tensor,
    uniforms,
    height: int,
    width: int,
    diffuse: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    corrmap_values: Optional[torch.Tensor] = None,
    corrmap_size=(512, 512),
    fragment_fn=None,
    vertex_fn=None,
):
    """One draw: vertex stage -> rasterize (K2 on the card) -> shade ->
    compose. ``vertex_fn`` and ``fragment_fn`` are a user shader's stages
    (engine/shader.py); None keeps the fixed stage."""
    stage = vertex_stage if vertex_fn is None else vertex_fn
    clip, view_pos, view_normal = stage(buffers["positions"], buffers["normals"], mv, proj)
    vis = rasterize_auto(clip, buffers["tris"], height, width, cull_backface=True)
    gbuf = shade_draw(
        vis, buffers["tris"], view_pos, view_normal, buffers["uvs"], buffers["colors"],
        buffers["vertex_ids"], uniforms, diffuse_tex=diffuse, noise_tex=noise,
        corrmap_values=corrmap_values, corrmap_size=corrmap_size, fragment_fn=fragment_fn,
    )
    return compose_draw(prev, prev_zbuf, gbuf, vis, uniforms.render_mode)


def _pack_arrays(gbuf: GBuffer, bg_noise: torch.Tensor) -> dict:
    """_save_frame_data's tensor math (renderManager.py:877-948)."""
    color = gbuf.color
    mask = 1.0 - color[..., 3]  # background mask = 1 - alpha
    m = mask[None, ..., None]
    noise_filled = gbuf.noise[None] * (1.0 - m) + bg_noise * m
    renormed = adain(downsample_mean(noise_filled, 8), noise_filled)
    depth = gbuf.normal_depth[..., 3:4]
    return dict(
        color=color[..., :3],
        mask=mask,
        id=gbuf.id,
        pos=gbuf.pos,
        normal=gbuf.normal_depth[..., :3],
        depth=torch.cat([depth] * 3, dim=-1),
        noise=renormed[0],
        canny=gbuf.canny,
    )


def pack_frame_data(gbuf: GBuffer, bg_noise: torch.Tensor, frame_index: int) -> dict:
    pack = _pack_arrays(gbuf, bg_noise)
    pack["frame_index"] = frame_index
    return pack
