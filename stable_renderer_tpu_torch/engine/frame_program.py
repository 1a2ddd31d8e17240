"""The frame step: rasterize -> G-buffer -> pack -> denoise -> decode -> uint8.

Counterpart of stable_renderer_tpu/engine/frame_program.py. The JAX package
compiles the whole frame into one XLA program; the port runs the same stages
eagerly, in order, on the device of the frame's tensors:

  draws -> vertex_stage -> rasterize_auto (the K2 tile kernel on the card)
  -> shade_draw / compose_draw -> _pack_arrays -> DiffusionPipeline._render
  (VAE encode, CFG UNet denoise with attention through the K1 flash kernel
  where K/V length >= 2048, ControlNet residuals from the G-buffer hints,
  VAE decode) -> apply_lights (when the scene has lights) -> defer_render ->
  post_process -> uint8.

With a stream state (or ``stream_init``) the denoise runs as
``DiffusionPipeline._render_stream`` instead: one batched UNet evaluation
advances the S in-flight frames, and the frame's hints and id map ride the
stream state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from stable_renderer_tpu_torch.data.framebuffers import GBuffer
from stable_renderer_tpu_torch.device import resolve_device
from stable_renderer_tpu_torch.engine.render_exec import _draw_pass, _pack_arrays
from stable_renderer_tpu_torch.ops.postprocess import apply_lights, defer_render, post_process
from stable_renderer_tpu_torch.utils.timer import stage


@torch.no_grad()
def frame_step(
    pipeline,                 # DiffusionPipeline | None
    corresponder,             # Corresponder | None
    sprite_ids: tuple,        # scene-conditioning sprite ids
    draw_sigs: tuple,         # per-draw (DrawUniforms, corrmap_size, vertex_fn, fragment_fn)
    height: int,
    width: int,
    run_diffusion: bool,
    is_baking: bool,
    pp,                       # PostProcessParams
    cn_sources: tuple,        # ControlNet hint sources ('normal', ...)
    to_uint8: bool,
    draws: tuple,             # per-draw dicts (buffers/mv/diffuse/noise/corrmap)
    proj: torch.Tensor,
    bg_noise: torch.Tensor,   # (1, H, W, 4); its device is the frame's device
    pending: Optional[dict],  # stacked packs of earlier bake frames
    ctx, nctx, sigmas, key,   # conditioning; key = the sampler's torch.Generator
    unet_params, vae_params, cn_params,
    y_cond=None, y_uncond=None,
    apply_post: bool = True,
    lights=None,              # (L, 16) Light.pack_lights rows or None
    stream_state=None,
    stream_init: bool = False,
    stream_kv=None,
    stream_version: int = 0,  # pipeline.stream_version
    step_noise=None,          # optional explicit sampler re-noise draws
):
    """One frame. Returns (display, gbuf, pack, images, stream_state,
    stream_kv): display is (H, W, 4), uint8 when ``to_uint8``. In the stream
    branch ``step_noise`` is the (S, h, w, 4) LCM re-noise draw.
    ``stream_version`` keys the JAX package's compiled frame to the
    pipeline's stream mesh; the port's eager frame reads the mesh from the
    pipeline at each call, and a state built before a mesh change is
    resharded by ``_render_stream`` (its stage count tells)."""
    dev = bg_noise.device
    with stage("raster"):
        gbuf = GBuffer.empty(height, width, device=dev)
        zbuf = torch.ones((height, width), dtype=torch.float32, device=dev)
        proj = torch.as_tensor(proj, dtype=torch.float32).to(dev)
        for d, (uniforms, corr_size, vertex_fn, fragment_fn) in zip(draws, draw_sigs):
            gbuf, zbuf = _draw_pass(
                gbuf, zbuf, d["buffers"], torch.as_tensor(d["mv"], dtype=torch.float32).to(dev),
                proj, uniforms, height, width, diffuse=d["diffuse"], noise=d["noise"],
                corrmap_values=d["corrmap"], corrmap_size=corr_size, fragment_fn=fragment_fn,
                vertex_fn=vertex_fn,
            )
        pack = _pack_arrays(gbuf, bg_noise)

    display = gbuf.color
    images = new_stream_state = new_stream_kv = None
    if run_diffusion and (stream_state is not None or stream_init):
        # one batched UNet evaluation advances the in-flight frames; each
        # frame's hints and ids ride the stream state with it
        stream_hints = tuple(pack[s][None] for s in cn_sources) or None
        images, new_stream_state, new_stream_kv = pipeline._render_stream(
            unet_params, vae_params, pack["color"][None], pack["noise"][None], pack["id"][None],
            stream_state, sigmas, key, ctx, nctx, stream_init=stream_init, kv_state=stream_kv,
            cn_params=cn_params, hints=stream_hints, corresponder=corresponder,
            step_noise=step_noise,
        )
        rgb = images[-1]
        display = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    elif run_diffusion:
        if pending is not None:
            batch = {k: torch.cat([pending[k], pack[k][None]], 0) for k in pending}
        else:
            batch = {k: v[None] for k, v in pack.items()}
        hints = tuple(batch[s] for s in cn_sources)
        images = pipeline._render(
            corresponder, sprite_ids, unet_params, vae_params, cn_params,
            batch["color"], batch["noise"], batch["id"], hints, ctx, nctx, sigmas, key,
            y_cond, y_uncond, normal_maps=batch["normal"], step_noise=step_noise,
        )
        rgb = images[-1]  # display the latest frame (renderManager.py:1017-1021)
        display = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)

    with stage("post"):
        if lights is not None:
            lights = torch.as_tensor(lights, dtype=torch.float32).to(dev)
            display = apply_lights(display, gbuf.normal, gbuf.pos, lights)
        display = defer_render(display, gbuf.id, is_baking=is_baking and not run_diffusion)
        if apply_post:
            display = post_process(display, pp)
        if to_uint8:
            display = display_to_uint8(display)
    return display, gbuf, pack, images, new_stream_state, new_stream_kv


def display_to_uint8(display: torch.Tensor) -> torch.Tensor:
    """[0, 1] float display -> uint8 (round half to even, as jnp.round)."""
    return torch.round(torch.clamp(display, 0.0, 1.0) * 255.0).to(torch.uint8)


def draw_call_inputs(draw_calls, view, device=None) -> Tuple[tuple, tuple]:
    """Split a sorted draw-call list into (draws, sigs) for frame_step. Each
    draw call carries ``mesh``, ``model_matrix``, ``uniforms`` and optional
    ``diffuse`` / ``noise`` textures, ``corrmap`` and ``shader``. The
    model-view product is host math on the (4, 4) ``view``; mesh buffers go
    to ``device`` (default: the card)."""
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers

    device = resolve_device(device)
    view = np.asarray(view, np.float32)
    draws, sigs = [], []
    for dc in draw_calls:
        corrmap = getattr(dc, "corrmap", None)
        corr_vals, corr_size = None, (512, 512)
        if corrmap is not None:
            corr_vals = corrmap.values
            corr_size = (corrmap.height, corrmap.width)
        diffuse, noise = getattr(dc, "diffuse", None), getattr(dc, "noise", None)
        draws.append(dict(
            buffers=mesh_device_buffers(dc.mesh, device),
            mv=view @ np.asarray(dc.model_matrix, np.float32),
            diffuse=None if diffuse is None else diffuse.array,
            noise=None if noise is None else noise.array,
            corrmap=corr_vals,
        ))
        shader = getattr(dc, "shader", None)
        sigs.append((dc.uniforms, corr_size,
                     None if shader is None else shader.vertex_fn,
                     None if shader is None else shader.bound_fragment()))
    return tuple(draws), tuple(sigs)
