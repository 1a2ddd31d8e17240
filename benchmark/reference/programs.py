"""The reference's frame programs, over the frozen plain copy in ``plain/``.

``Reference`` holds a configuration's towers and weight trees and runs, in
plain PyTorch, what the port's ``DiffusionPipeline`` and ``frame_step`` run:
the conditioning, the int8 calibration, the sequential img2img render, the
stream program's frame and the bake's batched render, then the display's
post-process and uint8. Its code is the port's plain path as it stood when
the benchmark was written (``engine/pipeline.py`` and
``engine/frame_program.py``), cut to one device and to the options the
cells use. It works out again everything the program derives: the
conditioning, the int8 scales, the G-buffers, the noise and the draws.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import scene as scene_mod
from benchmark.reference.plain.data.framebuffers import GBuffer
from benchmark.reference.plain.device import keep_f32
from benchmark.reference.plain.models.clip import (
    CLIPConfig,
    CLIPTextModel,
    OpenCLIPConfig,
    OpenCLIPTextModel,
    Tokenizer,
    encode_token_weights_batch,
    encode_token_weights_batch_xl,
)
from benchmark.reference.plain.models.quant import calibrate_act_scales, quantize_tree
from benchmark.reference.plain.models.sampling.assemble import build_denoiser
from benchmark.reference.plain.models.sampling.cfg import make_denoiser, timestep_from_sigma
from benchmark.reference.plain.models.sampling.samplers import sample
from benchmark.reference.plain.models.sampling.schedules import ModelSampling, calculate_sigmas
from benchmark.reference.plain.models.sdxl import sdxl_adm_vector
from benchmark.reference.plain.models.unet import AttnHooks, UNetConfig, UNetModel
from benchmark.reference.plain.models.vae import VAE, VAEConfig
from benchmark.reference.plain.ops.correspondence import (
    DefaultCorresponder,
    OverlapCorresponder,
    vertex_average_injection,
)
from benchmark.reference.plain.ops.math import resize_nearest
from benchmark.reference.plain.ops.postprocess import (
    PostProcessParams,
    defer_render,
    post_process,
)
from benchmark.reference.plain.engine.render_exec import _draw_pass, _pack_arrays


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build_towers(config: dict) -> Dict[str, object]:
    """The towers of a configuration file: UNet, VAE, CLIP-L (and CLIP-G)."""
    ccfg = CLIPConfig(**_tuples(config["clip"]))
    return {
        "unet": UNetModel(UNetConfig(**_tuples(config["unet"]))),
        "vae": VAE(VAEConfig(**_tuples(config["vae"]))),
        "clip": CLIPTextModel(ccfg),
        "clip_g": None if not config.get("clip_g") else OpenCLIPTextModel(
            OpenCLIPConfig(**_tuples(config["clip_g"]))),
        "tokenizer": Tokenizer(ccfg),
    }


def make_corresponder(spec: dict):
    """The corresponder a workload names, with its fields."""
    kinds = {"overlap": OverlapCorresponder, "default": DefaultCorresponder}
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in spec.items() if k != "kind"}
    return kinds[spec["kind"]](**fields)


def display_to_uint8(display: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(display, 0.0, 1.0) * 255.0).to(torch.uint8)


class Reference:
    """A configuration's plain program. ``weights`` are the benchmark's trees
    (the program gets the same); ``render`` is the workload's render block."""

    def __init__(self, config: dict, weights: dict, render: dict, device):
        t = build_towers(config)
        self.unet, self.vae, self.clip = t["unet"], t["vae"], t["clip"]
        self.clip_g, self.tokenizer = t["clip_g"], t["tokenizer"]
        self.unet_params, self.vae_params = weights["unet"], weights["vae"]
        self.clip_params, self.clip_g_params = weights["clip"], weights.get("clip_g")
        self.render_cfg = render
        self.device = torch.device(device)
        keep_f32()  # f32 towers compute in f32: TF32 off
        self.ms = ModelSampling(prediction=render.get("prediction", "lcm"))
        self._cond: dict = {}

    # --- conditioning ----------------------------------------------------------

    def encode(self, prompts, negatives):
        """(ctx_p, ctx_n, pooled_p, pooled_n), as ``_encode_prompts_full``."""
        key = (tuple(prompts), tuple(negatives))
        if key in self._cond:
            return self._cond[key]
        n = len(prompts)
        ids, weights, custom = self.tokenizer.tokenize_weighted_batch(
            list(prompts) + list(negatives))
        ids = torch.as_tensor(ids, device=self.device)
        weights = torch.as_tensor(weights, device=self.device)
        custom = None if custom is None else torch.as_tensor(custom, device=self.device)
        skip = int(self.render_cfg.get("clip_skip", -1))
        with torch.no_grad():
            if self.clip_g is not None:
                ctx, pooled = encode_token_weights_batch_xl(
                    self.clip, self.clip_g, self.clip_params, self.clip_g_params, ids, weights,
                    custom_embeds=custom, clip_skip=-2 if skip == -1 else skip)
            else:
                ctx, pooled = encode_token_weights_batch(
                    self.clip, self.clip_params, ids, weights, custom_embeds=custom,
                    clip_skip=skip)
        out = (ctx[:n], ctx[n:], pooled[:n], pooled[n:])
        self._cond[key] = out
        return out

    def conditioning(self, text: str, n: int, size):
        """(ctx, nctx, y_cond, y_uncond) for ``n`` frames of one prompt."""
        neg = self.render_cfg.get("negative_prompt", "")
        ctx, nctx, pooled, npooled = self.encode([text] * n, [neg] * n)
        y_cond = y_uncond = None
        if self.unet.config.adm_in_channels is not None:
            y_cond = sdxl_adm_vector(pooled, original_size=tuple(size), target_size=tuple(size))
            y_uncond = sdxl_adm_vector(npooled, original_size=tuple(size),
                                       target_size=tuple(size))
        return ctx, nctx, y_cond, y_uncond

    def sigmas(self) -> torch.Tensor:
        r = self.render_cfg
        sig = calculate_sigmas(self.ms, r["scheduler"], int(r["steps"]), float(r["denoise"]))
        return torch.as_tensor(sig, dtype=torch.float32)

    # --- int8 calibration (DiffusionPipeline.quantize_convs) ------------------

    @torch.no_grad()
    def quantize_convs(self, render_size) -> None:
        dt = torch.bfloat16
        ucfg = self.unet.config
        rh, rw = int(render_size[0]), int(render_size[1])
        lh, lw = max(rh // 8, 8), max(rw // 8, 8)
        gen = torch.Generator(device=self.device).manual_seed(7)
        sig = np.asarray(self.sigmas())
        s = max(int(sig.shape[0]) - 1, 1)
        b = 2 * s
        x = torch.randn((b, lh, lw, ucfg.in_channels), generator=gen, device=self.device).to(dt)
        t = torch.as_tensor(np.tile(self.ms.timestep(sig[:s]), 2), dtype=torch.float32,
                            device=self.device)
        cp, cn, _, _ = self.encode([self.render_cfg.get("prompt", "")],
                                   [self.render_cfg.get("negative_prompt", "")])
        ctx = torch.cat([cp[:1].expand((s,) + cp.shape[1:]),
                         cn[:1].expand((s,) + cn.shape[1:])], 0).to(dt)
        y = None
        if ucfg.adm_in_channels is not None:
            y = torch.zeros((b, ucfg.adm_in_channels), dtype=dt, device=self.device)
        scales_u = calibrate_act_scales(lambda p, *a: self.unet.apply(p, *a),
                                        self.unet_params, x, t, ctx, y)
        z = torch.randn((1, lh, lw, 4), generator=gen, device=self.device).to(dt)
        px = torch.tanh(torch.randn((1, rh, rw, 3), generator=gen, device=self.device).to(dt))

        def _vae_both(p, z, px):
            return self.vae.decode(p, z), self.vae.encode_moments(p, px)

        scales_v = calibrate_act_scales(_vae_both, self.vae_params, z, px)
        self.unet_params = quantize_tree(self.unet_params, scales_u, min_pixels=32 * 32)
        self.vae_params = quantize_tree(self.vae_params, scales_v, min_pixels=32 * 32)

    # --- the VAE ------------------------------------------------------------

    def _vae_dtype(self):
        return self.vae_params["quant_conv"]["weight"].dtype

    def encode_latent(self, color: torch.Tensor) -> torch.Tensor:
        return self.vae.encode(self.vae_params, (color * 2.0 - 1.0).to(self._vae_dtype())).float()

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        decoded = self.vae.decode(self.vae_params, latent.to(self._vae_dtype())).float()
        return torch.clamp(decoded * 0.5 + 0.5, 0.0, 1.0)

    # --- the sequential render (DiffusionPipeline._render) ---------------------

    @torch.no_grad()
    def render(self, corresponder, color, noise_maps, id_maps, ctx, nctx, key,
               y_cond=None, y_uncond=None, normal_maps=None) -> torch.Tensor:
        r = self.render_cfg
        latent = self.encode_latent(color)
        lh, lw = latent.shape[1], latent.shape[2]
        noise = noise_maps[..., : latent.shape[-1]]
        if noise.shape[1:3] != (lh, lw):
            noise = resize_nearest(noise, lh, lw)
        cfg_scale = float(r["cfg_scale"])
        uncond = None if cfg_scale == 1.0 else nctx
        log_sigmas = torch.as_tensor(self.ms.log_sigmas)
        hooks = corresponder.attn_hooks(None, generator=key)
        step_cb = corresponder.make_step_callback(id_maps, log_sigmas, normal_maps)
        den = build_denoiser(
            self.unet, self.unet_params, cond_context=ctx, scene_contexts=None,
            scene_masks=None, uncond_context=uncond, log_sigmas=log_sigmas,
            cfg_scale=cfg_scale, prediction=self.ms.prediction, hooks=hooks, control_fn=None,
            inpaint_mask=None, inpaint_latent=None, concat_latent=None, y_cond=y_cond,
            y_uncond=y_uncond)
        out = sample(den, noise, self.sigmas(), latent_image=latent, sampler=r["sampler"],
                     generator=key, step_callback=step_cb)
        return self.decode(out)

    # --- the stream program's frame (DiffusionPipeline._render_stream) --------

    @torch.no_grad()
    def render_stream(self, color, noise_maps, id_maps, state, key, ctx, nctx, kv_state,
                      corresponder, stream_init: bool):
        """(image (1, H, W, 3), new state, captured K) of one stream frame on
        one device, without ControlNets."""
        r = self.render_cfg
        sigmas = self.sigmas()
        latent = self.encode_latent(color)
        lh, lw = latent.shape[1], latent.shape[2]
        noise = noise_maps[..., : latent.shape[-1]]
        if noise.shape[1:3] != (lh, lw):
            noise = resize_nearest(noise, lh, lw)
        s = sigmas.shape[0] - 1
        x_t = latent + noise * sigmas[0]
        avg_ratio = float(getattr(corresponder, "step_finished_inject_ratio", 0.0) or 0.0)
        carry_ids = avg_ratio > 0.0 and id_maps is not None
        if stream_init:
            xs = x_t.expand(s, *x_t.shape[1:])
            ids_s = id_maps.expand(s, *id_maps.shape[1:]) if carry_ids else None
        elif isinstance(state, dict):
            xs, ids_s = state["x"], state.get("ids")
        else:
            xs, ids_s = state, None
        kv_layers = tuple(r.get("stream_kv_layers") or ())
        captured: dict = {}
        hooks = AttnHooks()
        if kv_layers:
            def kv_pre(q, k, v, layer):
                if layer not in kv_layers:
                    return q, k, v
                captured[str(layer)] = k
                if kv_state is None:
                    return q, k, v
                pk = kv_state[str(layer)].to(k.dtype)
                return q, pk, pk

            hooks = AttnHooks(pre=kv_pre)
        cfg_scale = float(r["cfg_scale"])
        uncond = None if cfg_scale == 1.0 else nctx
        log_sigmas = torch.as_tensor(self.ms.log_sigmas, dtype=torch.float32)
        den = make_denoiser(
            self.unet, self.unet_params, ctx[:1].expand(s, *ctx.shape[1:]),
            None if uncond is None else uncond[:1].expand(s, *uncond.shape[1:]),
            log_sigmas, cfg_scale=cfg_scale, prediction=self.ms.prediction, hooks=hooks,
            control_fn=None)
        sig_vec, sig_next = sigmas[:s], sigmas[1:s + 1]
        denoised = den(xs, sig_vec)
        dev = denoised.device
        if carry_ids:
            injected = vertex_average_injection(
                denoised, ids_s, avg_ratio,
                num_segments=int(getattr(corresponder, "vertex_segments", 262144)),
                weighting=getattr(corresponder, "weighting", "average"),
                adain_mode=getattr(corresponder, "step_finished_adain", "content"))
            stop_t = float(getattr(corresponder, "step_finished_stop_inject_timestep", 500.0))
            gate = (timestep_from_sigma(log_sigmas, sig_vec) >= stop_t).to(dev)
            denoised = torch.where(gate[:, None, None, None], injected, denoised)
        sv = sig_vec.to(dev)[:, None, None, None]
        sn = sig_next.to(dev)[:, None, None, None]
        if r["sampler"] == "lcm":
            fresh = torch.randn(denoised.shape, generator=key, device=dev)
            stepped = denoised + sn * fresh
        else:
            stepped = xs + (xs - denoised) / torch.clamp(sv, min=1e-8) * (sn - sv)
        out_latent = stepped[-1:] if float(sigmas[s]) > 0 else denoised[-1:]
        new_state = torch.cat([x_t, stepped[:-1]], 0)
        if carry_ids:
            new_state = {"x": new_state, "hints": (),
                         "ids": torch.cat([id_maps, ids_s[:-1]], 0)}
        return self.decode(out_latent), new_state, (captured if kv_layers else None)

    # --- one engine frame (frame_step) --------------------------------------

    @torch.no_grad()
    def draw(self, scene: dict, frame: int, size, render_mode: int, bg_noise, noise=None,
             corrmap=None):
        """The frame's G-buffer and pack (rasterize, shade, compose, pack)."""
        h, w = size
        draws, sigs, proj = scene_mod.draw_inputs(scene, frame, h, w, self.device, render_mode,
                                                  noise=noise, corrmap=corrmap)
        gbuf = GBuffer.empty(h, w, device=self.device)
        zbuf = torch.ones((h, w), dtype=torch.float32, device=self.device)
        proj = torch.as_tensor(proj, dtype=torch.float32).to(self.device)
        for d, (uniforms, corr_size, _, _) in zip(draws, sigs):
            gbuf, zbuf = _draw_pass(
                gbuf, zbuf, d["buffers"],
                torch.as_tensor(d["mv"], dtype=torch.float32).to(self.device), proj, uniforms,
                h, w, diffuse=d["diffuse"], noise=d["noise"], corrmap_values=d["corrmap"],
                corrmap_size=corr_size)
        return gbuf, _pack_arrays(gbuf, bg_noise)

    @staticmethod
    def display(gbuf, images) -> torch.Tensor:
        """The presented uint8 frame of the latest image over the G-buffer."""
        rgb = images[-1]
        display = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
        display = defer_render(display, gbuf.id, is_baking=False)
        return display_to_uint8(post_process(display, PostProcessParams()))


def bg_noise(size, device) -> torch.Tensor:
    """RenderManager.GlobalBGNoise: (1, H, W, 4) from a generator seeded 7."""
    h, w = size
    gen = torch.Generator(device=device).manual_seed(7)
    return torch.randn((1, h, w, 4), generator=gen, device=device)


def frame_key(seed: int, frame: int, device) -> torch.Generator:
    """The sampler's generator of engine frame ``frame``: seeded with
    (config seed + frame) & 0xFFFFFFFF on the device."""
    return torch.Generator(device=device).manual_seed((int(seed) + int(frame)) & 0xFFFFFFFF)

