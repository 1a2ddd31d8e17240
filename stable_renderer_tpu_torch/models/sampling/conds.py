"""General conditioning: per-cond area, mask, strength and sigma range.

Counterpart of stable_renderer_tpu/models/sampling/conds.py (reference
comfy/samplers.py:50-327: get_area_and_mult's area crop, mask mult,
strength, 8-pixel feather and timestep_start/end gating, and
calc_cond_uncond_batch's out_cond / out_count accumulation with a 1e-37
floor, divided at the end).

The full-frame conds and the uncond run as one UNet batch; each area cond
runs as its own call on the cropped latent. A cond outside its sigma range
still runs and adds zero weight, as in the JAX package. Blending happens in
model-output space and converts to x0 once. The corresponder's ``pre`` and
``post`` hooks apply per full-frame cond group (scene_cond.py's layout);
area conds bypass them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from stable_renderer_tpu_torch.models.sampling.cfg import (
    calculate_denoised, timestep_from_sigma, unet_extras)
from stable_renderer_tpu_torch.models.sampling.scene_cond import _tile_to, group_hooks
from stable_renderer_tpu_torch.models.unet import AttnHooks, UNetModel


@dataclass(frozen=True)
class CondSpec:
    """Metadata of one conditioning entry. area: (h, w, y, x) in latent
    units, or None for the full frame; the cond is active while
    sigma_end <= sigma <= sigma_start (comfy timestep_start/end,
    samplers.py:60-67)."""

    area: Optional[Tuple[int, int, int, int]] = None
    strength: float = 1.0
    mask_strength: float = 1.0
    sigma_start: float = float("inf")
    sigma_end: float = 0.0
    has_mask: bool = False


def _feather_mult(area: Tuple[int, int, int, int], h_in: int, w_in: int) -> np.ndarray:
    """8-pixel edge feathering of a maskless area cond on every side that
    does not touch the frame's border (samplers.py:89-102)."""
    ah, aw, ay, ax = area
    rr = 8
    mult = np.ones((ah, aw), np.float32)
    ramp = [(t, (t + 1) / rr) for t in range(rr)]
    if ay != 0:
        for t, f in ramp[:ah]:
            mult[t, :] *= f
    if ay + ah < h_in:
        for t, f in ramp[:ah]:
            mult[ah - 1 - t, :] *= f
    if ax != 0:
        for t, f in ramp[:aw]:
            mult[:, t] *= f
    if ax + aw < w_in:
        for t, f in ramp[:aw]:
            mult[:, aw - 1 - t] *= f
    return mult


def _pad_context(ctx: torch.Tensor, target_len: int) -> torch.Tensor:
    """A (B, L, D) context tiled to ``target_len`` tokens (CONDCrossAttn
    pads mismatched conds by repetition, comfy/conds.py)."""
    return ctx if ctx.shape[1] == target_len else _tile_to(ctx, target_len)


def make_cond_denoiser(
    unet: UNetModel,
    params: dict,
    contexts: List[torch.Tensor],           # per cond: (B, L_i, D)
    specs: List[CondSpec],
    masks: List[Optional[torch.Tensor]],    # per cond: (B, h, w) at latent size, or None
    uncond_context: Optional[torch.Tensor],
    log_sigmas: torch.Tensor,
    cfg_scale: float = 7.0,
    prediction: str = "eps",
    hooks: AttnHooks = AttnHooks(),
    control_fn: Optional[Callable] = None,
    y_cond: Optional[torch.Tensor] = None,
    y_uncond: Optional[torch.Tensor] = None,
    concat_latent: Optional[torch.Tensor] = None,  # (B, h, w, E); area crops slice it
) -> Callable:
    """(x, sigma) -> denoised with comfy's cond-list semantics."""
    if not (len(contexts) == len(specs) == len(masks)) or not contexts:
        raise ValueError("contexts, specs and masks must be aligned and non-empty")
    use_cfg = uncond_context is not None
    log_sigmas = torch.as_tensor(log_sigmas, dtype=torch.float32).cpu()
    compute_dtype = params["time_embed"]["0"]["weight"].dtype
    max_len = max([c.shape[1] for c in contexts]
                  + ([uncond_context.shape[1]] if use_cfg else []))
    contexts = [_pad_context(c, max_len) for c in contexts]
    if use_cfg:
        uncond_context = _pad_context(uncond_context, max_len)
    full_idx = [i for i, s in enumerate(specs) if s.area is None]
    crop_idx = [i for i, s in enumerate(specs) if s.area is not None]
    nf = len(full_idx)
    n_full = nf + (1 if use_cfg else 0)
    ctx_b = torch.cat([contexts[i] for i in full_idx] + ([uncond_context] if use_cfg else []),
                      0).to(compute_dtype)
    y_b, extra = unet_extras(y_cond, y_uncond, concat_latent, nf, use_cfg, compute_dtype)

    def denoise(x: torch.Tensor, sigma) -> torch.Tensor:
        b, h, w, _ = x.shape
        sigma = torch.as_tensor(sigma, dtype=torch.float32).cpu()
        s_host = float(sigma)
        t = timestep_from_sigma(log_sigmas, sigma)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        x_in = (x * c_in).to(compute_dtype)

        def mult_for(i: int, ah: int, aw: int) -> torch.Tensor:
            spec = specs[i]
            ay, ax = (spec.area or (h, w, 0, 0))[2:]
            if masks[i] is not None:
                m = masks[i][:, ay:ay + ah, ax:ax + aw] * spec.mask_strength
            else:
                m = torch.from_numpy(_feather_mult((ah, aw, ay, ax), h, w)).to(x.device)
                m = m[None].expand(b, ah, aw)
            active = float(spec.sigma_end <= s_host <= spec.sigma_start)
            return (m * (spec.strength * active))[..., None]

        out_cond = torch.zeros(x.shape, device=x.device)
        out_count = torch.full(x.shape, 1e-37, device=x.device)

        # the full-frame conds and the uncond: one batched call
        x_b = torch.cat([x_in] * n_full, 0)
        tb = t.to(x.device).expand(x_b.shape[0])
        control = control_fn(x_b, tb, ctx_b) if control_fn is not None else None
        xc_b = x_b if extra is None else torch.cat([x_b, extra], -1)
        out = unet.apply(params, xc_b, tb, ctx_b, control=control,
                         hooks=group_hooks(hooks, nf, b, use_cfg, attn_mid=False),
                         y=y_b).float()
        for gi, i in enumerate(full_idx):
            mult = mult_for(i, h, w)
            out_cond = out_cond + out[gi * b:(gi + 1) * b] * mult
            out_count = out_count + mult

        # the area conds: one call each on the cropped latent
        for i in crop_idx:
            ah, aw, ay, ax = specs[i].area
            x_crop = x_in[:, ay:ay + ah, ax:ax + aw]
            tb1 = t.to(x.device).expand(b)
            ctx_i = contexts[i].to(compute_dtype)
            control_i = control_fn(x_crop, tb1, ctx_i) if control_fn is not None else None
            if concat_latent is not None:
                x_crop = torch.cat([x_crop, concat_latent[:, ay:ay + ah, ax:ax + aw].to(
                    compute_dtype)], -1)
            o = unet.apply(params, x_crop, tb1, ctx_i, control=control_i, y=y_cond).float()
            mult = mult_for(i, ah, aw)
            out_cond[:, ay:ay + ah, ax:ax + aw] += o * mult
            out_count[:, ay:ay + ah, ax:ax + aw] += mult

        x32 = x.float()
        den_c = calculate_denoised(prediction, x32, out_cond / out_count, sigma, t)
        if not use_cfg:
            return den_c
        den_u = calculate_denoised(prediction, x32, out[nf * b:], sigma, t)
        return den_u + (den_c - den_u) * cfg_scale

    return denoise
