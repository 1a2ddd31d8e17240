"""Per-sprite masked text conditioning (SceneTextEncode / MaskedTextEncode).

Counterpart of stable_renderer_tpu/models/sampling/scene_cond.py (reference
comfyUI/stable_rendering/_nodes/conditions.py:52-110 SceneTextEncode and
comfy's mask blend in calc_cond_uncond_batch, comfy/samplers.py:175-327).
Each sprite's prompt conditions only the latent pixels whose id-map spriteID
matches, and the environment prompt the rest. The denoiser runs the S + 1
conditionings and the uncond as one UNet batch and blends the model outputs
by normalized masks.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from stable_renderer_tpu_torch.models.sampling.cfg import (
    _params_dtype, calculate_denoised, timestep_from_sigma, unet_extras)
from stable_renderer_tpu_torch.models.unet import PATCH_HOOKS, AttnHooks, UNetModel
from stable_renderer_tpu_torch.utils.timer import staged


def sprite_masks(
    id_maps: torch.Tensor,  # (B, H, W, 4) int32
    sprite_ids: Sequence[int],
    latent_h: int,
    latent_w: int,
) -> torch.Tensor:
    """(S+1, B, h, w) f32 masks at latent resolution, one per sprite and the
    background last: a sprite's mask holds the pixels of its spriteID, the
    background every pixel of no listed sprite."""
    _, ih, iw, _ = id_maps.shape
    rows = torch.arange(latent_h, device=id_maps.device) * ih // latent_h
    cols = torch.arange(latent_w, device=id_maps.device) * iw // latent_w
    sid_map = id_maps[:, rows][:, :, cols][..., 0]
    masks = [(sid_map == sid).float() for sid in sprite_ids]
    any_sprite = torch.zeros(sid_map.shape, device=id_maps.device)
    for m in masks:
        any_sprite = torch.maximum(any_sprite, m)
    return torch.stack(masks + [1.0 - any_sprite])


def _tile_to(t: torch.Tensor, length: int) -> torch.Tensor:
    """(B, L, C) repeated along L and cut to ``length`` tokens."""
    reps = -(-length // t.shape[1])
    return t.repeat(1, reps, 1)[:, :length]


def group_hooks(user: AttnHooks, groups: int, batch: int, use_cfg: bool,
                attn_mid: bool = True) -> AttnHooks:
    """``user``'s hooks applied per conditioning group on the batch
    [cond_0 x B, ..., cond_{groups-1} x B, uncond x B], never across groups
    and never to the uncond rows: those keep their own K/V contexts (tiled
    to the length the hook gave the groups), plain attention and their mid
    activations. ``attn_mid=False`` wraps ``pre`` and ``post`` only, as the
    cond-list denoiser does. The model-patch points pass through unchanged:
    they act on the whole batch."""
    passthru = {f: getattr(user, f) for f in PATCH_HOOKS}
    if user.pre is None and user.post is None and (
            not attn_mid or (user.attn is None and user.mid is None)):
        return AttnHooks(**passthru)
    nc = groups * batch

    def split(t: torch.Tensor):
        return [t[g * batch:(g + 1) * batch] for g in range(groups)]

    def pre(q, k, v, layer):
        if user.pre is None:
            return q, k, v
        outs = [user.pre(qg, kg, vg, layer) for qg, kg, vg in zip(split(q), split(k), split(v))]
        qo = torch.cat([o[0] for o in outs], 0)
        ko = torch.cat([o[1] for o in outs], 0)
        vo = torch.cat([o[2] for o in outs], 0)
        if not use_cfg:
            return qo, ko, vo
        kn, vn = k[nc:], v[nc:]
        if ko.shape[1] != kn.shape[1]:
            kn, vn = _tile_to(kn, ko.shape[1]), _tile_to(vn, vo.shape[1])
        return torch.cat([qo, q[nc:]], 0), torch.cat([ko, kn], 0), torch.cat([vo, vn], 0)

    def post(vals, layer):
        if user.post is None:
            return vals
        return torch.cat([user.post(g, layer) for g in split(vals)] + [vals[nc:]], 0)

    attn = mid = None
    if attn_mid and user.attn is not None:
        from stable_renderer_tpu_torch.models.layers import attention as _default_attn

        def attn(q, k, v, heads, layer):
            outs = [user.attn(qg, kg, vg, heads, layer)
                    for qg, kg, vg in zip(split(q), split(k), split(v))]
            if use_cfg:
                outs.append(_default_attn(q[nc:], k[nc:], v[nc:], heads))
            return torch.cat(outs, 0)

    if attn_mid and user.mid is not None:
        def mid(x, layer):
            return torch.cat([user.mid(g, layer) for g in split(x)] + [x[nc:]], 0)

    # no post wrapper without a user post hook: under tensor parallelism a
    # post hook costs an all-gather of every head
    return AttnHooks(pre=pre, post=None if user.post is None else post, attn=attn, mid=mid,
                     **passthru)


def make_scene_denoiser(
    unet: UNetModel,
    params: dict,
    contexts: torch.Tensor,        # (S+1, B, L, D) per-sprite + environment contexts
    masks: torch.Tensor,           # (S+1, B, h, w)
    uncond_context: Optional[torch.Tensor],  # (B, L, D); None = no CFG
    log_sigmas: torch.Tensor,
    cfg_scale: float = 7.0,
    prediction: str = "eps",
    hooks: AttnHooks = AttnHooks(),
    control_fn: Optional[Callable] = None,
    y_cond: Optional[torch.Tensor] = None,
    y_uncond: Optional[torch.Tensor] = None,
    concat_latent: Optional[torch.Tensor] = None,  # (B, h, w, E), the same for every group
) -> Callable:
    """(x, sigma) -> denoised with the mask-blended multi-conditioning. The
    UNet batch is [cond_0 x B, ..., cond_S x B, uncond x B], the analogue of
    calc_cond_uncond_batch's cond batching."""
    s1, b = contexts.shape[0], contexts.shape[1]
    use_cfg = uncond_context is not None
    groups = s1 + (1 if use_cfg else 0)
    log_sigmas = torch.as_tensor(log_sigmas, dtype=torch.float32).cpu()
    compute_dtype = _params_dtype(params)
    # normalized so every latent pixel's blend weights sum to 1
    weights = masks / torch.clamp(masks.sum(0, keepdim=True), min=1e-6)
    run_hooks = group_hooks(hooks, s1, b, use_cfg)
    ctx_flat = contexts.reshape(s1 * b, *contexts.shape[2:])
    if use_cfg:
        ctx_flat = torch.cat([ctx_flat, uncond_context], 0)
    ctx_flat = ctx_flat.to(compute_dtype)
    y, extra = unet_extras(y_cond, y_uncond, concat_latent, s1, int(use_cfg),
                           compute_dtype)

    @staged("unet")
    def denoise(x: torch.Tensor, sigma) -> torch.Tensor:
        sigma = torch.as_tensor(sigma, dtype=torch.float32).cpu()
        t = timestep_from_sigma(log_sigmas, sigma)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        x_tiled = torch.cat([(x * c_in).to(compute_dtype)] * groups, 0)
        tb = t.to(x.device).expand(x_tiled.shape[0])
        control = control_fn(x_tiled, tb, ctx_flat) if control_fn is not None else None
        x_u = x_tiled if extra is None else torch.cat([x_tiled, extra], -1)
        out = unet.apply(params, x_u, tb, ctx_flat, control=control, hooks=run_hooks,
                         y=y).float()
        cond_out = out[: s1 * b].reshape(s1, b, *out.shape[1:])
        blended = (cond_out * weights[..., None]).sum(0)
        x32 = x.float()
        den_c = calculate_denoised(prediction, x32, blended, sigma, t)
        if not use_cfg:
            return den_c
        den_u = calculate_denoised(prediction, x32, out[s1 * b:], sigma, t)
        return den_u + (den_c - den_u) * cfg_scale

    return denoise
