"""The one denoiser assembly used by the render program.

Counterpart of stable_renderer_tpu/models/sampling/assemble.py (reference
comfy/samplers.py:175-358, the one path every comfy sampler call takes):
dispatch to the scene, cond-list or plain CFG denoiser, with ControlNet
residuals, the corresponder's hooks, the inpaint keep-mask, a 9-channel
inpaint UNet's extra input channels and the UNet's ``y``. The JAX package's
model patches that only workflow nodes reach (PerpNeg, SAG, RescaleCFG,
denoise-mask and timestep functions, named extra inputs) come with the
workflow slice (ROADMAP 1.12).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from stable_renderer_tpu_torch.models.sampling.cfg import make_denoiser
from stable_renderer_tpu_torch.models.sampling.conds import CondSpec, make_cond_denoiser
from stable_renderer_tpu_torch.models.sampling.scene_cond import make_scene_denoiser
from stable_renderer_tpu_torch.models.unet import AttnHooks, UNetModel


def needs_cond_list(specs: Sequence[CondSpec], n_entries: int) -> bool:
    """True when the cond entries need the general cond-list denoiser
    (several entries, or an area, mask, sigma range or strength); one plain
    full-frame cond takes the fused CFG path."""
    return n_entries > 1 or any(
        s.area is not None or s.has_mask or s.sigma_start != float("inf")
        or s.sigma_end != 0.0 or s.strength != 1.0 for s in specs)


def build_denoiser(
    unet: UNetModel,
    params: dict,
    *,
    cond_context: Optional[torch.Tensor] = None,     # plain: (B, L, D)
    scene_contexts: Optional[torch.Tensor] = None,   # scene: (S+1, B, L, D)
    scene_masks: Optional[torch.Tensor] = None,      # scene: (S+1, B, h, w)
    cond_contexts: Optional[List[torch.Tensor]] = None,  # cond list, aligned with
    cond_specs: Optional[List[CondSpec]] = None,          # specs and masks
    cond_masks: Optional[List[Optional[torch.Tensor]]] = None,
    uncond_context: Optional[torch.Tensor] = None,
    log_sigmas: torch.Tensor,
    cfg_scale: float = 7.0,
    prediction: str = "eps",
    hooks: AttnHooks = AttnHooks(),
    control_fn: Optional[Callable] = None,
    inpaint_mask: Optional[torch.Tensor] = None,     # (B, h, w, 1), 1 = denoise
    inpaint_latent: Optional[torch.Tensor] = None,   # kept where the mask is 0
    concat_latent: Optional[torch.Tensor] = None,    # inpaint-model channels
    y_cond: Optional[torch.Tensor] = None,
    y_uncond: Optional[torch.Tensor] = None,
) -> Callable:
    """(x, sigma) -> denoised. Priority: scene conditioning > cond list >
    plain. The inpaint keep-mask wraps any of them (KSamplerX0Inpaint,
    comfy samplers.py:363-430)."""
    common = dict(cfg_scale=cfg_scale, prediction=prediction, hooks=hooks,
                  control_fn=control_fn, y_cond=y_cond, y_uncond=y_uncond,
                  concat_latent=concat_latent)
    if scene_contexts is not None:
        den = make_scene_denoiser(unet, params, scene_contexts, scene_masks, uncond_context,
                                  log_sigmas, **common)
    elif cond_contexts is not None and needs_cond_list(cond_specs or [], len(cond_contexts)):
        den = make_cond_denoiser(unet, params, list(cond_contexts), list(cond_specs),
                                 list(cond_masks), uncond_context, log_sigmas, **common)
    else:
        ctx0 = cond_context if cond_context is not None else cond_contexts[0]
        return make_denoiser(unet, params, ctx0, uncond_context, log_sigmas, mask=inpaint_mask,
                             masked_latent=inpaint_latent, **common)
    if inpaint_mask is None or inpaint_latent is None:
        return den

    def keep(x, sigma):
        return den(x, sigma) * inpaint_mask + inpaint_latent * (1.0 - inpaint_mask)

    return keep


def inpaint_concat_channels(
    latent: torch.Tensor,                 # (B, h, w, C) the frame's latent
    denoise_mask: Optional[torch.Tensor],  # (B, h, w, 1), 1 = denoise, or None
) -> torch.Tensor:
    """The 5 extra input channels of a 9-channel inpaint UNet: [mask,
    masked-image latent] (comfy model_base.py:93-126 extra_conds). Without a
    mask, comfy's blank-inpaint defaults: mask ones, image latent zeros."""
    if denoise_mask is None:
        return torch.cat([torch.ones_like(latent[..., :1]), torch.zeros_like(latent)], -1)
    mask = denoise_mask.to(latent.dtype)
    return torch.cat([mask, latent * (1.0 - mask)], -1)
