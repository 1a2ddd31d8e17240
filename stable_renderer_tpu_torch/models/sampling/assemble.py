"""The one denoiser assembly used by the render program.

Counterpart of stable_renderer_tpu/models/sampling/assemble.py: dispatch to
the scene / cond-list / plain CFG denoiser. The port has the plain CFG path
(one full-frame positive context, optional inpaint keep-mask); the others
raise until their slices are ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from stable_renderer_tpu_torch.models.sampling.cfg import make_denoiser
from stable_renderer_tpu_torch.models.unet import AttnHooks, UNetModel


def build_denoiser(
    unet: UNetModel,
    params: dict,
    *,
    cond_context: Optional[torch.Tensor] = None,
    scene_contexts: Optional[torch.Tensor] = None,
    cond_contexts=None,
    uncond_context: Optional[torch.Tensor] = None,
    log_sigmas: torch.Tensor,
    cfg_scale: float = 7.0,
    prediction: str = "eps",
    hooks: AttnHooks = AttnHooks(),
    control_fn: Optional[Callable] = None,
    inpaint_mask: Optional[torch.Tensor] = None,
    inpaint_latent: Optional[torch.Tensor] = None,
    concat_latent: Optional[torch.Tensor] = None,
    y_cond: Optional[torch.Tensor] = None,
    y_uncond: Optional[torch.Tensor] = None,
) -> Callable:
    """(x, sigma) -> denoised for the plain CFG path."""
    if scene_contexts is not None or cond_contexts is not None:
        raise NotImplementedError("scene and cond-list conditioning are not ported yet")
    if concat_latent is not None or y_cond is not None or y_uncond is not None:
        raise NotImplementedError("inpaint-model channels and ADM vectors are not ported yet")
    return make_denoiser(
        unet, params, cond_context, uncond_context, log_sigmas,
        cfg_scale=cfg_scale, prediction=prediction, hooks=hooks, control_fn=control_fn,
        mask=inpaint_mask, masked_latent=inpaint_latent,
    )
