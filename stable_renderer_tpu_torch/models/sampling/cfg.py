"""CFG denoiser assembly: raw UNet -> (x, sigma) -> denoised, with hooks.

Counterpart of stable_renderer_tpu/models/sampling/cfg.py (reference
comfy/samplers.py calc_cond_uncond_batch + sampling_function,
comfy/model_base.py apply_model input scaling, comfy/model_sampling.py
calculate_denoised). cond and uncond run as ONE UNet batch
[positive..., negative...], which also lets the corresponder's hooks act on
the positive rows only (attention.py:596-599).

Sigmas stay on the host as 0-d f32 CPU tensors, so the per-step scalars
(timestep, c_in, the LCM coefficients) cost no device round trip. The stream
pipeline passes a 1-D sigma, one per row (its rows sit at different denoise
stages); those stay host tensors too and go to the device as one small copy.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from stable_renderer_tpu_torch.device import to_device
from stable_renderer_tpu_torch.models.unet import AttnHooks, UNetModel


def timestep_from_sigma(log_sigmas: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """NEAREST log-sigma table index as f32 (model_sampling.py:125-128): the
    reference feeds integer timesteps to the UNet."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    log_sigma = torch.log(torch.clamp(sigma, min=1e-10))
    dists = (log_sigma[..., None] - log_sigmas.to(sigma.device)).abs()
    return torch.argmin(dists, dim=-1).float().reshape(sigma.shape)


def calculate_denoised(prediction: str, x: torch.Tensor, model_out: torch.Tensor,
                       sigma, timestep, sigma_data: float = 0.5,
                       timestep_scaling: float = 10.0) -> torch.Tensor:
    """model output -> x0 (ModelSamplingDiscrete/V/LCM.calculate_denoised)."""
    if prediction == "eps":
        return x - model_out * sigma
    if prediction == "v":
        c_skip = 1.0 / (sigma ** 2 + 1.0)
        c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
        return c_skip * x + c_out * model_out
    if prediction == "lcm":
        x0 = x - model_out * sigma
        scaled_t = timestep * timestep_scaling
        c_skip = sigma_data ** 2 / (scaled_t ** 2 + sigma_data ** 2)
        c_out = scaled_t / torch.sqrt(scaled_t ** 2 + sigma_data ** 2)
        return c_out * x0 + c_skip * x
    if prediction == "x0":
        return model_out
    raise ValueError(f"unknown prediction type {prediction}")


def make_denoiser(
    unet: UNetModel,
    params: dict,
    cond_context: torch.Tensor,             # (B, L, D) positive text conditioning
    uncond_context: Optional[torch.Tensor],  # (B, L, D) negative; None = no CFG
    log_sigmas: torch.Tensor,               # (1000,) from ModelSampling
    cfg_scale: float = 7.0,
    prediction: str = "eps",
    hooks: AttnHooks = AttnHooks(),
    control_fn: Optional[Callable] = None,  # (x_in, t, batched_context) -> control dict
    mask: Optional[torch.Tensor] = None,           # (B, h, w, 1) inpaint mask (1 = denoise)
    masked_latent: Optional[torch.Tensor] = None,
) -> Callable:
    """Build the (x, sigma) -> denoised closure for samplers.sample().

    CFG: uncond + (cond - uncond) * cfg_scale (samplers.py:329-358); with
    uncond_context=None the UNet runs cond-only. ``control_fn`` sees the
    batched UNet input, timesteps and contexts; its residual dict goes into
    ``UNetModel.apply``."""
    use_cfg = uncond_context is not None
    log_sigmas = torch.as_tensor(log_sigmas, dtype=torch.float32).cpu()
    compute_dtype = params["time_embed"]["0"]["weight"].dtype

    def wrap_hooks(batch: int) -> AttnHooks:
        """User hooks per the reference's slicing: pre on the positive rows'
        contexts, post / attn / mid on positive rows only."""
        if hooks == AttnHooks():
            return hooks

        def pre(q, k, v, layer):
            if hooks.pre is None:
                return q, k, v
            if not use_cfg:
                return hooks.pre(q, k, v, layer)
            qs, ks, vs = q[:batch], k[:batch], v[:batch]
            qp, kp, vp = hooks.pre(qs, ks, vs, layer)
            if qp is qs and kp is ks and vp is vs:
                return q, k, v  # untouched: keeps the block's fused QKV projection
            qn, kn, vn = q[batch:], k[batch:], v[batch:]
            if kp.shape[1] != kn.shape[1]:
                # negatives keep their own contexts, tiled to the injected length
                reps = -(-kp.shape[1] // kn.shape[1])
                kn = kn.repeat(1, reps, 1)[:, : kp.shape[1]]
                vn = vn.repeat(1, reps, 1)[:, : vp.shape[1]]
            return torch.cat([qp, qn], 0), torch.cat([kp, kn], 0), torch.cat([vp, vn], 0)

        def post(vals, layer):
            if hooks.post is None:
                return vals
            if not use_cfg:
                return hooks.post(vals, layer)
            return torch.cat([hooks.post(vals[:batch], layer), vals[batch:]], 0)

        attn = None
        if hooks.attn is not None:
            from stable_renderer_tpu_torch.models.layers import attention as _default_attn

            def attn(q, k, v, heads, layer):
                if not use_cfg:
                    return hooks.attn(q, k, v, heads, layer)
                pos = hooks.attn(q[:batch], k[:batch], v[:batch], heads, layer)
                return torch.cat([pos, _default_attn(q[batch:], k[batch:], v[batch:], heads)], 0)

        mid = None
        if hooks.mid is not None:

            def mid(x, layer):
                if not use_cfg:
                    return hooks.mid(x, layer)
                return torch.cat([hooks.mid(x[:batch], layer), x[batch:]], 0)

        return AttnHooks(pre=pre, post=post, attn=attn, mid=mid)

    def denoise(x: torch.Tensor, sigma) -> torch.Tensor:
        sigma = torch.as_tensor(sigma, dtype=torch.float32).cpu()
        b = x.shape[0]
        t = timestep_from_sigma(log_sigmas, sigma)
        if sigma.dim() == 1:
            # per-sample sigmas: the stream's rows sit at different denoise
            # stages; the per-row scalars broadcast over (h, w, C) and reach
            # the device without a host sync
            tb = to_device(t.repeat(2 if use_cfg else 1), x.device)
            sigma = to_device(sigma.reshape(b, 1, 1, 1), x.device)
            t = to_device(t.reshape(b, 1, 1, 1), x.device)
        else:
            tb = t.to(x.device).expand(2 * b if use_cfg else b)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        x_in = (x * c_in).to(compute_dtype)
        if use_cfg:
            x_b = torch.cat([x_in, x_in], 0)
            ctx = torch.cat([cond_context, uncond_context], 0)
        else:
            x_b, ctx = x_in, cond_context
        ctx = ctx.to(compute_dtype)
        control = control_fn(x_b, tb, ctx) if control_fn is not None else None
        out = unet.apply(params, x_b, tb, ctx, control=control, hooks=wrap_hooks(b)).float()
        x32 = x.float()
        if use_cfg:
            den_c = calculate_denoised(prediction, x32, out[:b], sigma, t)
            den_u = calculate_denoised(prediction, x32, out[b:], sigma, t)
            denoised = den_u + (den_c - den_u) * cfg_scale
        else:
            denoised = calculate_denoised(prediction, x32, out, sigma, t)
        if mask is not None and masked_latent is not None:
            denoised = denoised * mask + masked_latent * (1.0 - mask)
        return denoised

    return denoise
