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

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.device import to_device
from stable_renderer_tpu_torch.models.unet import PATCH_HOOKS, AttnHooks, UNetModel
from stable_renderer_tpu_torch.utils.timer import staged


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


def unet_extras(y_cond: Optional[torch.Tensor], y_uncond: Optional[torch.Tensor],
                concat_latent, cond_groups: int, uncond_groups: int, dtype: torch.dtype):
    """The UNet's ``y`` and extra input channels for a batch of
    ``cond_groups`` positive groups of B rows, then ``uncond_groups``
    negative ones (1 with CFG, 2 with PerpNeg's empty conditioning as well,
    0 without CFG): (y, extra). ``y`` is ``y_cond`` once a positive group,
    then ``y_uncond`` (default ``y_cond``); ``extra`` is ``concat_latent`` in
    ``dtype`` tiled the same way, for the caller to append to the UNet's
    input channels. ``concat_latent`` is one (B, h, w, E) for every group or
    a per-cond (cond, uncond) pair, uncond None meaning cond's. Each is None
    where its input is."""
    y = extra = None
    if y_cond is not None:
        yu = y_uncond if y_uncond is not None else y_cond
        y = torch.cat([y_cond] * cond_groups + [yu] * uncond_groups, 0)
    if concat_latent is not None:
        cc, cu = concat_latent if isinstance(concat_latent, tuple) else (concat_latent, None)
        cu = cc if cu is None else cu
        extra = torch.cat([cc.to(dtype)] * cond_groups + [cu.to(dtype)] * uncond_groups, 0)
    return y, extra


def _params_dtype(params: dict) -> torch.dtype:
    """A model tree's compute dtype: the UNet's ``time_embed`` for the SD
    family, else the first floating leaf in sorted key order, as JAX's
    ``tree_leaves`` walks it (Stable Cascade's trees have no time_embed)."""
    te = params.get("time_embed") if isinstance(params, dict) else None
    if te is not None:
        return te["0"]["weight"].dtype
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node[k] for k in sorted(node, reverse=True))
        elif isinstance(node, torch.Tensor) and node.is_floating_point():
            return node.dtype
    return torch.float32


def make_denoiser(
    unet: UNetModel,
    params: dict,
    cond_context: torch.Tensor,             # (B, L, D) positive text conditioning
    uncond_context: Optional[torch.Tensor],  # (B, L, D) negative; None = no CFG
    log_sigmas: torch.Tensor,               # (1000,) from ModelSampling
    cfg_scale=7.0,                          # a float, or a tensor broadcast per row
    prediction: str = "eps",
    hooks: AttnHooks = AttnHooks(),
    control_fn: Optional[Callable] = None,  # (x_in, t, batched_context) -> control dict
    mask: Optional[torch.Tensor] = None,           # (B, h, w, 1) inpaint mask (1 = denoise)
    masked_latent: Optional[torch.Tensor] = None,
    y_cond: Optional[torch.Tensor] = None,         # (B, ...) the UNet's y, positive rows
    y_uncond: Optional[torch.Tensor] = None,       # negative rows' y (default: y_cond)
    concat_latent=None,  # (B, h, w, E) inpaint-model channels, or (cond, uncond)
    nocond_context: Optional[torch.Tensor] = None,  # PerpNeg's empty conditioning
    perp_neg_scale: float = 1.0,
    sag: Optional[tuple] = None,                    # (scale, blur_sigma, mid_layer)
    denoise_mask_fn: Optional[Callable] = None,     # (sigma, mask) -> mask
    t_fn: Optional[Callable] = None,                # sigma -> the UNet's timestep
    rescale_cfg_multiplier: Optional[float] = None,
    model_extra_cond: Optional[dict] = None,        # named UNet inputs, positive rows
    model_extra_uncond: Optional[dict] = None,      # their negative rows (default zeros)
) -> Callable:
    """Build the (x, sigma) -> denoised closure for samplers.sample().

    CFG: uncond + (cond - uncond) * cfg_scale (samplers.py:329-358); with
    uncond_context=None the UNet runs cond-only. ``control_fn`` sees the
    batched UNet input, timesteps and contexts; its residual dict goes into
    ``UNetModel.apply``. ``concat_latent`` (a 9-channel inpaint UNet's mask
    and masked-image latent, comfy model_base.py:93-126) is appended to the
    UNet's input only: the controls see the latent channels.

    The model patches' extras, as the JAX package's ``make_denoiser``:
    ``nocond_context`` makes a third batch group and the perpendicular
    negative combine (comfy_extras/nodes_perpneg.py); ``sag`` records the
    uncond rows' attention probabilities at the middle layer, blurs the
    uncond prediction where they attend and steers away from a second
    evaluation of it (nodes_sag.py); ``rescale_cfg_multiplier`` combines in
    v space rescaled to the positive prediction's std
    (nodes_model_advanced.py RescaleCFG); ``denoise_mask_fn`` reshapes the
    inpaint mask each step (nodes_differential_diffusion.py); ``t_fn``
    replaces the log-sigma table index; ``model_extra_cond`` adds named
    UNet inputs."""
    use_cfg = uncond_context is not None
    log_sigmas = torch.as_tensor(log_sigmas, dtype=torch.float32).cpu()
    compute_dtype = _params_dtype(params)
    use_perp_neg = nocond_context is not None and use_cfg
    use_sag = sag is not None and use_cfg
    groups = 1 + int(use_cfg) + int(use_perp_neg)
    y, extra = unet_extras(y_cond, y_uncond, concat_latent, 1, groups - 1, compute_dtype)
    extra_kwargs = {}
    for name, val in (model_extra_cond or {}).items():
        vu = None if model_extra_uncond is None else model_extra_uncond.get(name)
        vu = torch.zeros_like(val) if vu is None else vu
        extra_kwargs[name] = torch.cat([val] + [vu] * (groups - 1), 0)

    def with_extra(xb: torch.Tensor, rows: slice) -> torch.Tensor:
        return xb if extra is None else torch.cat([xb, extra[rows]], -1)

    def wrap_hooks(batch: int) -> AttnHooks:
        """User hooks per the reference's slicing: pre on the positive rows'
        contexts, post / attn / mid on positive rows only; the model-patch
        points unchanged, on the whole batch."""
        passthru = {f: getattr(hooks, f) for f in PATCH_HOOKS}
        if hooks.pre is None and hooks.post is None and hooks.attn is None and hooks.mid is None:
            return AttnHooks(**passthru)

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

        # no post wrapper without a user post hook: under tensor parallelism a
        # post hook costs an all-gather of every head
        return AttnHooks(pre=pre, post=None if hooks.post is None else post, attn=attn, mid=mid,
                         **passthru)

    @staged("unet")
    def denoise(x: torch.Tensor, sigma) -> torch.Tensor:
        sigma = torch.as_tensor(sigma, dtype=torch.float32).cpu()
        b = x.shape[0]
        t = t_fn(sigma) if t_fn is not None else timestep_from_sigma(log_sigmas, sigma)
        if sigma.dim() == 1:
            # per-sample sigmas: the stream's rows sit at different denoise
            # stages; the per-row scalars broadcast over (h, w, C) and reach
            # the device without a host sync
            tb = to_device(t.repeat(groups), x.device)
            t_rows = to_device(t, x.device)
            sigma = to_device(sigma.reshape(b, 1, 1, 1), x.device)
            t = to_device(t.reshape(b, 1, 1, 1), x.device)
        else:
            tb = t.to(x.device).expand(groups * b)
            t_rows = tb[:b]
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        x_in = (x * c_in).to(compute_dtype)
        if use_cfg:
            ctxs = [cond_context, uncond_context]
            if use_perp_neg:
                noc = nocond_context[:1] if nocond_context.shape[0] != b else nocond_context
                ctxs.append(noc.expand((b,) + tuple(noc.shape[1:])))
            x_b = torch.cat([x_in] * groups, 0)
            ctx = torch.cat([c.to(compute_dtype) for c in ctxs], 0)
        else:
            x_b, ctx = x_in, cond_context
        ctx = ctx.to(compute_dtype)
        control = control_fn(x_b, tb, ctx) if control_fn is not None else None
        run_hooks = wrap_hooks(b)
        sag_sim: list = []
        if use_sag and run_hooks.attn is None:  # attn (a corresponder) takes precedence
            from stable_renderer_tpu_torch.models.layers import attention as _default_attn

            orig_attn_all = run_hooks.attn_all

            def sag_attn_all(q, k, v, heads, layer):
                out_a = (orig_attn_all(q, k, v, heads, layer) if orig_attn_all is not None
                         else _default_attn(q, k, v, heads))
                if layer == sag[2]:
                    # the uncond rows' probabilities, an explicit f32 softmax
                    d = q.shape[-1] // heads
                    qu = q[b:2 * b].reshape(b, -1, heads, d).transpose(1, 2).float()
                    ku = k[b:2 * b].reshape(b, -1, heads, d).transpose(1, 2).float()
                    logits = torch.matmul(qu, ku.transpose(-1, -2)) / math.sqrt(float(d))
                    sag_sim.append(torch.softmax(logits, dim=-1))
                return out_a

            run_hooks = run_hooks._replace(attn_all=sag_attn_all)
        out = unet.apply(params, with_extra(x_b, slice(None)), tb, ctx, control=control,
                         hooks=run_hooks, y=y, **extra_kwargs).float()
        x32 = x.float()
        if use_cfg:
            den_c = calculate_denoised(prediction, x32, out[:b], sigma, t)
            den_u = calculate_denoised(prediction, x32, out[b:2 * b], sigma, t)
            if use_perp_neg:
                # perpendicular negative guidance in noise-prediction space
                den_n = calculate_denoised(prediction, x32, out[2 * b:], sigma, t)
                np_noc = x32 - den_n
                pos = (x32 - den_c) - np_noc
                neg = (x32 - den_u) - np_noc
                perp = neg - (torch.sum(neg * pos)
                              / torch.clamp(torch.sum(pos * pos), min=1e-12)) * pos
                denoised = x32 - (np_noc + cfg_scale * (pos - perp * perp_neg_scale))
            elif rescale_cfg_multiplier is not None:
                # RescaleCFG: combine in v space, rescale to the positive
                # prediction's per-sample std, lerp by the multiplier
                mult = rescale_cfg_multiplier
                x_v = x32 / (sigma ** 2 + 1.0)
                s_root = torch.sqrt(sigma ** 2 + 1.0)
                cond_v = (x_v - den_c) * s_root / sigma
                uncond_v = (x_v - den_u) * s_root / sigma
                x_cfg = uncond_v + cfg_scale * (cond_v - uncond_v)
                ro_pos = torch.std(cond_v, dim=(1, 2, 3), keepdim=True, correction=0)
                ro_cfg = torch.std(x_cfg, dim=(1, 2, 3), keepdim=True, correction=0)
                x_rescaled = x_cfg * (ro_pos / torch.clamp(ro_cfg, min=1e-12))
                x_final = mult * x_rescaled + (1.0 - mult) * x_cfg
                denoised = x_v - x_final * sigma / s_root
            else:
                denoised = den_u + (den_c - den_u) * cfg_scale
        else:
            denoised = calculate_denoised(prediction, x32, out, sigma, t)

        if sag_sim and min(x.shape[1], x.shape[2]) > 4:  # too small to pad: skipped
            sag_scale, blur_sigma, _ = sag
            degraded = _sag_blur_map(den_u, sag_sim[0], blur_sigma)
            x_sag = ((degraded + x32 - den_u) * c_in).to(compute_dtype)
            ctx_u = uncond_context.to(compute_dtype)
            ctrl_sag = control_fn(x_sag, t_rows, ctx_u) if control_fn is not None else None
            # the uncond rows' y; the first group's extra channels, as the
            # JAX package's with_concat(x_sag, 1) takes them
            out_sag = unet.apply(params, with_extra(x_sag, slice(0, b)), t_rows, ctx_u,
                                 control=ctrl_sag,
                                 y=None if y is None else y[b:2 * b]).float()
            den_sag = calculate_denoised(prediction, x32, out_sag, sigma, t)
            denoised = denoised + (degraded - den_sag) * sag_scale

        eff_mask = mask
        if denoise_mask_fn is not None and mask is not None:
            eff_mask = denoise_mask_fn(sigma, mask)
        if eff_mask is not None and masked_latent is not None:
            denoised = denoised * eff_mask + masked_latent * (1.0 - eff_mask)
        return denoised

    return denoise


def _sag_gaussian_blur(img: torch.Tensor, kernel_size: int, sigma) -> torch.Tensor:
    """Depthwise 2D gaussian blur of NHWC with reflect padding
    (nodes_sag.py gaussian_blur_2d)."""
    half = (kernel_size - 1) * 0.5
    xs = torch.linspace(-half, half, kernel_size, device=img.device)
    pdf = torch.exp(-0.5 * (xs / sigma) ** 2)
    k1 = (pdf / pdf.sum()).to(img.dtype)
    c = img.shape[-1]
    r = kernel_size // 2
    x = F.pad(img.permute(0, 3, 1, 2), (r, r, r, r), mode="reflect")
    x = F.conv2d(x, k1.view(1, 1, kernel_size, 1).expand(c, 1, kernel_size, 1), groups=c)
    x = F.conv2d(x, k1.view(1, 1, 1, kernel_size).expand(c, 1, 1, kernel_size), groups=c)
    return x.permute(0, 2, 3, 1)


def _sag_blur_map(x0: torch.Tensor, sim: torch.Tensor, blur_sigma,
                  threshold: float = 1.0) -> torch.Tensor:
    """Blur x0 where the recorded attention mass exceeds ``threshold``
    (nodes_sag.py create_blur_map), NHWC."""
    from stable_renderer_tpu_torch.ops.math import resize_nearest

    b, lh, lw, _ = x0.shape
    hw1 = sim.shape[2]
    attn_mask = sim.mean(dim=1).sum(dim=1) > threshold  # (b, hw2)
    ratio = 2 ** ((math.ceil(math.sqrt(lh * lw / hw1)) - 1).bit_length())
    mh, mw = math.ceil(lh / ratio), math.ceil(lw / ratio)
    m = resize_nearest(attn_mask.reshape(b, mh, mw)[..., None].to(x0.dtype), lh, lw)
    return _sag_gaussian_blur(x0, 9, blur_sigma) * m + x0 * (1.0 - m)
