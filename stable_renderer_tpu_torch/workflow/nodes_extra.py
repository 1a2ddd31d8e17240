"""The comfy_extras node packs.

Counterpart of stable_renderer_tpu/workflow/nodes_extra.py, node for node
(reference source/comfyUI/comfy_extras/):

  * nodes_custom_sampler.py — SamplerCustom + KSamplerSelect + the scheduler /
    sigma-manipulation nodes (SIGMAS and SAMPLER as first-class values).
  * nodes_model_merging.py  — Model/CLIP merge arithmetic + checkpoint saves
    (through models/weights.py's writer).
  * nodes_morphology.py, nodes_compositing.py, nodes_rebatch.py,
    nodes_sdupscale.py, nodes_tomesd.py.
  * nodes_video_model.py    — ImageOnlyCheckpointLoader (SVD and Stable
    Zero123 files), SVD_img2vid_Conditioning, VideoLinearCFGGuidance.
  * nodes_stable_cascade.py — the latents, the stage-B conditioning and
    the stage loader (CascadeStageLoader / UNETLoader).
  * nodes_freelunch.py      — FreeU / FreeU_V2 output-block patches.
  * nodes_hypertile.py      — HyperTile tiled self-attention.
  * nodes_hypernetwork.py   — HypernetworkLoader: attn k/v context MLPs.
  * nodes_sag.py            — SelfAttentionGuidance.
  * nodes_perpneg.py        — Perp-Neg CFG.
  * nodes_differential_diffusion.py — per-step denoise-mask thresholding.
  * nodes_stable3d.py       — StableZero123_Conditioning.
  * nodes_photomaker.py     — PhotoMakerLoader / PhotoMakerEncode.

Patches ride the MODEL dict as ``model["patches"]``, an ordered tuple of
{"kind", "sig", ...} entries that the KSampler translates through
``model_patch_options`` into AttnHooks fields and build_denoiser options.
``model_patch_options`` also translates the kinds of the patch nodes in
nodes_parity.py and of TomePatchModel and VideoLinearCFGGuidance here
(tomesd, rescale_cfg, downscale, linear_cfg).

The JAX package picks HyperTile's and ToMe's random splits while it traces
the denoiser, once per attention layer, and its compiled program keeps them
for every step. The port's hooks run eagerly, so each layer's picks are
drawn on its first call and kept: the same splits, in the same order, from
the same ``random.Random(hash(p["sig"]))``.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.utils.log import get_logger
from stable_renderer_tpu_torch.workflow.executor import (
    InferenceContext,
    WorkflowNode,
    _find_model_file,
    _generator,
    _on,
    register_node,
)

logger = get_logger("sr_tpu_torch.nodes_extra")


def _add_patch(model: dict, entry: dict) -> dict:
    return {**model, "patches": tuple(model.get("patches", ())) + (entry,)}


# ---------------------------------------------------------------------------
# model patches: FreeU, HyperTile, Hypernetwork, SAG, PerpNeg, DiffDiffusion


@register_node("FreeU")
def freeu(ctx: InferenceContext, node: WorkflowNode, model=None):
    w = node.widgets
    b1 = float(w[0]) if w else 1.1
    b2 = float(w[1]) if len(w) > 1 else 1.2
    s1 = float(w[2]) if len(w) > 2 else 0.9
    s2 = float(w[3]) if len(w) > 3 else 0.2
    return (_add_patch(model, {"kind": "freeu", "version": 1,
                               "sig": ("freeu", b1, b2, s1, s2),
                               "b1": b1, "b2": b2, "s1": s1, "s2": s2}),)


@register_node("FreeU_V2")
def freeu_v2(ctx: InferenceContext, node: WorkflowNode, model=None):
    w = node.widgets
    b1 = float(w[0]) if w else 1.3
    b2 = float(w[1]) if len(w) > 1 else 1.4
    s1 = float(w[2]) if len(w) > 2 else 0.9
    s2 = float(w[3]) if len(w) > 3 else 0.2
    return (_add_patch(model, {"kind": "freeu", "version": 2,
                               "sig": ("freeu2", b1, b2, s1, s2),
                               "b1": b1, "b2": b2, "s1": s1, "s2": s2}),)


@register_node("HyperTile")
def hypertile(ctx: InferenceContext, node: WorkflowNode, model=None):
    w = node.widgets
    tile_size = int(w[0]) if w else 256
    swap_size = int(w[1]) if len(w) > 1 else 2
    max_depth = int(w[2]) if len(w) > 2 else 0
    scale_depth = (str(w[3]).lower() in ("true", "1", "enable")) if len(w) > 3 else False
    return (_add_patch(model, {
        "kind": "hypertile",
        "sig": ("hypertile", tile_size, swap_size, max_depth, scale_depth),
        "tile_size": tile_size, "swap_size": swap_size,
        "max_depth": max_depth, "scale_depth": scale_depth}),)


@register_node("HypernetworkLoader")
def hypernetwork_loader(ctx: InferenceContext, node: WorkflowNode, model=None):
    """Load an A1111-style hypernetwork .pt and patch attn1/attn2 k/v
    contexts with its per-dim MLPs (nodes_hypernetwork.py
    load_hypernetwork_patch). The file holds pickled module state, so it is
    read with ``weights_only=False``, as the JAX package reads it."""
    name = str(node.widgets[0]) if node.widgets else ""
    strength = float(node.widgets[1]) if len(node.widgets) > 1 else 1.0
    path = _find_model_file(ctx, name)
    if path is None:
        logger.warning(f"hypernetwork '{name}' not found; passing model through")
        return (model,)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    activation = sd.get("activation_func", "linear")
    is_layer_norm = bool(sd.get("is_layer_norm", False))
    activate_output = bool(sd.get("activate_output", False))
    nets = {}
    for d_key in sd:
        try:
            dim = int(d_key)
        except (TypeError, ValueError):
            continue
        per_slot = []
        for index in (0, 1):  # k-net, v-net
            attn_weights = sd[dim][index]
            names = sorted(
                {k[: -len(".weight")] for k in attn_weights if k.endswith(".weight")},
                key=lambda s: [int(p) if p.isdigit() else p for p in s.split(".")],
            )
            layers = []
            for n in names:
                w_ = attn_weights[f"{n}.weight"].float().numpy()
                b_ = attn_weights[f"{n}.bias"].float().numpy()
                layers.append({"weight": w_, "bias": b_,
                               "is_norm": is_layer_norm and w_.ndim == 1})
            per_slot.append(layers)
        nets[dim] = per_slot
    return (_add_patch(model, {
        "kind": "hypernetwork",
        "sig": ("hypernetwork", name, strength, activation),
        "nets": nets, "strength": strength, "activation": activation,
        "activate_output": activate_output}),)


@register_node("SelfAttentionGuidance")
def self_attention_guidance(ctx: InferenceContext, node: WorkflowNode, model=None):
    w = node.widgets
    scale = float(w[0]) if w else 0.5
    blur_sigma = float(w[1]) if len(w) > 1 else 2.0
    return (_add_patch(model, {"kind": "sag", "sig": ("sag", scale, blur_sigma),
                               "scale": scale, "blur_sigma": blur_sigma}),)


@register_node("PerpNeg")
def perp_neg(ctx: InferenceContext, node: WorkflowNode, model=None, empty_conditioning=None):
    neg_scale = float(node.widgets[0]) if node.widgets else 1.0
    return (_add_patch(model, {
        "kind": "perp_neg", "sig": ("perp_neg", neg_scale),
        "empty_context": empty_conditioning["context"],
        "neg_scale": neg_scale}),)


@register_node("DifferentialDiffusion")
def differential_diffusion(ctx: InferenceContext, node: WorkflowNode, model=None):
    return (_add_patch(model, {"kind": "diff_diffusion", "sig": ("diff_diffusion",)}),)


# --- patch -> denoiser-assembly translation (consumed by the KSampler) -------


def _freeu_fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """FFT low/high split scaling on NHWC (nodes_freelunch.py Fourier_filter)."""
    xf = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(1, 2)), dim=(1, 2))
    h, w_ = xf.shape[1], xf.shape[2]
    crow, ccol = h // 2, w_ // 2
    mask = torch.ones((1, h, w_, 1), device=x.device)
    mask[:, crow - threshold:crow + threshold, ccol - threshold:ccol + threshold, :] = scale
    xf = torch.fft.ifftshift(xf * mask, dim=(1, 2))
    return torch.fft.ifftn(xf, dim=(1, 2)).real.to(x.dtype)


def _make_freeu_out_block(p: dict, model_channels: int):
    scale_map = {model_channels * 4: (p["b1"], p["s1"]),
                 model_channels * 2: (p["b2"], p["s2"])}
    v2 = p.get("version") == 2

    def out_block(h, hsp, block_idx):
        c = h.shape[-1]
        if c not in scale_map:
            return h, hsp
        b_scale, s_scale = scale_map[c]
        if v2:
            # V2 ramps the boost by the per-pixel channel mean normalized to
            # [0, 1] (nodes_freelunch.py FreeU_V2.output_block_patch)
            hidden_mean = h.float().mean(-1, keepdim=True)
            flat = hidden_mean.reshape(hidden_mean.shape[0], -1)
            hmax = flat.amax(-1)[:, None, None, None]
            hmin = flat.amin(-1)[:, None, None, None]
            norm = (hidden_mean - hmin) / torch.clamp(hmax - hmin, min=1e-8)
            factor = ((b_scale - 1.0) * norm + 1.0).to(h.dtype)
        else:
            factor = torch.tensor(b_scale, dtype=h.dtype, device=h.device)
        scaled = torch.cat([h[..., : c // 2] * factor, h[..., c // 2:]], -1)
        return scaled, _freeu_fourier_filter(hsp, 1, s_scale)

    return out_block


def _per_layer(picks: dict, layer: int, draw):
    """``draw()`` on the layer's first call, the same value after."""
    if layer not in picks:
        picks[layer] = draw()
    return picks[layer]


def _make_hypertile_attn(p: dict):
    """Tiled self-attention (nodes_hypertile.py): split the tokens into
    nh x nw spatial tiles and attend within each, picks as in the module
    docstring. Tiles under 2048 tokens take the plain attention route."""
    from stable_renderer_tpu_torch.models.layers import attention

    latent_tile = max(32, p["tile_size"]) // 8
    rng = random.Random(hash(p["sig"]) & 0xFFFFFFFF)
    picks: dict = {}

    def pick_divisor(value: int, min_value: int) -> int:
        min_value = min(min_value, value)
        divisors = [i for i in range(min_value, value + 1) if value % i == 0]
        ns = [value // i for i in divisors[: p["swap_size"]]]
        return ns[rng.randrange(len(ns))] if len(ns) > 1 else ns[0]

    def attn_all(q, k, v, heads, layer):
        l_tok = q.shape[1]
        h = int(math.isqrt(l_tok))
        if h * h != l_tok:  # non-square latent: skip (aspect unknown here)
            return attention(q, k, v, heads)
        nh, nw = _per_layer(picks, layer, lambda: (pick_divisor(h, latent_tile),
                                                   pick_divisor(h, latent_tile)))
        if nh * nw <= 1 or h % nh or h % nw:
            return attention(q, k, v, heads)
        bsz, c = q.shape[0], q.shape[2]
        th, tw = h // nh, h // nw

        def tile(x):
            x = x.reshape(bsz, nh, th, nw, tw, c)
            return x.permute(0, 1, 3, 2, 4, 5).reshape(bsz * nh * nw, th * tw, c)

        def untile(x):
            x = x.reshape(bsz, nh, nw, th, tw, c).permute(0, 1, 3, 2, 4, 5)
            return x.reshape(bsz, l_tok, c)

        return untile(attention(tile(q), tile(k), tile(v), heads))

    return attn_all


def _make_tome_attn(p: dict):
    """ToMe self-attention (nodes_tomesd.py bipartite_soft_matching_random2d):
    one dst token per 2x2 region (picked per layer, as in the module
    docstring), the r = ratio * N most similar src tokens merged into their
    dst by mean, attention over the reduced set, then unmerged."""
    from stable_renderer_tpu_torch.models.layers import attention
    from stable_renderer_tpu_torch.ops.math import segment_add_

    ratio = p["ratio"]
    sx = sy = 2
    rng = random.Random(hash(p["sig"]) & 0xFFFFFFFF)
    picks: dict = {}

    def attn_all(q, k, v, heads, layer):
        bsz, n_tok, c = q.shape
        h = int(math.isqrt(n_tok))
        if h * h != n_tok or h % sy or (h // sy) < 2:
            return attention(q, k, v, heads)
        w = h
        hsy, wsx = h // sy, w // sx
        num_dst = hsy * wsx
        r = min(int(n_tok * ratio), n_tok - num_dst)
        if r <= 0:
            return attention(q, k, v, heads)
        pick = _per_layer(picks, layer, lambda: np.asarray(
            [[rng.randrange(sy * sx) for _ in range(wsx)] for _ in range(hsy)]))
        flags = np.zeros((hsy, wsx, sy * sx), np.int64)
        np.put_along_axis(flags, pick[..., None], -1, axis=2)
        flags = flags.reshape(hsy, wsx, sy, sx).transpose(0, 2, 1, 3).reshape(-1)
        order = np.argsort(flags, kind="stable")  # dst (-1) first, then src
        b_idx = torch.as_tensor(order[:num_dst], device=q.device)
        a_idx = torch.as_tensor(order[num_dst:], device=q.device)
        n_src = n_tok - num_dst

        metric = k / torch.clamp(torch.linalg.vector_norm(k.float(), dim=-1, keepdim=True),
                                 min=1e-6)
        scores = torch.einsum("bsc,bdc->bsd", metric[:, a_idx], metric[:, b_idx])
        node_max, node_idx = scores.amax(dim=-1), scores.argmax(dim=-1)  # best dst per src
        edge_idx = torch.argsort(-node_max, dim=-1, stable=True)  # most similar first
        src_idx, unm_idx = edge_idx[:, :r], edge_idx[:, r:]
        dst_of_src = torch.gather(node_idx, 1, src_idx)  # (B, r)

        def merge(x):
            src = x[:, a_idx]
            dst = x[:, b_idx].float()
            unm = torch.gather(src, 1, unm_idx[..., None].expand(-1, -1, c))
            mrg = torch.gather(src, 1, src_idx[..., None].expand(-1, -1, c)).float()
            out = []
            for i in range(bsz):
                sums = segment_add_(torch.zeros((num_dst, c), device=x.device),
                                    dst_of_src[i], mrg[i])
                cnts = segment_add_(torch.zeros((num_dst,), device=x.device),
                                    dst_of_src[i], torch.ones((r,), device=x.device))
                out.append((dst[i] + sums) / (1.0 + cnts)[:, None])
            return torch.cat([unm, torch.stack(out).to(x.dtype)], 1)

        def unmerge(x):
            unm, dst = x[:, : n_src - r], x[:, n_src - r:]
            cx = x.shape[-1]
            mrg = torch.gather(dst, 1, dst_of_src[..., None].expand(-1, -1, cx))
            src = torch.zeros((bsz, n_src, cx), dtype=x.dtype, device=x.device)
            src.scatter_(1, unm_idx[..., None].expand(-1, -1, cx), unm)
            src.scatter_(1, src_idx[..., None].expand(-1, -1, cx), mrg)
            out = torch.zeros((bsz, n_tok, cx), dtype=x.dtype, device=x.device)
            out[:, b_idx] = dst
            out[:, a_idx] = src
            return out

        return unmerge(attention(merge(q), merge(k), merge(v), heads))

    return attn_all


_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "swish": F.hardswish,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
}


def _make_hypernet_hooks(p: dict):
    act = _ACTIVATIONS.get(p["activation"], lambda x: x)
    strength = p["strength"]
    nets = p["nets"]
    on_dev: dict = {}  # (dim, slot, device) -> the MLP's tensors

    def apply_net(dim: int, slot: int, x: torch.Tensor) -> torch.Tensor:
        key = (dim, slot, x.device)
        if key not in on_dev:
            on_dev[key] = [(torch.as_tensor(l["weight"], device=x.device),
                            torch.as_tensor(l["bias"], device=x.device), l["is_norm"])
                           for l in nets[dim][slot]]
        layers = on_dev[key]
        out = x.float()
        n_lin = sum(1 for _, _, is_norm in layers if not is_norm)
        seen = 0
        for w_, b_, is_norm in layers:
            if is_norm:
                mean = out.mean(-1, keepdim=True)
                var = out.var(-1, keepdim=True, correction=0)
                out = (out - mean) * torch.rsqrt(var + 1e-5) * w_ + b_
            else:
                out = out @ w_.T + b_
                seen += 1
                if seen < n_lin or p.get("activate_output"):
                    out = act(out)
        return out.to(x.dtype)

    def transform(k_ctx, v_ctx):
        dim = k_ctx.shape[-1]
        if dim not in nets:
            return k_ctx, v_ctx
        return (k_ctx + apply_net(dim, 0, k_ctx) * strength,
                v_ctx + apply_net(dim, 1, v_ctx) * strength)

    def pre_all(q_ctx, k_ctx, v_ctx, layer):
        k2, v2 = transform(k_ctx, v_ctx)
        return q_ctx, k2, v2

    def pre_cross(n, ctx_k, ctx_v, layer):
        k2, v2 = transform(ctx_k, ctx_v)
        return n, k2, v2

    return pre_all, pre_cross


def model_patch_options(model: dict, unet, sigmas, ms):
    """Translate ``model["patches"]`` into (AttnHooks fields, build_denoiser
    keywords) for the shared denoiser assembly."""
    from stable_renderer_tpu_torch.models.sampling.cfg import timestep_from_sigma
    from stable_renderer_tpu_torch.models.unet import AttnHooks

    out_blocks, pre_alls, pre_crosses = [], [], []
    attn_all = in_block = in_block_after = None
    opts: dict = {}
    for p in model.get("patches", ()):
        kind = p["kind"]
        if kind == "freeu":
            out_blocks.append(_make_freeu_out_block(p, unet.config.model_channels))
        elif kind == "hypertile":
            attn_all = _make_hypertile_attn(p)
        elif kind == "tomesd":
            attn_all = _make_tome_attn(p)
        elif kind == "hypernetwork":
            pa, pc = _make_hypernet_hooks(p)
            pre_alls.append(pa)
            pre_crosses.append(pc)
        elif kind == "sag":
            # the middle block's transformer index = the down path's count
            mid_layer = sum(1 for k in unet.block_plan()[0] if k[0] == "res_attn")
            opts["sag"] = (p["scale"], p["blur_sigma"], mid_layer)
        elif kind == "perp_neg":
            opts["nocond_context"] = p["empty_context"]
            opts["perp_neg_scale"] = p["neg_scale"]
        elif kind == "rescale_cfg":
            opts["rescale_cfg_multiplier"] = p["multiplier"]
        elif kind == "downscale":
            # PatchModelAddDownscale (Kohya Deep Shrink), as the JAX package
            # approximates it: a low-pass (downscale, then upscale back) on
            # the input block, gated by the sigma window, shapes unchanged
            sigma_start = min(ms.percent_to_sigma(p["start_percent"]), float(ms.sigma_max))
            sigma_end = max(ms.percent_to_sigma(p["end_percent"]), float(ms.sigma_min))
            # thresholds in the UNet's timestep space
            if getattr(ms, "timestep_mode", "") == "edm":
                t_hi = float(0.25 * np.log(sigma_start))
                t_lo = float(0.25 * np.log(sigma_end))
            else:
                t_hi = float(ms.timestep(np.asarray(sigma_start)))
                t_lo = float(ms.timestep(np.asarray(sigma_end)))
            hook = _make_downscale_in_block(p, t_lo, t_hi)
            if p.get("after_skip", True):
                in_block_after = (hook if in_block_after is None
                                  else _chain_in_blocks(in_block_after, hook))
            else:
                in_block = hook if in_block is None else _chain_in_blocks(in_block, hook)
        elif kind == "linear_cfg":
            # VideoLinearCFGGuidance: per-frame cfg ramp (the KSampler's)
            opts["linear_cfg_min"] = p["min_cfg"]
        elif kind == "diff_diffusion":
            log_sigmas = torch.as_tensor(ms.log_sigmas)
            sig_arr = torch.as_tensor(np.asarray(sigmas, np.float32))
            t_from = timestep_from_sigma(log_sigmas, sig_arr[0])
            t_to = timestep_from_sigma(log_sigmas, torch.clamp(sig_arr[-1], min=ms.sigma_min))

            def denoise_mask_fn(sigma, mask, _tf=t_from, _tt=t_to, _ls=log_sigmas):
                t_cur = timestep_from_sigma(_ls, torch.as_tensor(sigma).cpu())
                threshold = (t_cur - _tt) / torch.clamp(_tf - _tt, min=1e-8)
                return (mask >= threshold.to(mask.device)).to(mask.dtype)

            opts["denoise_mask_fn"] = denoise_mask_fn

    def chain(fns):
        if not fns:
            return None
        if len(fns) == 1:
            return fns[0]

        def chained(a, b, c, layer):
            vals = (a, b, c)
            for f in fns:
                vals = f(*vals, layer)
            return vals

        return chained

    hooks = AttnHooks(
        pre_all=chain(pre_alls),
        pre_cross=chain(pre_crosses),
        attn_all=attn_all,
        out_block=(None if not out_blocks else
                   out_blocks[0] if len(out_blocks) == 1 else _chain_out_blocks(out_blocks)),
        in_block=in_block,
        in_block_after=in_block_after,
    )
    return hooks, opts


# comfy.utils.common_upscale method -> the resize the JAX package maps it to
# (jax.image.resize's linear / cubic, antialiased when shrinking, and its
# half-pixel nearest); 'area' and 'bislerp' become linear there
_RESIZE_METHODS = {
    "nearest-exact": "nearest", "nearest": "nearest",
    "bilinear": "linear", "area": "linear", "bislerp": "linear",
    "bicubic": "cubic", "lanczos": "cubic",
}


def _resize_image(x: torch.Tensor, h: int, w: int, method: str) -> torch.Tensor:
    """NHWC spatial resize (comfy.utils.common_upscale's counterpart)."""
    m = _RESIZE_METHODS.get(method, "linear")
    xc = x.permute(0, 3, 1, 2).float()
    if m == "nearest":
        y = F.interpolate(xc, size=(h, w), mode="nearest-exact")
    else:
        y = F.interpolate(xc, size=(h, w), mode="bilinear" if m == "linear" else "bicubic",
                          align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _make_downscale_in_block(p: dict, t_lo: float, t_hi: float):
    """Sigma-window-gated low-pass input-block hook for Deep Shrink."""
    block_number = int(p["block_number"])
    factor = float(p["downscale_factor"])

    def hook(h, idx, t):
        if idx != block_number:
            return h
        hh = _resize_image(h, max(1, round(h.shape[1] / factor)),
                           max(1, round(h.shape[2] / factor)),
                           p.get("downscale_method", "bicubic"))
        hh = _resize_image(hh, h.shape[1], h.shape[2], p.get("upscale_method", "bicubic"))
        gate = (t >= t_lo) & (t <= t_hi)
        return torch.where(gate[:, None, None, None], hh, h)

    return hook


def _chain_in_blocks(first, second):
    """Compose two input-block hooks (stacked PatchModelAddDownscale)."""
    def chained(h, idx, t):
        return second(first(h, idx, t), idx, t)

    return chained


def _chain_out_blocks(fns):
    def chained(h, hsp, i):
        for f in fns:
            h, hsp = f(h, hsp, i)
        return h, hsp

    return chained


# ---------------------------------------------------------------------------
# custom sampler pack (nodes_custom_sampler.py)


@register_node("KSamplerSelect")
def ksampler_select(ctx: InferenceContext, node: WorkflowNode):
    from stable_renderer_tpu_torch.models.sampling import SAMPLER_NAMES

    name = str(node.widgets[0]) if node.widgets else "euler"
    if name.endswith("_gpu"):  # gpu-noise variants are a torch device detail
        name = name[: -len("_gpu")]
    if name not in SAMPLER_NAMES:
        raise ValueError(f"unknown sampler {name}")
    return ({"name": name, "extra": {}},)


@register_node("SamplerDPMPP_2M_SDE")
def sampler_dpmpp_2m_sde(ctx: InferenceContext, node: WorkflowNode):
    w = node.widgets
    eta = float(w[1]) if len(w) > 1 else 1.0
    return ({"name": "dpmpp_2m_sde", "extra": {"eta": eta}},)


@register_node("SamplerDPMPP_SDE")
def sampler_dpmpp_sde(ctx: InferenceContext, node: WorkflowNode):
    w = node.widgets
    eta = float(w[0]) if w else 1.0
    return ({"name": "dpmpp_sde", "extra": {"eta": eta}},)


@register_node("BasicScheduler")
def basic_scheduler(ctx: InferenceContext, node: WorkflowNode, model=None):
    from stable_renderer_tpu_torch.models.sampling import calculate_sigmas

    w = node.widgets
    scheduler = str(w[0]) if w else "normal"
    steps = int(w[1]) if len(w) > 1 else 20
    denoise = float(w[2]) if len(w) > 2 else 1.0
    return (np.asarray(calculate_sigmas(model["sampling"], scheduler, steps, denoise)),)


@register_node("KarrasScheduler")
def karras_scheduler(ctx: InferenceContext, node: WorkflowNode):
    from stable_renderer_tpu_torch.models.sampling.schedules import sigmas_karras

    w = node.widgets
    steps = int(w[0]) if w else 20
    sigma_max = float(w[1]) if len(w) > 1 else 14.614642
    sigma_min = float(w[2]) if len(w) > 2 else 0.0291675
    rho = float(w[3]) if len(w) > 3 else 7.0
    return (sigmas_karras(steps, sigma_min, sigma_max, rho),)


@register_node("ExponentialScheduler")
def exponential_scheduler(ctx: InferenceContext, node: WorkflowNode):
    from stable_renderer_tpu_torch.models.sampling.schedules import sigmas_exponential

    w = node.widgets
    steps = int(w[0]) if w else 20
    sigma_max = float(w[1]) if len(w) > 1 else 14.614642
    sigma_min = float(w[2]) if len(w) > 2 else 0.0291675
    return (sigmas_exponential(steps, sigma_min, sigma_max),)


@register_node("PolyexponentialScheduler")
def polyexponential_scheduler(ctx: InferenceContext, node: WorkflowNode):
    from stable_renderer_tpu_torch.models.sampling.schedules import sigmas_polyexponential

    w = node.widgets
    steps = int(w[0]) if w else 20
    sigma_max = float(w[1]) if len(w) > 1 else 14.614642
    sigma_min = float(w[2]) if len(w) > 2 else 0.0291675
    rho = float(w[3]) if len(w) > 3 else 1.0
    return (sigmas_polyexponential(steps, sigma_min, sigma_max, rho),)


@register_node("VPScheduler")
def vp_scheduler(ctx: InferenceContext, node: WorkflowNode):
    from stable_renderer_tpu_torch.models.sampling.schedules import sigmas_vp

    w = node.widgets
    steps = int(w[0]) if w else 20
    beta_d = float(w[1]) if len(w) > 1 else 19.9
    beta_min = float(w[2]) if len(w) > 2 else 0.1
    eps_s = float(w[3]) if len(w) > 3 else 0.001
    return (sigmas_vp(steps, beta_d, beta_min, eps_s),)


@register_node("SDTurboScheduler")
def sd_turbo_scheduler(ctx: InferenceContext, node: WorkflowNode, model=None):
    from stable_renderer_tpu_torch.models.sampling.schedules import sigmas_sd_turbo

    w = node.widgets
    steps = int(w[0]) if w else 1
    denoise = float(w[1]) if len(w) > 1 else 1.0
    return (sigmas_sd_turbo(model["sampling"], steps, denoise),)


@register_node("SplitSigmas")
def split_sigmas(ctx: InferenceContext, node: WorkflowNode, sigmas=None):
    step = int(node.widgets[0]) if node.widgets else 0
    s = np.asarray(sigmas)
    return (s[: step + 1], s[step:])


@register_node("FlipSigmas")
def flip_sigmas(ctx: InferenceContext, node: WorkflowNode, sigmas=None):
    s = np.asarray(sigmas)[::-1].copy()
    if s.shape[0] and s[0] == 0:
        s[0] = 0.0001
    return (s,)


@register_node("SamplerCustom")
def sampler_custom(ctx: InferenceContext, node: WorkflowNode, model=None, positive=None,
                   negative=None, sampler=None, sigmas=None, latent_image=None):
    """SamplerCustom: explicit SAMPLER + SIGMAS sampling
    (nodes_custom_sampler.py SamplerCustom.sample), run eagerly. Returns
    (output, denoised_output); without an x0 preview callback the reference
    returns the same latent for both — matched here. The noise and the
    sampler's draws come from a generator seeded with the seed widget on the
    context's device."""
    from stable_renderer_tpu_torch.models.sampling import build_denoiser
    from stable_renderer_tpu_torch.ops.math import resize_nearest
    from stable_renderer_tpu_torch.workflow import executor as _ex

    w = node.widgets
    add_noise = (str(w[0]).lower() not in ("false", "disable", "0")) if w else True
    noise_seed = int(w[1]) % (2**31) if len(w) > 1 else 0
    cfg_scale = float(w[-1]) if len(w) > 2 else 8.0

    latent = _ex._on(ctx, latent_image["samples"] if isinstance(latent_image, dict)
                     else latent_image)
    b = latent.shape[0]
    ctx_pos = positive["context"]
    ctx_neg = negative["context"] if negative else None
    if ctx_pos.shape[0] != b:
        ctx_pos = ctx_pos[:1].expand((b,) + tuple(ctx_pos.shape[1:]))
    if ctx_neg is not None and ctx_neg.shape[0] != b:
        ctx_neg = ctx_neg[:1].expand((b,) + tuple(ctx_neg.shape[1:]))
    sig = torch.as_tensor(np.asarray(sigmas, np.float32))
    noise_mask = latent_image.get("noise_mask") if isinstance(latent_image, dict) else None
    if noise_mask is not None:
        nm = _ex._on(ctx, noise_mask)
        if nm.dim() == 2:
            nm = nm[None]
        if tuple(nm.shape[1:3]) != tuple(latent.shape[1:3]):
            nm = resize_nearest(nm[..., None], latent.shape[1], latent.shape[2])[..., 0]
        noise_mask = nm[..., None]

    unet = model["unet"]
    ms = model["sampling"]
    log_sigmas = torch.as_tensor(ms.log_sigmas)
    hooks, patch_opts = model_patch_options(model, unet, sig, ms)
    eta = float(sampler.get("extra", {}).get("eta", 1.0))
    den = build_denoiser(
        unet, model["params"], cond_context=ctx_pos,
        uncond_context=None if cfg_scale == 1.0 else ctx_neg,
        log_sigmas=log_sigmas, cfg_scale=cfg_scale,
        prediction=ms.prediction, hooks=hooks,
        inpaint_mask=noise_mask, inpaint_latent=None if noise_mask is None else latent,
        **patch_opts,
    )
    noise = (torch.randn(tuple(latent.shape), generator=_ex._generator(ctx, noise_seed),
                         device=ctx.device)
             if add_noise else torch.zeros_like(latent))
    out = _ex.sample(den, noise, sig, latent_image=latent, sampler=sampler["name"],
                     generator=_ex._generator(ctx, noise_seed), eta=eta)
    out_latent = {"samples": out}
    return (out_latent, out_latent)


# ---------------------------------------------------------------------------
# model merging (nodes_model_merging.py)


def _tree_combine(a: dict, b: dict, sa: float, sb: float, per_key=None) -> dict:
    """new = a * sa + b * sb per leaf, in f32, cast back to a's dtype
    (ModelPatcher.add_patches diff math). ``per_key(flat_key) -> (sa, sb)``
    overrides per parameter."""
    from stable_renderer_tpu_torch.models.weights import flatten, nest

    fa, fb = flatten(a), flatten(b)
    out = {}
    for k, va in fa.items():
        vb = fb.get(k)
        wa, wb = (sa, sb) if per_key is None else per_key(k)
        if vb is None or wb == 0.0:
            # the scalar rounded to va's dtype first, as a JAX weak scalar is
            out[k] = va if wa == 1.0 else va * torch.tensor(wa, dtype=va.dtype, device=va.device)
        else:
            out[k] = (va.float() * wa + vb.to(va.device).float() * wb).to(va.dtype)
    return nest(out, "")


@register_node("ModelMergeSimple")
def model_merge_simple(ctx: InferenceContext, node: WorkflowNode, model1=None, model2=None):
    ratio = float(node.widgets[0]) if node.widgets else 1.0
    params = _tree_combine(model1["params"], model2["params"], 1.0 - ratio, ratio)
    return ({**model1, "params": params},)


@register_node("ModelMergeAdd")
def model_merge_add(ctx: InferenceContext, node: WorkflowNode, model1=None, model2=None):
    params = _tree_combine(model1["params"], model2["params"], 1.0, 1.0)
    return ({**model1, "params": params},)


@register_node("ModelMergeSubtract")
def model_merge_subtract(ctx: InferenceContext, node: WorkflowNode, model1=None, model2=None):
    mult = float(node.widgets[0]) if node.widgets else 1.0
    params = _tree_combine(model1["params"], model2["params"], -mult, mult)
    return ({**model1, "params": params},)


@register_node("ModelMergeBlocks")
def model_merge_blocks(ctx: InferenceContext, node: WorkflowNode, model1=None, model2=None):
    """Per-section merge ratios (input/middle/out prefixes, longest match;
    nodes_model_merging.py ModelMergeBlocks.merge)."""
    w = node.widgets
    ratios = {"input": float(w[0]) if w else 1.0,
              "middle": float(w[1]) if len(w) > 1 else 1.0,
              "out": float(w[2]) if len(w) > 2 else 1.0}
    default = ratios["input"]

    def per_key(k: str):
        r, best = default, 0
        for prefix, val in ratios.items():
            if k.startswith(prefix) and len(prefix) > best:
                r, best = val, len(prefix)
        return (1.0 - r, r)

    params = _tree_combine(model1["params"], model2["params"], 0.0, 0.0, per_key=per_key)
    return ({**model1, "params": params},)


@register_node("CLIPMergeSimple")
def clip_merge_simple(ctx: InferenceContext, node: WorkflowNode, clip1=None, clip2=None):
    ratio = float(node.widgets[0]) if node.widgets else 1.0

    def per_key(k: str):
        # position_ids / logit_scale keep clip1 (nodes_model_merging.py:88)
        if k.endswith("position_ids") or k.endswith("logit_scale"):
            return (1.0, 0.0)
        return (1.0 - ratio, ratio)

    params = _tree_combine(clip1["params"], clip2["params"], 0.0, 0.0, per_key=per_key)
    return ({**clip1, "params": params},)


def _save_file(prefix: str, default: str, sub: str) -> str:
    """OUTPUT_DIR/<prefix's folder or ``sub``>/<prefix's name>.safetensors,
    its folder made."""
    import os

    from stable_renderer_tpu_torch.utils import paths

    d = os.path.join(str(paths.OUTPUT_DIR), os.path.dirname(prefix) or sub)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{os.path.basename(prefix) or default}.safetensors")


def _f32_under(prefix: str, params: dict) -> dict:
    from stable_renderer_tpu_torch.models.weights import flatten

    return {prefix + k: v.float() for k, v in flatten(params).items()}


@register_node("CheckpointSave")
def checkpoint_save(ctx: InferenceContext, node: WorkflowNode, model=None, clip=None,
                    vae=None):
    """Write a merged checkpoint as reference-layout safetensors, f32
    (nodes_model_merging.py CheckpointSave -> comfy sd.py save_checkpoint):
    model.diffusion_model.* + first_stage_model.* + cond_stage_model.transformer.*"""
    from stable_renderer_tpu_torch.models.weights import write_safetensors

    path = _save_file(str(node.widgets[0]) if node.widgets else "checkpoints/sr_tpu",
                      "sr_tpu", "checkpoints")
    flat = _f32_under("model.diffusion_model.", model["params"])
    if vae is not None:
        flat.update(_f32_under("first_stage_model.", vae["params"]))
    if clip is not None:
        flat.update(_f32_under("cond_stage_model.transformer.", clip["params"]))
    write_safetensors(flat, path)
    logger.info(f"saved checkpoint {path} ({len(flat)} tensors)")
    return (path,)


@register_node("CLIPSave")
def clip_save(ctx: InferenceContext, node: WorkflowNode, clip=None):
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    path = _save_file(str(node.widgets[0]) if node.widgets else "clip/sr_tpu", "sr_tpu",
                      "clip")
    write_safetensors(flatten(clip["params"]), path)
    return (path,)


@register_node("VAESave")
def vae_save(ctx: InferenceContext, node: WorkflowNode, vae=None):
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    path = _save_file(str(node.widgets[0]) if node.widgets else "vae/sr_tpu_vae",
                      "sr_tpu_vae", "vae")
    write_safetensors(flatten(vae["params"]), path)
    return (path,)


@register_node("ImageOnlyCheckpointSave")
def image_only_checkpoint_save(ctx: InferenceContext, node: WorkflowNode, model=None,
                               clip_vision=None, vae=None):
    """SVD-style checkpoint save, f32: diffusion model + VAE + clip-vision
    under the SVD prefixes (nodes_video_model.py ImageOnlyCheckpointSave)."""
    from stable_renderer_tpu_torch.models.weights import write_safetensors

    path = _save_file(str(node.widgets[0]) if node.widgets else "checkpoints/sr_tpu_svd",
                      "sr_tpu_svd", "checkpoints")
    flat = _f32_under("model.diffusion_model.", model["params"])
    if vae is not None:
        flat.update(_f32_under("first_stage_model.", vae["params"]))
    if clip_vision is not None:
        inner = clip_vision["params"]
        flat.update(_f32_under("conditioner.embedders.0.open_clip.model.visual.",
                               inner.get("vision_model", inner)))
    write_safetensors(flat, path)
    return (path,)


# ---------------------------------------------------------------------------
# morphology (nodes_morphology.py, kornia semantics: edge-padded max / min)


def _morph_pool(img: torch.Tensor, ksize: int, op: str) -> torch.Tensor:
    r = ksize // 2
    x = F.pad(img.permute(0, 3, 1, 2), (r, ksize - 1 - r, r, ksize - 1 - r), mode="replicate")
    if op == "dilate":
        out = F.max_pool2d(x, ksize, stride=1)
    else:
        out = -F.max_pool2d(-x, ksize, stride=1)
    return out.permute(0, 2, 3, 1)


@register_node("Morphology")
def morphology(ctx: InferenceContext, node: WorkflowNode, image=None):
    w = node.widgets
    op = str(w[0]) if w else "erode"
    ksize = int(w[1]) if len(w) > 1 else 3
    img = image
    if op == "erode":
        out = _morph_pool(img, ksize, "erode")
    elif op == "dilate":
        out = _morph_pool(img, ksize, "dilate")
    elif op == "open":
        out = _morph_pool(_morph_pool(img, ksize, "erode"), ksize, "dilate")
    elif op == "close":
        out = _morph_pool(_morph_pool(img, ksize, "dilate"), ksize, "erode")
    elif op == "gradient":
        out = _morph_pool(img, ksize, "dilate") - _morph_pool(img, ksize, "erode")
    elif op == "top_hat":
        out = img - _morph_pool(_morph_pool(img, ksize, "erode"), ksize, "dilate")
    elif op == "bottom_hat":
        out = _morph_pool(_morph_pool(img, ksize, "dilate"), ksize, "erode") - img
    else:
        raise ValueError(f"invalid morphology operation {op}")
    return (out,)


# ---------------------------------------------------------------------------
# compositing (nodes_compositing.py)

def _porter_duff(src, sa, dst, da, mode: str):
    if mode == "ADD":
        return torch.clamp(src + dst, 0, 1), torch.clamp(sa + da, 0, 1)
    if mode == "CLEAR":
        return torch.zeros_like(dst), torch.zeros_like(da)
    if mode == "DARKEN":
        return (1 - da) * src + (1 - sa) * dst + torch.minimum(src, dst), sa + da - sa * da
    if mode == "DST":
        return dst, da
    if mode == "DST_ATOP":
        return sa * dst + (1 - da) * src, sa
    if mode == "DST_IN":
        return dst * sa, sa * da
    if mode == "DST_OUT":
        return (1 - sa) * dst, (1 - sa) * da
    if mode == "DST_OVER":
        return dst + (1 - da) * src, da + (1 - da) * sa
    if mode == "LIGHTEN":
        return (1 - da) * src + (1 - sa) * dst + torch.maximum(src, dst), sa + da - sa * da
    if mode == "MULTIPLY":
        return src * dst, sa * da
    if mode == "OVERLAY":
        return (torch.where(2 * dst < da, 2 * src * dst, sa * da - 2 * (da - src) * (sa - dst)),
                sa + da - sa * da)
    if mode == "SCREEN":
        return src + dst - src * dst, sa + da - sa * da
    if mode == "SRC":
        return src, sa
    if mode == "SRC_ATOP":
        return da * src + (1 - sa) * dst, da
    if mode == "SRC_IN":
        return src * da, sa * da
    if mode == "SRC_OUT":
        return (1 - da) * src, (1 - da) * sa
    if mode == "SRC_OVER":
        return src + (1 - sa) * dst, sa + (1 - sa) * da
    if mode == "XOR":
        return (1 - da) * src + (1 - sa) * dst, (1 - da) * sa + (1 - sa) * da
    raise ValueError(f"unknown PorterDuff mode {mode}")


@register_node("PorterDuffImageComposite")
def porter_duff_image_composite(ctx: InferenceContext, node: WorkflowNode, source=None,
                                source_alpha=None, destination=None, destination_alpha=None):
    mode = str(node.widgets[0]) if node.widgets else "DST"
    src, dst = source[..., :3], destination[..., :3]
    sa, da = source_alpha, destination_alpha
    if sa.dim() == 3:
        sa = sa[..., None]
    if da.dim() == 3:
        da = da[..., None]
    out_img, out_a = _porter_duff(src, sa, dst, da, mode)
    return (out_img, out_a[..., 0])


@register_node("SplitImageWithAlpha")
def split_image_with_alpha(ctx: InferenceContext, node: WorkflowNode, image=None):
    rgb = image[..., :3]
    alpha = image[..., 3] if image.shape[-1] > 3 else torch.ones_like(image[..., 0])
    return (rgb, 1.0 - alpha)


@register_node("JoinImageWithAlpha")
def join_image_with_alpha(ctx: InferenceContext, node: WorkflowNode, image=None, alpha=None):
    from stable_renderer_tpu_torch.ops.math import resize_nearest

    img = image[..., :3]
    a = alpha.to(img.device)
    if a.dim() == 2:
        a = a[None]
    if tuple(a.shape[1:3]) != tuple(img.shape[1:3]):
        a = resize_nearest(a[..., None], img.shape[1], img.shape[2])[..., 0]
    return (torch.cat([img, (1.0 - a)[..., None]], -1),)


# ---------------------------------------------------------------------------
# rebatch (nodes_rebatch.py)


@register_node("RebatchLatents")
def rebatch_latents(ctx: InferenceContext, node: WorkflowNode, latents=None):
    batch_size = int(node.widgets[0]) if node.widgets else 1
    items = latents if isinstance(latents, list) else [latents]
    samples = torch.cat([l["samples"] if isinstance(l, dict) else l for l in items], 0)
    return ([{"samples": samples[i:i + batch_size]}
             for i in range(0, samples.shape[0], batch_size)],)


@register_node("RebatchImages")
def rebatch_images(ctx: InferenceContext, node: WorkflowNode, images=None):
    batch_size = int(node.widgets[0]) if node.widgets else 1
    items = images if isinstance(images, list) else [images]
    stacked = torch.cat(list(items), 0)
    return ([stacked[i:i + batch_size] for i in range(0, stacked.shape[0], batch_size)],)


# ---------------------------------------------------------------------------
# SD 4x upscale conditioning (nodes_sdupscale.py)


@register_node("SD_4XUpscale_Conditioning")
def sd_4x_upscale_conditioning(ctx: InferenceContext, node: WorkflowNode, images=None,
                               positive=None, negative=None):
    """The x4 upscaler's conditioning: the image at a quarter of the target
    size in [-1, 1] on both conds, and an empty latent of that size. The
    KSampler noise-augments the image (models/noise_aug.py) for the x4
    UNet."""
    w = node.widgets
    scale_ratio = float(w[0]) if w else 4.0
    noise_aug = float(w[1]) if len(w) > 1 else 0.0
    width = max(1, round(images.shape[2] * scale_ratio))
    height = max(1, round(images.shape[1] * scale_ratio))
    pixels = _resize_image(images * 2.0 - 1.0, height // 4, width // 4, "bilinear")
    pos = {**(positive or {}), "concat_image": pixels, "noise_augmentation": noise_aug}
    neg = {**(negative or {}), "concat_image": pixels, "noise_augmentation": noise_aug}
    latent = {"samples": torch.zeros((images.shape[0], height // 4, width // 4, 4),
                                     device=images.device)}
    return (pos, neg, latent)


@register_node("VideoLinearCFGGuidance")
def video_linear_cfg_guidance(ctx: InferenceContext, node: WorkflowNode, model=None):
    min_cfg = float(node.widgets[0]) if node.widgets else 1.0
    return (_add_patch(model, {"kind": "linear_cfg", "sig": ("linear_cfg", min_cfg),
                               "min_cfg": min_cfg}),)


# ---------------------------------------------------------------------------
# token merging (nodes_tomesd.py — ToMe for SD; the hook is _make_tome_attn)


@register_node("TomePatchModel")
def tome_patch_model(ctx: InferenceContext, node: WorkflowNode, model=None):
    ratio = float(node.widgets[0]) if node.widgets else 0.3
    return (_add_patch(model, {"kind": "tomesd", "sig": ("tomesd", ratio), "ratio": ratio}),)


# ---------------------------------------------------------------------------
# Stable Cascade (nodes_stable_cascade.py): the latents, the stage-B
# conditioning and the stage loader (models/cascade.py)


@register_node("StableCascade_EmptyLatentImage")
def stable_cascade_empty_latent(ctx: InferenceContext, node: WorkflowNode):
    w = node.widgets
    width = int(w[0]) if w else 1024
    height = int(w[1]) if len(w) > 1 else 1024
    compression = int(w[2]) if len(w) > 2 else 42
    batch = int(w[3]) if len(w) > 3 else 1
    dev = ctx.device
    c_latent = torch.zeros((batch, height // compression, width // compression, 16), device=dev)
    b_latent = torch.zeros((batch, height // 4, width // 4, 4), device=dev)
    return ({"samples": c_latent}, {"samples": b_latent})


@register_node("StableCascade_StageB_Conditioning")
def stable_cascade_stage_b_conditioning(ctx: InferenceContext, node: WorkflowNode,
                                        conditioning=None, stage_c=None):
    prior = stage_c["samples"] if isinstance(stage_c, dict) else stage_c
    return ({**(conditioning or {}), "stable_cascade_prior": prior},)


@register_node("CascadeStageLoader", "UNETLoader")
def cascade_stage_loader(ctx: InferenceContext, node: WorkflowNode):
    """UNet-only checkpoint loader (comfy UNETLoader) with Stable Cascade's
    stage detection, as the JAX package's node: clip_txt_mapper -> Stage C
    (``STAGE_C_CONFIG`` for every such file, shift 2.0), effnet_mapper ->
    Stage B (``STAGE_B_CONFIG``, shift 1.0), any other UNet file of a family
    ``detect_unet_config`` takes with the default eps sampling; all in bf16.
    Without a file, a tiny random stage: Stage B when the name holds
    'stage_b', else Stage C."""
    from stable_renderer_tpu_torch.models import cascade
    from stable_renderer_tpu_torch.models.sampling import ModelSampling
    from stable_renderer_tpu_torch.models.sampling.schedules import ModelSamplingCascade
    from stable_renderer_tpu_torch.models.unet import UNetModel
    from stable_renderer_tpu_torch.models.weights import (
        detect_unet_config,
        load_state_dict,
        nest,
        tree_to,
    )

    name = str(node.widgets[0]) if node.widgets else ""
    path = _find_model_file(ctx, name)
    if not path:
        logger.warning(f"unet '{name}' not found; tiny random cascade stage")
        if "stage_b" in name.lower():
            model, ms = cascade.CascadeStageB(cascade.TINY_CASCADE_B_CONFIG), 1.0
        else:
            model, ms = cascade.CascadeStageC(cascade.TINY_CASCADE_C_CONFIG), 2.0
        return ({"unet": model, "params": model.init(_generator(ctx, 0), device=ctx.device),
                 "sampling": ModelSamplingCascade(shift=ms)},)
    flat = load_state_dict(path)
    if any(k.startswith("model.diffusion_model.") for k in flat):
        flat = {k[len("model.diffusion_model."):]: v for k, v in flat.items()
                if k.startswith("model.diffusion_model.")}
    if "clip_txt_mapper.weight" in flat:
        model, ms = cascade.CascadeStageC(cascade.STAGE_C_CONFIG), ModelSamplingCascade(shift=2.0)
    elif "effnet_mapper.0.weight" in flat:
        model, ms = cascade.CascadeStageB(cascade.STAGE_B_CONFIG), ModelSamplingCascade(shift=1.0)
    else:
        model = UNetModel(detect_unet_config(
            {f"model.diffusion_model.{k}": v for k, v in flat.items()}))
        ms = ModelSampling()
    return ({"unet": model, "params": tree_to(nest(flat, ""), ctx.device, torch.bfloat16),
             "sampling": ms},)


# ---------------------------------------------------------------------------
# video models (nodes_video_model.py: SVD img2vid)


def _vision_tower(cv_p: dict, device) -> dict:
    """A checkpoint's embedded vision tower, nested under ``vision_model`` as
    the JAX package's loader nests it, in f32. A ``visual_projection`` found
    inside is lifted beside ``vision_model``, where ``CLIPVisionModel``
    reads it: the JAX package leaves it inside, so its encode of any loaded
    tower raises (ROADMAP queue 3). A tower in open_clip's layout stays as it
    is and raises at the encode in both packages."""
    from stable_renderer_tpu_torch.models.weights import tree_to

    params = tree_to({"vision_model": cv_p}, device, torch.float32)
    proj = params["vision_model"].pop("visual_projection", None)
    if proj is not None:
        params["visual_projection"] = proj
    return params


@register_node("ImageOnlyCheckpointLoader")
def image_only_checkpoint_loader(ctx: InferenceContext, node: WorkflowNode):
    """An SVD checkpoint -> (MODEL, CLIP_VISION, VAE) (nodes_video_model.py
    ImageOnlyCheckpointLoader). A file with ``time_stack`` keys loads the
    temporal UNet with EDM v-prediction sampling; any other the
    image-conditioned stills UNet (Stable Zero123) with the default
    schedule and its ``cc_projection``. The UNet and the VAE
    (``SD15_VAE_CONFIG``) in bf16, the vision tower (``VITH_CONFIG``, at
    ``conditioner.embedders.0.open_clip.model.visual.`` or Zero123's
    ``cond_stage_model.model.visual.``) in f32, as the JAX package's node
    loads them. Without a file, tiny random models."""
    from stable_renderer_tpu_torch.models import clip_vision
    from stable_renderer_tpu_torch.models import vae as vae_mod
    from stable_renderer_tpu_torch.models.sampling import ModelSampling
    from stable_renderer_tpu_torch.models.sampling.schedules import ModelSamplingEDM
    from stable_renderer_tpu_torch.models.unet import UNetModel
    from stable_renderer_tpu_torch.models.video_unet import (
        TINY_VIDEO_UNET_CONFIG,
        VideoUNetConfig,
        VideoUNetModel,
    )
    from stable_renderer_tpu_torch.models.weights import (
        detect_unet_config,
        load_state_dict,
        nest,
        tree_to,
    )

    name = str(node.widgets[0]) if node.widgets else ""
    path = _find_model_file(ctx, name)
    dev = ctx.device
    if not path:
        logger.warning(f"video checkpoint '{name}' not found; tiny random models")
        gen = _generator(ctx, 0)
        unet = VideoUNetModel(TINY_VIDEO_UNET_CONFIG)
        model = {"unet": unet, "params": unet.init(gen, device=dev),
                 "sampling": ModelSamplingEDM(prediction="v")}
        vae = vae_mod.VAE(vae_mod.TINY_VAE_CONFIG)
        cv = clip_vision.CLIPVisionModel(clip_vision.TINY_VISION_CONFIG)
        return (model, {"model": cv, "params": cv.init(gen, device=dev)},
                {"vae": vae, "params": vae.init(gen, device=dev)})
    flat = load_state_dict(path)
    cv_p = nest(flat, "conditioner.embedders.0.open_clip.model.visual.")
    if not cv_p:  # Zero123's layout (cond_stage_model = the vision tower)
        cv_p = nest(flat, "cond_stage_model.model.visual.")
    ucfg = detect_unet_config(flat)
    if isinstance(ucfg, VideoUNetConfig):
        unet, ms = VideoUNetModel(ucfg), ModelSamplingEDM(prediction="v")
    else:  # an image-conditioned stills model (Stable Zero123)
        unet, ms = UNetModel(ucfg), ModelSampling()
    model = {"unet": unet, "params": tree_to(nest(flat, "model.diffusion_model."), dev,
                                             torch.bfloat16), "sampling": ms}
    if "cc_projection.weight" in flat:
        model["cc_projection"] = {k: flat[f"cc_projection.{k}"] for k in ("weight", "bias")
                                  if f"cc_projection.{k}" in flat}
    vae = {"vae": vae_mod.VAE(vae_mod.SD15_VAE_CONFIG),
           "params": tree_to(nest(flat, "first_stage_model."), dev, torch.bfloat16)}
    cv = {"model": clip_vision.CLIPVisionModel(clip_vision.VITH_CONFIG),
          "params": _vision_tower(cv_p, dev)}
    return model, cv, vae


@register_node("SVD_img2vid_Conditioning")
def svd_img2vid_conditioning(ctx: InferenceContext, node: WorkflowNode, clip_vision=None,
                             init_image=None, vae=None):
    """SVD's conditioning (nodes_video_model.py SVD_img2vid_Conditioning):
    the init image's CLIP vision embed as the cross-attention context, its
    latent at (height, width) as c_concat (zeros for the negative), the
    fps / motion / augmentation ADM vector, and an empty latent of
    ``video_frames`` rows. With ``augmentation_level`` > 0 the image takes
    a draw from a generator seeded 7 on the executor's device (the JAX
    package draws from PRNGKey(7))."""
    from stable_renderer_tpu_torch.models.video_unet import svd_adm_vector

    w = node.widgets
    width = int(w[0]) if w else 1024
    height = int(w[1]) if len(w) > 1 else 576
    video_frames = int(w[2]) if len(w) > 2 else 14
    motion_bucket_id = int(w[3]) if len(w) > 3 else 127
    fps = int(w[4]) if len(w) > 4 else 6
    aug = float(w[5]) if len(w) > 5 else 0.0

    image = _on(ctx, init_image)
    out = clip_vision["model"].encode_image(clip_vision["params"], image)
    pooled = out.image_embeds[:1][:, None, :]  # (1, 1, D)
    img = image[..., :3]
    if tuple(img.shape[1:3]) != (height, width):
        img = _resize_image(img, height, width, "bilinear")
    if aug > 0:
        img = img + torch.randn(tuple(img.shape), generator=_generator(ctx, 7),
                                device=img.device) * aug
    dtype = vae["params"]["quant_conv"]["weight"].dtype
    t = vae["vae"].encode(vae["params"], (img * 2.0 - 1.0).to(dtype)).float()
    y = svd_adm_vector(fps - 1, motion_bucket_id, aug, device=ctx.device)
    pos = {"context": pooled, "concat_latent_image": t, "y": y, "fps": fps,
           "motion_bucket_id": motion_bucket_id, "augmentation_level": aug}
    neg = {"context": torch.zeros_like(pooled), "concat_latent_image": torch.zeros_like(t),
           "y": y}
    latent = {"samples": torch.zeros((video_frames, t.shape[1], t.shape[2], 4),
                                     device=ctx.device)}
    return pos, neg, latent


# ---------------------------------------------------------------------------
# Stable Zero123 (nodes_stable3d.py: novel-view synthesis conditioning)


def zero123_latent(clip_vision: dict, init_image: torch.Tensor, vae: dict, width: int,
                   height: int):
    """Zero123's image embed (1, 1, D) and the init image's latent: the
    image bilinear-resized to (height, width) and VAE-encoded in the VAE's
    dtype, the latent f32 (nodes_stable3d.py)."""
    out = clip_vision["model"].encode_image(clip_vision["params"], init_image)
    pooled = out.image_embeds[:1][:, None, :]
    img = init_image[..., :3]
    if tuple(img.shape[1:3]) != (height, width):
        img = _resize_image(img, height, width, "bilinear")
    dtype = vae["params"]["quant_conv"]["weight"].dtype
    t = vae["vae"].encode(vae["params"], (img * 2.0 - 1.0).to(dtype)).float()
    return pooled, t


def zero123_camera(elevation: float, azimuth: float) -> list:
    """Zero123's camera row: the polar offset, sin and cos of the azimuth,
    a fixed 90 degrees (nodes_stable3d.py camera_embeddings)."""
    return [math.radians((90.0 - elevation) - 90.0), math.sin(math.radians(azimuth)),
            math.cos(math.radians(azimuth)), math.radians(90.0)]


@register_node("StableZero123_Conditioning")
def stable_zero123_conditioning(ctx: InferenceContext, node: WorkflowNode, clip_vision=None,
                                init_image=None, vae=None):
    """Zero123 novel-view conditioning (nodes_stable3d.py
    StableZero123_Conditioning): the CLIP vision embed concatenated with the
    camera row as the cross-attention context, the init image's latent as
    c_concat. A Zero123 model's cc_projection (772 -> 768) is applied by the
    KSampler."""
    w = node.widgets
    width = int(w[0]) if w else 256
    height = int(w[1]) if len(w) > 1 else 256
    batch_size = int(w[2]) if len(w) > 2 else 1
    elevation = float(w[3]) if len(w) > 3 else 0.0
    azimuth = float(w[4]) if len(w) > 4 else 0.0
    pooled, t = zero123_latent(clip_vision, _on(ctx, init_image), vae, width, height)
    cam = torch.tensor([[zero123_camera(elevation, azimuth)]], dtype=torch.float32,
                       device=pooled.device)
    pos = {"context": torch.cat([pooled, cam], dim=-1), "concat_latent_image": t}
    neg = {"context": torch.zeros_like(pooled), "concat_latent_image": torch.zeros_like(t)}
    latent = {"samples": torch.zeros((batch_size, t.shape[1], t.shape[2], 4),
                                     device=ctx.device)}
    return pos, neg, latent


# ---------------------------------------------------------------------------
# PhotoMaker (nodes_photomaker.py: identity-conditioned SDXL encoding)


def _pm_mlp(p: dict, x: torch.Tensor, residual: bool) -> torch.Tensor:
    """PhotoMaker's MLP: LayerNorm, fc1, GELU (the tanh form, jax.nn.gelu's
    default in the JAX package), fc2, optional residual."""
    from stable_renderer_tpu_torch.models.layers import layer_norm, linear

    h = layer_norm(p["layernorm"], x)
    h = linear(p["fc2"], F.gelu(linear(p["fc1"], h), approximate="tanh"))
    return h + x if residual else h


def photomaker_fuse(p: dict, prompt_embeds: torch.Tensor, id_embeds: torch.Tensor,
                    token_index: int) -> torch.Tensor:
    """FuseModule.fuse_fn and the scatter at the trigger token's position:
    the class token's embedding becomes LN(mlp2(mlp1([token; id]) + token))."""
    from stable_renderer_tpu_torch.models.layers import layer_norm

    tok = prompt_embeds[:, token_index]
    fused = _pm_mlp(p["mlp1"], torch.cat([tok, id_embeds.expand(tok.shape[0], -1)], -1),
                    residual=False) + tok
    fused = layer_norm(p["layer_norm"], _pm_mlp(p["mlp2"], fused, residual=True))
    out = prompt_embeds.clone()
    out[:, token_index] = fused
    return out


@register_node("PhotoMakerLoader")
def photomaker_loader(ctx: InferenceContext, node: WorkflowNode):
    """PhotoMaker's ID encoder: a ViT-L CLIP vision tower, two projections
    (1024 -> 768 and 1024 -> 1280, concatenated to SDXL's 2048 width) and
    the FuseModule (nodes_photomaker.py PhotoMakerIDEncoder), in f32.
    Without the file: a tiny random encoder of the JAX package's shapes."""
    from stable_renderer_tpu_torch.models.clip_vision import (
        TINY_VISION_CONFIG,
        VITL_CONFIG,
        CLIPVisionModel,
    )
    from stable_renderer_tpu_torch.models.weights import load_state_dict, nest, tree_to

    name = str(node.widgets[0]) if node.widgets else ""
    path = _find_model_file(ctx, name)
    if path:
        flat = {k[len("id_encoder."):] if k.startswith("id_encoder.") else k: v
                for k, v in load_state_dict(path).items()}
        return ({"vision": CLIPVisionModel(VITL_CONFIG),
                 "params": tree_to(nest(flat, ""), ctx.device, torch.float32)},)
    logger.warning(f"photomaker '{name}' not found; tiny random encoder")
    cfg = TINY_VISION_CONFIG
    vis = CLIPVisionModel(cfg)
    g = _generator(ctx, 0)
    dev = ctx.device
    embed = 2 * cfg.projection_dim

    def lin(i, o):
        return {"weight": torch.randn((o, i), generator=g, device=dev) * 0.02,
                "bias": torch.zeros((o,), device=dev)}

    def norm(c):
        return {"weight": torch.ones((c,), device=dev), "bias": torch.zeros((c,), device=dev)}

    def mlp(i, o, hdim):
        return {"layernorm": norm(i), "fc1": lin(i, hdim), "fc2": lin(hdim, o)}

    params = {
        **vis.init(g, device=dev),
        "visual_projection_2": {"weight": torch.randn((cfg.projection_dim, cfg.hidden_size),
                                                      generator=g, device=dev) * 0.02},
        "fuse_module": {"mlp1": mlp(embed * 2, embed, embed), "mlp2": mlp(embed, embed, embed),
                        "layer_norm": norm(embed)},
    }
    return ({"vision": vis, "params": params},)


@register_node("PhotoMakerEncode")
def photomaker_encode(ctx: InferenceContext, node: WorkflowNode, photomaker=None, image=None,
                      clip=None):
    """Encode a prompt whose 'photomaker' trigger word's embedding is
    replaced by the fused identity embedding of the reference image
    (nodes_photomaker.py PhotoMakerEncode). The trigger's word index stands
    for its token index, as in the JAX package."""
    from stable_renderer_tpu_torch.workflow.executor import _encode_weighted

    text = str(node.widgets[0]) if node.widgets else "photograph of photomaker"
    words = text.split(" ")
    index = words.index("photomaker") + 1 if "photomaker" in words else -1
    clean = " ".join(w for w in words if w != "photomaker")
    cond = _encode_weighted(clip, [clean or text], ctx.device)
    if index <= 0 or photomaker is None or image is None:
        return ({"context": cond},)
    p = photomaker["params"]
    out = photomaker["vision"].encode_image(p, _on(ctx, image))
    # the two projections concatenated; encode_image applied the first
    id2 = out.last_hidden_state[:, 0] @ p["visual_projection_2"]["weight"].T
    id_embeds = torch.cat([out.image_embeds, id2], -1)[:1]
    token_index = min(index - 1, cond.shape[1] - 1)
    if id_embeds.shape[-1] != cond.shape[-1]:
        # a text tower of another width: the id embed tiled onto it, blended
        reps = -(-cond.shape[-1] // id_embeds.shape[-1])
        id_embeds = id_embeds.repeat(1, reps)[:, : cond.shape[-1]]
        fused = cond.clone()
        fused[:, token_index] = 0.5 * cond[:, token_index] + 0.5 * id_embeds
        return ({"context": fused},)
    return ({"context": photomaker_fuse(p["fuse_module"], cond, id_embeds, token_index)},)
