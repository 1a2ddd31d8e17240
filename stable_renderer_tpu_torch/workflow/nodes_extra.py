"""The model-patch nodes of the comfy_extras packs.

Counterpart of the model-patch part of stable_renderer_tpu/workflow/
nodes_extra.py (reference source/comfyUI/comfy_extras/):

  * nodes_freelunch.py      — FreeU / FreeU_V2 output-block patches.
  * nodes_hypertile.py      — HyperTile tiled self-attention.
  * nodes_hypernetwork.py   — HypernetworkLoader: attn k/v context MLPs.
  * nodes_sag.py            — SelfAttentionGuidance.
  * nodes_perpneg.py        — Perp-Neg CFG.
  * nodes_differential_diffusion.py — per-step denoise-mask thresholding.

Patches ride the MODEL dict as ``model["patches"]``, an ordered tuple of
{"kind", "sig", ...} entries that the KSampler translates through
``model_patch_options`` into AttnHooks fields and build_denoiser options.
``model_patch_options`` also translates the kinds whose nodes wait for
ROADMAP 1.12b (tomesd, rescale_cfg, downscale, linear_cfg). The pack's other
names are registered as stubs naming 1.12b.

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
    register_node,
    register_stubs,
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


# the pack's other nodes wait for ROADMAP 1.12b
register_stubs((
    "KSamplerSelect", "SamplerDPMPP_2M_SDE", "SamplerDPMPP_SDE", "BasicScheduler",
    "KarrasScheduler", "ExponentialScheduler", "PolyexponentialScheduler", "VPScheduler",
    "SDTurboScheduler", "SplitSigmas", "FlipSigmas", "SamplerCustom", "ModelMergeSimple",
    "ModelMergeAdd", "ModelMergeSubtract", "ModelMergeBlocks", "CLIPMergeSimple",
    "CheckpointSave", "CLIPSave", "VAESave", "Morphology", "PorterDuffImageComposite",
    "SplitImageWithAlpha", "JoinImageWithAlpha", "RebatchLatents", "RebatchImages",
    "SD_4XUpscale_Conditioning", "ImageOnlyCheckpointLoader", "SVD_img2vid_Conditioning",
    "VideoLinearCFGGuidance", "ImageOnlyCheckpointSave", "TomePatchModel",
    "StableZero123_Conditioning", "StableCascade_EmptyLatentImage",
    "StableCascade_StageB_Conditioning", "CascadeStageLoader", "UNETLoader",
    "PhotoMakerLoader", "PhotoMakerEncode",
), "1.12b", "the rest of workflow/nodes_extra.py")
