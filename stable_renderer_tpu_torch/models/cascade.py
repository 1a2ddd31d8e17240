"""Stable Cascade (Wuerstchen v3): the Stage C prior and the Stage B decoder.

Counterpart of stable_renderer_tpu/models/cascade.py (reference
comfy/ldm/cascade/common.py, stage_c.py StageC, stage_b.py StageB,
comfy/supported_models.py StableCascade_C / _B,
comfy_extras/nodes_stable_cascade.py).

Functional PyTorch over NHWC activations with the checkpoint's parameter
names: depthwise / channelwise ConvNeXt ResBlocks with GlobalResponseNorm,
AttnBlocks whose K/V prepend the image tokens to the mapped conditioning,
TimestepBlocks (an adaptive scale and shift summed over the t_conds), and
pixel-(un)shuffle patching.

  * Stage C, the text-conditional prior over 16-channel latents compressed
    42x: two equal-width levels of [C, T, A] blocks; the CLIP text sequence,
    the pooled text and the image embeds mapped into one conditioning
    sequence.
  * Stage B, the decoder: four levels, conditioned on Stage C's latent
    through the effnet mapper (align-corners bilinear resize) and on the
    pooled text.

Both fit the denoiser contract ``apply(params, x, timesteps, context, y,
...)``; the timesteps carry Cascade's continuous t in [0, 1]
(``ModelSamplingCascade.t_of_sigma``), the prediction is eps. At the
published 1024x1024 no attention reaches K1's 2048 keys (Stage C attends
over 576 + 85 keys, Stage B's widest over 1024 + 308), and there is no
GroupNorm and no dense 3x3 conv: Stable Cascade runs no hand-written kernel.

``conv_transpose2x`` reproduces the JAX package's ``lax.conv_transpose``,
which takes the 2x2 taps flipped against torch's ConvTranspose2d with the
same weight (ROADMAP queue 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.layers import attention, layer_norm, linear, silu
from stable_renderer_tpu_torch.models.unet import AttnHooks

# ---------------------------------------------------------------------------
# primitives


def conv1x1(p: dict, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv as a matmul on NHWC (weight (O, I, 1, 1))."""
    b = p.get("bias")
    return F.linear(x, p["weight"][:, :, 0, 0].to(x.dtype), None if b is None else b.to(x.dtype))


def conv2d_generic(p: dict, x: torch.Tensor, stride: int = 1, padding: int = 0,
                   groups: int = 1) -> torch.Tensor:
    """torch Conv2d on NHWC (any kernel, stride, groups)."""
    b = p.get("bias")
    out = F.conv2d(x.permute(0, 3, 1, 2), p["weight"].to(x.dtype),
                   None if b is None else b.to(x.dtype), stride=stride, padding=padding,
                   groups=groups)
    return out.permute(0, 2, 3, 1)


def conv_transpose2x(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ConvTranspose2d(k=2, s=2) on NHWC, weight (I, O, 2, 2):
    ``lax.conv_transpose`` there takes the taps unflipped, which is torch's
    ``conv_transpose2d`` with the weight flipped on both spatial axes."""
    b = p.get("bias")
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), p["weight"].to(x.dtype).flip(2, 3),
                             None if b is None else b.to(x.dtype), stride=2)
    return out.permute(0, 2, 3, 1)


def resize_bilinear_ac(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True, as the JAX package's gather
    and lerp (torch F.interpolate's semantics)."""
    _, ih, iw, _ = x.shape
    if (ih, iw) == (h, w):
        return x

    def axis_idx(out_n, in_n):
        if out_n == 1 or in_n == 1:
            z = torch.zeros(out_n, dtype=torch.long, device=x.device)
            return torch.zeros(out_n, device=x.device), z, z
        pos = torch.arange(out_n, device=x.device) * ((in_n - 1) / (out_n - 1))
        lo = torch.clamp(torch.floor(pos).long(), 0, in_n - 1)
        return pos - lo, lo, torch.clamp(lo + 1, 0, in_n - 1)

    fy, y0, y1 = axis_idx(h, ih)
    fx, x0, x1 = axis_idx(w, iw)
    # f32 weights cast to the activation dtype, as JAX's weak-typed floats are
    wx0, wx1 = ((1 - fx).to(x.dtype)[None, None, :, None], fx.to(x.dtype)[None, None, :, None])
    wy0, wy1 = (1 - fy).to(x.dtype)[None, :, None, None], fy.to(x.dtype)[None, :, None, None]
    top = x[:, y0][:, :, x0] * wx0 + x[:, y0][:, :, x1] * wx1
    bot = x[:, y1][:, :, x0] * wx0 + x[:, y1][:, :, x1] * wx1
    return top * wy0 + bot * wy1


def pixel_unshuffle(x: torch.Tensor, p: int) -> torch.Tensor:
    """torch PixelUnshuffle on NHWC, channels in torch's (C, py, px) order."""
    if p == 1:
        return x
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // p, w // p, c * p * p)


def pixel_shuffle(x: torch.Tensor, p: int) -> torch.Tensor:
    if p == 1:
        return x
    b, h, w, cpp = x.shape
    c = cpp // (p * p)
    x = x.reshape(b, h, w, c, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * p, w * p, c)


def _ln2d(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm2d without affine (common.py LayerNorm2d_op), eps 1e-6."""
    return layer_norm(None, x, eps=1e-6)


def global_response_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """ConvNeXt-V2 GRN over NHWC tokens (common.py GlobalResponseNorm), in
    f32, cast back."""
    x32 = x.float()
    gx = torch.sqrt(torch.sum(x32 * x32, dim=(1, 2), keepdim=True))
    nx = gx / (torch.mean(gx, dim=-1, keepdim=True) + 1e-6)
    gamma = p["gamma"].float().reshape(1, 1, 1, -1)
    beta = p["beta"].float().reshape(1, 1, 1, -1)
    return (gamma * (x32 * nx) + beta + x32).to(x.dtype)


def _channelwise(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Linear -> GELU (jax.nn.gelu's tanh form) -> GRN -> Linear."""
    h = F.gelu(linear(p["0"], x), approximate="tanh")
    return linear(p["4"], global_response_norm(p["2"], h))


def cascade_res_block(p: dict, x: torch.Tensor,
                      x_skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """common.py ResBlock: depthwise conv -> LN2d -> channelwise MLP, residual."""
    k = p["depthwise"]["weight"].shape[-1]
    h = _ln2d(conv2d_generic(p["depthwise"], x, padding=k // 2, groups=x.shape[-1]))
    if x_skip is not None:
        h = torch.cat([h, x_skip], dim=-1)
    return x + _channelwise(p["channelwise"], h)


def cascade_attn_block(p: dict, x: torch.Tensor, clip: torch.Tensor, heads: int,
                       self_attn: bool) -> torch.Tensor:
    """common.py AttnBlock: the conditioning through kv_mapper (SiLU, Linear);
    with ``self_attn`` the image tokens lead the K/V sequence."""
    kv = linear(p["kv_mapper"]["1"], silu(clip))
    b, h, w, c = x.shape
    n = _ln2d(x).reshape(b, h * w, c)
    if self_attn:
        kv = torch.cat([n, kv], dim=1)
    a = p["attention"]["attn"]
    q, k, v = linear(a["to_q"], n), linear(a["to_k"], kv), linear(a["to_v"], kv)
    out = linear(a["out_proj"], attention(q, k, v, heads))
    return x + out.reshape(b, h, w, c)


def cascade_ffn_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x + _channelwise(p["channelwise"], _ln2d(x))


def cascade_timestep_block(p: dict, x: torch.Tensor, r_embed: torch.Tensor,
                           t_conds: Sequence[str]) -> torch.Tensor:
    """common.py TimestepBlock: an adaptive scale and shift summed over the
    t_conds."""
    parts = r_embed.chunk(1 + len(t_conds), dim=1)
    ab = linear(p["mapper"], parts[0])
    for i, cname in enumerate(t_conds):
        ab = ab + linear(p[f"mapper_{cname}"], parts[i + 1])
    a, b_ = ab.chunk(2, dim=-1)
    return x * (1.0 + a[:, None, None, :]) + b_[:, None, None, :]


def r_embedding(r: torch.Tensor, c_r: int, max_positions: float = 10000.0) -> torch.Tensor:
    """stage_c / stage_b gen_r_embedding: sinusoids of r * 10000, f32."""
    r = r.float() * max_positions
    half = c_r // 2
    freqs = torch.exp(-math.log(max_positions)
                      * torch.arange(half, dtype=torch.float32, device=r.device) / (half - 1))
    args = r[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if c_r % 2:
        emb = F.pad(emb, (0, 1))
    return emb


# ---------------------------------------------------------------------------
# configs


@dataclass(frozen=True)
class CascadeConfig:
    c_in: int = 16
    c_out: int = 16
    c_r: int = 64
    patch_size: int = 1
    c_cond: int = 2048
    c_hidden: Tuple[int, ...] = (2048, 2048)
    nhead: Tuple[int, ...] = (32, 32)
    blocks_down: Tuple[int, ...] = (8, 24)
    blocks_up: Tuple[int, ...] = (24, 8)
    block_repeat_down: Tuple[int, ...] = (1, 1)
    block_repeat_up: Tuple[int, ...] = (1, 1)
    level_config: Tuple[str, ...] = ("CTA", "CTA")
    kernel_size: int = 3
    self_attn: bool = True
    t_conds: Tuple[str, ...] = ("sca", "crp")
    switch_level: Tuple[bool, ...] = (False,)
    # Stage C's conditioning widths
    c_clip_text: int = 1280
    c_clip_text_pooled: int = 1280
    c_clip_img: int = 768
    c_clip_seq: int = 4
    # Stage B's
    c_clip: int = 1280
    c_effnet: int = 16
    c_pixels: int = 3


STAGE_C_CONFIG = CascadeConfig()
"""The full 3.6 B Stage C prior (stage_c.py defaults)."""

STAGE_C_LITE_CONFIG = CascadeConfig(
    c_cond=1536, c_hidden=(1536, 1536), nhead=(24, 24),
    blocks_down=(4, 12), blocks_up=(12, 4))
"""The 1 B 'lite' Stage C."""

STAGE_B_CONFIG = CascadeConfig(
    c_in=4, c_out=4, patch_size=2, c_cond=1280,
    c_hidden=(320, 640, 1280, 1280), nhead=(1, 1, 20, 20),
    blocks_down=(2, 6, 28, 6), blocks_up=(6, 28, 6, 2),
    block_repeat_down=(1, 1, 1, 1), block_repeat_up=(3, 3, 2, 2),
    level_config=("CT", "CT", "CTA", "CTA"), t_conds=("sca",),
    switch_level=(False, False, False))
"""The full Stage B decoder (stage_b.py defaults)."""

TINY_CASCADE_C_CONFIG = CascadeConfig(
    c_in=16, c_out=16, c_r=32, c_cond=64, c_hidden=(64, 64), nhead=(2, 2),
    blocks_down=(1, 1), blocks_up=(1, 1), level_config=("CTA", "CTA"),
    c_clip_text=48, c_clip_text_pooled=48, c_clip_img=32, c_clip_seq=2)

TINY_CASCADE_B_CONFIG = CascadeConfig(
    c_in=4, c_out=4, c_r=32, patch_size=2, c_cond=48,
    c_hidden=(32, 64), nhead=(1, 2), blocks_down=(1, 1), blocks_up=(1, 1),
    block_repeat_down=(1, 1), block_repeat_up=(1, 1),
    level_config=("CT", "CTA"), t_conds=("sca",), switch_level=(False,),
    c_clip=48, c_effnet=16, c_pixels=3)


# ---------------------------------------------------------------------------
# the level walkers


def _run_blocks(p_level: dict, level_cfg: str, n_blocks: int, x, clip, r_embed,
                cfg: CascadeConfig, nhead: int, skip=None):
    """One level's blocks in order; the level's first ResBlock takes the skip."""
    idx = 0
    for blk_i in range(n_blocks):
        for kind in level_cfg:
            bp = p_level[str(idx)]
            if kind == "C":
                x = cascade_res_block(bp, x, skip if blk_i == 0 and idx == 0 else None)
            elif kind == "T":
                x = cascade_timestep_block(bp, x, r_embed, cfg.t_conds)
            elif kind == "A":
                x = cascade_attn_block(bp, x, clip, nhead, cfg.self_attn)
            elif kind == "F":
                x = cascade_ffn_block(bp, x)
            idx += 1
    return x


class _CascadeBase:
    """The down and up walkers both stages share (_down_encode / _up_decode).
    A tree without ``down_repeat_mappers`` or ``up_repeat_mappers`` has no
    repeat mapper: a stage file holds no key under them where every repeat
    is 1 (Stage C's both, Stage B's down), and the JAX package's walkers
    raise KeyError on such a loaded tree (ROADMAP queue 3)."""

    def __init__(self, config: CascadeConfig):
        self.config = config

    def _r_embed(self, timesteps: torch.Tensor, dtype) -> torch.Tensor:
        """r's embedding, then a zero r's for each t_cond."""
        zero = r_embedding(torch.zeros_like(timesteps), self.config.c_r).to(dtype)
        return torch.cat([r_embedding(timesteps, self.config.c_r).to(dtype)]
                         + [zero] * len(self.config.t_conds), dim=1)

    def _down(self, params, x, clip, r_embed):
        cfg = self.config
        outs = []
        for i in range(len(cfg.c_hidden)):
            if i > 0:
                ds = params["down_downscalers"][str(i)]
                x = _ln2d(x)
                if "blocks" in ds["1"]:  # Stage C's UpDownBlock2d (a 1x1 conv)
                    x = conv1x1(ds["1"]["blocks"]["0"], x)
                    if cfg.switch_level[i - 1]:
                        x = resize_bilinear_ac(x, x.shape[1] // 2, x.shape[2] // 2)
                else:  # Stage B's strided conv
                    x = conv2d_generic(ds["1"], x, stride=2)
            reps = params.get("down_repeat_mappers", {}).get(str(i), {})
            for rep in range(len(reps) + 1):
                x = _run_blocks(params["down_blocks"][str(i)], cfg.level_config[i],
                                cfg.blocks_down[i], x, clip, r_embed, cfg, cfg.nhead[i])
                if rep < len(reps):
                    x = conv1x1(reps[str(rep)], x)
            outs.insert(0, x)
        return outs

    def _up(self, params, outs, clip, r_embed):
        cfg = self.config
        n = len(cfg.c_hidden)
        x = outs[0]
        for oi, i in enumerate(reversed(range(n))):
            reps = params.get("up_repeat_mappers", {}).get(str(oi), {})
            skip = outs[oi] if oi > 0 else None
            for rep in range(len(reps) + 1):
                # the level's skip joins again at every repeat, as the JAX package does
                if skip is not None and x.shape[1:3] != skip.shape[1:3]:
                    x = resize_bilinear_ac(x, skip.shape[1], skip.shape[2])
                x = _run_blocks(params["up_blocks"][str(oi)], cfg.level_config[i],
                                cfg.blocks_up[::-1][i], x, clip, r_embed, cfg, cfg.nhead[i],
                                skip=skip)
                if rep < len(reps):
                    x = conv1x1(reps[str(rep)], x)
            if i > 0:
                us = params["up_upscalers"][str(oi)]
                x = _ln2d(x)
                if "blocks" in us["1"]:  # Stage C's UpDownBlock2d
                    if cfg.switch_level[i - 1]:
                        x = resize_bilinear_ac(x, x.shape[1] * 2, x.shape[2] * 2)
                    x = conv1x1(us["1"]["blocks"]["1"], x)
                else:  # Stage B's ConvTranspose2d
                    x = conv_transpose2x(us["1"], x)
        return x

    def _trunk(self, params, h, clip, r_embed):
        h = self._up(params, self._down(params, h, clip, r_embed), clip, r_embed)
        h = conv1x1(params["clf"]["1"], _ln2d(h))
        return pixel_shuffle(h, self.config.patch_size)


class CascadeStageC(_CascadeBase):
    """Stage C prior, ``apply(params, x, timesteps, context, y)``: context the
    CLIP-G text sequence (B, L, c_clip_text), y the pooled text embed
    (B, c_clip_text_pooled) (zeros when None), ``clip_img`` the image
    embeds (zeros when None); timesteps Cascade's t in [0, 1]."""

    def apply(self, params, x, timesteps, context, y=None, control=None,
              hooks: AttnHooks = AttnHooks(), clip_img=None, **_):
        cfg = self.config
        b, dt = x.shape[0], x.dtype
        r_embed = self._r_embed(timesteps, dt)
        txt = linear(params["clip_txt_mapper"], context.to(dt))
        pooled = y if y is not None else torch.zeros((b, cfg.c_clip_text_pooled), dtype=dt,
                                                     device=x.device)
        if pooled.dim() == 2:
            pooled = pooled[:, None, :]
        pool_m = linear(params["clip_txt_pooled_mapper"], pooled.to(dt))
        pool_m = pool_m.reshape(b, pooled.shape[1] * cfg.c_clip_seq, -1)
        img = clip_img if clip_img is not None else torch.zeros((b, 1, cfg.c_clip_img), dtype=dt,
                                                                device=x.device)
        img_m = linear(params["clip_img_mapper"], img.to(dt))
        img_m = img_m.reshape(b, img.shape[1] * cfg.c_clip_seq, -1)
        clip = layer_norm(None, torch.cat([txt, pool_m, img_m], dim=1), eps=1e-6)

        h = _ln2d(conv1x1(params["embedding"]["1"], pixel_unshuffle(x, cfg.patch_size)))
        return self._trunk(params, h, clip, r_embed)

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        return _init_cascade(self.config, generator, dtype, device, stage="c")


class CascadeStageB(_CascadeBase):
    """Stage B decoder, ``apply(params, x, timesteps, context, effnet=...)``:
    context the CLIP text embeds (B, 1 | L, c_clip); ``effnet`` Stage C's
    latent (B, hc, wc, 16), which the denoiser hands in as an extra model
    input (zeros when None); ``pixels`` zeros (B, 8, 8, 3) when None."""

    def apply(self, params, x, timesteps, context, y=None, control=None,
              hooks: AttnHooks = AttnHooks(), effnet=None, pixels=None, **_):
        cfg = self.config
        b, dt = x.shape[0], x.dtype
        if pixels is None:
            pixels = torch.zeros((b, 8, 8, cfg.c_pixels), dtype=dt, device=x.device)
        r_embed = self._r_embed(timesteps, dt)
        clip = context if context.dim() == 3 else context[:, None, :]
        clip = linear(params["clip_mapper"], clip.to(dt)).reshape(b, -1, cfg.c_cond)
        clip = layer_norm(None, clip, eps=1e-6)

        h = _ln2d(conv1x1(params["embedding"]["1"], pixel_unshuffle(x, cfg.patch_size)))
        if effnet is None:
            effnet = torch.zeros((b, h.shape[1], h.shape[2], cfg.c_effnet), dtype=dt,
                                 device=x.device)
        eff = resize_bilinear_ac(effnet.to(dt), h.shape[1], h.shape[2])
        eff = F.gelu(conv1x1(params["effnet_mapper"]["0"], eff), approximate="tanh")
        h = h + _ln2d(conv1x1(params["effnet_mapper"]["2"], eff))
        px = F.gelu(conv1x1(params["pixels_mapper"]["0"], pixels.to(dt)), approximate="tanh")
        px = conv1x1(params["pixels_mapper"]["2"], px)
        h = h + resize_bilinear_ac(_ln2d(px), h.shape[1], h.shape[2])
        return self._trunk(params, h, clip, r_embed)

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        return _init_cascade(self.config, generator, dtype, device, stage="b")


# ---------------------------------------------------------------------------
# init (checkpoint-layout param trees)


def _init_cascade(cfg: CascadeConfig, generator, dtype, device, stage: str) -> dict:
    """The JAX package's ``_init_cascade`` tree, drawn from ``generator``:
    fan-in scaled normal weights, zero biases, zero GRN gamma and beta."""

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def lin(i, o):
        return {"weight": (randn(o, i) / math.sqrt(i)).to(dtype), "bias": zeros(o)}

    def conv(i, o, k=1, groups=1):
        return {"weight": (randn(o, i // groups, k, k) / math.sqrt(i * k * k / groups)).to(dtype),
                "bias": zeros(o)}

    def channelwise(c, c_skip=0):
        return {"0": lin(c + c_skip, c * 4),
                "2": {"gamma": zeros(1, 1, 1, c * 4), "beta": zeros(1, 1, 1, c * 4)},
                "4": lin(c * 4, c)}

    def level_blocks(i, n_blocks, skip_first: bool):
        out, idx, c = {}, 0, cfg.c_hidden[i]
        for blk_i in range(n_blocks):
            for kind in cfg.level_config[i]:
                if kind == "C":
                    c_skip = c if (skip_first and blk_i == 0 and idx == 0) else 0
                    out[str(idx)] = {"depthwise": conv(c, c, k=cfg.kernel_size, groups=c),
                                     "channelwise": channelwise(c, c_skip)}
                elif kind == "T":
                    out[str(idx)] = {"mapper": lin(cfg.c_r, c * 2),
                                     **{f"mapper_{t}": lin(cfg.c_r, c * 2) for t in cfg.t_conds}}
                elif kind == "A":
                    out[str(idx)] = {"kv_mapper": {"1": lin(cfg.c_cond, c)},
                                     "attention": {"attn": {"to_q": lin(c, c), "to_k": lin(c, c),
                                                            "to_v": lin(c, c),
                                                            "out_proj": lin(c, c)}}}
                elif kind == "F":
                    out[str(idx)] = {"channelwise": channelwise(c)}
                idx += 1
        return out

    n = len(cfg.c_hidden)
    params: dict = {
        "embedding": {"1": conv(cfg.c_in * cfg.patch_size ** 2, cfg.c_hidden[0])},
        "clf": {"1": conv(cfg.c_hidden[0], cfg.c_out * cfg.patch_size ** 2)},
        "down_blocks": {}, "down_downscalers": {}, "down_repeat_mappers": {},
        "up_blocks": {}, "up_upscalers": {}, "up_repeat_mappers": {},
    }
    if stage == "c":
        params["clip_txt_mapper"] = lin(cfg.c_clip_text, cfg.c_cond)
        params["clip_txt_pooled_mapper"] = lin(cfg.c_clip_text_pooled, cfg.c_cond * cfg.c_clip_seq)
        params["clip_img_mapper"] = lin(cfg.c_clip_img, cfg.c_cond * cfg.c_clip_seq)
    else:
        params["clip_mapper"] = lin(cfg.c_clip, cfg.c_cond * cfg.c_clip_seq)
        params["effnet_mapper"] = {"0": conv(cfg.c_effnet, cfg.c_hidden[0] * 4),
                                   "2": conv(cfg.c_hidden[0] * 4, cfg.c_hidden[0])}
        params["pixels_mapper"] = {"0": conv(cfg.c_pixels, cfg.c_hidden[0] * 4),
                                   "2": conv(cfg.c_hidden[0] * 4, cfg.c_hidden[0])}
    for i in range(n):
        params["down_blocks"][str(i)] = level_blocks(i, cfg.blocks_down[i], False)
        if i > 0:
            params["down_downscalers"][str(i)] = (
                {"1": {"blocks": {"0": conv(cfg.c_hidden[i - 1], cfg.c_hidden[i])}}}
                if stage == "c" else {"1": conv(cfg.c_hidden[i - 1], cfg.c_hidden[i], k=2)})
        params["down_repeat_mappers"][str(i)] = {
            str(r): conv(cfg.c_hidden[i], cfg.c_hidden[i])
            for r in range(cfg.block_repeat_down[i] - 1)}
    for oi, i in enumerate(reversed(range(n))):
        params["up_blocks"][str(oi)] = level_blocks(i, cfg.blocks_up[::-1][i],
                                                    skip_first=i < n - 1)
        if i > 0:
            if stage == "c":
                params["up_upscalers"][str(oi)] = {
                    "1": {"blocks": {"1": conv(cfg.c_hidden[i], cfg.c_hidden[i - 1])}}}
            else:  # torch ConvTranspose2d's weight layout (in, out, kh, kw)
                w = randn(cfg.c_hidden[i], cfg.c_hidden[i - 1], 2, 2) / math.sqrt(
                    cfg.c_hidden[i] * 4)
                params["up_upscalers"][str(oi)] = {"1": {"weight": w.to(dtype),
                                                         "bias": zeros(cfg.c_hidden[i - 1])}}
        params["up_repeat_mappers"][str(oi)] = {
            str(r): conv(cfg.c_hidden[i], cfg.c_hidden[i])
            for r in range(cfg.block_repeat_up[::-1][i] - 1)}
    return params
