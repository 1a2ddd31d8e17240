"""Swin2SR: SwinV2-attention super-resolution and compressed-input SR.

Counterpart of stable_renderer_tpu/models/swin2sr.py (reference chainner
Swin2SR.py: SwinV2 WindowAttention :83-240 with cosine attention, the
clamped logit scale, the continuous position bias MLP and split q/v bias;
the post-norm block :243-380; assembly and detection :855-1010; the
reconstruction variants :1285-1345). Functional PyTorch over NHWC.

Upsamplers: pixelshuffle, pixelshuffledirect, nearest+conv and
pixelshuffle_aux, whose bicubic skip is the JAX package's
``jax.image.resize(..., "cubic")`` (Keys a = -0.5, antialiased when it
shrinks: ``clip_vision.resize_cubic``), not torch's a = -0.75 bicubic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.clip_vision import resize_cubic
from stable_renderer_tpu_torch.models.layers import conv2d, layer_norm, linear, upsample_nearest_2x
from stable_renderer_tpu_torch.models.swinir import (
    RGB_MEAN,
    Draws,
    _rel_pos_index,
    shift_mask,
    _window_partition,
    _window_reverse,
    add_window_mask,
    block_shift,
    layer_block_extent,
    lrelu,
    pad_reflect,
    pixel_shuffle,
    table,
)


@dataclass(frozen=True)
class Swin2SRConfig:
    embed_dim: int = 180
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    window_size: int = 8
    mlp_ratio: float = 2.0
    upsampler: str = "pixelshuffle"
    upscale: int = 4
    num_feat: int = 64
    img_range: float = 1.0
    in_chans: int = 3
    out_chans: int = 3


TINY_SWIN2SR_CONFIG = Swin2SRConfig(
    embed_dim=16, depths=(2,), num_heads=(2,), window_size=4, mlp_ratio=2.0,
    upsampler="pixelshuffledirect", upscale=2, num_feat=8)


def _coords_table(ws: int) -> np.ndarray:
    """Log-spaced continuous relative coords (Swin2SR.py:121-147)."""
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    tab = np.stack(np.meshgrid(r, r, indexing="ij"), -1)  # (2w-1, 2w-1, 2)
    tab = tab / max(ws - 1, 1) * 8.0
    tab = np.sign(tab) * np.log2(np.abs(tab) + 1.0) / np.log2(8)
    return tab.reshape(-1, 2)


def _v2_window_attention(p: dict, x: torch.Tensor, heads: int, ws: int,
                         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """SwinV2 W-MSA: cosine attention and the CPB MLP bias (Swin2SR.py:178-235)."""
    bw, n, c = x.shape
    d = c // heads
    qkv = x @ p["qkv"]["weight"].to(x.dtype).T
    if "q_bias" in p:
        qkv = qkv + torch.cat([p["q_bias"], torch.zeros_like(p["v_bias"]),
                               p["v_bias"]]).to(x.dtype)
    qkv = qkv.reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.einsum("bhnd,bhmd->bhnm", F.normalize(q, dim=-1), F.normalize(k, dim=-1))
    logit_scale = torch.exp(torch.clamp(p["logit_scale"], max=math.log(1.0 / 0.01)))
    attn = attn * logit_scale.to(attn.dtype)
    # continuous position bias: a small MLP over the log-coords table
    coords = table(("cpb", ws), lambda: _coords_table(ws), x.device)
    cpb = torch.relu(linear(p["cpb_mlp"]["0"], coords))
    cpb = cpb @ p["cpb_mlp"]["2"]["weight"].to(cpb.dtype).T  # no bias
    idx = table(("rel_pos", ws), lambda: _rel_pos_index(ws).reshape(-1), x.device)
    rpb = cpb[idx].reshape(n, n, heads).permute(2, 0, 1)
    attn = attn + (16.0 * torch.sigmoid(rpb))[None].to(attn.dtype)
    if mask is not None:
        attn = add_window_mask(attn, mask)
    attn = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
    return linear(p["proj"], out.permute(0, 2, 1, 3).reshape(bw, n, c))


def _v2_block(p: dict, x: torch.Tensor, hw: Tuple[int, int], heads: int, ws: int,
              shift: int) -> torch.Tensor:
    """The SwinV2 post-norm block (Swin2SR.py:243-380)."""
    h, w = hw
    b, l, c = x.shape
    xs = x.reshape(b, h, w, c)
    mask = None
    if shift > 0:
        xs = torch.roll(xs, (-shift, -shift), dims=(1, 2))
        mask = shift_mask(h, w, ws, shift, x.device)
    win = _v2_window_attention(p["attn"], _window_partition(xs, ws), heads, ws, mask)
    xs = _window_reverse(win, ws, h, w)
    if shift > 0:
        xs = torch.roll(xs, (shift, shift), dims=(1, 2))
    x = x + layer_norm(p["norm1"], xs.reshape(b, l, c))  # post-norm
    mlp = linear(p["mlp"]["fc2"], F.gelu(linear(p["mlp"]["fc1"], x)))
    return x + layer_norm(p["norm2"], mlp)


class Swin2SR:
    def __init__(self, config: Swin2SRConfig = Swin2SRConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return self.config.upscale

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        ws, r = cfg.window_size, cfg.upscale
        b, h_in, w_in, _ = x.shape
        if cfg.in_chans == 3:
            mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
        else:
            mean = torch.zeros((x.shape[-1],), dtype=x.dtype, device=x.device)
        x0 = x
        x = pad_reflect((x - mean) * cfg.img_range, (ws - h_in % ws) % ws, (ws - w_in % ws) % ws)
        h, w = x.shape[1], x.shape[2]

        feat = conv2d(params["conv_first"], x, padding=1)

        def features(f):
            t = f.reshape(b, h * w, cfg.embed_dim)
            if "patch_embed" in params:
                t = layer_norm(params["patch_embed"]["norm"], t)
            for li, depth in enumerate(cfg.depths):
                lp = params["layers"][str(li)]
                rr = t
                for bi in range(depth):
                    rr = _v2_block(lp["residual_group"]["blocks"][str(bi)], rr, (h, w),
                                   cfg.num_heads[li], ws, block_shift(bi, ws, h, w))
                rimg = conv2d(lp["conv"], rr.reshape(b, h, w, cfg.embed_dim), padding=1)
                t = rimg.reshape(b, h * w, cfg.embed_dim) + t
            return layer_norm(params["norm"], t).reshape(b, h, w, cfg.embed_dim)

        feat = conv2d(params["conv_after_body"], features(feat), padding=1) + feat
        up = cfg.upsampler
        if up in ("pixelshuffle", "pixelshuffle_aux"):
            feat = lrelu(conv2d(params["conv_before_upsample"]["0"], feat, padding=1))
            if up == "pixelshuffle_aux":
                bic = resize_cubic(x0, h_in * r, w_in * r)
                bic = conv2d(params["conv_bicubic"], (bic - mean) * cfg.img_range, padding=1)
                aux = conv2d(params["conv_aux"], feat, padding=1)
                feat = lrelu(conv2d(params["conv_after_aux"]["0"], aux, padding=1))
            y = feat
            for s in range(int(math.log2(r))):
                y = pixel_shuffle(conv2d(params["upsample"][str(s * 2)], y, padding=1), 2)
            if up == "pixelshuffle_aux":
                y = y[:, : h_in * r, : w_in * r] + bic[:, : h_in * r, : w_in * r]
            out = conv2d(params["conv_last"], y, padding=1)
        elif up == "pixelshuffledirect":
            out = pixel_shuffle(conv2d(params["upsample"]["0"], feat, padding=1), r)
        else:  # nearest+conv
            feat = lrelu(conv2d(params["conv_before_upsample"]["0"], feat, padding=1))
            feat = lrelu(conv2d(params["conv_up1"], upsample_nearest_2x(feat), padding=1))
            if r >= 4:
                feat = lrelu(conv2d(params["conv_up2"], upsample_nearest_2x(feat), padding=1))
            out = conv2d(params["conv_last"], lrelu(conv2d(params["conv_hr"], feat, padding=1)),
                         padding=1)
        out = out / cfg.img_range + mean[: out.shape[-1]]
        return out[:, : h_in * r, : w_in * r]

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        cfg = self.config
        d = Draws(generator, dtype, device)
        e = cfg.embed_dim
        hidden = int(e * cfg.mlp_ratio)

        def block(heads):
            return {
                "norm1": d.norm(e), "norm2": d.norm(e),
                "attn": {"qkv": d.lin(e, 3 * e, bias=False), "q_bias": d.zeros((e,)),
                         "v_bias": d.zeros((e,)), "proj": d.lin(e, e),
                         "logit_scale": d.full((heads, 1, 1), math.log(10.0)),
                         "cpb_mlp": {"0": d.lin(2, 512), "2": d.lin(512, heads, bias=False)}},
                "mlp": {"fc1": d.lin(e, hidden), "fc2": d.lin(hidden, e)},
            }

        layers = {str(li): {"residual_group": {"blocks": {str(bi): block(cfg.num_heads[li])
                                                          for bi in range(depth)}},
                            "conv": d.conv(e, e)}
                  for li, depth in enumerate(cfg.depths)}
        params = {"conv_first": d.conv(cfg.in_chans, e), "patch_embed": {"norm": d.norm(e)},
                  "layers": layers, "norm": d.norm(e), "conv_after_body": d.conv(e, e)}
        r, nf = cfg.upscale, cfg.num_feat
        if cfg.upsampler in ("pixelshuffle", "pixelshuffle_aux"):
            params["conv_before_upsample"] = {"0": d.conv(e, nf)}
            params["upsample"] = {str(s * 2): d.conv(nf, 4 * nf) for s in range(int(math.log2(r)))}
            params["conv_last"] = d.conv(nf, cfg.out_chans)
            if cfg.upsampler == "pixelshuffle_aux":
                params["conv_bicubic"] = d.conv(cfg.in_chans, nf)
                params["conv_aux"] = d.conv(nf, cfg.out_chans)
                params["conv_after_aux"] = {"0": d.conv(cfg.out_chans, nf)}
        elif cfg.upsampler == "pixelshuffledirect":
            params["upsample"] = {"0": d.conv(e, cfg.out_chans * r * r)}
        else:
            params["conv_before_upsample"] = {"0": d.conv(e, nf)}
            params["conv_up1"] = d.conv(nf, nf)
            if r >= 4:
                params["conv_up2"] = d.conv(nf, nf)
            params["conv_hr"] = d.conv(nf, nf)
            params["conv_last"] = d.conv(nf, cfg.out_chans)
        return params


def detect_swin2sr_config(flat: Dict[str, torch.Tensor]) -> Optional[Swin2SRConfig]:
    """Swin2SR detection: SwinIR's layout plus the SwinV2 logit_scale
    (Swin2SR.py:855-1010)."""
    if "layers.0.residual_group.blocks.0.attn.logit_scale" not in flat:
        return None
    keys = flat.keys()
    if "conv_before_upsample.0.weight" in keys:
        if "conv_aux.weight" in keys:
            upsampler = "pixelshuffle_aux"
        elif "conv_up1.weight" in keys:
            upsampler = "nearest+conv"
        else:
            upsampler = "pixelshuffle"
    elif "upsample.0.weight" in keys:
        upsampler = "pixelshuffledirect"
    else:
        upsampler = "pixelshuffle"
    num_feat = (flat["conv_before_upsample.0.weight"].shape[0]
                if "conv_before_upsample.0.weight" in keys else 64)
    embed_dim, in_chans = flat["conv_first.weight"].shape[:2]
    out_chans = flat["conv_last.weight"].shape[0] if "conv_last.weight" in keys else in_chans
    upscale = 1
    if upsampler in ("pixelshuffle", "pixelshuffle_aux"):
        for k in keys:
            if "upsample" in k and "conv" not in k and "bias" not in k and "aux" not in k:
                upscale *= int(math.sqrt(flat[k].shape[0] // num_feat))
    elif upsampler == "nearest+conv":
        upscale = 2 ** len([k for k in keys if "conv_up" in k and "bias" not in k])
    else:
        upscale = int(math.sqrt(flat["upsample.0.bias"].shape[0] // out_chans))
    max_layer, max_block = layer_block_extent(keys)
    heads_n = flat["layers.0.residual_group.blocks.0.attn.logit_scale"].shape[0]
    mlp_ratio = float(flat["layers.0.residual_group.blocks.0.mlp.fc1.bias"].shape[0] / embed_dim)
    # the window is not stored: read it from a relative_position_index
    # buffer when the file keeps one, else the official default 8
    window_size = 8
    for k in keys:
        if k.endswith("attn.relative_position_index"):
            window_size = math.isqrt(int(math.isqrt(int(flat[k].numel()))))
            break
    return Swin2SRConfig(embed_dim=int(embed_dim), depths=(max_block + 1,) * (max_layer + 1),
                         num_heads=(heads_n,) * (max_layer + 1), window_size=window_size,
                         mlp_ratio=mlp_ratio, upsampler=upsampler, upscale=max(upscale, 1),
                         num_feat=num_feat, in_chans=int(in_chans), out_chans=out_chans)


def load_swin2sr(path, device=None):
    """A Swin2SR checkpoint -> (Swin2SR, params on ``device``, default the card)."""
    from stable_renderer_tpu_torch.models.upscale import read_upscale_state, to_params

    flat = read_upscale_state(path)
    cfg = detect_swin2sr_config(flat)
    if cfg is None:
        raise ValueError(f"{path} is not a Swin2SR checkpoint")
    flat = {k: v for k, v in flat.items()
            if not (k.endswith("relative_position_index") or k.endswith("relative_coords_table")
                    or k.endswith("attn_mask"))}
    return Swin2SR(cfg), to_params(flat, device)
