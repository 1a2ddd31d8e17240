"""HAT: Hybrid Attention Transformer super-resolution.

Counterpart of stable_renderer_tpu/models/hat.py (reference chainner HAT.py:
ChannelAttention/CAB :44-79, WindowAttention :141-232, HAB :234-364, OCAB
:405-537, RHAG :643-745, assembly and detection :847-1140, rpi tables
:1142-1188). Functional PyTorch over NHWC.

HAT is SwinIR's shifted-window attention with an RCAN channel-attention conv
branch in every block (scaled by ``conv_scale``), plus one Overlapping
Cross-Attention Block a residual group: queries over non-overlapping windows,
keys and values over larger overlapping windows (``F.unfold`` with padding).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.layers import conv2d, layer_norm, linear
from stable_renderer_tpu_torch.models.swinir import (
    RGB_MEAN,
    Draws,
    shift_mask,
    _window_attention,
    _window_partition,
    _window_reverse,
    block_shift,
    layer_block_extent,
    pad_reflect,
    pixel_shuffle,
    table,
)


@dataclass(frozen=True)
class HATConfig:
    embed_dim: int = 180
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    window_size: int = 16
    overlap_ratio: float = 0.5
    compress_ratio: int = 3
    squeeze_factor: int = 30
    conv_scale: float = 0.01
    mlp_ratio: float = 4.0
    upscale: int = 4
    num_feat: int = 64
    img_range: float = 1.0
    in_chans: int = 3
    out_chans: int = 3
    resi_connection: str = "1conv"


TINY_HAT_CONFIG = HATConfig(embed_dim=16, depths=(2,), num_heads=(2,), window_size=4,
                            overlap_ratio=0.5, compress_ratio=2, squeeze_factor=4,
                            mlp_ratio=2.0, upscale=2, num_feat=8)


def _channel_attention(p: dict, x: torch.Tensor) -> torch.Tensor:
    """RCAN channel attention (HAT.py:44-64): squeeze-excite with a sigmoid."""
    y = x.mean(dim=(1, 2), keepdim=True)
    y = torch.sigmoid(conv2d(p["3"], torch.relu(conv2d(p["1"], y))))
    return x * y


def _cab(p: dict, x: torch.Tensor) -> torch.Tensor:
    """CAB (HAT.py:66-79): conv -> GELU -> conv -> channel attention."""
    h = conv2d(p["cab"]["2"], F.gelu(conv2d(p["cab"]["0"], x, padding=1)), padding=1)
    return _channel_attention(p["cab"]["3"]["attention"], h)


def _mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], F.gelu(linear(p["fc1"], x)))


def _hab(p: dict, x: torch.Tensor, hw: Tuple[int, int], heads: int, ws: int,
         shift: int, conv_scale: float) -> torch.Tensor:
    """Hybrid Attention Block (HAT.py:312-364). x: (B, H*W, C)."""
    h, w = hw
    b, l, c = x.shape
    n1 = layer_norm(p["norm1"], x).reshape(b, h, w, c)
    conv_x = _cab(p["conv_block"], n1).reshape(b, l, c)
    xs, mask = n1, None
    if shift > 0:
        xs = torch.roll(n1, (-shift, -shift), dims=(1, 2))
        mask = shift_mask(h, w, ws, shift, x.device)
    win = _window_attention(p["attn"], _window_partition(xs, ws), heads, ws, mask)
    xs = _window_reverse(win, ws, h, w)
    if shift > 0:
        xs = torch.roll(xs, (shift, shift), dims=(1, 2))
    x = x + xs.reshape(b, l, c) + conv_x * conv_scale
    return x + _mlp(p["mlp"], layer_norm(p["norm2"], x))


def _rpi_oca(ws: int, ow: int) -> np.ndarray:
    """The OCA relative position index (HAT.py:1160-1188). The reference
    indexes its bias table with negative indices (Python-style wrap-around),
    which the modulo reproduces."""
    co = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(ow), np.arange(ow), indexing="ij")).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - ow + 1
    rel[:, :, 1] += ws - ow + 1
    rel[:, :, 0] *= ws + ow - 1
    return rel.sum(-1) % ((ws + ow - 1) ** 2)


def _extract_overlap_windows(x: torch.Tensor, ws: int, ow: int) -> torch.Tensor:
    """torch Unfold(kernel=ow, stride=ws, padding=(ow-ws)//2) on NHWC:
    (B, H, W, C) -> (B, nW, ow*ow, C), windows in row-major order."""
    b, h, w, c = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), kernel_size=ow, stride=ws, padding=(ow - ws) // 2)
    return cols.reshape(b, c, ow * ow, -1).permute(0, 3, 2, 1)


def _ocab(p: dict, x: torch.Tensor, hw: Tuple[int, int], heads: int, ws: int,
          overlap_ratio: float) -> torch.Tensor:
    """Overlapping Cross-Attention Block (HAT.py:457-537)."""
    h, w = hw
    b, l, c = x.shape
    ow = int(ws * overlap_ratio) + ws
    n1 = layer_norm(p["norm1"], x).reshape(b, h, w, c)
    qkv = linear(p["qkv"], n1)
    q, k, v = qkv[..., :c], qkv[..., c: 2 * c], qkv[..., 2 * c:]
    qw = _window_partition(q, ws)  # (B*nW, ws*ws, C)
    kw = _extract_overlap_windows(k, ws, ow).reshape(-1, ow * ow, c)
    vw = _extract_overlap_windows(v, ws, ow).reshape(-1, ow * ow, c)
    d = c // heads
    qh = qw.reshape(-1, ws * ws, heads, d).permute(0, 2, 1, 3) * (d ** -0.5)
    kh = kw.reshape(-1, ow * ow, heads, d).permute(0, 2, 1, 3)
    vh = vw.reshape(-1, ow * ow, heads, d).permute(0, 2, 1, 3)
    attn = torch.einsum("bhnd,bhmd->bhnm", qh, kh)
    idx = table(("rpi_oca", ws, ow), lambda: _rpi_oca(ws, ow).reshape(-1), x.device)
    bias = p["relative_position_bias_table"][idx].reshape(ws * ws, ow * ow, heads)
    attn = torch.softmax(attn + bias.permute(2, 0, 1)[None].to(attn.dtype), dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, vh).permute(0, 2, 1, 3).reshape(-1, ws * ws, c)
    out = _window_reverse(out, ws, h, w).reshape(b, l, c)
    x = linear(p["proj"], out) + x
    return x + _mlp(p["mlp"], layer_norm(p["norm2"], x))


class HAT:
    def __init__(self, config: HATConfig = HATConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return self.config.upscale

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        ws = cfg.window_size
        b, h_in, w_in, _ = x.shape
        if cfg.in_chans == 3:
            mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
        else:
            mean = torch.zeros((x.shape[-1],), dtype=x.dtype, device=x.device)
        x = pad_reflect((x - mean) * cfg.img_range, (ws - h_in % ws) % ws, (ws - w_in % ws) % ws)
        h, w = x.shape[1], x.shape[2]

        feat = conv2d(params["conv_first"], x, padding=1)
        t = feat.reshape(b, h * w, cfg.embed_dim)
        for rg, depth in enumerate(cfg.depths):
            lp = params["layers"][str(rg)]
            res = t
            for bi in range(depth):
                t = _hab(lp["residual_group"]["blocks"][str(bi)], t, (h, w), cfg.num_heads[rg],
                         ws, block_shift(bi, ws, h, w), cfg.conv_scale)
            t = _ocab(lp["residual_group"]["overlap_attn"], t, (h, w), cfg.num_heads[rg], ws,
                      cfg.overlap_ratio)
            timg = t.reshape(b, h, w, cfg.embed_dim)
            if cfg.resi_connection == "1conv":
                timg = conv2d(lp["conv"], timg, padding=1)
            t = res + timg.reshape(b, h * w, cfg.embed_dim)
        deep = layer_norm(params["norm"], t).reshape(b, h, w, cfg.embed_dim)

        feat = conv2d(params["conv_after_body"], deep, padding=1) + feat
        up = F.leaky_relu(conv2d(params["conv_before_upsample"]["0"], feat, padding=1), 0.01)
        for s in range(int(math.log2(cfg.upscale))):
            up = pixel_shuffle(conv2d(params["upsample"][str(s * 2)], up, padding=1), 2)
        out = conv2d(params["conv_last"], up, padding=1)
        out = out / cfg.img_range + mean[: out.shape[-1]]
        return out[:, : h_in * cfg.upscale, : w_in * cfg.upscale]

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        cfg = self.config
        d = Draws(generator, dtype, device)
        e, ws = cfg.embed_dim, cfg.window_size
        ow = int(ws * cfg.overlap_ratio) + ws
        hidden = int(e * cfg.mlp_ratio)
        sq = max(e // cfg.squeeze_factor, 1)
        cr = max(e // cfg.compress_ratio, 1)

        def hab(heads):
            return {
                "norm1": d.norm(e), "norm2": d.norm(e),
                "attn": {"qkv": d.lin(e, 3 * e), "proj": d.lin(e, e),
                         "relative_position_bias_table": d.normal(((2 * ws - 1) ** 2, heads),
                                                                  0.02)},
                "conv_block": {"cab": {"0": d.conv(e, cr), "2": d.conv(cr, e),
                                       "3": {"attention": {"1": d.conv(e, sq, 1),
                                                           "3": d.conv(sq, e, 1)}}}},
                "mlp": {"fc1": d.lin(e, hidden), "fc2": d.lin(hidden, e)},
            }

        def ocab(heads):
            return {"norm1": d.norm(e), "norm2": d.norm(e), "qkv": d.lin(e, 3 * e),
                    "proj": d.lin(e, e),
                    "relative_position_bias_table": d.normal(((ws + ow - 1) ** 2, heads), 0.02),
                    "mlp": {"fc1": d.lin(e, 2 * e), "fc2": d.lin(2 * e, e)}}

        layers = {str(rg): {"residual_group": {"blocks": {str(bi): hab(cfg.num_heads[rg])
                                                          for bi in range(depth)},
                                               "overlap_attn": ocab(cfg.num_heads[rg])},
                            "conv": d.conv(e, e)}
                  for rg, depth in enumerate(cfg.depths)}
        return {
            "conv_first": d.conv(cfg.in_chans, e), "layers": layers, "norm": d.norm(e),
            "conv_after_body": d.conv(e, e),
            "conv_before_upsample": {"0": d.conv(e, cfg.num_feat)},
            "upsample": {str(s * 2): d.conv(cfg.num_feat, 4 * cfg.num_feat)
                         for s in range(int(math.log2(cfg.upscale)))},
            "conv_last": d.conv(cfg.num_feat, cfg.out_chans),
        }


def detect_hat_config(flat: Dict[str, torch.Tensor]) -> Optional[HATConfig]:
    """Detect a HAT checkpoint (HAT.py:905-1000): the OCAB's per-group
    overlap_attn keys tell it from SwinIR."""
    if "layers.0.residual_group.overlap_attn.norm1.weight" not in flat:
        return None
    keys = flat.keys()
    embed_dim, in_chans = flat["conv_first.weight"].shape[:2]
    num_feat = (flat["conv_before_upsample.0.weight"].shape[0]
                if "conv_before_upsample.0.weight" in keys else 64)
    upscale = 1
    for k in keys:
        if "upsample" in k and "conv" not in k and "bias" not in k:
            upscale *= int(math.sqrt(flat[k].shape[0] // num_feat))
    max_layer, max_block = layer_block_extent(keys)
    sa_tab = flat["layers.0.residual_group.blocks.0.attn.relative_position_bias_table"]
    window_size = (math.isqrt(int(sa_tab.shape[0])) + 1) // 2
    # (ws + ow - 1)^2 rows -> ow; overlap_ratio = (ow - ws) / ws
    oca_tab = flat["layers.0.residual_group.overlap_attn.relative_position_bias_table"]
    ow = math.isqrt(int(oca_tab.shape[0])) + 1 - window_size
    cab0 = flat["layers.0.residual_group.blocks.0.conv_block.cab.0.weight"]
    sq_w = flat["layers.0.residual_group.blocks.0.conv_block.cab.3.attention.1.weight"]
    return HATConfig(
        embed_dim=int(embed_dim), depths=(max_block + 1,) * (max_layer + 1),
        num_heads=(sa_tab.shape[-1],) * (max_layer + 1), window_size=window_size,
        overlap_ratio=(ow - window_size) / window_size,
        compress_ratio=max(int(embed_dim) // cab0.shape[0], 1),
        squeeze_factor=max(int(embed_dim) // sq_w.shape[0], 1),
        mlp_ratio=float(flat["layers.0.residual_group.blocks.0.mlp.fc1.bias"].shape[0]
                        / embed_dim),
        upscale=max(upscale, 1), num_feat=num_feat, in_chans=int(in_chans),
        out_chans=flat["conv_last.weight"].shape[0])


def load_hat(path, device=None):
    """A HAT checkpoint -> (HAT, params on ``device``, default the card)."""
    from stable_renderer_tpu_torch.models.upscale import read_upscale_state, to_params

    flat = read_upscale_state(path)
    cfg = detect_hat_config(flat)
    if cfg is None:
        raise ValueError(f"{path} is not a HAT checkpoint")
    flat = {k: v for k, v in flat.items()
            if not (k.endswith("relative_position_index_SA")
                    or k.endswith("relative_position_index_OCA") or k.endswith("attn_mask"))}
    return HAT(cfg), to_params(flat, device)
