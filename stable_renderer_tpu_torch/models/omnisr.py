"""OmniSR: omni-axis (spatial and channel, block and grid) attention SR.

Counterpart of stable_renderer_tpu/models/omnisr.py (reference chainner
OmniSR/: OSA.py MBConv :129-196, window/grid Attention :199-290,
Channel_Attention(_grid) :377-496, OSA_Block :497-577; OSAG.py :20-61 with
ESA, esa.py:27-57; OmniSR.py assembly and detection :23-135). Functional
PyTorch over NHWC, the OSA_Block Sequential indices kept.

One OSA block: MBConv -> block-window attention -> gated dwconv FFN ->
windowed channel attention -> FFN -> grid attention (dilated windows) ->
FFN -> grid channel attention -> FFN, each a pre-norm residual. ESA's max
pool is ``F.max_pool2d(7, 3)`` (JAX's VALID ``reduce_window``) and its
upsample JAX's bilinear resize (``clip_vision.resize_linear``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.clip_vision import resize_linear
from stable_renderer_tpu_torch.models.layers import conv2d, layer_norm
from stable_renderer_tpu_torch.models.swinir import (
    Draws,
    dwconv,
    pixel_shuffle,
    table,
)


@dataclass(frozen=True)
class OmniSRConfig:
    num_feat: int = 64
    res_num: int = 5
    block_num: int = 1
    window_size: int = 8
    up_scale: int = 4
    in_ch: int = 3
    with_pe: bool = True


TINY_OMNISR_CONFIG = OmniSRConfig(num_feat=16, res_num=1, window_size=4, up_scale=2)


def _mbconv(p: dict, x: torch.Tensor) -> torch.Tensor:
    """MBConv, expansion rate 1, with squeeze-excite; residual (OSA.py:129-196)."""
    net = p["net"]
    h = F.gelu(dwconv(net["2"], F.gelu(conv2d(net["0"], x))))
    g = h.mean(dim=(1, 2))
    g = F.silu(g @ net["4"]["gate"]["1"]["weight"].to(g.dtype).T)
    g = torch.sigmoid(g @ net["4"]["gate"]["3"]["weight"].to(g.dtype).T)
    return conv2d(net["5"], h * g[:, None, None, :]) + x


def _rel_pos_indices(ws: int) -> np.ndarray:
    pos = np.arange(ws)
    grid = np.stack(np.meshgrid(pos, pos, indexing="ij")).reshape(2, -1).T
    rel = grid[:, None, :] - grid[None, :, :] + ws - 1
    return (rel * np.array([2 * ws - 1, 1])).sum(-1)


def _window_attention(p: dict, x: torch.Tensor, heads: int, ws: int,
                      with_pe: bool) -> torch.Tensor:
    """Token attention in windows over (nW*B, N, C) (OSA.py:199-290)."""
    b, n, c = x.shape
    d = c // heads
    q, k, v = (x @ p["to_qkv"]["weight"].to(x.dtype).T).chunk(3, dim=-1)

    def h_of(t):
        return t.reshape(b, n, heads, d).permute(0, 2, 1, 3)

    sim = torch.einsum("bhnd,bhmd->bhnm", h_of(q) * (d ** -0.5), h_of(k))
    if with_pe:
        idx = table(("omnisr_rel", ws), lambda: _rel_pos_indices(ws), x.device)
        sim = sim + p["rel_pos_bias"]["weight"][idx].permute(2, 0, 1)[None].to(sim.dtype)
    out = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(sim, dim=-1), h_of(v))
    out = out.permute(0, 2, 1, 3).reshape(b, n, c)
    return out @ p["to_out"]["0"]["weight"].to(out.dtype).T


def _block_partition(x: torch.Tensor, ws: int, grid: bool) -> torch.Tensor:
    """Block windows (x w1)(y w2); grid windows (w1 x)(w2 y)."""
    b, h, w, c = x.shape
    if grid:
        t = x.reshape(b, ws, h // ws, ws, w // ws, c).permute(0, 2, 4, 1, 3, 5)
    else:
        t = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, ws * ws, c)


def _block_reverse(t: torch.Tensor, ws: int, h: int, w: int, grid: bool) -> torch.Tensor:
    c = t.shape[-1]
    t = t.reshape(-1, h // ws, w // ws, ws, ws, c)
    t = t.permute(0, 3, 1, 4, 2, 5) if grid else t.permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, h, w, c)


def _channel_attention(p: dict, x: torch.Tensor, heads: int, ws: int,
                       grid: bool) -> torch.Tensor:
    """Channel attention in windows (OSA.py:377-496)."""
    b, h, w, c = x.shape
    d = c // heads
    q, k, v = dwconv(p["qkv_dwconv"], conv2d(p["qkv"], x)).chunk(3, dim=-1)

    def part(t):
        win = _block_partition(t, ws, grid)  # (B*nW, N, C)
        nw = win.shape[0] // b
        # (b, nW, heads, d, N): channels attend, the window's tokens contract
        return win.reshape(b, nw, ws * ws, heads, d).permute(0, 1, 3, 4, 2)

    qn, kn = F.normalize(part(q), dim=-1), F.normalize(part(k), dim=-1)
    attn = torch.einsum("bwhdn,bwhen->bwhde", qn, kn)
    attn = torch.softmax(attn * p["temperature"].to(attn.dtype), dim=-1)
    out = torch.einsum("bwhde,bwhen->bwhdn", attn, part(v))
    out = _block_reverse(out.permute(0, 1, 4, 2, 3).reshape(-1, ws * ws, c), ws, h, w, grid)
    return conv2d(p["project_out"], out)


def _gated_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The gated dwconv feed-forward (OSA.py:91-114)."""
    x1, x2 = dwconv(p["dwconv"], conv2d(p["project_in"], x)).chunk(2, dim=-1)
    return conv2d(p["project_out"], F.gelu(x1) * x2)


def _osa_block(p: dict, x: torch.Tensor, heads: int, ws: int, with_pe: bool) -> torch.Tensor:
    """OSA_Block.layer's Sequential (OSA.py:497-577). x: (B, H, W, C)."""
    b, h, w, c = x.shape
    lp = p["layer"]
    x = _mbconv(lp["0"], x)
    for attn_i, ffn_i, chan_i, ffn2_i, grid in (("2", "4", "5", "6", False),
                                                ("8", "10", "11", "12", True)):
        win = _block_partition(x, ws, grid)
        win = win + _window_attention(lp[attn_i]["fn"], layer_norm(lp[attn_i]["norm"], win),
                                      heads, ws, with_pe)
        x = _block_reverse(win, ws, h, w, grid)
        x = x + _gated_ffn(lp[ffn_i]["fn"], layer_norm(lp[ffn_i]["norm"], x))
        x = x + _channel_attention(lp[chan_i]["fn"], layer_norm(lp[chan_i]["norm"], x), heads,
                                   ws, grid)
        x = x + _gated_ffn(lp[ffn2_i]["fn"], layer_norm(lp[ffn2_i]["norm"], x))
    return x


def _esa(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Enhanced Spatial Attention (esa.py:27-57)."""
    b, h, w, c = x.shape
    c1_ = conv2d(p["conv1"], x)
    c1 = conv2d(p["conv2"], c1_, stride=2, padding=0)
    vmax = F.max_pool2d(c1.permute(0, 3, 1, 2), kernel_size=7, stride=3).permute(0, 2, 3, 1)
    c3 = resize_linear(conv2d(p["conv3"], vmax, padding=1), h, w)
    return x * torch.sigmoid(conv2d(p["conv4"], c3 + conv2d(p["conv_f"], c1_)))


class OmniSR:
    def __init__(self, config: OmniSRConfig = OmniSRConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return self.config.up_scale

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        ws, s = cfg.window_size, cfg.up_scale
        b, h_in, w_in, _ = x.shape
        ph, pw = (ws - h_in % ws) % ws, (ws - w_in % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        residual = conv2d(params["input"], x, padding=1)
        out = residual
        for i in range(cfg.res_num):
            gp = params["residual_layer"][str(i)]
            g = out
            for j in range(cfg.block_num):
                g = _osa_block(gp["residual_layer"][str(j)], g, 4, ws, cfg.with_pe)
            g = conv2d(gp["residual_layer"][str(cfg.block_num)], g) + out
            out = _esa(gp["esa"], g)
        out = conv2d(params["output"], out, padding=1) + residual
        out = pixel_shuffle(conv2d(params["up"]["0"], out, padding=1), s)
        return out[:, : h_in * s, : w_in * s]

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        cfg = self.config
        d = Draws(generator, dtype, device)
        c, ws = cfg.num_feat, cfg.window_size

        def mbconv():
            sq = max(int(c * 0.25), 1)  # expansion rate 1: hidden = c
            return {"net": {"0": d.conv(c, c, 1), "2": d.dconv(c),
                            "4": {"gate": {"1": d.lin(c, sq, bias=False),
                                           "3": d.lin(sq, c, bias=False)}},
                            "5": d.conv(c, c, 1)}}

        def attn():
            return {"to_qkv": d.lin(c, 3 * c, bias=False), "to_out": {"0": d.lin(c, c, bias=False)},
                    "rel_pos_bias": {"weight": d.normal(((2 * ws - 1) ** 2, 4), 0.02)}}

        def chan_attn():
            return {"temperature": d.full((4, 1, 1), 1.0), "qkv": d.conv(c, 3 * c, 1, bias=False),
                    "qkv_dwconv": d.dconv(3 * c, bias=False),
                    "project_out": d.conv(c, c, 1, bias=False)}

        def gffn():
            return {"project_in": d.conv(c, 2 * c, 1, bias=False),
                    "dwconv": d.dconv(2 * c, bias=False),
                    "project_out": d.conv(c, c, 1, bias=False)}

        def osa():
            return {"layer": {"0": mbconv(),
                              "2": {"norm": d.norm(c), "fn": attn()},
                              "4": {"norm": d.norm(c), "fn": gffn()},
                              "5": {"norm": d.norm(c), "fn": chan_attn()},
                              "6": {"norm": d.norm(c), "fn": gffn()},
                              "8": {"norm": d.norm(c), "fn": attn()},
                              "10": {"norm": d.norm(c), "fn": gffn()},
                              "11": {"norm": d.norm(c), "fn": chan_attn()},
                              "12": {"norm": d.norm(c), "fn": gffn()}}}

        esa_c = max(c // 4, 16)

        def osag():
            rl = {str(j): osa() for j in range(cfg.block_num)}
            rl[str(cfg.block_num)] = d.conv(c, c, 1)
            return {"residual_layer": rl,
                    "esa": {"conv1": d.conv(c, esa_c, 1), "conv_f": d.conv(esa_c, esa_c, 1),
                            "conv2": d.conv(esa_c, esa_c), "conv3": d.conv(esa_c, esa_c),
                            "conv4": d.conv(esa_c, c, 1)}}

        return {"input": d.conv(cfg.in_ch, c),
                "residual_layer": {str(i): osag() for i in range(cfg.res_num)},
                "output": d.conv(c, c),
                "up": {"0": d.conv(c, cfg.in_ch * cfg.up_scale ** 2, bias=False)}}


def detect_omnisr_config(flat: Dict[str, torch.Tensor]) -> Optional[OmniSRConfig]:
    if "input.weight" not in flat or "up.0.weight" not in flat:
        return None
    if not any(k.startswith("residual_layer.0.residual_layer.0.layer.") for k in flat):
        return None
    num_feat, in_ch = flat["input.weight"].shape[:2]
    res_num = 1 + max(int(k.split(".")[1]) for k in flat if k.startswith("residual_layer."))
    pe_key = "residual_layer.0.residual_layer.0.layer.2.fn.rel_pos_bias.weight"
    if pe_key in flat:
        window_size, with_pe = int((math.sqrt(flat[pe_key].shape[0]) + 1) / 2), True
    else:
        window_size, with_pe = 8, False
    # inner indices are 0..block_num-1 (OSA blocks) and block_num (the 1x1 conv)
    block_num = max(int(k.split(".")[3]) for k in flat
                    if k.startswith("residual_layer.0.residual_layer."))
    return OmniSRConfig(num_feat=int(num_feat), res_num=res_num, block_num=max(block_num, 1),
                        window_size=window_size,
                        up_scale=int(math.sqrt(flat["up.0.weight"].shape[0] / in_ch)),
                        in_ch=int(in_ch), with_pe=with_pe)


def load_omnisr(path, device=None):
    """An OmniSR checkpoint -> (OmniSR, params on ``device``, default the card)."""
    from stable_renderer_tpu_torch.models.upscale import read_upscale_state, to_params

    flat = read_upscale_state(path)
    cfg = detect_omnisr_config(flat)
    if cfg is None:
        raise ValueError(f"{path} is not an OmniSR checkpoint")
    return OmniSR(cfg), to_params(flat, device)
