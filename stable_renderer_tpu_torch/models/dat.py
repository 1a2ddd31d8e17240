"""DAT: Dual Aggregation Transformer super-resolution.

Counterpart of stable_renderer_tpu/models/dat.py (reference chainner DAT.py:
SpatialGate/SGFN :43-111, DynamicPosBias :114-153, Spatial_Attention
:156-290, Adaptive_Spatial_Attention :293-575, Adaptive_Channel_Attention
:578-681, DATB/ResidualGroup :682-847, assembly and detection :897-1182).
Functional PyTorch over NHWC.

Residual groups alternate DSTB (rectangle-window spatial attention over the
two channel halves, with the dynamic relative position bias) and DCTB
(XCiT-style channel attention), each fused with a depthwise-conv branch by
the Adaptive Interaction Module. Shift masks and coordinate tables are host
numpy.
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
    dwconv,
    layer_block_extent,
    pixel_shuffle,
    table,
)
from stable_renderer_tpu_torch.models.upscale import batch_norm as _bn


@dataclass(frozen=True)
class DATConfig:
    embed_dim: int = 180
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (2, 2, 2, 2)
    split_size: Tuple[int, int] = (2, 4)
    expansion_factor: float = 4.0
    upsampler: str = "pixelshuffle"  # or 'pixelshuffledirect'
    upscale: int = 2
    num_feat: int = 64
    img_range: float = 1.0
    in_chans: int = 3
    out_chans: int = 3
    resi_connection: str = "1conv"


TINY_DAT_CONFIG = DATConfig(embed_dim=16, depths=(2,), num_heads=(2,), split_size=(2, 4),
                            expansion_factor=2.0, upsampler="pixelshuffledirect", upscale=2,
                            num_feat=16)


def _dwconv_bn_gelu(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Sequential(dw Conv2d, BatchNorm2d, GELU): the conv branch."""
    return F.gelu(_bn(p["1"], dwconv(p["0"], x)))


def _channel_interaction(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Sequential(AdaptiveAvgPool, 1x1, BN, GELU, 1x1) -> a (B, 1, 1, C) map."""
    h = conv2d(p["1"], x.mean(dim=(1, 2), keepdim=True))
    return conv2d(p["4"], F.gelu(_bn(p["2"], h)))


def _spatial_interaction(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Sequential(1x1, BN, GELU, 1x1) -> a (B, H, W, 1) map."""
    return conv2d(p["3"], F.gelu(_bn(p["1"], conv2d(p["0"], x))))


def _spatial_gate(p: dict, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """SpatialGate (DAT.py:43-68): x (B, N, C) -> (B, N, C/2)."""
    c = x.shape[-1]
    x1, x2 = x[..., : c // 2], x[..., c // 2:]
    img = dwconv(p["conv"], layer_norm(p["norm"], x2).reshape(x.shape[0], h, w, c // 2))
    return x1 * img.reshape(x.shape[0], h * w, c // 2)


def _sgfn(p: dict, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return linear(p["fc2"], _spatial_gate(p["sg"], F.gelu(linear(p["fc1"], x)), h, w))


def _dyn_pos_bias(p: dict, biases: torch.Tensor) -> torch.Tensor:
    """DynamicPosBias, the non-residual path (DAT.py:145-153)."""
    pos = linear(p["pos_proj"], biases)
    for name in ("pos1", "pos2", "pos3"):
        pos = linear(p[name]["2"], torch.relu(layer_norm(p[name]["0"], pos)))
    return pos


def _rect_mask(h: int, w: int, hsp: int, wsp: int, sh: int, sw: int) -> np.ndarray:
    """The shift mask of rectangle windows (calculate_mask, DAT.py:395-468)."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -hsp), slice(-hsp, -sh), slice(-sh, None)):
        for wsl in (slice(0, -wsp), slice(-wsp, -sw), slice(-sw, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(h // hsp, hsp, w // wsp, wsp).transpose(0, 2, 1, 3).reshape(-1, hsp * wsp)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _rect_rel_index(hsp: int, wsp: int) -> np.ndarray:
    ch = np.stack(np.meshgrid(np.arange(hsp), np.arange(wsp), indexing="ij")).reshape(2, -1)
    rel = (ch[:, :, None] - ch[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += hsp - 1
    rel[:, :, 1] += wsp - 1
    rel[:, :, 0] *= 2 * wsp - 1
    return rel.sum(-1).reshape(-1)


def _spatial_attention(p: dict, q, k, v, h: int, w: int, hsp: int, wsp: int,
                       heads: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Rectangle-window attention with the dynamic position bias
    (Spatial_Attention.forward, DAT.py:239-290). q, k, v: (B, H*W, C)."""
    b, _, c = q.shape
    d = c // heads
    n = hsp * wsp

    def win(t):
        t = t.reshape(b, h // hsp, hsp, w // wsp, wsp, c).permute(0, 1, 3, 2, 4, 5)
        return t.reshape(-1, n, heads, d).permute(0, 2, 1, 3)

    attn = torch.einsum("whnd,whmd->whnm", win(q) * (d ** -0.5), win(k))
    # the dynamic relative position bias over the (2H-1)x(2W-1) coordinate table
    coords = table(("dat_coords", hsp, wsp), lambda: np.stack(np.meshgrid(
        np.arange(1 - hsp, hsp), np.arange(1 - wsp, wsp), indexing="ij")).reshape(2, -1).T.astype(
        np.float32), q.device)
    pos = _dyn_pos_bias(p["pos"], coords)  # (T, heads)
    idx = table(("dat_rel", hsp, wsp), lambda: _rect_rel_index(hsp, wsp), q.device)
    rpb = pos[idx].reshape(n, n, heads).permute(2, 0, 1)
    attn = attn + rpb[None].to(attn.dtype)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(-1, nw, heads, n, n) + mask[None, :, None]
        attn = attn.reshape(-1, heads, n, n)
    out = torch.einsum("whnm,whmd->whnd", torch.softmax(attn, dim=-1), win(v))
    out = out.permute(0, 2, 1, 3).reshape(b, h // hsp, w // wsp, hsp, wsp, c)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _adaptive_spatial_attention(p: dict, x: torch.Tensor, h: int, w: int, heads: int,
                                split: Tuple[int, int], do_shift: bool) -> torch.Tensor:
    """The DSTB's attention (DAT.py:473-575). x: (B, H*W, C)."""
    b, l, c = x.shape
    shift = (split[0] // 2, split[1] // 2)
    qkv = linear(p["qkv"], x).reshape(b, l, 3, c).permute(2, 0, 1, 3)
    q, k, v = qkv[0], qkv[1], qkv[2]
    v_img = v.reshape(b, h, w, c)

    mx = max(split)
    ph, pw = (mx - h % mx) % mx, (mx - w % mx) % mx
    hh, ww = h + ph, w + pw

    def pad_img(t):
        return F.pad(t.reshape(b, h, w, c), (0, 0, 0, pw, 0, ph))

    qi, ki, vi = pad_img(q), pad_img(k), pad_img(v)
    half = c // 2
    branches = ((p["attns"]["0"], slice(0, half), split[0], split[1], shift),
                (p["attns"]["1"], slice(half, c), split[1], split[0], shift[::-1]))
    outs = []
    for bp, chans, hsp, wsp, sft in branches:
        ts = [t[..., chans] for t in (qi, ki, vi)]
        mask = None
        if do_shift:
            ts = [torch.roll(t, (-sft[0], -sft[1]), dims=(1, 2)) for t in ts]
            mask = table(("dat_mask", hh, ww, hsp, wsp, sft),
                         lambda: _rect_mask(hh, ww, hsp, wsp, sft[0], sft[1]), x.device)
        o = _spatial_attention(bp, *(t.reshape(b, hh * ww, half) for t in ts), hh, ww, hsp, wsp,
                               heads // 2, mask)
        if do_shift:
            o = torch.roll(o, (sft[0], sft[1]), dims=(1, 2))
        outs.append(o[:, :h, :w])
    attened = torch.cat(outs, -1).reshape(b, l, c)

    # the Adaptive Interaction Module
    conv_x = _dwconv_bn_gelu(p["dwconv"], v_img)
    channel_map = _channel_interaction(p["channel_interaction"], conv_x)
    spatial_map = _spatial_interaction(p["spatial_interaction"], attened.reshape(b, h, w, c))
    attened = attened * torch.sigmoid(channel_map.reshape(b, 1, c))
    conv_x = conv_x * torch.sigmoid(spatial_map)
    return linear(p["proj"], attened + conv_x.reshape(b, l, c))


def _adaptive_channel_attention(p: dict, x: torch.Tensor, h: int, w: int,
                                heads: int) -> torch.Tensor:
    """The DCTB's attention (DAT.py:627-681): XCiT channel attention and the AIM."""
    b, n, c = x.shape
    d = c // heads
    qkv = linear(p["qkv"], x).reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    # channels attend over channels: (B, heads, d, N)
    qt, kt, vt = (t.transpose(-1, -2) for t in (qkv[0], qkv[1], qkv[2]))
    attn = torch.einsum("bhcn,bhdn->bhcd", F.normalize(qt, dim=-1), F.normalize(kt, dim=-1))
    attn = torch.softmax(attn * p["temperature"].to(attn.dtype), dim=-1)
    out = torch.einsum("bhcd,bhdn->bhcn", attn, vt)  # (B, heads, d, N)
    attened = out.permute(0, 3, 1, 2).reshape(b, n, c)

    v_img = vt.reshape(b, c, n).permute(0, 2, 1).reshape(b, h, w, c)
    conv_x = _dwconv_bn_gelu(p["dwconv"], v_img)
    channel_map = _channel_interaction(p["channel_interaction"], attened.reshape(b, h, w, c))
    spatial_map = _spatial_interaction(p["spatial_interaction"], conv_x)
    attened = attened * torch.sigmoid(spatial_map.reshape(b, n, 1))
    conv_x = conv_x * torch.sigmoid(channel_map)
    return linear(p["proj"], attened + conv_x.reshape(b, n, c))


def _do_shift(rg_idx: int, b_idx: int) -> bool:
    """The reference's shift cadence (DAT.py:363-366 / :501-503)."""
    return ((rg_idx % 2 == 0 and b_idx > 0 and (b_idx - 2) % 4 == 0)
            or (rg_idx % 2 != 0 and b_idx % 4 == 0))


class DAT:
    def __init__(self, config: DATConfig = DATConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return self.config.upscale

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, h, w, _ = x.shape
        if cfg.in_chans == 3:
            mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
        else:
            mean = torch.zeros((x.shape[-1],), dtype=x.dtype, device=x.device)
        feat = conv2d(params["conv_first"], (x - mean) * cfg.img_range, padding=1)

        t = layer_norm(params["before_RG"]["1"], feat.reshape(b, h * w, cfg.embed_dim))
        for rg, depth in enumerate(cfg.depths):
            lp = params["layers"][str(rg)]
            res = t
            for bi in range(depth):
                bp = lp["blocks"][str(bi)]
                n1 = layer_norm(bp["norm1"], t)
                if bi % 2 == 0:  # DSTB
                    a = _adaptive_spatial_attention(bp["attn"], n1, h, w, cfg.num_heads[rg],
                                                    cfg.split_size, _do_shift(rg, bi))
                else:  # DCTB
                    a = _adaptive_channel_attention(bp["attn"], n1, h, w, cfg.num_heads[rg])
                t = t + a
                t = t + _sgfn(bp["ffn"], layer_norm(bp["norm2"], t), h, w)
            timg = t.reshape(b, h, w, cfg.embed_dim)
            if cfg.resi_connection == "3conv":
                timg = F.leaky_relu(conv2d(lp["conv"]["0"], timg, padding=1), 0.2)
                timg = F.leaky_relu(conv2d(lp["conv"]["2"], timg), 0.2)
                timg = conv2d(lp["conv"]["4"], timg, padding=1)
            else:
                timg = conv2d(lp["conv"], timg, padding=1)
            t = res + timg.reshape(b, h * w, cfg.embed_dim)
        deep = layer_norm(params["norm"], t).reshape(b, h, w, cfg.embed_dim)

        feat = conv2d(params["conv_after_body"], deep, padding=1) + feat
        if cfg.upsampler == "pixelshuffle":
            up = F.leaky_relu(conv2d(params["conv_before_upsample"]["0"], feat, padding=1), 0.01)
            for s in range(int(math.log2(cfg.upscale))):
                up = pixel_shuffle(conv2d(params["upsample"][str(s * 2)], up, padding=1), 2)
            out = conv2d(params["conv_last"], up, padding=1)
        else:  # pixelshuffledirect
            out = pixel_shuffle(conv2d(params["upsample"]["0"], feat, padding=1), cfg.upscale)
        return out / cfg.img_range + mean[: out.shape[-1]]

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        cfg = self.config
        d = Draws(generator, dtype, device)
        e = cfg.embed_dim

        def aim(c):
            c8, c16 = max(c // 8, 1), max(c // 16, 1)
            return {
                "dwconv": {"0": d.dconv(c), "1": d.bn(c)},
                "channel_interaction": {"1": d.conv(c, c8, 1), "2": d.bn(c8),
                                        "4": d.conv(c8, c, 1)},
                "spatial_interaction": {"0": d.conv(c, c16, 1), "1": d.bn(c16),
                                        "3": d.conv(c16, 1, 1)},
            }

        def pos_block(c_half, heads):
            pd = max(c_half // 4, 4)
            return {"pos_proj": d.lin(2, pd),
                    "pos1": {"0": d.norm(pd), "2": d.lin(pd, pd)},
                    "pos2": {"0": d.norm(pd), "2": d.lin(pd, pd)},
                    "pos3": {"0": d.norm(pd), "2": d.lin(pd, heads)}}

        def block(bi, heads):
            hidden = int(e * cfg.expansion_factor)
            if bi % 2 == 0:
                attn = {"qkv": d.lin(e, 3 * e), "proj": d.lin(e, e),
                        "attns": {"0": {"pos": pos_block(e // 2, heads // 2)},
                                  "1": {"pos": pos_block(e // 2, heads // 2)}}, **aim(e)}
            else:
                attn = {"qkv": d.lin(e, 3 * e), "proj": d.lin(e, e),
                        "temperature": d.full((heads, 1, 1), 1.0), **aim(e)}
            return {"norm1": d.norm(e), "norm2": d.norm(e), "attn": attn,
                    "ffn": {"fc1": d.lin(e, hidden),
                            "sg": {"norm": d.norm(hidden // 2), "conv": d.dconv(hidden // 2)},
                            "fc2": d.lin(hidden // 2, e)}}

        layers = {str(rg): {"blocks": {str(bi): block(bi, cfg.num_heads[rg])
                                       for bi in range(depth)},
                            "conv": d.conv(e, e)}
                  for rg, depth in enumerate(cfg.depths)}
        params = {"conv_first": d.conv(cfg.in_chans, e), "before_RG": {"1": d.norm(e)},
                  "layers": layers, "norm": d.norm(e), "conv_after_body": d.conv(e, e)}
        if cfg.upsampler == "pixelshuffle":
            params["conv_before_upsample"] = {"0": d.conv(e, cfg.num_feat)}
            params["upsample"] = {str(s * 2): d.conv(cfg.num_feat, 4 * cfg.num_feat)
                                  for s in range(int(math.log2(cfg.upscale)))}
            params["conv_last"] = d.conv(cfg.num_feat, cfg.out_chans)
        else:
            params["upsample"] = {"0": d.conv(e, cfg.out_chans * cfg.upscale ** 2)}
        return params


def detect_dat_config(flat: Dict[str, torch.Tensor]) -> Optional[DATConfig]:
    """Detect a DAT checkpoint (DAT.py:947-1035)."""
    if "layers.0.blocks.0.attn.attns.0.pos.pos_proj.weight" not in flat:
        return None
    keys = flat.keys()
    if "conv_before_upsample.0.weight" in keys:
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
    if upsampler == "pixelshuffle":
        for k in keys:
            if "upsample" in k and "conv" not in k and "bias" not in k:
                upscale *= int(math.sqrt(flat[k].shape[0] // num_feat))
    else:
        upscale = int(math.sqrt(flat["upsample.0.bias"].shape[0] // out_chans))
    max_layer, max_block = layer_block_extent(keys, r"layers.(\d+).blocks.(\d+).norm1.weight")
    depths = (max_block + 1,) * (max_layer + 1)
    if "layers.0.blocks.1.attn.temperature" in keys:
        heads_n = flat["layers.0.blocks.1.attn.temperature"].shape[0]
    else:
        heads_n = depths[0]
    split = (2, 4)
    if "layers.0.blocks.0.attn.attns.0.rpe_biases" in keys:
        last = flat["layers.0.blocks.0.attn.attns.0.rpe_biases"][-1]
        split = (int(last[0]) + 1, int(last[1]) + 1)
    return DATConfig(embed_dim=int(embed_dim), depths=depths, num_heads=(heads_n,) * len(depths),
                     split_size=split,
                     expansion_factor=float(flat["layers.0.blocks.0.ffn.fc1.weight"].shape[0]
                                            / embed_dim),
                     upsampler=upsampler, upscale=max(upscale, 1), num_feat=num_feat,
                     in_chans=int(in_chans), out_chans=int(out_chans),
                     resi_connection="3conv" if "layers.0.conv.4.weight" in keys else "1conv")


def load_dat(path, device=None):
    """A DAT checkpoint -> (DAT, params on ``device``, default the card)."""
    from stable_renderer_tpu_torch.models.upscale import read_upscale_state, to_params

    flat = read_upscale_state(path)
    cfg = detect_dat_config(flat)
    if cfg is None:
        raise ValueError(f"{path} is not a DAT checkpoint")
    flat = {k: v for k, v in flat.items()
            if not (k.endswith("relative_position_index") or k.endswith("rpe_biases")
                    or ".attn_mask" in k or k.endswith("num_batches_tracked"))}
    return DAT(cfg), to_params(flat, device)
