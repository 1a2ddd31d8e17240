"""SwinIR: window-attention transformer super-resolution and denoising.

Counterpart of stable_renderer_tpu/models/swinir.py (reference chainner
SwinIR.py: WindowAttention :83-210, SwinTransformerBlock :212-395, RSTB
:541-652, state-dict detection :820-990, forward :1140-1215). Functional
PyTorch over NHWC activations with the checkpoint's parameter names.

The relative-position index and the shifted-window mask are numpy tables
built on the host (``_rel_pos_index``, ``_shift_attn_mask``), as the JAX
package builds them at trace time. ``pixel_shuffle`` / ``pixel_unshuffle``
(NHWC, torch's channel order) are ``cascade``'s. ``Draws`` is the random-init helper
the zoo's modules share: every leaf drawn in call order from one
``torch.Generator``.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.cascade import (
    conv2d_generic,
    pixel_shuffle,
    pixel_unshuffle,
)
from stable_renderer_tpu_torch.models.layers import (
    conv2d,
    layer_norm,
    linear,
    upsample_nearest_2x,
)

RGB_MEAN = (0.4488, 0.4371, 0.4040)  # SwinIR.py:989


@dataclass(frozen=True)
class SwinIRConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6)
    window_size: int = 8
    mlp_ratio: float = 4.0
    upsampler: str = "pixelshuffle"  # '', 'pixelshuffle(direct)', 'nearest+conv'
    upscale: int = 4
    num_feat: int = 64
    img_range: float = 1.0
    in_chans: int = 3
    out_chans: int = 3
    resi_connection: str = "1conv"
    start_unshuffle: int = 1
    patch_norm: bool = True


TINY_SWINIR_CONFIG = SwinIRConfig(
    embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4,
    mlp_ratio=2.0, upsampler="pixelshuffledirect", upscale=2, num_feat=16)

# the published classical SwinIR-M x4 (001_classicalSR_DF2K_s64w8_SwinIR-M_x4)
SWINIR_M_X4_CONFIG = SwinIRConfig(
    embed_dim=180, depths=(6,) * 6, num_heads=(6,) * 6, window_size=8, mlp_ratio=2.0,
    upsampler="pixelshuffle", upscale=4, num_feat=64, resi_connection="1conv")


class Draws:
    """Random-init leaves in the checkpoint layout, drawn in call order from
    ``generator`` on ``device`` (default: the generator's), cast to
    ``dtype``: N(0, std^2) weights, zero biases, unit norms."""

    def __init__(self, generator: Optional[torch.Generator], dtype=torch.float32, device=None):
        self.generator, self.dtype = generator, dtype
        if device is None:
            device = generator.device if generator is not None else "cpu"
        self.device = torch.device(device)

    def normal(self, shape, std: float = 1.0) -> torch.Tensor:
        t = torch.randn(tuple(shape), generator=self.generator, device=self.device)
        return (t * std).to(self.dtype)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(tuple(shape), value, dtype=self.dtype, device=self.device)

    def zeros(self, shape) -> torch.Tensor:
        return self.full(shape, 0.0)

    def conv(self, i: int, o: int, k: int = 3, std: float = 0.05, bias: bool = True) -> dict:
        p = {"weight": self.normal((o, i, k, k), std)}
        if bias:
            p["bias"] = self.zeros((o,))
        return p

    def lin(self, i: int, o: int, std: float = 0.05, bias: bool = True) -> dict:
        p = {"weight": self.normal((o, i), std)}
        if bias:
            p["bias"] = self.zeros((o,))
        return p

    def dconv(self, c: int, k: int = 3, std: float = 0.05, bias: bool = True) -> dict:
        """A depthwise conv: weight (C, 1, k, k)."""
        p = {"weight": self.normal((c, 1, k, k), std)}
        if bias:
            p["bias"] = self.zeros((c,))
        return p

    def norm(self, c: int) -> dict:
        return {"weight": self.full((c,), 1.0), "bias": self.zeros((c,))}

    def bn(self, c: int) -> dict:
        return {"weight": self.full((c,), 1.0), "bias": self.zeros((c,)),
                "running_mean": self.zeros((c,)), "running_var": self.full((c,), 1.0)}


def lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of an axis of length ``n`` reflect-padded by ``pad`` at its
    end, repeating the reflection where ``pad`` >= ``n`` (numpy's and
    ``jnp.pad``'s "reflect"; torch's reflect pad needs ``pad`` < ``n``)."""
    i = torch.arange(n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    j = i % (2 * (n - 1))
    return torch.where(j >= n, 2 * (n - 1) - j, j)


def pad_reflect(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect padding at the bottom and right of an NHWC tensor."""
    if ph:
        x = x.index_select(1, _reflect_index(x.shape[1], ph, x.device))
    if pw:
        x = x.index_select(2, _reflect_index(x.shape[2], pw, x.device))
    return x


def dwconv(p: dict, x: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Depthwise conv on NHWC: weight (C, 1, k, k), groups = C."""
    return conv2d_generic(p, x, padding=padding, groups=x.shape[-1])


def _rel_pos_index(ws: int) -> np.ndarray:
    """Pairwise relative-position index (SwinIR.py:119-134), host numpy."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (ws*ws, ws*ws)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws, ws*ws) 0/-100 mask for shifted windows (calculate_mask),
    host numpy."""
    img_mask = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    mw = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


_TABLES: dict = {}


def table(key, make, device) -> torch.Tensor:
    """The host numpy table ``make()`` on ``device``, made and sent once per
    ``key`` and device (a copy to the card waits for it)."""
    t = _TABLES.get((key, device))
    if t is None:
        t = _TABLES[(key, device)] = torch.from_numpy(np.ascontiguousarray(make())).to(device)
    return t


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(win: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    c = win.shape[-1]
    x = win.reshape(-1, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def add_window_mask(attn: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """attn (nW*B, heads, N, N) plus the (nW, N, N) mask of its window."""
    bw, heads, n, _ = attn.shape
    nw = mask.shape[0]
    attn = attn.reshape(bw // nw, nw, heads, n, n) + mask[None, :, None].to(attn.dtype)
    return attn.reshape(bw, heads, n, n)


def shift_mask(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    """``_shift_attn_mask`` on ``device``."""
    return table(("shift", h, w, ws, shift), lambda: _shift_attn_mask(h, w, ws, shift), device)


def _window_attention(p: dict, x: torch.Tensor, heads: int, ws: int,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
    """W-MSA with the relative position bias (SwinIR.py:145-194).
    x: (nW*B, N, C); mask: (nW, N, N) or None."""
    bw, n, c = x.shape
    d = c // heads
    qkv = linear(p["qkv"], x).reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (d ** -0.5), qkv[1], qkv[2]
    attn = torch.einsum("bhnd,bhmd->bhnm", q, k)
    idx = table(("rel_pos", ws), lambda: _rel_pos_index(ws).reshape(-1), x.device)
    bias = p["relative_position_bias_table"][idx].reshape(n, n, heads)
    attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
    if mask is not None:
        attn = add_window_mask(attn, mask)
    attn = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
    out = out.permute(0, 2, 1, 3).reshape(bw, n, c)
    return linear(p["proj"], out)


def _swin_block(p: dict, x: torch.Tensor, hw: Tuple[int, int], heads: int,
                ws: int, shift: int) -> torch.Tensor:
    """SwinTransformerBlock (SwinIR.py:321-372). x: (B, H*W, C)."""
    h, w = hw
    b, l, c = x.shape
    shortcut = x
    xs = layer_norm(p["norm1"], x).reshape(b, h, w, c)
    mask = None
    if shift > 0:
        xs = torch.roll(xs, (-shift, -shift), dims=(1, 2))
        mask = shift_mask(h, w, ws, shift, x.device)
    win = _window_attention(p["attn"], _window_partition(xs, ws), heads, ws, mask)
    xs = _window_reverse(win, ws, h, w)
    if shift > 0:
        xs = torch.roll(xs, (shift, shift), dims=(1, 2))
    x = shortcut + xs.reshape(b, l, c)
    n2 = layer_norm(p["norm2"], x)
    return x + linear(p["mlp"]["fc2"], F.gelu(linear(p["mlp"]["fc1"], n2)))


def block_shift(bi: int, ws: int, h: int, w: int) -> int:
    """Odd blocks shift by half a window, except when the padded image is a
    single window."""
    return 0 if bi % 2 == 0 or min(h, w) <= ws else ws // 2


class SwinIR:
    def __init__(self, config: SwinIRConfig = SwinIRConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return self.config.upscale // self.config.start_unshuffle

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) in [0, 1] -> (B, scale*H, scale*W, C)."""
        cfg = self.config
        ws = cfg.window_size
        b, h_in, w_in, _ = x.shape

        if cfg.in_chans == 3 * cfg.start_unshuffle ** 2 and x.shape[-1] == 3:
            mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
        else:
            mean = torch.zeros((x.shape[-1],), dtype=x.dtype, device=x.device)
        x = (x - mean) * cfg.img_range
        if cfg.start_unshuffle > 1:
            x = pixel_unshuffle(x, cfg.start_unshuffle)

        # pad to a window multiple (check_image_size, SwinIR.py:1140-1146)
        h, w = x.shape[1], x.shape[2]
        x = pad_reflect(x, (ws - h % ws) % ws, (ws - w % ws) % ws)
        h, w = x.shape[1], x.shape[2]

        feat = conv2d(params["conv_first"], x, padding=1)

        def features(f):
            t = f.reshape(b, h * w, cfg.embed_dim)
            if cfg.patch_norm and "patch_embed" in params:
                t = layer_norm(params["patch_embed"]["norm"], t)
            for li, depth in enumerate(cfg.depths):
                lp = params["layers"][str(li)]
                r = t
                for bi in range(depth):
                    r = _swin_block(lp["residual_group"]["blocks"][str(bi)], r, (h, w),
                                    cfg.num_heads[li], ws, block_shift(bi, ws, h, w))
                rimg = r.reshape(b, h, w, cfg.embed_dim)
                if cfg.resi_connection == "3conv":
                    cpr = lp["conv"]
                    rimg = lrelu(conv2d(cpr["0"], rimg, padding=1))
                    rimg = lrelu(conv2d(cpr["2"], rimg, padding=0))
                    rimg = conv2d(cpr["4"], rimg, padding=1)
                else:
                    rimg = conv2d(lp["conv"], rimg, padding=1)
                t = rimg.reshape(b, h * w, cfg.embed_dim) + t
            t = layer_norm(params["norm"], t)
            return t.reshape(b, h, w, cfg.embed_dim)

        feat = conv2d(params["conv_after_body"], features(feat), padding=1) + feat
        if cfg.upsampler == "pixelshuffle":
            up = lrelu(conv2d(params["conv_before_upsample"]["0"], feat, padding=1))
            for s in range(int(math.log2(self.scale))):
                up = pixel_shuffle(conv2d(params["upsample"][str(s * 2)], up, padding=1), 2)
            out = conv2d(params["conv_last"], up, padding=1)
        elif cfg.upsampler == "pixelshuffledirect":
            out = pixel_shuffle(conv2d(params["upsample"]["0"], feat, padding=1), self.scale)
        elif cfg.upsampler == "nearest+conv":
            feat = lrelu(conv2d(params["conv_before_upsample"]["0"], feat, padding=1))
            feat = lrelu(conv2d(params["conv_up1"], upsample_nearest_2x(feat), padding=1))
            if self.scale >= 4:
                feat = lrelu(conv2d(params["conv_up2"], upsample_nearest_2x(feat), padding=1))
            if self.scale >= 8:
                feat = lrelu(conv2d(params["conv_up3"], upsample_nearest_2x(feat), padding=1))
            out = conv2d(params["conv_last"], lrelu(conv2d(params["conv_hr"], feat, padding=1)),
                         padding=1)
        else:  # denoise / artifact removal: residual, no upsample
            out = x + conv2d(params["conv_last"], feat, padding=1)

        out = out / cfg.img_range + mean[: out.shape[-1]]
        return out[:, : h_in * self.scale, : w_in * self.scale]

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        """Random init with the JAX package's tree and scales (N(0, 0.05^2)
        weights, N(0, 0.02^2) bias tables, zero biases)."""
        cfg = self.config
        d = Draws(generator, dtype, device)
        e, ws = cfg.embed_dim, cfg.window_size
        hidden = int(e * cfg.mlp_ratio)

        def block(heads):
            return {
                "norm1": d.norm(e), "norm2": d.norm(e),
                "attn": {"qkv": d.lin(e, 3 * e), "proj": d.lin(e, e),
                         "relative_position_bias_table": d.normal(((2 * ws - 1) ** 2, heads),
                                                                  0.02)},
                "mlp": {"fc1": d.lin(e, hidden), "fc2": d.lin(hidden, e)},
            }

        layers = {
            str(li): {"residual_group": {"blocks": {str(bi): block(cfg.num_heads[li])
                                                    for bi in range(depth)}},
                      "conv": d.conv(e, e)}
            for li, depth in enumerate(cfg.depths)
        }
        params = {"conv_first": d.conv(cfg.in_chans, e), "patch_embed": {"norm": d.norm(e)},
                  "layers": layers, "norm": d.norm(e), "conv_after_body": d.conv(e, e)}
        r = self.scale
        if cfg.upsampler == "pixelshuffle":
            params["conv_before_upsample"] = {"0": d.conv(e, cfg.num_feat)}
            params["upsample"] = {str(s * 2): d.conv(cfg.num_feat, 4 * cfg.num_feat)
                                  for s in range(int(math.log2(r)))}
            params["conv_last"] = d.conv(cfg.num_feat, cfg.out_chans)
        elif cfg.upsampler == "pixelshuffledirect":
            params["upsample"] = {"0": d.conv(e, cfg.out_chans * r * r)}
        elif cfg.upsampler == "nearest+conv":
            params["conv_before_upsample"] = {"0": d.conv(e, cfg.num_feat)}
            params["conv_up1"] = d.conv(cfg.num_feat, cfg.num_feat)
            if r >= 4:
                params["conv_up2"] = d.conv(cfg.num_feat, cfg.num_feat)
            if r >= 8:
                params["conv_up3"] = d.conv(cfg.num_feat, cfg.num_feat)
            params["conv_hr"] = d.conv(cfg.num_feat, cfg.num_feat)
            params["conv_last"] = d.conv(cfg.num_feat, cfg.out_chans)
        else:
            params["conv_last"] = d.conv(e, cfg.out_chans)
        return params


def detect_swinir_config(flat: Dict[str, torch.Tensor]) -> Optional[SwinIRConfig]:
    """Detect a SwinIR checkpoint's layout (SwinIR.py:820-990)."""
    if "layers.0.residual_group.blocks.0.norm1.weight" not in flat:
        return None
    keys = flat.keys()
    if "conv_before_upsample.0.weight" in keys:
        upsampler = "nearest+conv" if "conv_up1.weight" in keys else "pixelshuffle"
    elif "upsample.0.weight" in keys:
        upsampler = "pixelshuffledirect"
    else:
        upsampler = ""
    num_feat = (flat["conv_before_upsample.0.weight"].shape[0]
                if "conv_before_upsample.0.weight" in keys else 64)
    start_unshuffle = 1
    if "conv_first.1.weight" in keys:  # pixel-unshuffled realSR variants
        start_unshuffle = round(math.sqrt(flat["conv_first.1.weight"].shape[1] // 3))
    conv_first_w = flat.get("conv_first.weight", flat.get("conv_first.1.weight"))
    in_chans, embed_dim = conv_first_w.shape[1], conv_first_w.shape[0]
    out_chans = flat["conv_last.weight"].shape[0] if "conv_last.weight" in keys else in_chans
    upscale = 1
    if upsampler == "nearest+conv":
        upscale = 2 ** len([k for k in keys if "conv_up" in k and "bias" not in k])
    elif upsampler == "pixelshuffle":
        for k in keys:
            if "upsample" in k and "conv" not in k and "bias" not in k:
                upscale *= int(math.sqrt(flat[k].shape[0] // num_feat))
    elif upsampler == "pixelshuffledirect":
        upscale = int(math.sqrt(flat["upsample.0.bias"].shape[0] // out_chans))
    max_layer, max_block = layer_block_extent(keys)
    depths = tuple(max_block + 1 for _ in range(max_layer + 1))
    bias_table = flat["layers.0.residual_group.blocks.0.attn.relative_position_bias_table"]
    heads = tuple(bias_table.shape[-1] for _ in range(max_layer + 1))
    mlp_ratio = float(flat["layers.0.residual_group.blocks.0.mlp.fc1.bias"].shape[0] / embed_dim)
    resi = "3conv" if "layers.0.conv.4.weight" in keys else "1conv"
    window_size = (math.isqrt(int(bias_table.shape[0])) + 1) // 2  # (2w-1)^2 rows
    return SwinIRConfig(
        embed_dim=embed_dim, depths=depths, num_heads=heads, window_size=window_size,
        mlp_ratio=mlp_ratio, upsampler=upsampler, upscale=max(upscale, 1), num_feat=num_feat,
        img_range=255.0 if window_size == 7 else 1.0, in_chans=in_chans, out_chans=out_chans,
        resi_connection=resi, start_unshuffle=start_unshuffle,
        patch_norm="patch_embed.norm.weight" in keys)


def layer_block_extent(keys, pattern=r"layers.(\d+).residual_group.blocks.(\d+).norm1.weight"):
    """The largest layer and block indices named by ``pattern``'s keys."""
    max_layer = max_block = 0
    for k in keys:
        mt = re.match(pattern, k)
        if mt:
            max_layer = max(max_layer, int(mt.group(1)))
            max_block = max(max_block, int(mt.group(2)))
    return max_layer, max_block


def load_swinir(path, device=None):
    """A SwinIR checkpoint -> (SwinIR, params on ``device``, default the card)."""
    from stable_renderer_tpu_torch.models.upscale import read_upscale_state, to_params

    flat = read_upscale_state(path)
    cfg = detect_swinir_config(flat)
    if cfg is None:
        raise ValueError(f"{path} is not a SwinIR checkpoint")
    if "conv_first.1.weight" in flat:
        flat["conv_first.weight"] = flat.pop("conv_first.1.weight")
        flat["conv_first.bias"] = flat.pop("conv_first.1.bias")
    flat = {k: v for k, v in flat.items()
            if not (k.endswith("relative_position_index") or k.endswith("attn_mask"))}
    return SwinIR(cfg), to_params(flat, device)
