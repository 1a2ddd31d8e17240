"""GFPGAN (clean): blind face restoration, a UNet prior and a StyleGAN2-CSFT
decoder.

Counterpart of stable_renderer_tpu/models/gfpgan.py (reference chainner
face/gfpganv1_clean_arch.py: ResBlock :141-174, GFPGANv1Clean :177-370; and
stylegan2_clean_arch.py: ModulatedConv2d :53-140, StyleConv :146-195, ToRGB
:198-231, StyleGAN2GeneratorClean :249-453 with the CSFT SFT-half
modulation). Functional PyTorch over NHWC.

The per-sample modulated conv (the JAX package vmaps a conv over the batch)
is one grouped conv of batch x out channels, in f32. Its bilinear resamples
are JAX's ``jax.image.resize(..., "bilinear")``, which is antialiased when it
halves (``clip_vision.resize_linear``). The decoder's noise injection takes,
per layer, the checkpoint's stored noise buffer; else the caller's
``noises`` (layer index -> (B, res, res, 1)), else zeros: the randomness
is passed in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.clip_vision import resize_linear
from stable_renderer_tpu_torch.models.layers import conv2d, linear
from stable_renderer_tpu_torch.models.swinir import Draws, lrelu


def _resize_bilinear(x: torch.Tensor, scale: float) -> torch.Tensor:
    return resize_linear(x, int(x.shape[1] * scale), int(x.shape[2] * scale))


def _channels(base: int, channel_multiplier: float, narrow: float) -> Dict[str, int]:
    """The StyleGAN2 channel table (stylegan2_clean_arch.py:284-295), with
    ``base`` 512 for published checkpoints (smaller in tests)."""
    out = {str(r): int(base * narrow) for r in (4, 8, 16, 32)}
    for i, r in enumerate((64, 128, 256, 512, 1024)):
        out[str(r)] = int(base / 2 ** (i + 1) * channel_multiplier * narrow)
    return out


@dataclass(frozen=True)
class GFPGANConfig:
    out_size: int = 512
    num_style_feat: int = 512
    channel_multiplier: float = 2
    narrow: float = 1.0
    sft_half: bool = True
    different_w: bool = True
    base_channels: int = 512  # 512 for published checkpoints; small for tests

    @property
    def log_size(self) -> int:
        return int(math.log2(self.out_size))

    @property
    def num_latent(self) -> int:
        return self.log_size * 2 - 2


TINY_GFPGAN_CONFIG = GFPGANConfig(out_size=32, num_style_feat=16, channel_multiplier=2,
                                  base_channels=32)


def _modulated_conv(p: dict, x: torch.Tensor, style: torch.Tensor, demodulate: bool = True,
                    sample_mode: Optional[str] = None, eps: float = 1e-8) -> torch.Tensor:
    """ModulatedConv2d (stylegan2_clean_arch.py:102-140). x: (B, H, W, Cin),
    style: (B, num_style_feat)."""
    w = p["weight"].float()  # (1, out, in, k, k)
    s = linear(p["modulation"], style).float()  # (B, Cin)
    weight = w * s[:, None, :, None, None]  # (B, out, in, k, k)
    if demodulate:
        weight = weight * torch.rsqrt(weight.square().sum(dim=(2, 3, 4)) + eps)[:, :, None, None,
                                                                                None]
    if sample_mode == "upsample":
        x = _resize_bilinear(x, 2.0)
    elif sample_mode == "downsample":
        x = _resize_bilinear(x, 0.5)
    b, h, wd, cin = x.shape
    cout, k = weight.shape[1], weight.shape[-1]
    xg = x.float().permute(0, 3, 1, 2).reshape(1, b * cin, h, wd)
    out = F.conv2d(xg, weight.reshape(b * cout, cin, k, k), padding=k // 2, groups=b)
    return out.reshape(b, cout, h, wd).permute(0, 2, 3, 1).to(x.dtype)


def _style_conv(p: dict, x: torch.Tensor, style: torch.Tensor, noise: torch.Tensor,
                sample_mode: Optional[str]) -> torch.Tensor:
    """StyleConv (stylegan2_clean_arch.py:146-195)."""
    out = _modulated_conv(p["modulated_conv"], x, style, True, sample_mode) * (2 ** 0.5)
    out = out + p["weight"].to(out.dtype) * noise
    out = out + p["bias"].reshape(1, 1, 1, -1).to(out.dtype)  # stored (1, C, 1, 1)
    return lrelu(out)


def _to_rgb(p: dict, x: torch.Tensor, style: torch.Tensor, skip: Optional[torch.Tensor],
            upsample: bool) -> torch.Tensor:
    """ToRGB (stylegan2_clean_arch.py:198-231)."""
    out = _modulated_conv(p["modulated_conv"], x, style, demodulate=False)
    out = out + p["bias"].reshape(1, 1, 1, -1).to(out.dtype)
    if skip is not None:
        out = out + (_resize_bilinear(skip, 2.0) if upsample else skip)
    return out


def _res_block(p: dict, x: torch.Tensor, mode: str) -> torch.Tensor:
    """ResBlock with a bilinear resample (gfpganv1_clean_arch.py:141-174)."""
    scale = 0.5 if mode == "down" else 2.0
    out = _resize_bilinear(lrelu(conv2d(p["conv1"], x, padding=1)), scale)
    out = lrelu(conv2d(p["conv2"], out, padding=1))
    return out + conv2d(p["skip"], _resize_bilinear(x, scale))


class GFPGAN:
    """GFPGANv1Clean (gfpganv1_clean_arch.py:177-370): (B, S, S, 3) in
    [-1, 1] face crops -> the restored (B, S, S, 3)."""

    def __init__(self, config: GFPGANConfig = GFPGANConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return 1  # restores at the input face size

    def apply(self, params: dict, x: torch.Tensor,
              noises: Optional[Dict[int, torch.Tensor]] = None) -> torch.Tensor:
        cfg = self.config
        ls = cfg.log_size
        b = x.shape[0]

        # the UNet encoder
        feat = lrelu(conv2d(params["conv_body_first"], x))
        skips: List[torch.Tensor] = []
        for i in range(ls - 2):
            feat = _res_block(params["conv_body_down"][str(i)], feat, "down")
            skips.insert(0, feat)
        feat = lrelu(conv2d(params["final_conv"], feat, padding=1))

        # the style code (different_w: one latent a decoder layer); torch
        # flattens NCHW, channel-major
        style_code = linear(params["final_linear"], feat.permute(0, 3, 1, 2).reshape(b, -1))
        if cfg.different_w:
            latent = style_code.reshape(b, cfg.num_latent, cfg.num_style_feat)
        else:
            latent = style_code[:, None].expand(b, cfg.num_latent, style_code.shape[-1])

        # the UNet decoder -> the SFT conditions
        conditions: List[torch.Tensor] = []
        for i in range(ls - 2):
            feat = _res_block(params["conv_body_up"][str(i)], feat + skips[i], "up")
            for name in ("condition_scale", "condition_shift"):
                sp = params[name][str(i)]
                conditions.append(conv2d(sp["2"], lrelu(conv2d(sp["0"], feat, padding=1)),
                                         padding=1))

        # the StyleGAN2-CSFT decoder
        dec = params["stylegan_decoder"]

        def noise_for(layer_idx: int, res: int) -> torch.Tensor:
            shape = (b, res, res, 1)
            stored = dec.get("noises", {}).get(f"noise{layer_idx}")
            if stored is not None:
                return stored.reshape(1, *stored.shape[-2:], 1).expand(shape)
            if noises is not None:
                return noises[layer_idx]
            return torch.zeros(shape, device=x.device)

        const = dec["constant_input"]["weight"]  # (1, C, 4, 4)
        out = const.permute(0, 2, 3, 1).expand(b, 4, 4, const.shape[1])
        out = _style_conv(dec["style_conv1"], out, latent[:, 0], noise_for(0, 4), None)
        skip = _to_rgb(dec["to_rgb1"], out, latent[:, 1], None, upsample=False)

        li = 1
        for gi in range(ls - 2):
            res = 2 ** (gi + 3)
            out = _style_conv(dec["style_convs"][str(2 * gi)], out, latent[:, li],
                              noise_for(2 * gi + 1, res), "upsample")
            # SFT (the conditions may cover fewer levels; reference :118-128)
            if li < len(conditions):
                cond_scale, cond_shift = conditions[li - 1], conditions[li]
                if cfg.sft_half:
                    half = out.shape[-1] // 2
                    out = torch.cat([out[..., :half], out[..., half:] * cond_scale + cond_shift],
                                    -1)
                else:
                    out = out * cond_scale + cond_shift
            out = _style_conv(dec["style_convs"][str(2 * gi + 1)], out, latent[:, li + 1],
                              noise_for(2 * gi + 2, res), None)
            skip = _to_rgb(dec["to_rgbs"][str(gi)], out, latent[:, li + 2], skip, upsample=True)
            li += 2
        return skip

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        """Random init with the JAX package's tree and scales (stored decoder
        noises included)."""
        cfg = self.config
        d = Draws(generator, dtype, device)
        ch = _channels(cfg.base_channels, cfg.channel_multiplier, cfg.narrow)
        uch = _channels(cfg.base_channels, cfg.channel_multiplier, cfg.narrow * 0.5)
        ls, nsf = cfg.log_size, cfg.num_style_feat

        def mod_conv(i, o, k):
            return {"modulation": {"weight": d.normal((i, nsf), 0.05), "bias": d.full((i,), 1.0)},
                    "weight": d.normal((1, o, i, k, k), 1.0 / math.sqrt(i * k * k))}

        def style_conv(i, o):
            return {"modulated_conv": mod_conv(i, o, 3), "weight": d.zeros(()),
                    "bias": d.zeros((1, o, 1, 1))}

        def to_rgb(i):
            return {"modulated_conv": mod_conv(i, 3, 1), "bias": d.zeros((1, 3, 1, 1))}

        def res_block(i, o):
            return {"conv1": d.conv(i, i), "conv2": d.conv(i, o),
                    "skip": d.conv(i, o, 1, bias=False)}

        params: dict = {"conv_body_first": d.conv(3, uch[str(cfg.out_size)], 1)}
        in_c = uch[str(cfg.out_size)]
        down = {}
        for idx, i in enumerate(range(ls, 2, -1)):
            down[str(idx)] = res_block(in_c, uch[str(2 ** (i - 1))])
            in_c = uch[str(2 ** (i - 1))]
        params["conv_body_down"] = down
        params["final_conv"] = d.conv(in_c, uch["4"])
        up, cs, csh, trgb = {}, {}, {}, {}
        in_c = uch["4"]
        for idx, i in enumerate(range(3, ls + 1)):
            out_c = uch[str(2 ** i)]
            up[str(idx)] = res_block(in_c, out_c)
            # the SFT width is the UNet's half-width channels (reference :300-305)
            sft_out = out_c if cfg.sft_half else out_c * 2
            cs[str(idx)] = {"0": d.conv(out_c, out_c), "2": d.conv(out_c, sft_out)}
            csh[str(idx)] = {"0": d.conv(out_c, out_c), "2": d.conv(out_c, sft_out)}
            trgb[str(idx)] = d.conv(out_c, 3, 1)
            in_c = out_c
        params.update(conv_body_up=up, condition_scale=cs, condition_shift=csh, toRGB=trgb)
        n_lat = cfg.num_latent if cfg.different_w else 1
        params["final_linear"] = d.lin(uch["4"] * 16, n_lat * nsf)

        dec: dict = {"constant_input": {"weight": d.normal((1, ch["4"], 4, 4))},
                     "style_conv1": style_conv(ch["4"], ch["4"]), "to_rgb1": to_rgb(ch["4"]),
                     "style_convs": {}, "to_rgbs": {}, "noises": {}}
        for layer_idx in range((ls - 2) * 2 + 1):
            res = 2 ** ((layer_idx + 5) // 2)
            dec["noises"][f"noise{layer_idx}"] = d.normal((1, 1, res, res))
        in_c = ch["4"]
        for gi, i in enumerate(range(3, ls + 1)):
            out_c = ch[str(2 ** i)]
            dec["style_convs"][str(2 * gi)] = style_conv(in_c, out_c)
            dec["style_convs"][str(2 * gi + 1)] = style_conv(out_c, out_c)
            dec["to_rgbs"][str(gi)] = to_rgb(out_c)
            in_c = out_c
        params["stylegan_decoder"] = dec
        return params


def detect_gfpgan_config(flat: Dict[str, torch.Tensor]) -> Optional[GFPGANConfig]:
    if "stylegan_decoder.style_conv1.modulated_conv.weight" not in flat:
        return None
    n_down = len({k.split(".")[1] for k in flat if k.startswith("conv_body_down.")})
    dec = "stylegan_decoder."
    return GFPGANConfig(
        out_size=2 ** (n_down + 2),
        num_style_feat=flat[dec + "style_conv1.modulated_conv.modulation.weight"].shape[1],
        base_channels=flat[dec + "constant_input.weight"].shape[1])


def load_gfpgan(path, device=None):
    """A GFPGAN (clean) checkpoint -> (GFPGAN, params on ``device``, default
    the card); the decoder's noise buffers load as
    stylegan_decoder.noises.noiseN."""
    from stable_renderer_tpu_torch.models.upscale import read_upscale_state, to_params

    flat = read_upscale_state(path)
    cfg = detect_gfpgan_config(flat)
    if cfg is None:
        raise ValueError(f"{path} is not a GFPGAN (clean) checkpoint")
    return GFPGAN(cfg), to_params(flat, device)
