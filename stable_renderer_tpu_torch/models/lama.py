"""LaMa: large-mask inpainting with Fast Fourier Convolutions.

Counterpart of stable_renderer_tpu/models/lama.py (reference chainner
LaMa.py: FourierUnit :83-221, SpectralTransform :224-279, FFC :282-388,
FFC_BN_ACT :391-442, FFCResnetBlock :444-506, FFCResNetGenerator :519-663,
the LaMa wrapper :666-694). Functional PyTorch over NHWC, the
``model.model.{idx}`` Sequential indices kept.

The FFC's global branch is ``torch.fft.rfft2`` -> a 1x1 conv over the
stacked real and imaginary channels -> ``irfft2``, ortho norm, in f32. Every
padding is reflect, as torch's padding_mode. The stride-2 ConvTranspose2d
(k=3, p=1, output_padding=1) is torch's own ``conv_transpose2d``, which the
JAX package builds as a fractionally strided conv with the flipped,
transposed kernel: the same taps. BatchNorm runs in inference mode.
``load_upscale_model`` has no LaMa branch, as in the JAX package (ROADMAP
queue 3): load it with ``load_lama``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.swinir import Draws, pad_reflect
from stable_renderer_tpu_torch.models.upscale import batch_norm as _bn


@dataclass(frozen=True)
class LaMaConfig:
    ngf: int = 64
    n_downsampling: int = 3
    n_blocks: int = 18
    ratio_g: float = 0.75
    max_features: int = 1024
    in_nc: int = 4
    out_nc: int = 3


TINY_LAMA_CONFIG = LaMaConfig(ngf=8, n_downsampling=2, n_blocks=2, max_features=64)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _reflect_conv(p: dict, x: torch.Tensor, k: int, stride: int = 1,
                  pad: Optional[int] = None) -> torch.Tensor:
    """Conv2d with reflect padding (torch padding_mode='reflect')."""
    pad = k // 2 if pad is None else pad
    xn = _nchw(x)
    if pad:
        xn = F.pad(xn, (pad, pad, pad, pad), mode="reflect")
    b = p.get("bias")
    return _nhwc(F.conv2d(xn, p["weight"].to(x.dtype), None if b is None else b.to(x.dtype),
                          stride=stride))


def _conv_transpose_s2(p: dict, x: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose2d(k=3, s=2, p=1, output_padding=1), weight (in, out, 3, 3)."""
    b = p.get("bias")
    return _nhwc(F.conv_transpose2d(_nchw(x), p["weight"].to(x.dtype),
                                    None if b is None else b.to(x.dtype), stride=2, padding=1,
                                    output_padding=1))


def _fourier_unit(p: dict, x: torch.Tensor) -> torch.Tensor:
    """FourierUnit (LaMa.py:126-221): rfft2 -> a 1x1 conv over the stacked
    real and imaginary parts -> irfft2, ortho norm."""
    b, h, w, c = x.shape
    f = torch.fft.rfft2(x.float(), dim=(1, 2), norm="ortho")
    w2 = f.shape[2]
    # channel-major (c, 2) stacking, as torch's permute / view
    stacked = torch.stack([f.real, f.imag], dim=-1).reshape(b, h, w2, 2 * c)
    y = torch.relu(_bn(p["bn"], _reflect_conv(p["conv_layer"], stacked, 1, pad=0)))
    y = y.reshape(b, h, w2, c, 2)
    out = torch.fft.irfft2(torch.complex(y[..., 0], y[..., 1]), s=(h, w), dim=(1, 2), norm="ortho")
    return out.to(x.dtype)


def _spectral_transform(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SpectralTransform, stride 1, LFU off (LaMa.py:259-279)."""
    h = torch.relu(_bn(p["conv1"]["1"], _reflect_conv(p["conv1"]["0"], x, 1, pad=0)))
    return _reflect_conv(p["conv2"], h + _fourier_unit(p["fu"], h), 1, pad=0)


def _ffc_bn_act(p: dict, x_l: torch.Tensor, x_g: Union[torch.Tensor, int], k: int, stride: int,
                ratio_gin: float, ratio_gout: float, relu: bool = True
                ) -> Tuple[Union[torch.Tensor, int], Union[torch.Tensor, int]]:
    """FFC + BN + ReLU over the (local, global) pair (LaMa.py:282-442)."""
    ffc = p["ffc"]
    out_l: Union[torch.Tensor, int] = 0
    out_g: Union[torch.Tensor, int] = 0
    has_g = ratio_gin > 0 and isinstance(x_g, torch.Tensor)
    if ratio_gout != 1:
        out_l = _reflect_conv(ffc["convl2l"], x_l, k, stride)
        if has_g:
            out_l = out_l + _reflect_conv(ffc["convg2l"], x_g, k, stride)
        out_l = _bn(p["bn_l"], out_l)
        if relu:
            out_l = torch.relu(out_l)
    if ratio_gout != 0:
        out_g = _reflect_conv(ffc["convl2g"], x_l, k, stride)
        if has_g:
            out_g = out_g + _spectral_transform(ffc["convg2g"], x_g)
        out_g = _bn(p["bn_g"], out_g)
        if relu:
            out_g = torch.relu(out_g)
    return out_l, out_g


class LaMa:
    def __init__(self, config: LaMaConfig = LaMaConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return 1

    def apply(self, params: dict, img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, 3) in [0, 1], mask (B, H, W, 1) with 1 = hole -> the
        inpainted composite (LaMa.forward, LaMa.py:690-694)."""
        cfg = self.config
        b, h_in, w_in, _ = img.shape
        pad_mod = 2 ** cfg.n_downsampling
        ph, pw = (pad_mod - h_in % pad_mod) % pad_mod, (pad_mod - w_in % pad_mod) % pad_mod
        img_p, mask_p = img, mask
        if ph or pw:
            img_p = pad_reflect(img, ph, pw)
            mask_p = F.pad(mask, (0, 0, 0, pw, 0, ph))
        x = torch.cat([img_p * (1.0 - mask_p), mask_p], -1)
        m = params["model"]["model"]

        # index 0 is the ReflectionPad(3): _reflect_conv's own k // 2 reflect
        # pad is the same for the k=7 pad=0 conv
        x_l, x_g = _ffc_bn_act(m["1"], x, 0, 7, 1, 0.0, 0.0)
        idx = 2
        for i in range(cfg.n_downsampling):
            gout = cfg.ratio_g if i == cfg.n_downsampling - 1 else 0.0
            x_l, x_g = _ffc_bn_act(m[str(idx)], x_l, x_g, 3, 2, 0.0, gout)
            idx += 1
        for _ in range(cfg.n_blocks):
            bp = m[str(idx)]
            id_l, id_g = x_l, x_g
            x_l, x_g = _ffc_bn_act(bp["conv1"], x_l, x_g, 3, 1, cfg.ratio_g, cfg.ratio_g)
            x_l, x_g = _ffc_bn_act(bp["conv2"], x_l, x_g, 3, 1, cfg.ratio_g, cfg.ratio_g)
            x_l, x_g = id_l + x_l, id_g + x_g
            idx += 1
        x = torch.cat([x_l, x_g], -1)
        idx += 1  # ConcatTupleLayer
        for _ in range(cfg.n_downsampling):
            x = torch.relu(_bn(m[str(idx + 1)], _conv_transpose_s2(m[str(idx)], x)))
            idx += 3  # convtranspose + bn + relu
        idx += 1  # ReflectionPad(3)
        out = torch.sigmoid(_reflect_conv(m[str(idx)], x, 7, pad=3))
        out, mask = out[:, :h_in, :w_in], mask[:, :h_in, :w_in]
        return mask * out + (1.0 - mask) * img

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        cfg = self.config
        d = Draws(generator, dtype, device)
        mf = cfg.max_features

        def conv(i, o, k=3, bias=False):
            return d.conv(i, o, k, bias=bias)

        def ffc_plain(i, o, k):
            return {"ffc": {"convl2l": conv(i, o, k)}, "bn_l": d.bn(o)}

        def ffc_split(i, o, gout):
            ocg = int(o * gout)
            return {"ffc": {"convl2l": conv(i, o - ocg), "convl2g": conv(i, ocg)},
                    "bn_l": d.bn(o - ocg), "bn_g": d.bn(ocg)}

        def spectral(cg):
            half = cg // 2
            return {"conv1": {"0": conv(cg, half, 1), "1": d.bn(half)},
                    "fu": {"conv_layer": conv(2 * half, 2 * half, 1), "bn": d.bn(2 * half)},
                    "conv2": conv(half, cg, 1)}

        def ffc_res(dim):
            cg = int(dim * cfg.ratio_g)
            cl = dim - cg

            def one():
                return {"ffc": {"convl2l": conv(cl, cl), "convl2g": conv(cl, cg),
                                "convg2l": conv(cg, cl), "convg2g": spectral(cg)},
                        "bn_l": d.bn(cl), "bn_g": d.bn(cg)}

            return {"conv1": one(), "conv2": one()}

        m: Dict[str, dict] = {"1": ffc_plain(cfg.in_nc, cfg.ngf, 7)}
        idx = 2
        for i in range(cfg.n_downsampling):
            cin, cout = min(mf, cfg.ngf * 2 ** i), min(mf, cfg.ngf * 2 ** (i + 1))
            m[str(idx)] = (ffc_split(cin, cout, cfg.ratio_g) if i == cfg.n_downsampling - 1
                           else ffc_plain(cin, cout, 3))
            idx += 1
        bottleneck = min(mf, cfg.ngf * 2 ** cfg.n_downsampling)
        for _ in range(cfg.n_blocks):
            m[str(idx)] = ffc_res(bottleneck)
            idx += 1
        idx += 1  # concat
        for i in range(cfg.n_downsampling):
            mult = 2 ** (cfg.n_downsampling - i)
            cin, cout = min(mf, cfg.ngf * mult), min(mf, cfg.ngf * mult // 2)
            m[str(idx)] = {"weight": d.normal((cin, cout, 3, 3), 0.05), "bias": d.zeros((cout,))}
            m[str(idx + 1)] = d.bn(cout)
            idx += 3
        m[str(idx + 1)] = conv(cfg.ngf, cfg.out_nc, 7, bias=True)
        return {"model": {"model": m}}


def detect_lama_config(flat: Dict[str, torch.Tensor]) -> Optional[LaMaConfig]:
    key = next((k for k in flat if k.endswith("model.1.ffc.convl2l.weight")), None)
    if key is None or not any(".ffc.convg2g.fu.conv_layer" in k for k in flat):
        return None
    return LaMaConfig(ngf=flat[key].shape[0], in_nc=flat[key].shape[1])


def load_lama(path, device=None):
    """A LaMa checkpoint -> (LaMa, params on ``device``, default the card);
    the official files' ``generator.model.*`` keys (LaMa.py:680-683) load as
    ``model.model.*``."""
    from stable_renderer_tpu_torch.models.upscale import read_upscale_state, to_params

    flat = {k.replace("generator.model", "model.model"): v
            for k, v in read_upscale_state(path).items() if not k.endswith("num_batches_tracked")}
    cfg = detect_lama_config(flat)
    if cfg is None:
        raise ValueError(f"{path} is not a LaMa checkpoint")
    return LaMa(cfg), to_params(flat, device)
