"""SPSR: structure-preserving super-resolution with a gradient branch.

Counterpart of stable_renderer_tpu/models/spsr.py (reference chainner
SPSR.py: Get_gradient_nopadding :13-36, SPSRNet :38-420; block.py RRDB
:286-352, ResidualDenseBlock_5C :356-460, upconv_block :519-560).
Functional PyTorch over NHWC, the old-arch torch key layout
(model.1.sub.{i}.RDB{k}.conv{m}.0.*).

Two trunks: the ESRGAN RRDB SR trunk (features tapped every num_blocks / 4
blocks) and a gradient branch fed by the per-channel gradient magnitude,
fused by concat + RRDB at four taps, then a final fusion block.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.layers import conv2d, upsample_nearest_2x
from stable_renderer_tpu_torch.models.swinir import Draws, lrelu


def _c(p: dict) -> dict:
    """Tolerant conv access: SPSR checkpoints wrap some convs in a
    Sequential ('X.0.weight') and leave others bare ('X.weight')."""
    return p if "weight" in p else p["0"]


def gradient_map(x: torch.Tensor) -> torch.Tensor:
    """The per-channel gradient magnitude (SPSR.py:13-36): sqrt(v^2 + h^2 + 1e-6)
    of the central differences, zero padded."""
    c = x.shape[-1]
    kv = torch.tensor([[0, -1, 0], [0, 0, 0], [0, 1, 0]], dtype=x.dtype, device=x.device)
    kh = torch.tensor([[0, 0, 0], [-1, 0, 1], [0, 0, 0]], dtype=x.dtype, device=x.device)
    xn = x.permute(0, 3, 1, 2)

    def dw(k):
        return F.conv2d(xn, k[None, None].expand(c, 1, 3, 3), padding=1, groups=c)

    return torch.sqrt(dw(kv) ** 2 + dw(kh) ** 2 + 1e-6).permute(0, 2, 3, 1)


def _rdb(p: dict, x: torch.Tensor) -> torch.Tensor:
    x1 = lrelu(conv2d(_c(p["conv1"]), x, padding=1))
    x2 = lrelu(conv2d(_c(p["conv2"]), torch.cat([x, x1], -1), padding=1))
    x3 = lrelu(conv2d(_c(p["conv3"]), torch.cat([x, x1, x2], -1), padding=1))
    x4 = lrelu(conv2d(_c(p["conv4"]), torch.cat([x, x1, x2, x3], -1), padding=1))
    x5 = conv2d(_c(p["conv5"]), torch.cat([x, x1, x2, x3, x4], -1), padding=1)
    return x + 0.2 * x5


def _rrdb(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x + 0.2 * _rdb(p["RDB3"], _rdb(p["RDB2"], _rdb(p["RDB1"], x)))


@dataclass(frozen=True)
class SPSRConfig:
    num_filters: int = 64
    num_blocks: int = 23
    scale: int = 4
    in_nc: int = 3
    out_nc: int = 3


TINY_SPSR_CONFIG = SPSRConfig(num_filters=16, num_blocks=4, scale=2)


class SPSRNet:
    def __init__(self, config: SPSRConfig = SPSRConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return self.config.scale

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        n_up = int(math.log2(cfg.scale))
        m = params["model"]

        x_grad = gradient_map(x)
        feat = conv2d(_c(m["0"]), x, padding=1)

        # the trunk: RRDBs with taps every num_blocks // 4 (SPSR.py:496-527)
        sub = m["1"]["sub"]
        nb = cfg.num_blocks
        tap_every = max(nb // 4, 1)
        h = feat
        taps = []
        for i in range(nb):
            h = _rrdb(sub[str(i)], h)
            if (i + 1) % tap_every == 0 and len(taps) < 4:
                taps.append(h)
        taps += [h] * (4 - len(taps))
        h = feat + conv2d(_c(sub[str(nb)]), h, padding=1)  # the trailing LR conv
        # upsample convs at indices 3, 6 (scale 4) or 3 (scale 2), then the
        # HR convs at the following even indices (old-arch layout)
        idx = 3
        for _ in range(n_up):
            h = lrelu(conv2d(_c(m[str(idx)]), upsample_nearest_2x(h), padding=1))
            idx += 3
        h = lrelu(conv2d(_c(m[str(idx - 1)]), h, padding=1))
        h = conv2d(_c(m[str(idx + 1)]), h, padding=1)
        h = conv2d(_c(params["HR_conv1_new"]), h, padding=1)  # the reference applies it twice

        # the gradient branch
        b = conv2d(_c(params["b_fea_conv"]), x_grad, padding=1)
        cat = b
        for k in range(1, 5):
            cat = _rrdb(params[f"b_block_{k}"], torch.cat([cat, taps[k - 1]], -1))
            cat = conv2d(_c(params[f"b_concat_{k}"]), cat, padding=1)
        cat = conv2d(_c(params["b_LR_conv"]), cat, padding=1) + b
        bm = params["b_module"]
        bi = 1
        for _ in range(n_up):
            cat = lrelu(conv2d(_c(bm[str(bi)]), upsample_nearest_2x(cat), padding=1))
            bi += 3
        branch = conv2d(_c(bm[str(bi + 1)]), lrelu(conv2d(_c(bm[str(bi - 1)]), cat, padding=1)),
                        padding=1)

        # the final fusion (SPSR.py:374-380)
        f = _rrdb(params["f_block"], torch.cat([branch, h], -1))
        f = conv2d(_c(params["f_concat"]), f, padding=1)
        f = lrelu(conv2d(_c(params["f_HR_conv0"]), f, padding=1))
        return conv2d(_c(params["f_HR_conv1"]), f, padding=1)

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        cfg = self.config
        d = Draws(generator, dtype, device)
        nf, gc = cfg.num_filters, max(cfg.num_filters // 2, 8)

        def conv(i, o, k=3):
            return d.conv(i, o, k, std=0.02)

        def rrdb(n):
            def rdb():
                return {"conv1": conv(n, gc), "conv2": conv(n + gc, gc),
                        "conv3": conv(n + 2 * gc, gc), "conv4": conv(n + 3 * gc, gc),
                        "conv5": conv(n + 4 * gc, n)}

            return {"RDB1": rdb(), "RDB2": rdb(), "RDB3": rdb()}

        n_up = int(math.log2(cfg.scale))
        model = {"0": conv(cfg.in_nc, nf),
                 "1": {"sub": {**{str(i): rrdb(nf) for i in range(cfg.num_blocks)},
                               str(cfg.num_blocks): conv(nf, nf)}}}
        idx = 3
        for _ in range(n_up):
            model[str(idx)] = conv(nf, nf)
            idx += 3
        model[str(idx - 1)] = conv(nf, nf)  # HR_conv0_new
        model[str(idx + 1)] = conv(nf, nf)  # HR_conv1_new
        b_module = {}
        bi = 1
        for _ in range(n_up):
            b_module[str(bi)] = conv(nf, nf)
            bi += 3
        b_module[str(bi - 1)] = conv(nf, nf)
        b_module[str(bi + 1)] = conv(nf, nf)
        params = {"model": model, "HR_conv1_new": model[str(idx + 1)],
                  "b_fea_conv": conv(cfg.in_nc, nf), "b_LR_conv": conv(nf, nf),
                  "b_module": b_module, "conv_w": conv(nf, cfg.out_nc, 1),
                  "f_concat": conv(2 * nf, nf), "f_block": rrdb(2 * nf),
                  "f_HR_conv0": conv(nf, nf), "f_HR_conv1": conv(nf, cfg.out_nc)}
        for k in range(1, 5):
            params[f"b_block_{k}"] = rrdb(2 * nf)
            params[f"b_concat_{k}"] = conv(2 * nf, nf)
        return params


def detect_spsr_config(flat: Dict[str, torch.Tensor]) -> Optional[SPSRConfig]:
    if "b_fea_conv.weight" not in flat and "b_fea_conv.0.weight" not in flat:
        return None
    if "model.0.weight" not in flat:
        return None
    nf, in_nc = flat["model.0.weight"].shape[:2]
    out_key = "f_HR_conv1.0.bias" if "f_HR_conv1.0.bias" in flat else "f_HR_conv1.bias"
    nb = 0
    for k in flat:
        parts = k.split(".")
        if len(parts) >= 4 and parts[0] == "model" and parts[2] == "sub":
            nb = max(nb, int(parts[3]))
    # upsample convs in b_module at indices 1, 4, ... (every 3)
    n_up = len({k.split(".")[1] for k in flat if k.startswith("b_module.")
                and int(k.split(".")[1]) % 3 == 1 and k.endswith("weight")})
    return SPSRConfig(num_filters=int(nf), num_blocks=nb, scale=2 ** max(n_up, 1),
                      in_nc=int(in_nc), out_nc=flat[out_key].shape[0])


def load_spsr(path, device=None):
    """An SPSR checkpoint -> (SPSRNet, params on ``device``, default the card)."""
    from stable_renderer_tpu_torch.models.upscale import read_upscale_state, to_params

    flat = read_upscale_state(path)
    cfg = detect_spsr_config(flat)
    if cfg is None:
        raise ValueError(f"{path} is not an SPSR checkpoint")
    return SPSRNet(cfg), to_params(flat, device)
