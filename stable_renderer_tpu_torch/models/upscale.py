"""Image upscalers: ESRGAN/RRDBNet, SRVGG (Real-ESRGAN compact), Swift-SRGAN,
and the architecture-sniffing loader of the whole restoration zoo.

Counterpart of stable_renderer_tpu/models/upscale.py (reference chainner
architecture/RRDB.py, SRVGG.py, SwiftSRGAN.py and __init__.py's dispatch).
Functional PyTorch over NHWC activations; params keep the "new-arch" torch
layout (conv_first / body.N.rdbM.convK / conv_up1 ...), with the old-arch
ESRGAN key remap (model.0.weight style) done at load.

``load_upscale_model(path, device=None)`` reads a ``.pth`` / ``.ckpt`` /
``.safetensors`` file and returns ``(model, params)`` on ``device`` (the card
by default): ``model.apply(params, images)`` restores or upscales (N, H, W, 3)
images. The sniffing order is the JAX package's: HAT before Swin2SR before
SwinIR (all three share SwinIR's keys), then RestoreFormer, CodeFormer,
GFPGAN, SCUNet, DAT, OmniSR, SPSR, Swift-SRGAN and SRVGG, with ESRGAN last.
LaMa has no branch there, as in the JAX package (ROADMAP queue 3); its
loader is ``lama.load_lama``.

Published BasicSR-style files nest their state dict as ``{"params_ema":
...}`` or ``{"params": ...}``; ``read_upscale_state`` unwraps that (the JAX
package's reader drops it: ROADMAP queue 3) and strips the flattened
``params_ema.`` / ``params.`` prefixes in every loader.

Usage:
    model, params = load_upscale_model("RealESRGAN_x4plus.pth", device="cuda")
    up = model.apply(params, images)   # (N, H, W, 3) -> (N, sH, sW, 3)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import torch

from stable_renderer_tpu_torch.device import keep_f32, resolve_device
from stable_renderer_tpu_torch.models.layers import conv2d, upsample_nearest_2x
from stable_renderer_tpu_torch.models.swinir import Draws, dwconv, lrelu, pixel_shuffle
from stable_renderer_tpu_torch.models.weights import nest, read_safetensors, tree_to

_PREFIXES = ("params_ema.", "params.")


def read_upscale_state(path) -> Dict[str, torch.Tensor]:
    """A zoo file -> flat {name: CPU tensor}: a ``.safetensors`` file, or a
    torch pickle whose ``state_dict``, ``params_ema`` or ``params`` entry
    (tried in that order) holds the tensors; flattened ``params_ema.`` /
    ``params.`` prefixes are stripped."""
    path = Path(path)
    if path.suffix == ".safetensors":
        flat = dict(read_safetensors(path))
    else:
        sd = torch.load(str(path), map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        for key in ("params_ema", "params"):
            if isinstance(sd.get(key), dict):
                sd = sd[key]
                break
        flat = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    if any(k.startswith(_PREFIXES) for k in flat):
        flat = {k.split(".", 1)[1]: v for k, v in flat.items() if k.startswith(_PREFIXES)}
    return flat


def to_params(flat: Dict[str, torch.Tensor], device=None) -> dict:
    """A flat state dict -> the nested param tree on ``device`` (default: the
    card), each tensor in the file's dtype. Every zoo loader ends here, so a
    load to the card keeps f32 f32 (``device.keep_f32``), as the other card
    entry points do."""
    device = resolve_device(device)
    if device.type == "cuda":
        keep_f32()
    return tree_to(nest(flat, ""), device)


# ---------------------------------------------------------------------------
# ESRGAN / RRDBNet (chainner RRDB.py)


@dataclass(frozen=True)
class RRDBConfig:
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    scale: int = 4


# JAX's UpscaleModelLoader fallback when the named file is missing
TINY_RRDB_CONFIG = RRDBConfig(num_feat=16, num_block=2, num_grow_ch=8, scale=4)


def _rdb(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Residual dense block: 5 convs with dense connectivity, 0.2 residual."""
    x1 = lrelu(conv2d(p["conv1"], x, padding=1))
    x2 = lrelu(conv2d(p["conv2"], torch.cat([x, x1], -1), padding=1))
    x3 = lrelu(conv2d(p["conv3"], torch.cat([x, x1, x2], -1), padding=1))
    x4 = lrelu(conv2d(p["conv4"], torch.cat([x, x1, x2, x3], -1), padding=1))
    x5 = conv2d(p["conv5"], torch.cat([x, x1, x2, x3, x4], -1), padding=1)
    return x + 0.2 * x5


def _rrdb(p: dict, x: torch.Tensor) -> torch.Tensor:
    out = _rdb(p["rdb3"], _rdb(p["rdb2"], _rdb(p["rdb1"], x)))
    return x + 0.2 * out


class RRDBNet:
    def __init__(self, config: RRDBConfig = RRDBConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return self.config.scale

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, 3) in [0, 1] -> (N, scale*H, scale*W, 3) in [0, 1]."""
        cfg = self.config
        feat = conv2d(params["conv_first"], x, padding=1)
        body = feat
        for i in range(cfg.num_block):
            body = _rrdb(params["body"][str(i)], body)
        feat = feat + conv2d(params["conv_body"], body, padding=1)
        if cfg.scale >= 2:
            feat = lrelu(conv2d(params["conv_up1"], upsample_nearest_2x(feat), padding=1))
        if cfg.scale >= 4:
            feat = lrelu(conv2d(params["conv_up2"], upsample_nearest_2x(feat), padding=1))
        out = conv2d(params["conv_last"], lrelu(conv2d(params["conv_hr"], feat, padding=1)),
                     padding=1)
        return torch.clamp(out, 0.0, 1.0)

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        """Random init with the JAX package's tree: N(0, 0.02^2) conv weights,
        zero biases."""
        cfg = self.config
        d = Draws(generator, dtype, device)
        nf, gc = cfg.num_feat, cfg.num_grow_ch

        def conv(i, o):
            return d.conv(i, o, std=0.02)

        def rdb():
            return {"conv1": conv(nf, gc), "conv2": conv(nf + gc, gc),
                    "conv3": conv(nf + 2 * gc, gc), "conv4": conv(nf + 3 * gc, gc),
                    "conv5": conv(nf + 4 * gc, nf)}

        return {
            "conv_first": conv(3, nf),
            "body": {str(i): {"rdb1": rdb(), "rdb2": rdb(), "rdb3": rdb()}
                     for i in range(cfg.num_block)},
            "conv_body": conv(nf, nf), "conv_up1": conv(nf, nf), "conv_up2": conv(nf, nf),
            "conv_hr": conv(nf, nf), "conv_last": conv(nf, 3),
        }


_OLD_ARCH_MAP = {
    "model.0": "conv_first",
    "model.1.sub.23": "conv_body",
    "model.3": "conv_up1",
    "model.6": "conv_up2",
    "model.8": "conv_hr",
    "model.10": "conv_last",
}


def convert_esrgan_state_dict(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Normalize old-arch ESRGAN keys (model.1.sub.N.RDBk.convM.0.*) to the
    new-arch names used above (chainner does the same)."""
    if "conv_first.weight" in flat:
        return dict(flat)
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        name, leaf = key.rsplit(".", 1)
        mapped = None
        if name in _OLD_ARCH_MAP:
            mapped = _OLD_ARCH_MAP[name]
        elif name.startswith("model.1.sub."):
            parts = name.split(".")  # model 1 sub N RDBk convM 0
            mapped = f"body.{parts[3]}.{parts[4].lower()}.{parts[5].lower()}"
        out[f"{mapped}.{leaf}" if mapped is not None else key] = value
    return out


def load_esrgan(path, device=None):
    """An ESRGAN / Real-ESRGAN file -> (params on ``device``, RRDBConfig);
    KeyError 'conv_first.weight' on a file that is not one, as the JAX
    package's."""
    flat = convert_esrgan_state_dict(read_upscale_state(path))
    nf = flat["conv_first.weight"].shape[0]
    blocks = 1 + max(int(k.split(".")[1]) for k in flat if k.startswith("body."))
    gc = flat["body.0.rdb1.conv1.weight"].shape[0]
    scale = 4 if "conv_up2.weight" in flat else 2
    cfg = RRDBConfig(num_feat=nf, num_block=blocks, num_grow_ch=gc, scale=scale)
    return to_params(flat, device), cfg


# ---------------------------------------------------------------------------
# SRVGG / Real-ESRGAN compact (chainner SRVGG.py:10-116)


@dataclass(frozen=True)
class SRVGGConfig:
    num_feat: int = 64
    num_conv: int = 16
    scale: int = 4
    in_ch: int = 3


def prelu(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """PReLU with a per-channel slope over NHWC."""
    return torch.clamp(x, min=0.0) + w.to(x.dtype) * torch.clamp(x, max=0.0)


class SRVGGNetCompact:
    """VGG-style compact SR: conv + PReLU body, one pixel shuffle, nearest
    residual (SRVGG.py forward)."""

    def __init__(self, config: SRVGGConfig = SRVGGConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return self.config.scale

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        body = params["body"]
        out = x
        for i in range(0, 2 * (cfg.num_conv + 1), 2):
            out = prelu(body[str(i + 1)]["weight"], conv2d(body[str(i)], out, padding=1))
        out = conv2d(body[str(2 * (cfg.num_conv + 1))], out, padding=1)
        out = pixel_shuffle(out, cfg.scale)
        base = x.repeat_interleave(cfg.scale, 1).repeat_interleave(cfg.scale, 2)
        return out + base

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        cfg = self.config
        d = Draws(generator, dtype, device)
        body = {"0": d.conv(cfg.in_ch, cfg.num_feat),
                "1": {"weight": d.full((cfg.num_feat,), 0.25)}}
        for c in range(cfg.num_conv):
            body[str(2 + 2 * c)] = d.conv(cfg.num_feat, cfg.num_feat)
            body[str(3 + 2 * c)] = {"weight": d.full((cfg.num_feat,), 0.25)}
        body[str(2 * (cfg.num_conv + 1))] = d.conv(cfg.num_feat,
                                                   cfg.in_ch * cfg.scale * cfg.scale)
        return {"body": body}


def detect_srvgg_config(flat) -> Optional[SRVGGConfig]:
    keys = sorted(flat.keys(), key=lambda k: tuple(
        int(p) if p.isdigit() else p for p in k.split(".")))
    if not keys or not keys[0].startswith("body.0."):
        return None
    if any(not k.startswith("body.") for k in keys):
        return None
    last_idx = max(int(k.split(".")[1]) for k in keys)
    in_ch = flat["body.0.weight"].shape[1]
    scale = int(math.sqrt(flat[f"body.{last_idx}.weight"].shape[0] / in_ch))
    return SRVGGConfig(num_feat=flat["body.0.weight"].shape[0], num_conv=(last_idx - 2) // 2,
                       scale=scale, in_ch=in_ch)


# ---------------------------------------------------------------------------
# Swift-SRGAN (chainner SwiftSRGAN.py:7-161): depthwise-separable SRGAN


@dataclass(frozen=True)
class SwiftSRGANConfig:
    num_channels: int = 64
    num_blocks: int = 16
    scale: int = 4
    in_ch: int = 3


def _sep_conv(p: dict, x: torch.Tensor, padding: int) -> torch.Tensor:
    """SeperableConv2d: depthwise (groups = C), then a pointwise 1x1."""
    return conv2d(p["pointwise"], dwconv(p["depthwise"], x, padding))


def batch_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d in inference mode over NHWC channels, in f32."""
    out = (x.float() - p["running_mean"].float()) * torch.rsqrt(p["running_var"].float() + eps)
    out = out * p["weight"].float() + p["bias"].float()
    return out.to(x.dtype)


class SwiftSRGAN:
    """The generator (SwiftSRGAN.py:90-161)."""

    def __init__(self, config: SwiftSRGANConfig = SwiftSRGANConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return self.config.scale

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        init = prelu(params["initial"]["act"]["weight"], _sep_conv(params["initial"]["cnn"], x, 4))
        h = init
        for i in range(cfg.num_blocks):
            bp = params["residual"][str(i)]
            r = prelu(bp["block1"]["act"]["weight"],
                      batch_norm(bp["block1"]["bn"], _sep_conv(bp["block1"]["cnn"], h, 1)))
            h = h + batch_norm(bp["block2"]["bn"], _sep_conv(bp["block2"]["cnn"], r, 1))
        cb = params["convblock"]
        h = batch_norm(cb["bn"], _sep_conv(cb["cnn"], h, 1)) + init
        for i in range(cfg.scale // 2):
            up = params["upsampler"][str(i)]
            h = prelu(up["act"]["weight"], pixel_shuffle(_sep_conv(up["conv"], h, 1), 2))
        out = _sep_conv(params["final_conv"], h, 4)
        return (torch.tanh(out) + 1.0) / 2.0

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        cfg = self.config
        d = Draws(generator, dtype, device)

        def sep(i, o, k, bias=True):
            return {"depthwise": d.dconv(i, k, bias=bias), "pointwise": d.conv(i, o, 1)}

        def act(c):
            return {"weight": d.full((c,), 0.25)}

        n = cfg.num_channels
        return {
            "initial": {"cnn": sep(cfg.in_ch, n, 9), "act": act(n)},
            "residual": {str(i): {"block1": {"cnn": sep(n, n, 3, bias=False), "bn": d.bn(n),
                                             "act": act(n)},
                                  "block2": {"cnn": sep(n, n, 3, bias=False), "bn": d.bn(n)}}
                         for i in range(cfg.num_blocks)},
            "convblock": {"cnn": sep(n, n, 3, bias=False), "bn": d.bn(n)},
            "upsampler": {str(i): {"conv": sep(n, 4 * n, 3), "act": act(n)}
                          for i in range(cfg.scale // 2)},
            "final_conv": sep(n, cfg.in_ch, 9),
        }


def detect_swift_srgan_config(flat) -> Optional[SwiftSRGANConfig]:
    if "initial.cnn.depthwise.weight" not in flat:
        return None
    blocks = len({k.split(".")[1] for k in flat if k.startswith("residual.")})
    scale = 2 ** len({k.split(".")[1] for k in flat if k.startswith("upsampler.")})
    return SwiftSRGANConfig(num_channels=flat["initial.cnn.pointwise.weight"].shape[0],
                            num_blocks=blocks, scale=scale,
                            in_ch=flat["initial.cnn.depthwise.weight"].shape[0])


# ---------------------------------------------------------------------------
# the loader (chainner __init__.py load_state_dict dispatch)


def load_upscale_model(path, device=None):
    """Sniff a zoo file's architecture and load it -> (model, params on
    ``device``, default the card); ``model.scale`` is the factor. The order
    is the JAX package's (see the module docstring)."""
    from stable_renderer_tpu_torch.models import (
        codeformer,
        dat,
        gfpgan,
        hat,
        omnisr,
        restoreformer,
        scunet,
        spsr,
        swin2sr,
        swinir,
    )

    flat = read_upscale_state(path)
    if "layers.0.residual_group.overlap_attn.norm1.weight" in flat:
        return hat.load_hat(path, device)  # HAT shares SwinIR's layout: its OCAB first
    if "layers.0.residual_group.blocks.0.attn.logit_scale" in flat:
        return swin2sr.load_swin2sr(path, device)  # the SwinV2 logit_scale marks Swin2SR
    if "layers.0.residual_group.blocks.0.norm1.weight" in flat:
        return swinir.load_swinir(path, device)
    if "decoder.mid.attn_1.norm2.weight" in flat and "quantize.embedding.weight" in flat:
        return restoreformer.load_restoreformer(path, device)
    if "position_emb" in flat and "quantize.embedding.weight" in flat:
        return codeformer.load_codeformer(path, device)
    if "stylegan_decoder.style_conv1.modulated_conv.weight" in flat:
        return gfpgan.load_gfpgan(path, device)
    if "m_head.0.weight" in flat and "m_down1.0.trans_block.ln1.weight" in flat:
        return scunet.load_scunet(path, device)
    if "layers.0.blocks.0.attn.attns.0.pos.pos_proj.weight" in flat:
        return dat.load_dat(path, device)
    if ("input.weight" in flat
            and any(k.startswith("residual_layer.0.residual_layer.0.layer.") for k in flat)):
        return omnisr.load_omnisr(path, device)
    if "b_fea_conv.weight" in flat or "b_fea_conv.0.weight" in flat:
        return spsr.load_spsr(path, device)
    swift = detect_swift_srgan_config(flat)
    if swift is not None:
        return SwiftSRGAN(swift), to_params(flat, device)
    srvgg = detect_srvgg_config(flat)
    if srvgg is not None:
        return SRVGGNetCompact(srvgg), to_params(flat, device)
    params, cfg = load_esrgan(path, device)
    return RRDBNet(cfg), params
