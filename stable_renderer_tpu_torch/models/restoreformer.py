"""RestoreFormer: multi-head cross-attention VQ face restoration.

Counterpart of stable_renderer_tpu/models/restoreformer.py (reference
chainner face/restoreformer_arch.py: VectorQuantizer :11-124, ResnetBlock
:162-220, MultiHeadAttnBlock :222-289, MultiHeadEncoder :292-414,
MultiHeadDecoderTransformer :544-672, RestoreFormer :674-790). Functional
PyTorch over NHWC.

Flow: the VQ encoder (collecting its attention-level features) -> the
nearest codebook entry (an argmin) -> a decoder whose multi-head attention
blocks take queries from the decoder and keys and values from the encoder's
stored features. Its GroupNorms and 3x3 convs route as CodeFormer's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.layers import conv2d, group_norm, upsample_nearest_2x
from stable_renderer_tpu_torch.models.swinir import Draws


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    return group_norm(p, x, num_groups=32, eps=1e-6)


@dataclass(frozen=True)
class RestoreFormerConfig:
    ch: int = 64
    ch_mult: Tuple[int, ...] = (1, 2, 2, 4, 4, 8)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    resolution: int = 512
    z_channels: int = 256
    embed_dim: int = 256
    codebook_size: int = 1024
    head_size: int = 8
    in_ch: int = 3
    out_ch: int = 3


TINY_RESTOREFORMER_CONFIG = RestoreFormerConfig(
    ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16,
    z_channels=16, embed_dim=16, codebook_size=32, head_size=2)


def _res_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """ResnetBlock (restoreformer_arch.py:162-220)."""
    h = conv2d(p["conv1"], _swish(_norm(p["norm1"], x)), padding=1)
    h = conv2d(p["conv2"], _swish(_norm(p["norm2"], h)), padding=1)
    if "nin_shortcut" in p:
        x = conv2d(p["nin_shortcut"], x)
    return x + h


def _mh_attn(p: dict, x: torch.Tensor, heads: int, y: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """MultiHeadAttnBlock (restoreformer_arch.py:222-289): queries from y
    (norm2), keys and values from x (norm1); residual onto x."""
    b, h, w, c = x.shape
    d = c // heads
    hx = _norm(p["norm1"], x)
    hy = hx if y is None else _norm(p["norm2"], y)

    def heads_of(t):
        return t.reshape(b, h * w, heads, d).permute(0, 2, 1, 3)

    q = heads_of(conv2d(p["q"], hy))
    k, v = heads_of(conv2d(p["k"], hx)), heads_of(conv2d(p["v"], hx))
    attn = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", q * (d ** -0.5), k), dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, v).permute(0, 2, 1, 3).reshape(b, h, w, c)
    return x + conv2d(p["proj_out"], out)


class RestoreFormer:
    def __init__(self, config: RestoreFormerConfig = RestoreFormerConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return 1

    def encode(self, params: dict, x: torch.Tensor):
        """The encoder and the quantizer's distances: (z (B, h, w, E), the
        squared distance of each latent to each code (B*h*w, K), the
        encoder features the decoder attends to)."""
        cfg = self.config
        heads, nres = cfg.head_size, len(cfg.ch_mult)
        enc = params["encoder"]
        h = conv2d(enc["conv_in"], x, padding=1)
        hs: Dict[str, torch.Tensor] = {}
        curr = cfg.resolution
        for i in range(nres):
            dp = enc["down"][str(i)]
            for j in range(cfg.num_res_blocks):
                h = _res_block(dp["block"][str(j)], h)
                if curr in cfg.attn_resolutions:
                    h = _mh_attn(dp["attn"][str(j)], h, heads)
            if i != nres - 1:
                hs[f"block_{i}"] = h
                h = conv2d(dp["downsample"]["conv"], F.pad(h, (0, 0, 0, 1, 0, 1)), stride=2)
                curr //= 2
        h = _res_block(enc["mid"]["block_1"], h)
        hs[f"block_{nres - 1}_atten"] = h
        h = _res_block(enc["mid"]["block_2"], _mh_attn(enc["mid"]["attn_1"], h, heads))
        hs["mid_atten"] = h
        h = conv2d(enc["conv_out"], _swish(_norm(enc["norm_out"], h)), padding=1)
        z = conv2d(params["quant_conv"], h)
        codebook = params["quantize"]["embedding"]["weight"]
        flat = z.reshape(-1, z.shape[-1])
        d2 = (flat.square().sum(-1, keepdim=True) + codebook.square().sum(-1)
              - 2.0 * flat @ codebook.T)
        return z, d2, hs

    def decode(self, params: dict, z_shape, idx: torch.Tensor, hs: dict) -> torch.Tensor:
        """The codebook lookup and the decoder with its cross-attention priors
        (restoreformer_arch.py:636-672)."""
        cfg = self.config
        heads, nres = cfg.head_size, len(cfg.ch_mult)
        quant = params["quantize"]["embedding"]["weight"][idx].reshape(z_shape)
        dec = params["decoder"]
        h = conv2d(dec["conv_in"], conv2d(params["post_quant_conv"], quant), padding=1)
        h = _res_block(dec["mid"]["block_1"], h)
        h = _mh_attn(dec["mid"]["attn_1"], h, heads, y=hs["mid_atten"])
        h = _res_block(dec["mid"]["block_2"], h)
        curr = cfg.resolution // 2 ** (nres - 1)
        for i in reversed(range(nres)):
            up = dec["up"][str(i)]
            for j in range(cfg.num_res_blocks + 1):
                h = _res_block(up["block"][str(j)], h)
                if curr in cfg.attn_resolutions:
                    h = _mh_attn(up["attn"][str(j)], h, heads, y=hs[f"block_{i}_atten"])
            if i != 0:
                h = conv2d(up["upsample"]["conv"], upsample_nearest_2x(h), padding=1)
                curr *= 2
        return conv2d(dec["conv_out"], _swish(_norm(dec["norm_out"], h)), padding=1)

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) in [-1, 1] -> the restored (B, S, S, 3)."""
        z, d2, hs = self.encode(params, x)
        return self.decode(params, z.shape, torch.argmin(d2, dim=-1), hs)

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        cfg = self.config
        d = Draws(generator, dtype, device)

        def res(i, o):
            p = {"norm1": d.norm(i), "conv1": d.conv(i, o), "norm2": d.norm(o),
                 "conv2": d.conv(o, o)}
            if i != o:
                p["nin_shortcut"] = d.conv(i, o, 1)
            return p

        def attn(c):
            return {"norm1": d.norm(c), "norm2": d.norm(c), "q": d.conv(c, c, 1),
                    "k": d.conv(c, c, 1), "v": d.conv(c, c, 1), "proj_out": d.conv(c, c, 1)}

        ch, cm = cfg.ch, cfg.ch_mult
        nres = len(cm)
        in_mult = (1,) + tuple(cm)
        enc: dict = {"conv_in": d.conv(cfg.in_ch, ch), "down": {}}
        curr = cfg.resolution
        for i in range(nres):
            cin, cout = ch * in_mult[i], ch * cm[i]
            blocks, attns = {}, {}
            for j in range(cfg.num_res_blocks):
                blocks[str(j)] = res(cin, cout)
                cin = cout
                if curr in cfg.attn_resolutions:
                    attns[str(j)] = attn(cin)
            dp = {"block": blocks, "attn": attns}
            if i != nres - 1:
                dp["downsample"] = {"conv": d.conv(cin, cin)}
                curr //= 2
            enc["down"][str(i)] = dp
        enc["mid"] = {"block_1": res(cin, cin), "attn_1": attn(cin), "block_2": res(cin, cin)}
        enc["norm_out"] = d.norm(cin)
        enc["conv_out"] = d.conv(cin, cfg.z_channels)

        block_in = ch * cm[-1]
        dec: dict = {"conv_in": d.conv(cfg.z_channels, block_in), "up": {}}
        dec["mid"] = {"block_1": res(block_in, block_in), "attn_1": attn(block_in),
                      "block_2": res(block_in, block_in)}
        curr = cfg.resolution // 2 ** (nres - 1)
        for i in reversed(range(nres)):
            blocks, attns = {}, {}
            for j in range(cfg.num_res_blocks + 1):
                blocks[str(j)] = res(block_in, ch * cm[i])
                block_in = ch * cm[i]
                if curr in cfg.attn_resolutions:
                    attns[str(j)] = attn(block_in)
            up = {"block": blocks, "attn": attns}
            if i != 0:
                up["upsample"] = {"conv": d.conv(block_in, block_in)}
                curr *= 2
            dec["up"][str(i)] = up
        dec["norm_out"] = d.norm(block_in)
        dec["conv_out"] = d.conv(block_in, cfg.out_ch)
        return {"encoder": enc, "decoder": dec,
                "quant_conv": d.conv(cfg.z_channels, cfg.embed_dim, 1),
                "post_quant_conv": d.conv(cfg.embed_dim, cfg.z_channels, 1),
                "quantize": {"embedding": {"weight": d.normal((cfg.codebook_size, cfg.embed_dim),
                                                              0.05)}}}


def detect_restoreformer_config(flat: Dict[str, torch.Tensor]) -> Optional[RestoreFormerConfig]:
    if ("encoder.down.0.block.0.norm1.weight" not in flat
            or "decoder.mid.attn_1.norm2.weight" not in flat):
        return None
    ch, in_ch = flat["encoder.conv_in.weight"].shape[:2]
    codebook, embed = flat["quantize.embedding.weight"].shape
    n_levels = 1 + max(int(k.split(".")[2]) for k in flat if k.startswith("encoder.down."))
    ch_mult = tuple(flat[f"encoder.down.{i}.block.0.conv1.weight"].shape[0] // ch
                    for i in range(n_levels))
    n_res = 1 + max(int(k.split(".")[4]) for k in flat if k.startswith("encoder.down.0.block."))
    return RestoreFormerConfig(ch=int(ch), ch_mult=ch_mult, num_res_blocks=n_res,
                               z_channels=flat["quant_conv.weight"].shape[1], embed_dim=embed,
                               codebook_size=codebook, in_ch=int(in_ch))


def load_restoreformer(path, device=None):
    """A RestoreFormer checkpoint -> (RestoreFormer, params on ``device``,
    default the card)."""
    from stable_renderer_tpu_torch.models.upscale import read_upscale_state, to_params

    flat = read_upscale_state(path)
    cfg = detect_restoreformer_config(flat)
    if cfg is None:
        raise ValueError(f"{path} is not a RestoreFormer checkpoint")
    return RestoreFormer(cfg), to_params(flat, device)
