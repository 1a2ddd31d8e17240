"""SCUNet: the Swin-Conv-UNet blind denoiser.

Counterpart of stable_renderer_tpu/models/scunet.py (reference chainner
SCUNet.py: WMSA :19-165, Block :167-200, ConvTransBlock :203-271, the UNet
:273-441). Functional PyTorch over NHWC, the torch Sequential indices
(m_head / m_down1..3 / m_body / m_up3..1 / m_tail) kept.

The stride-2 kernel-2 ConvTranspose upsample has no overlap, so torch's
``conv_transpose2d`` is the JAX package's einsum and depth-to-space, tap for
tap; the shifted-window masks are ``swinir``'s host tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.layers import conv2d, layer_norm, linear
from stable_renderer_tpu_torch.models.swinir import Draws, pad_reflect, shift_mask, table


@dataclass(frozen=True)
class SCUNetConfig:
    dim: int = 64
    config: Tuple[int, ...] = (4, 4, 4, 4, 4, 4, 4)
    head_dim: int = 32
    window_size: int = 8
    in_nc: int = 3


TINY_SCUNET_CONFIG = SCUNetConfig(dim=16, config=(1, 1, 1, 1, 1, 1, 1), head_dim=8,
                                  window_size=4)


def _rel_index(ws: int) -> np.ndarray:
    """(N, N, 2) offsets into the (heads, 2w-1, 2w-1) relative embedding."""
    cord = np.array([[i, j] for i in range(ws) for j in range(ws)])
    return cord[:, None, :] - cord[None, :, :] + ws - 1


def _wmsa(p: dict, x: torch.Tensor, head_dim: int, ws: int, shifted: bool) -> torch.Tensor:
    """Window MSA (SCUNet.py:19-165). x: (B, H, W, C)."""
    b, h, w, c = x.shape
    heads = c // head_dim
    if shifted:
        x = torch.roll(x, (-(ws // 2), -(ws // 2)), dims=(1, 2))
    win = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    win = win.reshape(b, -1, ws * ws, c)  # (B, nW, N, C)
    q, k, v = linear(p["embedding_layer"], win).chunk(3, dim=-1)

    def heads_of(t):
        return t.reshape(b, t.shape[1], ws * ws, heads, head_dim).permute(0, 3, 1, 2, 4)

    sim = torch.einsum("bhwpc,bhwqc->bhwpq", heads_of(q), heads_of(k)) * (head_dim ** -0.5)
    rel = table(("scunet_rel", ws), lambda: _rel_index(ws), x.device)
    bias = p["relative_position_params"][:, rel[:, :, 0], rel[:, :, 1]]
    sim = sim + bias[None, :, None].to(sim.dtype)
    if shifted:
        sim = sim + shift_mask(h, w, ws, ws // 2, x.device)[None, None]
    out = torch.einsum("bhwij,bhwjc->bhwic", torch.softmax(sim, dim=-1), heads_of(v))
    out = linear(p["linear"], out.permute(0, 2, 3, 1, 4).reshape(b, -1, ws * ws, c))
    out = out.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    if shifted:
        out = torch.roll(out, (ws // 2, ws // 2), dims=(1, 2))
    return out


def _trans_block(p: dict, x: torch.Tensor, head_dim: int, ws: int, shifted: bool) -> torch.Tensor:
    """The Swin block (SCUNet.py:167-200). x: (B, H, W, C)."""
    x = x + _wmsa(p["msa"], layer_norm(p["ln1"], x), head_dim, ws, shifted)
    h = linear(p["mlp"]["2"], F.gelu(linear(p["mlp"]["0"], layer_norm(p["ln2"], x))))
    return x + h


def _conv_trans_block(p: dict, x: torch.Tensor, conv_dim: int, head_dim: int, ws: int,
                      shifted: bool) -> torch.Tensor:
    """ConvTransBlock (SCUNet.py:203-271): a 1x1 split into a conv branch and
    a transformer branch, merged again by a 1x1, residual."""
    y = conv2d(p["conv1_1"], x)
    conv_x, trans_x = y[..., :conv_dim], y[..., conv_dim:]
    cb = conv2d(p["conv_block"]["0"], conv_x, padding=1)
    conv_x = conv2d(p["conv_block"]["2"], torch.relu(cb), padding=1) + conv_x
    trans_x = _trans_block(p["trans_block"], trans_x, head_dim, ws, shifted)
    return x + conv2d(p["conv1_2"], torch.cat([conv_x, trans_x], -1))


def _conv_down(p: dict, x: torch.Tensor) -> torch.Tensor:
    """A stride-2 kernel-2 conv (no bias)."""
    return conv2d(p, x, stride=2, padding=0)


def _conv_transpose_up(p: dict, x: torch.Tensor) -> torch.Tensor:
    """A stride-2 kernel-2 ConvTranspose2d, weight (in, out, 2, 2)."""
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), p["weight"].to(x.dtype), stride=2)
    return out.permute(0, 2, 3, 1)


class SCUNet:
    def __init__(self, config: SCUNetConfig = SCUNetConfig()):
        self.config = config

    @property
    def scale(self) -> int:
        return 1

    def _stage(self, params: dict, x: torch.Tensor, name: str, n_blocks: int, conv_dim: int,
               first_up: bool = False, last_down: bool = False) -> torch.Tensor:
        cfg = self.config
        sp = params[name]
        idx = 0
        if first_up:
            x = _conv_transpose_up(sp["0"], x)
            idx = 1
        for i in range(n_blocks):
            x = _conv_trans_block(sp[str(idx + i)], x, conv_dim, cfg.head_dim, cfg.window_size,
                                  shifted=bool(i % 2))
        if last_down:
            x = _conv_down(sp[str(idx + n_blocks)], x)
        return x

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) in [0, 1] -> denoised (B, H, W, C)."""
        cfg = self.config
        d, c = cfg.dim, cfg.config
        b, h_in, w_in, _ = x.shape
        pad = 8 * cfg.window_size  # the UNet's 3 downsamples x the window
        x = pad_reflect(x, (pad - h_in % pad) % pad, (pad - w_in % pad) % pad)
        x1 = conv2d(params["m_head"]["0"], x, padding=1)
        x2 = self._stage(params, x1, "m_down1", c[0], d // 2, last_down=True)
        x3 = self._stage(params, x2, "m_down2", c[1], d, last_down=True)
        x4 = self._stage(params, x3, "m_down3", c[2], 2 * d, last_down=True)
        y = self._stage(params, x4, "m_body", c[3], 4 * d)
        y = self._stage(params, y + x4, "m_up3", c[4], 2 * d, first_up=True)
        y = self._stage(params, y + x3, "m_up2", c[5], d, first_up=True)
        y = self._stage(params, y + x2, "m_up1", c[6], d // 2, first_up=True)
        return conv2d(params["m_tail"]["0"], y + x1, padding=1)[:, :h_in, :w_in]

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        cfg = self.config
        dr = Draws(generator, dtype, device)
        ws = cfg.window_size

        def ctb(cd, td):
            return {
                "conv1_1": dr.conv(cd + td, cd + td, 1), "conv1_2": dr.conv(cd + td, cd + td, 1),
                "conv_block": {"0": dr.conv(cd, cd, bias=False), "2": dr.conv(cd, cd, bias=False)},
                "trans_block": {
                    "ln1": dr.norm(td), "ln2": dr.norm(td),
                    "msa": {"embedding_layer": dr.lin(td, 3 * td), "linear": dr.lin(td, td),
                            "relative_position_params": dr.normal(
                                (td // cfg.head_dim, 2 * ws - 1, 2 * ws - 1), 0.02)},
                    "mlp": {"0": dr.lin(td, 4 * td), "2": dr.lin(4 * td, td)},
                },
            }

        def convt(i, o):
            return {"weight": dr.normal((i, o, 2, 2), 0.05)}

        d, c = cfg.dim, cfg.config
        params: Dict[str, dict] = {"m_head": {"0": dr.conv(cfg.in_nc, d, bias=False)},
                                   "m_tail": {"0": dr.conv(d, cfg.in_nc, bias=False)}}
        for name, n, w, nxt in (("m_down1", c[0], d // 2, 2 * d), ("m_down2", c[1], d, 4 * d),
                                ("m_down3", c[2], 2 * d, 8 * d)):
            params[name] = {str(i): ctb(w, w) for i in range(n)}
            params[name][str(n)] = dr.conv(2 * w, nxt, 2, bias=False)
        params["m_body"] = {str(i): ctb(4 * d, 4 * d) for i in range(c[3])}
        for name, n, w in (("m_up3", c[4], 2 * d), ("m_up2", c[5], d), ("m_up1", c[6], d // 2)):
            params[name] = {"0": convt(4 * w, 2 * w)}
            params[name].update({str(1 + i): ctb(w, w) for i in range(n)})
        return params


def detect_scunet_config(flat: Dict[str, torch.Tensor]) -> Optional[SCUNetConfig]:
    if "m_head.0.weight" not in flat or "m_down1.0.trans_block.ln1.weight" not in flat:
        return None
    dim, in_nc = flat["m_head.0.weight"].shape[:2]

    def n_blocks(stage: str, offset: int = 0) -> int:
        i = offset
        while f"{stage}.{i}.trans_block.ln1.weight" in flat:
            i += 1
        return i - offset

    cfg = (n_blocks("m_down1"), n_blocks("m_down2"), n_blocks("m_down3"), n_blocks("m_body"),
           n_blocks("m_up3", 1), n_blocks("m_up2", 1), n_blocks("m_up1", 1))
    rel = flat["m_down1.0.trans_block.msa.relative_position_params"]
    return SCUNetConfig(dim=int(dim), config=cfg, head_dim=(int(dim) // 2) // rel.shape[0],
                        window_size=(rel.shape[1] + 1) // 2, in_nc=int(in_nc))


def load_scunet(path, device=None):
    """A SCUNet checkpoint -> (SCUNet, params on ``device``, default the card)."""
    from stable_renderer_tpu_torch.models.upscale import read_upscale_state, to_params

    flat = read_upscale_state(path)
    cfg = detect_scunet_config(flat)
    if cfg is None:
        raise ValueError(f"{path} is not a SCUNet checkpoint")
    return SCUNet(cfg), to_params(flat, device)
