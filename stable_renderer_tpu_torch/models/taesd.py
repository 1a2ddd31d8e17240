"""TAESD — the tiny autoencoder for realtime frames and cheap previews.

Counterpart of stable_renderer_tpu/models/taesd.py (the reference's
comfy/taesd/taesd.py). Param keys are the torch Sequential indices of the
original ("decoder.1.weight", "decoder.3.conv.0.weight", ...), so the tree has
the official taesd_encoder / taesd_decoder layout.

Layer plan (taesd.py):
  Encoder: conv(3,64) B c2 B B B c2 B B B c2 B B B conv(64,4)
  Decoder: Clamp conv(4,64) ReLU  B B B U c  B B B U c  B B B U c  B conv(64,3)
  (B = residual block of 3 convs + ReLUs; c2 = stride-2 conv without bias;
   U = nearest x2; c = conv without bias)

The convs go through ``models.layers.conv2d``, which casts the weight to the
activation's dtype: the f32 tree runs in bf16 when the pipeline hands it bf16
pixels, as the JAX package's conv2d does. At 64 channels no conv passes K3's
gate. ``TAESD.load`` reads the official taesd_encoder / taesd_decoder
.pth or .safetensors files.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from stable_renderer_tpu_torch.models.layers import conv2d, upsample_nearest_2x

_ENC_PLAN: List[Tuple] = (
    [("conv", 3, 64)]
    + [("block", 64)]
    + [("down", 64), ("block", 64), ("block", 64), ("block", 64)]
    + [("down", 64), ("block", 64), ("block", 64), ("block", 64)]
    + [("down", 64), ("block", 64), ("block", 64), ("block", 64)]
    + [("conv", 64, 4)]
)
_DEC_PLAN: List[Tuple] = (
    [("clamp",), ("conv", 4, 64), ("relu",)]
    + [("block", 64), ("block", 64), ("block", 64), ("up",), ("convnb", 64, 64)]
    + [("block", 64), ("block", 64), ("block", 64), ("up",), ("convnb", 64, 64)]
    + [("block", 64), ("block", 64), ("block", 64), ("up",), ("convnb", 64, 64)]
    + [("block", 64), ("conv", 64, 3)]
)

LATENT_MAGNITUDE = 3.0


def _block(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(conv2d(p["conv"]["0"], x, padding=1))
    h = torch.relu(conv2d(p["conv"]["2"], h, padding=1))
    h = conv2d(p["conv"]["4"], h, padding=1)
    return torch.relu(h + x)


def _run_plan(plan, params: dict, x: torch.Tensor) -> torch.Tensor:
    for idx, layer in enumerate(plan):
        kind = layer[0]
        key = str(idx)
        if kind in ("conv", "convnb"):
            x = conv2d(params[key], x, padding=1)
        elif kind == "down":
            x = conv2d(params[key], x, stride=2, padding=1)
        elif kind == "block":
            x = _block(params[key], x)
        elif kind == "up":
            x = upsample_nearest_2x(x)
        elif kind == "relu":
            x = torch.relu(x)
        elif kind == "clamp":
            x = torch.tanh(x / 3.0) * 3.0
    return x


class TAESD:
    def encode(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """pixels (N, H, W, 3) in [0, 1] -> scaled SD latent (N, H/8, W/8, 4)."""
        return _run_plan(_ENC_PLAN, params["encoder"], x) / LATENT_MAGNITUDE

    def decode(self, params: dict, z: torch.Tensor) -> torch.Tensor:
        """SD latent -> pixels (N, 8h, 8w, 3) in [0, 1]."""
        return torch.clamp(_run_plan(_DEC_PLAN, params["decoder"], z), 0.0, 1.0)

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        """Random init with the JAX package's tree, shapes and scale: every
        conv weight N(0, 0.05^2), biases zero, drawn in plan order (encoder,
        then decoder) from ``generator``."""

        def conv(i, o, bias=True):
            w = torch.randn((o, i, 3, 3), generator=generator, device=device) * 0.05
            p = {"weight": w.to(dtype)}
            if bias:
                p["bias"] = torch.zeros((o,), dtype=dtype, device=device)
            return p

        def build(plan):
            params: Dict[str, dict] = {}
            for idx, layer in enumerate(plan):
                kind = layer[0]
                if kind == "conv":
                    params[str(idx)] = conv(layer[1], layer[2])
                elif kind == "convnb":
                    params[str(idx)] = conv(layer[1], layer[2], bias=False)
                elif kind == "down":
                    params[str(idx)] = conv(layer[1], layer[1], bias=False)
                elif kind == "block":
                    n = layer[1]
                    params[str(idx)] = {
                        "conv": {"0": conv(n, n), "2": conv(n, n), "4": conv(n, n)}}
            return params

        return {"encoder": build(_ENC_PLAN), "decoder": build(_DEC_PLAN)}

    @staticmethod
    def load(encoder_path: Optional[str] = None, decoder_path: Optional[str] = None) -> dict:
        """Official taesd .pth / .safetensors files -> {"encoder", "decoder"}
        trees of CPU tensors in the files' dtypes (a path left out gives an
        empty tree)."""
        from stable_renderer_tpu_torch.models.weights import load_state_dict, nest

        params: dict = {"encoder": {}, "decoder": {}}
        if encoder_path:
            params["encoder"] = nest(load_state_dict(encoder_path), "")
        if decoder_path:
            params["decoder"] = nest(load_state_dict(decoder_path), "")
        return params
