"""T2I-Adapter: a light hint tower feeding input-block residuals.

Counterpart of stable_renderer_tpu/models/t2i_adapter.py (reference:
comfy/controlnet.py:487-560 T2IAdapter / load_t2i_adapter,
comfy/t2i_adapter/adapter.py Adapter / Adapter_light). The adapter sees only
the hint image, not the latent or the timestep, so its features do not
change within a frame: ``apply_hint`` computes them once (the pipeline's
control callable caches them per frame, as it caches a ControlNet's hint
tower) and ``apply`` gates them per evaluation.

Residual placement is ``apply_control(h, control, 'input')``
(openaimodel.py:891): feature i is added after UNet input block i; for SD1.x
the stage outputs land after blocks 2 / 5 / 8 / 11 (320 / 640 / 1280 / 1280
channels at 64 / 32 / 16 / 8 from a 512 hint through PixelUnshuffle(8) and
three downsamples). The convs go through ``layers.conv2d``, so under the K3
switch a 3x3 conv that passes its gate runs on K3.

The param tree mirrors the checkpoint names (conv_in, body.N.{in_conv,
block1, block2, skep, down_opt.op}), so loading is re-nesting.
``StyleAdapter`` and ``load_style_model`` need the CLIP vision tower and wait
for ROADMAP 1.11.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from stable_renderer_tpu_torch.models.layers import avg_pool_2x, conv2d


@dataclass(frozen=True)
class T2IAdapterConfig:
    channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    nums_rb: int = 2
    cin: int = 192              # 64 * 3 (PixelUnshuffle(8) of RGB)
    ksize: int = 1
    sk: bool = True
    use_conv: bool = False
    xl: bool = False
    light: bool = False

    @property
    def unshuffle(self) -> int:
        return 16 if self.xl else 8

    @property
    def input_channels(self) -> int:
        return self.cin // (self.unshuffle * self.unshuffle)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC PixelUnshuffle: (B, H, W, C) -> (B, H/r, W/r, C*r*r), channel
    index c * r * r + dy * r + dx, as torch.nn.PixelUnshuffle on NCHW."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)


def _pad(p: dict) -> int:
    """'same' padding of a conv leaf's odd kernel."""
    return p["weight"].shape[-1] // 2


class T2IAdapter:
    def __init__(self, config: T2IAdapterConfig = T2IAdapterConfig()):
        self.config = config

    # --- blocks ---------------------------------------------------------------

    def _resnet(self, p: dict, x: torch.Tensor, down: bool) -> torch.Tensor:
        if down:
            if self.config.use_conv:
                x = conv2d(p["down_opt"]["op"], x, stride=2, padding=1)
            else:
                x = avg_pool_2x(x)
        if "in_conv" in p:
            x = conv2d(p["in_conv"], x, padding=_pad(p["in_conv"]))
        h = torch.relu(conv2d(p["block1"], x, padding=1))
        h = conv2d(p["block2"], h, padding=_pad(p["block2"]))
        if "skep" in p:
            return h + conv2d(p["skep"], x, padding=_pad(p["skep"]))
        return h + x

    def _extractor(self, p: dict, x: torch.Tensor, down: bool) -> torch.Tensor:
        """An Adapter_light stage: avg-pool down, 1x1 in, nums_rb light
        resnets, 1x1 out."""
        if down:
            x = avg_pool_2x(x)
        x = conv2d(p["in_conv"], x)
        for j in range(self.config.nums_rb):
            b = p["body"][str(j)]
            h = torch.relu(conv2d(b["block1"], x, padding=1))
            x = x + conv2d(b["block2"], h, padding=1)
        return conv2d(p["out_conv"], x)

    # --- forward ----------------------------------------------------------------

    def features(self, params: dict, hint: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """hint (B, H, W, C) in [0, 1] -> one residual (or None) per UNet input
        block, in the hint's dtype."""
        cfg = self.config
        if cfg.input_channels == 1 and hint.shape[-1] > 1:
            hint = hint.mean(dim=-1, keepdim=True)
        else:
            hint = hint[..., : cfg.input_channels]
        x = pixel_unshuffle(hint, cfg.unshuffle)
        feats: List[Optional[torch.Tensor]] = []
        if cfg.light:
            for i in range(len(cfg.channels)):
                x = self._extractor(params["body"][str(i)], x, down=i != 0)
                feats += [None, None, x]
            return feats
        x = conv2d(params["conv_in"], x, padding=1)
        down_stages = (2,) if cfg.xl else (1, 2, 3)
        idx = 0
        for i in range(len(cfg.channels)):
            for j in range(cfg.nums_rb):
                x = self._resnet(params["body"][str(idx)], x, i in down_stages and j == 0)
                idx += 1
            if cfg.xl:
                feats.append(None)
                if i == 0:
                    feats += [None, None]
                if i == 2:
                    feats.append(None)
            else:
                feats += [None, None]
            feats.append(x)
        return feats

    def apply_hint(self, params: dict, hint: torch.Tensor,
                   dtype: Optional[torch.dtype] = None) -> List[Optional[torch.Tensor]]:
        """The features of ``hint`` computed in ``dtype`` (the UNet's
        activation type, as the JAX package computes them)."""
        return self.features(params, hint if dtype is None else hint.to(dtype))

    def apply(
        self,
        params: dict,
        x: torch.Tensor,          # (B, h, w, 4) scaled latent input, as the UNet's
        hint: Optional[torch.Tensor],  # (B, H, W, C) control image in [0, 1]
        timesteps: torch.Tensor,  # (B,)
        context: torch.Tensor,    # unused (ControlNet.apply's signature)
        strength: float = 1.0,
        percent_range: Tuple[float, float] = (0.0, 1.0),
        total_timesteps: int = 1000,
        guided_hint: Optional[List[Optional[torch.Tensor]]] = None,
    ) -> dict:
        """{'input': the features scaled by ``strength``, gated by the
        denoise-percent range on ``timesteps[0]``}. ``guided_hint``, when
        given, is ``apply_hint(params, hint, x.dtype)`` computed beforehand,
        and ``hint`` is not read."""
        del context
        feats = guided_hint if guided_hint is not None else self.apply_hint(params, hint, x.dtype)
        pct = 1.0 - timesteps[0].float() / (total_timesteps - 1)
        on = (pct >= percent_range[0]) & (pct <= percent_range[1] + 1e-6)
        gate = torch.where(on, strength, 0.0).to(x.dtype)
        return {"input": [None if f is None else f * gate for f in feats]}

    # --- init (tests) -----------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        """Random init with the checkpoint tree: N(0, 0.02^2) conv weights,
        zero biases, as the JAX package's ``init``."""
        cfg = self.config

        def conv(i, o, k):
            w = torch.randn((o, i, k, k), generator=generator, device=device) * 0.02
            return {"weight": w.to(dtype), "bias": torch.zeros(o, dtype=dtype, device=device)}

        if cfg.light:
            body = {}
            prev = cfg.cin
            for i, ch in enumerate(cfg.channels):
                body[str(i)] = {
                    "in_conv": conv(prev, ch // 4, 1),
                    "body": {str(j): {"block1": conv(ch // 4, ch // 4, 3),
                                      "block2": conv(ch // 4, ch // 4, 3)}
                             for j in range(cfg.nums_rb)},
                    "out_conv": conv(ch // 4, ch, 1),
                }
                prev = ch
            return {"body": body}
        body = {}
        idx = 0
        down_stages = (2,) if cfg.xl else (1, 2, 3)
        for i, ch in enumerate(cfg.channels):
            for j in range(cfg.nums_rb):
                in_c = cfg.channels[i - 1] if (j == 0 and i > 0) else ch
                p: dict = {"block1": conv(ch, ch, 3), "block2": conv(ch, ch, cfg.ksize)}
                if in_c != ch or not cfg.sk:
                    p["in_conv"] = conv(in_c, ch, cfg.ksize)
                if not cfg.sk:
                    p["skep"] = conv(in_c, ch, cfg.ksize)
                if i in down_stages and j == 0 and cfg.use_conv:
                    p["down_opt"] = {"op": conv(in_c, in_c, 3)}
                body[str(idx)] = p
                idx += 1
        return {"conv_in": conv(cfg.cin, cfg.channels[0], 3), "body": body}


def load_t2i_adapter(flat: Mapping[str, Any]) -> Tuple[T2IAdapter, Dict[str, Any]]:
    """A reference-format adapter state dict -> (T2IAdapter, params), as
    comfy load_t2i_adapter (controlnet.py:541-560) detects it: the diffusers
    layout (``adapter.body.i.resnets.j.*``) is renamed first; Adapter_light
    when ``body.0.in_conv`` is there without ``conv_in``; else the full
    Adapter keyed off ``conv_in``, ksize from ``body.0.block2``, xl when cin
    is 256 or 768. The params are the file's tensors, nested."""
    from stable_renderer_tpu_torch.models.weights import nest

    if any(k.startswith("adapter.") for k in flat):
        remapped = {}
        for k, v in flat.items():
            parts = k.split(".")
            if k.startswith("adapter.body.") and "resnets" in parts:
                i, j = int(parts[2]), int(parts[4])
                remapped["body.%d.%s" % (i * 2 + j, ".".join(parts[5:]))] = v
            elif k.startswith("adapter.body."):
                remapped["body.%d.%s" % (int(parts[2]) * 2, ".".join(parts[3:]))] = v
            elif k.startswith("adapter."):
                remapped[k[len("adapter."):]] = v
        flat = remapped
    if "body.0.in_conv.weight" in flat and "conv_in.weight" not in flat:
        cfg = T2IAdapterConfig(cin=flat["body.0.in_conv.weight"].shape[1], light=True, nums_rb=4)
        nested = nest(flat, "")
        return T2IAdapter(cfg), {"body": {str(i): nested["body"][str(i)]
                                          for i in range(len(cfg.channels))}}
    if "conv_in.weight" not in flat:
        raise ValueError("not a t2i adapter state dict")
    cin, channel = flat["conv_in.weight"].shape[1], flat["conv_in.weight"].shape[0]
    cfg = T2IAdapterConfig(
        channels=(channel, channel * 2, channel * 4, channel * 4), nums_rb=2, cin=cin,
        ksize=flat["body.0.block2.weight"].shape[2], sk=True,
        use_conv=any(k.endswith("down_opt.op.weight") for k in flat), xl=cin in (256, 768))
    return T2IAdapter(cfg), nest(flat, "")
