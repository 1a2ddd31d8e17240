"""ControlNet (cldm): conditioning the UNet on G-buffer maps.

Counterpart of stable_renderer_tpu/models/controlnet.py (reference:
comfy/controlnet.py ControlBase / ControlNet, comfy/cldm/cldm.py). The engine
feeds it the G-buffer's normal / depth / canny maps directly.

The param tree mirrors the checkpoint under ``control_model.``:
time_embed.*, input_hint_block.*, input_blocks.*, zero_convs.N.0.*,
middle_block.*, middle_block_out.0.*.

``apply`` returns the control dict ``UNetModel.apply`` takes:
{'middle': [tensor], 'output': [one residual per input block]}, scaled by
``strength`` and gated by the (start, end) denoise-percent range. The gate
reads ``timesteps[0]`` for the whole batch, as the JAX package does: in the
stream pipeline every row is gated by row 0's timestep.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from stable_renderer_tpu_torch.models.layers import conv2d, linear, silu, timestep_embedding
from stable_renderer_tpu_torch.models.unet import (
    SD15_UNET_CONFIG,
    AttnHooks,
    UNetConfig,
    UNetModel,
    downsample,
    res_block,
    spatial_transformer,
)

# input_hint_block: (torch index, stride) of its 8 convs, SiLU between them;
# channels 3 -> 16 -> 16 -> 32 -> 32 -> 96 -> 96 -> 256 -> model_channels
_HINT_CONVS = (("0", 1), ("2", 1), ("4", 2), ("6", 1), ("8", 2), ("10", 1), ("12", 2), ("14", 1))
_HINT_CHANNELS = (16, 16, 32, 32, 96, 96, 256)


@dataclass(frozen=True)
class ControlNetConfig:
    unet: UNetConfig = SD15_UNET_CONFIG
    hint_channels: int = 3


class ControlNet:
    def __init__(self, config: ControlNetConfig = ControlNetConfig()):
        self.config = config
        self._unet = UNetModel(config.unet)

    def apply_hint(self, params: dict, hint: torch.Tensor) -> torch.Tensor:
        """input_hint_block: hint (B, H, W, 3) -> (B, H/8, W/8, model_channels)."""
        p = params["input_hint_block"]
        h = hint
        for i, (key, stride) in enumerate(_HINT_CONVS):
            h = conv2d(p[key], h, stride=stride, padding=1)
            if i != len(_HINT_CONVS) - 1:
                h = silu(h)
        return h

    def apply(
        self,
        params: dict,
        x: torch.Tensor,          # (B, h, w, 4) scaled latent input, as the UNet's
        hint: Optional[torch.Tensor],  # (B, H, W, 3) control image in [0, 1]
        timesteps: torch.Tensor,  # (B,)
        context: torch.Tensor,    # (B, L, D)
        strength: float = 1.0,
        percent_range: Tuple[float, float] = (0.0, 1.0),
        total_timesteps: int = 1000,
        guided_hint: Optional[torch.Tensor] = None,
    ) -> dict:
        """The control dict for one UNet evaluation. ``guided_hint``, when
        given, is ``apply_hint(params, hint)`` computed beforehand (the hint
        tower's output does not change within a frame), and ``hint`` is
        not read."""
        cfg = self.config.unet
        t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
        emb = linear(params["time_embed"]["0"], t_emb)
        emb = linear(params["time_embed"]["2"], silu(emb))
        if guided_hint is None:
            guided_hint = self.apply_hint(params, hint)
        guided_hint = guided_hint.to(x.dtype)

        plan_in, _, _ = self._unet.block_plan()
        hooks = AttnHooks()
        outs = []
        h = x
        layer_idx = 0
        for i, (kind, _, depth, dis) in enumerate(plan_in):
            p = params["input_blocks"][str(i)]
            if kind == "conv":
                h = conv2d(p["0"], h, padding=1) + guided_hint
            elif kind == "down":
                h = downsample(p["0"], h)
            else:
                h = res_block(p["0"], h, emb)
                if kind == "res_attn":
                    h, layer_idx = spatial_transformer(
                        p["1"], h, context, cfg.heads_for(h.shape[-1]), depth, layer_idx, hooks,
                        disable_self_attn=dis)
            outs.append(conv2d(params["zero_convs"][str(i)]["0"], h))

        mp = params["middle_block"]
        h = res_block(mp["0"], h, emb)
        h, layer_idx = spatial_transformer(mp["1"], h, context, cfg.heads_for(h.shape[-1]),
                                           max(cfg.middle_depth(), 1), layer_idx, hooks)
        h = res_block(mp["2"], h, emb)
        mid = conv2d(params["middle_block_out"]["0"], h)

        # strength and the denoise-percent gate (ControlBase): percent 0 is the
        # start (t = 999), 1 the end (t = 0). A tensor op: no host sync.
        pct = 1.0 - timesteps[0].float() / (total_timesteps - 1)
        on = (pct >= percent_range[0]) & (pct <= percent_range[1] + 1e-6)
        gate = torch.where(on, strength, 0.0).to(x.dtype)
        return {"middle": [mid * gate], "output": [o * gate for o in outs]}

    def init_control_lora(self, unet_params: dict, control_weights: dict) -> dict:
        """ControlLora (comfy/controlnet.py:303-352 ControlLora +
        ControlLoraOps): ControlNet params composed from the UNet's trunk
        (``time_embed``, ``input_blocks``, ``middle_block``, ``label_emb``,
        copied as the reference copies the diffusion model's state dict) and
        a control file holding full tensors for the control-specific parts
        (hint block, zero convs, norms, biases), which replace the trunk's, and
        ``<name>.up`` / ``<name>.down`` low-rank factors for the shared
        weights. The reference adds ``up @ down`` in every forward; here each
        pair is merged once, as the JAX package does: the product in numpy at
        the factors' own dtype (bf16 factors, which numpy promotes, in f32),
        cast to the weight's dtype and added to it. Full tensors keep the
        file's dtype, on the trunk's device."""
        from stable_renderer_tpu_torch.models.weights import flatten, nest

        flat_unet = flatten(unet_params)
        device = flat_unet["time_embed.0.weight"].device
        out: dict = {k: v for k, v in flat_unet.items()
                     if k.startswith(("time_embed.", "input_blocks.", "middle_block.",
                                      "label_emb."))}
        ups: dict = {}
        for k, v in control_weights.items():
            if k == "lora_controlnet":
                continue
            if k.endswith(".up") or k.endswith(".down"):
                ups.setdefault(k.rsplit(".", 1)[0], {})[k.rsplit(".", 1)[1]] = v
            else:
                out[k] = torch.as_tensor(v).to(device)
        for base, ud in ups.items():
            w = out[base + ".weight"]
            up, down = (torch.as_tensor(ud[s]).cpu() for s in ("up", "down"))
            up, down = (t.float() if t.dtype == torch.bfloat16 else t for t in (up, down))
            delta = torch.from_numpy(up.numpy().reshape(up.shape[0], -1)
                                     @ down.numpy().reshape(down.shape[0], -1))
            out[base + ".weight"] = w + delta.reshape(w.shape).to(device=w.device, dtype=w.dtype)
        return nest(out, "")

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        """Random init with the checkpoint tree: the UNet's trunk (its
        ``init``), hint convs drawn N(0, 0.02^2), and zero-initialised zero
        convs, middle_block_out and last hint conv, as the JAX package's
        ``init``: a fresh ControlNet's residuals are exact zeros."""
        cfg = self.config.unet
        unet_params = self._unet.init(generator, dtype=dtype, device=device)

        def conv(i, o, k=3, zero=False):
            if zero:
                w = torch.zeros((o, i, k, k), dtype=dtype, device=device)
            else:
                w = (torch.randn((o, i, k, k), generator=generator, device=device) * 0.02).to(dtype)
            return {"weight": w, "bias": torch.zeros(o, dtype=dtype, device=device)}

        plan_in, _, _ = self._unet.block_plan()
        zero_convs = {}
        cur = cfg.model_channels
        for i, (kind, out_ch, _depth, _dis) in enumerate(plan_in):
            if kind not in ("conv", "down") and out_ch is not None:
                cur = out_ch
            zero_convs[str(i)] = {"0": conv(cur, cur, k=1, zero=True)}
        mid_ch = cfg.model_channels * cfg.channel_mult[-1]
        hint = {}
        in_c = self.config.hint_channels
        out_chs = _HINT_CHANNELS + (cfg.model_channels,)
        for j, out_c in enumerate(out_chs):
            hint[str(j * 2)] = conv(in_c, out_c, zero=j == len(out_chs) - 1)
            in_c = out_c
        return {
            "time_embed": unet_params["time_embed"],
            "input_blocks": unet_params["input_blocks"],
            "zero_convs": zero_convs,
            "input_hint_block": hint,
            "middle_block": unet_params["middle_block"],
            "middle_block_out": {"0": conv(mid_ch, mid_ch, k=1, zero=True)},
        }
