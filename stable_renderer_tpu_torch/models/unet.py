"""SD1.5-class UNet as a function over a checkpoint-layout param dict, with
correspondence hooks.

Counterpart of stable_renderer_tpu/models/unet.py (reference:
openaimodel.py UNetModel, attention.py SpatialTransformer /
BasicTransformerBlock). The reference threads ``transformer_options`` through
every block and calls ``corresponder.pre_atten_inject`` /
``post_atten_inject`` around each self-attention; here those hooks are the
callables of ``AttnHooks``, called with the running transformer index
(0..15 for SD1.5, in execution order).

Activations are NHWC; matmuls and convs run in the activation dtype (bf16 on
the card) with f32 norm statistics. Self-attention at 64 x 64 latent (4096
tokens) goes to the flash-attention kernel through ``layers.attention``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from stable_renderer_tpu_torch.models.layers import (
    attention,
    conv2d,
    geglu,
    group_norm,
    layer_norm,
    linear,
    norm_act_conv,
    silu,
    timestep_embedding,
    upsample_nearest_2x,
)


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    attention_levels: Tuple[int, ...] = (0, 1, 2)  # levels with SpatialTransformer
    transformer_depth: int = 1
    num_heads: int = 8
    context_dim: int = 768
    # class-label embedding table (num_classes, time_embed_dim), indexed by
    # an integer y (openaimodel num_classes=int path)
    num_classes: Optional[int] = None
    # ADM vector width: label_emb is the MLP adm -> time_embed_dim -> same
    adm_in_channels: Optional[int] = None

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4

    def heads_for(self, channels: int) -> int:
        """Attention heads at a block of ``channels`` (a fixed count for SD1.5)."""
        return self.num_heads


SD15_UNET_CONFIG = UNetConfig()

TINY_UNET_CONFIG = UNetConfig(
    model_channels=32,
    num_res_blocks=1,
    channel_mult=(1, 2),
    attention_levels=(0, 1),
    num_heads=2,
    context_dim=64,
)
"""Small config for tests (same topology, tiny widths)."""


class AttnHooks(NamedTuple):
    """The Corresponder attention-injection points (corresponder.py:29-98).

    pre:  (q_ctx, k_ctx, v_ctx, layer_idx) -> (q_ctx, k_ctx, v_ctx), on the
          contexts before the q/k/v projections of self-attention.
    post: (values, layer_idx) -> values, on the self-attention output.
    attn: (q, k, v, heads, layer_idx) -> values, replacing self-attention.
    mid:  (x, layer_idx) -> x, after the attn1 residual add.

    The JAX package's model-patch points (pre_all, pre_cross, attn_all,
    out_block, in_block, in_block_after) come with the workflow slice.
    """

    pre: Optional[Callable] = None
    post: Optional[Callable] = None
    attn: Optional[Callable] = None
    mid: Optional[Callable] = None


# ---------------------------------------------------------------------------
# blocks


def res_block(p: dict, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """openaimodel ResBlock: GN-SiLU-conv + time-emb add + GN-SiLU-conv + skip.
    eps=1e-5: ResBlock norms are plain GroupNorm(32, ch) (torch default)."""
    h = norm_act_conv(p["in_layers"]["0"], p["in_layers"]["2"], x, eps=1e-5)
    emb_out = linear(p["emb_layers"]["1"], silu(emb))
    h = h + emb_out[:, None, None, :].to(h.dtype)
    h = norm_act_conv(p["out_layers"]["0"], p["out_layers"]["3"], h, eps=1e-5)
    if "skip_connection" in p:
        x = conv2d(p["skip_connection"], x)
    return x + h


def basic_transformer_block(
    p: dict,
    x: torch.Tensor,        # (B, L, C)
    context: torch.Tensor,  # (B, Lc, context_dim)
    heads: int,
    layer_idx: int,
    hooks: AttnHooks,
) -> torch.Tensor:
    """attention.py BasicTransformerBlock._forward with the injection points."""
    n = layer_norm(p["norm1"], x)
    q_ctx = k_ctx = v_ctx = n
    if hooks.pre is not None:
        q_ctx, k_ctx, v_ctx = hooks.pre(q_ctx, k_ctx, v_ctx, layer_idx)
    a1 = p["attn1"]
    if q_ctx is k_ctx and k_ctx is v_ctx:
        # fused QKV: one (L, C) x (C, 3C) product instead of three
        w_qkv = torch.cat([a1["to_q"]["weight"], a1["to_k"]["weight"], a1["to_v"]["weight"]], 0)
        q, k, v = linear({"weight": w_qkv}, q_ctx).chunk(3, dim=-1)
    else:
        q = linear(a1["to_q"], q_ctx)
        k = linear(a1["to_k"], k_ctx)
        v = linear(a1["to_v"], v_ctx)
    if hooks.attn is not None:
        attn_out = hooks.attn(q, k, v, heads, layer_idx)
    else:
        attn_out = attention(q, k, v, heads)
    if hooks.post is not None:
        attn_out = hooks.post(attn_out, layer_idx)
    x = x + linear(a1["to_out"]["0"], attn_out)

    if hooks.mid is not None:
        x = hooks.mid(x, layer_idx)

    # cross-attention (attn2) over the text context, fused KV projection
    n = layer_norm(p["norm2"], x)
    a2 = p["attn2"]
    q = linear(a2["to_q"], n)
    w_kv = torch.cat([a2["to_k"]["weight"], a2["to_v"]["weight"]], 0)
    k, v = linear({"weight": w_kv}, context).chunk(2, dim=-1)
    x = x + linear(a2["to_out"]["0"], attention(q, k, v, heads))

    n = layer_norm(p["norm3"], x)
    return x + linear(p["ff"]["net"]["2"], geglu(p["ff"]["net"]["0"], n))


def spatial_transformer(
    p: dict,
    x: torch.Tensor,  # (B, H, W, C)
    context: torch.Tensor,
    heads: int,
    depth: int,
    layer_idx: int,
    hooks: AttnHooks,
) -> Tuple[torch.Tensor, int]:
    """attention.py SpatialTransformer.forward; proj_in/proj_out may be
    linears (B, L, C) or 1x1 convs (O, I, 1, 1)."""
    b, h, w, c = x.shape
    n = group_norm(p["norm"], x)
    use_conv_proj = p["proj_in"]["weight"].dim() == 4
    if use_conv_proj:
        n = conv2d(p["proj_in"], n).reshape(b, h * w, c)
    else:
        n = linear(p["proj_in"], n.reshape(b, h * w, c))
    for d in range(depth):
        n = basic_transformer_block(p["transformer_blocks"][str(d)], n, context, heads,
                                    layer_idx, hooks)
    if use_conv_proj:
        n = conv2d(p["proj_out"], n.reshape(b, h, w, c))
    else:
        n = linear(p["proj_out"], n).reshape(b, h, w, c)
    return n + x, layer_idx + 1


def downsample(p: dict, x: torch.Tensor) -> torch.Tensor:
    return conv2d(p["op"], x, stride=2, padding=1)


def upsample(p: dict, x: torch.Tensor) -> torch.Tensor:
    return conv2d(p["conv"], upsample_nearest_2x(x), padding=1)


# ---------------------------------------------------------------------------
# UNet


class UNetModel:
    """Functional UNet: ``apply(params, x, timesteps, context, hooks=...)``.

    The param tree mirrors the checkpoint under ``model.diffusion_model.``:
    input_blocks.N.M.*, middle_block.M.*, output_blocks.N.M.*, time_embed.*,
    out.*."""

    def __init__(self, config: UNetConfig = SD15_UNET_CONFIG):
        self.config = config

    def block_plan(self):
        """(plan_in, plan_out, input_chs): plan_in entries (kind, out_ch,
        depth), plan_out entries (kind, out_ch, upsample, depth)."""
        cfg = self.config
        ch = cfg.model_channels
        input_chs = [ch]
        plan_in = [("conv", None, 0)]
        for level, mult in enumerate(cfg.channel_mult):
            out_ch = cfg.model_channels * mult
            depth = cfg.transformer_depth if level in cfg.attention_levels else 0
            for _ in range(cfg.num_res_blocks):
                plan_in.append(("res_attn" if depth > 0 else "res", out_ch, depth))
                ch = out_ch
                input_chs.append(ch)
            if level != len(cfg.channel_mult) - 1:
                plan_in.append(("down", ch, 0))
                input_chs.append(ch)
        plan_out = []
        for level in reversed(range(len(cfg.channel_mult))):
            out_ch = cfg.model_channels * cfg.channel_mult[level]
            depth = cfg.transformer_depth if level in cfg.attention_levels else 0
            for i in range(cfg.num_res_blocks + 1):
                up = level != 0 and i == cfg.num_res_blocks
                plan_out.append(("res_attn" if depth > 0 else "res", out_ch, up, depth))
        return plan_in, plan_out, input_chs

    def apply(
        self,
        params: dict,
        x: torch.Tensor,          # (B, H, W, in_channels) latent
        timesteps: torch.Tensor,  # (B,) float
        context: torch.Tensor,    # (B, L, context_dim) text conditioning
        y: Optional[torch.Tensor] = None,
        control: Optional[dict] = None,  # {'input': [...], 'middle': [...], 'output': [...]}
        hooks: AttnHooks = AttnHooks(),
    ) -> torch.Tensor:
        """``control`` holds ControlNet residuals (``models/controlnet.py``):
        ``input`` entries are added after their input block (None: none),
        ``middle`` after the middle block, and ``output`` entries are popped
        onto the skip connections, last first. ``y`` joins the time
        embedding through ``label_emb``: a class-table row when the config
        has ``num_classes``, the ADM MLP when it has ``adm_in_channels``; a
        UNet with neither ignores it, as the JAX package's does."""
        cfg = self.config
        t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
        emb = linear(params["time_embed"]["0"], t_emb)
        emb = linear(params["time_embed"]["2"], silu(emb))
        if cfg.num_classes is not None and y is not None:
            table = params["label_emb"]["weight"]
            emb = emb + table[torch.as_tensor(y).to(table.device).long().reshape(-1)].to(emb.dtype)
        elif cfg.adm_in_channels is not None and y is not None:
            y_emb = linear(params["label_emb"]["0"]["0"], y.to(x.dtype))
            emb = emb + linear(params["label_emb"]["0"]["2"], silu(y_emb))
        middle_depth = max(cfg.transformer_depth, 1)

        plan_in, plan_out, _ = self.block_plan()
        layer_idx = 0
        hs = []
        h = x
        ctrl_in = control.get("input") if control is not None else None
        for i, (kind, _, depth) in enumerate(plan_in):
            p = params["input_blocks"][str(i)]
            if kind == "conv":
                h = conv2d(p["0"], h, padding=1)
            elif kind == "down":
                h = downsample(p["0"], h)
            else:
                h = res_block(p["0"], h, emb)
                if kind == "res_attn":
                    h, layer_idx = spatial_transformer(
                        p["1"], h, context, cfg.heads_for(h.shape[-1]), depth, layer_idx, hooks)
            if ctrl_in is not None and i < len(ctrl_in) and ctrl_in[i] is not None:
                h = h + ctrl_in[i].to(h.dtype)
            hs.append(h)

        mp = params["middle_block"]
        h = res_block(mp["0"], h, emb)
        h, layer_idx = spatial_transformer(
            mp["1"], h, context, cfg.heads_for(h.shape[-1]), middle_depth, layer_idx, hooks)
        h = res_block(mp["2"], h, emb)
        if control is not None and control.get("middle"):
            h = h + control["middle"][0].to(h.dtype)

        ctrl_out = list(control.get("output", [])) if control is not None else []
        for i, (kind, _, up, depth) in enumerate(plan_out):
            p = params["output_blocks"][str(i)]
            skip = hs.pop()
            if ctrl_out:
                skip = skip + ctrl_out.pop().to(h.dtype)
            h = torch.cat([h, skip], dim=-1)
            h = res_block(p["0"], h, emb)
            if kind == "res_attn":
                h, layer_idx = spatial_transformer(
                    p["1"], h, context, cfg.heads_for(h.shape[-1]), depth, layer_idx, hooks)
            if up:
                h = upsample(p["2" if kind == "res_attn" else "1"], h)

        # out.0 = GroupNorm(32, ch), torch default eps 1e-5
        h = group_norm(params["out"]["0"], h, eps=1e-5, act="silu")
        return conv2d(params["out"]["2"], h, padding=1)

    # --- initialization ----------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        """Random init with the param tree and shapes of the checkpoint layout
        (the JAX package's ``init``: fan-in scaled normals, zero biases, unit
        norm scales)."""
        cfg = self.config

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

        def lin(i, o):
            return {"weight": (randn(o, i) / math.sqrt(i)).to(dtype),
                    "bias": torch.zeros(o, dtype=dtype, device=device)}

        def conv(i, o, k=3):
            return {"weight": (randn(o, i, k, k) / math.sqrt(i * k * k)).to(dtype),
                    "bias": torch.zeros(o, dtype=dtype, device=device)}

        def norm(c):
            return {"weight": torch.ones(c, dtype=dtype, device=device),
                    "bias": torch.zeros(c, dtype=dtype, device=device)}

        def resb(i, o):
            p = {
                "in_layers": {"0": norm(i), "2": conv(i, o)},
                "emb_layers": {"1": lin(cfg.time_embed_dim, o)},
                "out_layers": {"0": norm(o), "3": conv(o, o)},
            }
            if i != o:
                p["skip_connection"] = conv(i, o, k=1)
            return p

        def btb(c):
            return {
                "norm1": norm(c), "norm2": norm(c), "norm3": norm(c),
                "attn1": {
                    "to_q": {"weight": lin(c, c)["weight"]},
                    "to_k": {"weight": lin(c, c)["weight"]},
                    "to_v": {"weight": lin(c, c)["weight"]},
                    "to_out": {"0": lin(c, c)},
                },
                "attn2": {
                    "to_q": {"weight": lin(c, c)["weight"]},
                    "to_k": {"weight": lin(cfg.context_dim, c)["weight"]},
                    "to_v": {"weight": lin(cfg.context_dim, c)["weight"]},
                    "to_out": {"0": lin(c, c)},
                },
                "ff": {"net": {"0": {"proj": lin(c, c * 8)}, "2": lin(c * 4, c)}},
            }

        def st(c, depth):
            return {
                "norm": norm(c),
                "proj_in": lin(c, c),
                "transformer_blocks": {str(d): btb(c) for d in range(depth)},
                "proj_out": lin(c, c),
            }

        plan_in, plan_out, _ = self.block_plan()
        params: dict = {
            "time_embed": {
                "0": lin(cfg.model_channels, cfg.time_embed_dim),
                "2": lin(cfg.time_embed_dim, cfg.time_embed_dim),
            },
            "input_blocks": {},
            "middle_block": {},
            "output_blocks": {},
        }
        if cfg.num_classes is not None:
            params["label_emb"] = {"weight": randn(cfg.num_classes, cfg.time_embed_dim).to(dtype)}
        elif cfg.adm_in_channels is not None:
            params["label_emb"] = {"0": {"0": lin(cfg.adm_in_channels, cfg.time_embed_dim),
                                         "2": lin(cfg.time_embed_dim, cfg.time_embed_dim)}}
        ch = cfg.model_channels
        chs = [ch]
        for i, (kind, out_ch, depth) in enumerate(plan_in):
            if kind == "conv":
                params["input_blocks"][str(i)] = {"0": conv(cfg.in_channels, ch)}
            elif kind == "down":
                params["input_blocks"][str(i)] = {"0": {"op": conv(ch, ch)}}
            else:
                blk = {"0": resb(ch, out_ch)}
                ch = out_ch
                if kind == "res_attn":
                    blk["1"] = st(ch, depth)
                params["input_blocks"][str(i)] = blk
            chs.append(ch)
        params["middle_block"] = {
            "0": resb(ch, ch), "1": st(ch, max(cfg.transformer_depth, 1)), "2": resb(ch, ch)}
        for i, (kind, out_ch, up, depth) in enumerate(plan_out):
            blk = {"0": resb(ch + chs.pop(), out_ch)}
            ch = out_ch
            if kind == "res_attn":
                blk["1"] = st(ch, depth)
            if up:
                blk["2" if kind == "res_attn" else "1"] = {"conv": conv(ch, ch)}
            params["output_blocks"][str(i)] = blk
        params["out"] = {"0": norm(ch), "2": conv(ch, cfg.out_channels)}
        return params

    def num_transformer_layers(self) -> int:
        """SpatialTransformer count (16 for SD1.5): the layer indices the
        Corresponder hooks see."""
        plan_in, plan_out, _ = self.block_plan()
        return (sum(k[0] == "res_attn" for k in plan_in) + 1
                + sum(k[0] == "res_attn" for k in plan_out))
