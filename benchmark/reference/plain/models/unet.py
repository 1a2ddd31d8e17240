"""The SD-family UNet (SD1.x, SD2, SDXL and its refiner, the x4 upscaler) as
a function over a checkpoint-layout param dict, with correspondence hooks.

Counterpart of stable_renderer_tpu/models/unet.py (reference:
openaimodel.py UNetModel, attention.py SpatialTransformer /
BasicTransformerBlock). The reference threads ``transformer_options`` through
every block and calls ``corresponder.pre_atten_inject`` /
``post_atten_inject`` around each self-attention; here those hooks are the
callables of ``AttnHooks``, called with the running SpatialTransformer
index in execution order (0..15 for SD1.5, 0..10 for SDXL).

Activations are NHWC; matmuls and convs run in the activation dtype (bf16 on
the card) with f32 norm statistics. Self-attention at 64 x 64 latent (4096
tokens) goes to the flash-attention kernel through ``layers.attention``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from benchmark.reference.plain.models.layers import (
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
from benchmark.reference.plain.parallel.mesh import active_tp, copy_to_tp, reduce_from_tp


@dataclass(frozen=True)
class UNetConfig:
    """The JAX package's ``UNetConfig``, field for field: the uniform SD1.5
    layout by default, and the per-level and per-block layouts that SD2,
    SDXL, the refiner, the distilled SDXL family and the x4 upscaler need."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    attention_levels: Tuple[int, ...] = (0, 1, 2)  # levels with SpatialTransformer
    transformer_depth: int = 1
    # per-level transformer depth (SDXL); None = transformer_depth everywhere
    transformer_depth_per_level: Optional[Tuple[int, ...]] = None
    # per-res-block depths in input_blocks / output_blocks order (comfy
    # model_detection's layout; SSD-1B, Vega, KOALA); None = the per-level rule
    transformer_depth_blocks: Optional[Tuple[int, ...]] = None
    transformer_depth_blocks_out: Optional[Tuple[int, ...]] = None
    # the middle block (openaimodel.py:735-738): None = a transformer at the
    # last level's depth; >= 0 = [res, transformer(d), res]; -1 = [res];
    # <= -2 = no middle block
    transformer_depth_middle: Optional[int] = None
    # per-level res-block counts (KOALA); None = num_res_blocks everywhere
    num_res_blocks_per_level: Optional[Tuple[int, ...]] = None
    # per-level disable_self_attn (SD_X4Upscaler): attn1 cross-attends the
    # text context instead of self-attending
    disable_self_attn_levels: Optional[Tuple[bool, ...]] = None
    # class-label embedding table (num_classes, time_embed_dim), indexed by
    # an integer y (openaimodel num_classes=int path, the x4 upscaler)
    num_classes: Optional[int] = None
    num_heads: int = 8
    # 64-wide heads (SD2, SDXL) instead of a fixed head count
    head_dim: Optional[int] = None
    context_dim: int = 768
    # ADM vector width: label_emb is the MLP adm -> time_embed_dim -> same
    adm_in_channels: Optional[int] = None

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4

    def depth_at(self, level: int) -> int:
        if self.transformer_depth_per_level is not None:
            return self.transformer_depth_per_level[level]
        return self.transformer_depth

    def res_blocks_at(self, level: int) -> int:
        if self.num_res_blocks_per_level is not None:
            return self.num_res_blocks_per_level[level]
        return self.num_res_blocks

    def middle_depth(self) -> int:
        """The middle block's transformer depth (see transformer_depth_middle)."""
        if self.transformer_depth_middle is not None:
            return self.transformer_depth_middle
        return max(self.depth_at(len(self.channel_mult) - 1), 1)

    def self_attn_disabled(self, level: int) -> bool:
        if self.disable_self_attn_levels is None:
            return False
        return bool(self.disable_self_attn_levels[level])

    def heads_for(self, channels: int) -> int:
        """Attention heads at a block of ``channels``: channels / head_dim
        with ``head_dim``, else the fixed ``num_heads``."""
        if self.head_dim is not None:
            return max(channels // self.head_dim, 1)
        return self.num_heads


SD15_UNET_CONFIG = UNetConfig()

SDXL_UNET_CONFIG = UNetConfig(
    model_channels=320,
    channel_mult=(1, 2, 4),
    attention_levels=(1, 2),
    transformer_depth_per_level=(0, 2, 10),
    head_dim=64,
    context_dim=2048,
    adm_in_channels=2816,
)
"""SDXL base (comfy/supported_models.py SDXL): attention at levels 1-2 with
depths 2 and 10, the 2048-wide dual-CLIP context, the ADM vector."""

TINY_UNET_CONFIG = UNetConfig(
    model_channels=32,
    num_res_blocks=1,
    channel_mult=(1, 2),
    attention_levels=(0, 1),
    num_heads=2,
    context_dim=64,
)
"""Small config for tests (same topology, tiny widths)."""

TINY_SDXL_UNET_CONFIG = UNetConfig(
    model_channels=32,
    num_res_blocks=1,
    channel_mult=(1, 2),
    attention_levels=(0, 1),
    num_heads=2,
    context_dim=128,               # tiny CLIP-L 64 + tiny CLIP-G 64
    adm_in_channels=32 + 6 * 256,  # tiny CLIP-G projection + the size Fourier rows
)
"""Tiny SDXL-family config for tests: the ADM vector and the dual-tower context."""


class AttnHooks(NamedTuple):
    """The Corresponder attention-injection points (corresponder.py:29-98).

    pre:  (q_ctx, k_ctx, v_ctx, layer_idx) -> (q_ctx, k_ctx, v_ctx), on the
          contexts before the q/k/v projections of self-attention.
    post: (values, layer_idx) -> values, on the self-attention output.
    attn: (q, k, v, heads, layer_idx) -> values, replacing self-attention.
    mid:  (x, layer_idx) -> x, after the attn1 residual add.

    The model-patch points (comfy ModelPatcher set_model_* API). The CFG
    wrapper passes them through unchanged: they act on the full cond+uncond
    batch, as the reference's model patches do.

    pre_all:   (q_ctx, k_ctx, v_ctx, layer_idx) -> (q_ctx, k_ctx, v_ctx),
               after ``pre`` (set_model_attn1_patch, e.g. hypernetworks).
    pre_cross: (n, ctx_k, ctx_v, layer_idx) -> (n, ctx_k, ctx_v), on the
               cross-attention's inputs (set_model_attn2_patch).
    attn_all:  (q, k, v, heads, layer_idx) -> values, replacing
               self-attention when ``attn`` is None (e.g. HyperTile).
    out_block: (h, hsp, block_idx) -> (h, hsp), before each output block's
               skip concat (set_model_output_block_patch, e.g. FreeU).
    in_block:  (h, block_idx, t) -> h, after each input block, before its
               skip is stored; ``t`` is the (B,) timestep batch.
    in_block_after: (h, block_idx, t) -> h, the same after the skip is
               stored (set_model_input_block_patch_after_skip).
    """

    pre: Optional[Callable] = None
    post: Optional[Callable] = None
    attn: Optional[Callable] = None
    mid: Optional[Callable] = None
    pre_all: Optional[Callable] = None
    pre_cross: Optional[Callable] = None
    attn_all: Optional[Callable] = None
    out_block: Optional[Callable] = None
    in_block: Optional[Callable] = None
    in_block_after: Optional[Callable] = None


# the model-patch points, which act on the whole batch
PATCH_HOOKS = ("pre_all", "pre_cross", "attn_all", "out_block", "in_block", "in_block_after")


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


def _row_linear(p: dict, x: torch.Tensor, tp) -> torch.Tensor:
    """``linear`` of a row-parallel weight: under tensor parallelism the
    rank's (out, in / t) shard times its share of ``x``, summed over the tp
    ranks in f32 (``reduce_from_tp``), then the bias added once."""
    if tp is None:
        return linear(p, x)
    part = reduce_from_tp(torch.nn.functional.linear(x, p["weight"].to(x.dtype)).float(), tp)
    b = p.get("bias")
    return (part if b is None else part + b.float()).to(x.dtype)


def _gather_heads(x: torch.Tensor, tp) -> torch.Tensor:
    """Every rank's head share of (B, L, H/t * D) ``x``, concatenated in
    head order over the tp ranks: (B, L, H * D)."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(tp.size)]
    torch.distributed.all_gather(parts, x.contiguous(), group=tp.group)
    return torch.cat(parts, -1)


def _own_heads(x: torch.Tensor, tp) -> torch.Tensor:
    """This rank's head share of (B, L, H * D) ``x``."""
    cols = x.shape[-1] // tp.size
    return x.narrow(-1, tp.rank * cols, cols)


def _local_heads(heads: int, tp) -> int:
    if tp is None:
        return heads
    if heads % tp.size:
        raise ValueError(f"{tp.size} tensor-parallel ranks do not divide {heads} attention heads")
    return heads // tp.size


def basic_transformer_block(
    p: dict,
    x: torch.Tensor,        # (B, L, C)
    context: torch.Tensor,  # (B, Lc, context_dim)
    heads: int,
    layer_idx: int,
    hooks: AttnHooks,
    disable_self_attn: bool = False,
) -> torch.Tensor:
    """attention.py BasicTransformerBlock._forward with the injection points.
    With ``disable_self_attn`` (the x4 upscaler's levels) attn1 cross-attends
    the text context, and no hook applies to the block.

    Under ``parallel.mesh.tp_context`` the params are a rank's tensor-parallel
    shards (``parallel.sharding.apply_param_sharding``): q/k/v and the GEGLU
    input give the rank's heads and MLP columns, attention runs over
    ``heads / t`` heads, and the attention outputs and the MLP output are
    row-parallel products summed over the ranks (Megatron's pair:
    ``copy_to_tp`` on the column-parallel inputs, ``reduce_from_tp`` on the
    row-parallel outputs, so a gradient is summed over the ranks). The
    ``pre`` hook sees the contexts (whole rows) and ``attn`` the rank's
    heads; ``attn_all`` and ``post`` see every head, all-gathered over the
    ranks in head order, and the rank keeps its share of what they
    return."""
    tp = active_tp()
    heads_all = heads
    heads = _local_heads(heads, tp)
    n = layer_norm(p["norm1"], x)
    if disable_self_attn:
        ctx_t = copy_to_tp(context, tp)
        for name, norm in (("attn1", "norm2"), ("attn2", "norm3")):
            a = p[name]
            n = copy_to_tp(n, tp)
            q, k, v = (linear(a["to_q"], n), linear(a["to_k"], ctx_t), linear(a["to_v"], ctx_t))
            x = x + _row_linear(a["to_out"]["0"], attention(q, k, v, heads), tp)
            n = layer_norm(p[norm], x)
        return x + _row_linear(p["ff"]["net"]["2"], geglu(p["ff"]["net"]["0"],
                                                         copy_to_tp(n, tp)), tp)
    q_ctx = k_ctx = v_ctx = n
    if hooks.pre is not None:
        q_ctx, k_ctx, v_ctx = hooks.pre(q_ctx, k_ctx, v_ctx, layer_idx)
    if hooks.pre_all is not None:
        q_ctx, k_ctx, v_ctx = hooks.pre_all(q_ctx, k_ctx, v_ctx, layer_idx)
    a1 = p["attn1"]
    if q_ctx is k_ctx and k_ctx is v_ctx:
        # fused QKV: one (L, C) x (C, 3C) product instead of three
        w_qkv = torch.cat([a1["to_q"]["weight"], a1["to_k"]["weight"], a1["to_v"]["weight"]], 0)
        q, k, v = linear({"weight": w_qkv}, copy_to_tp(q_ctx, tp)).chunk(3, dim=-1)
    else:
        q = linear(a1["to_q"], copy_to_tp(q_ctx, tp))
        k = linear(a1["to_k"], copy_to_tp(k_ctx, tp))
        v = linear(a1["to_v"], copy_to_tp(v_ctx, tp))
    if hooks.attn is not None:
        attn_out = hooks.attn(q, k, v, heads, layer_idx)
    elif hooks.attn_all is not None and tp is not None:
        attn_out = _own_heads(hooks.attn_all(*(_gather_heads(t, tp) for t in (q, k, v)),
                                             heads_all, layer_idx), tp)
    elif hooks.attn_all is not None:
        attn_out = hooks.attn_all(q, k, v, heads, layer_idx)
    else:
        attn_out = attention(q, k, v, heads)
    if hooks.post is not None and tp is not None:
        attn_out = _own_heads(hooks.post(_gather_heads(attn_out, tp), layer_idx), tp)
    elif hooks.post is not None:
        attn_out = hooks.post(attn_out, layer_idx)
    x = x + _row_linear(a1["to_out"]["0"], attn_out, tp)

    if hooks.mid is not None:
        x = hooks.mid(x, layer_idx)

    # cross-attention (attn2) over the text context, fused KV projection
    n = layer_norm(p["norm2"], x)
    a2 = p["attn2"]
    ctx_k = ctx_v = context
    if hooks.pre_cross is not None:
        n, ctx_k, ctx_v = hooks.pre_cross(n, ctx_k, ctx_v, layer_idx)
    q = linear(a2["to_q"], copy_to_tp(n, tp))
    if ctx_k is ctx_v:
        w_kv = torch.cat([a2["to_k"]["weight"], a2["to_v"]["weight"]], 0)
        k, v = linear({"weight": w_kv}, copy_to_tp(ctx_k, tp)).chunk(2, dim=-1)
    else:
        k, v = linear(a2["to_k"], copy_to_tp(ctx_k, tp)), linear(a2["to_v"], copy_to_tp(ctx_v, tp))
    x = x + _row_linear(a2["to_out"]["0"], attention(q, k, v, heads), tp)

    n = copy_to_tp(layer_norm(p["norm3"], x), tp)
    return x + _row_linear(p["ff"]["net"]["2"], geglu(p["ff"]["net"]["0"], n), tp)


def spatial_transformer(
    p: dict,
    x: torch.Tensor,  # (B, H, W, C)
    context: torch.Tensor,
    heads: int,
    depth: int,
    layer_idx: int,
    hooks: AttnHooks,
    disable_self_attn: bool = False,
) -> Tuple[torch.Tensor, int]:
    """attention.py SpatialTransformer.forward; proj_in/proj_out may be
    linears (B, L, C) or 1x1 convs (O, I, 1, 1). Its ``depth`` blocks all
    see the one transformer index ``layer_idx``; returns the next index."""
    b, h, w, c = x.shape
    n = group_norm(p["norm"], x)
    use_conv_proj = p["proj_in"]["weight"].dim() == 4
    if use_conv_proj:
        n = conv2d(p["proj_in"], n).reshape(b, h * w, c)
    else:
        n = linear(p["proj_in"], n.reshape(b, h * w, c))
    for d in range(depth):
        n = basic_transformer_block(p["transformer_blocks"][str(d)], n, context, heads,
                                    layer_idx, hooks, disable_self_attn=disable_self_attn)
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
        depth, disable_self_attn), plan_out entries (kind, out_ch, upsample,
        depth, disable_self_attn). input_blocks[0] is conv_in; each level has
        res_blocks_at(level) res blocks (with a transformer where its depth
        is > 0) and a downsample but the last; the output side mirrors it
        with one res block more a level and an upsample at each level's end.
        Depths come from the per-block lists when the config has them, else
        from the per-level rule."""
        cfg = self.config
        ch = cfg.model_channels
        input_chs = [ch]
        plan_in = [("conv", None, 0, False)]
        blk = 0
        for level, mult in enumerate(cfg.channel_mult):
            out_ch = cfg.model_channels * mult
            dis = cfg.self_attn_disabled(level)
            for _ in range(cfg.res_blocks_at(level)):
                if cfg.transformer_depth_blocks is not None:
                    depth = cfg.transformer_depth_blocks[blk]
                else:
                    depth = cfg.depth_at(level) if level in cfg.attention_levels else 0
                blk += 1
                plan_in.append(("res_attn" if depth > 0 else "res", out_ch, depth, dis))
                ch = out_ch
                input_chs.append(ch)
            if level != len(cfg.channel_mult) - 1:
                plan_in.append(("down", ch, 0, False))
                input_chs.append(ch)
        plan_out = []
        blk = 0
        for level in reversed(range(len(cfg.channel_mult))):
            out_ch = cfg.model_channels * cfg.channel_mult[level]
            dis = cfg.self_attn_disabled(level)
            for i in range(cfg.res_blocks_at(level) + 1):
                if cfg.transformer_depth_blocks_out is not None:
                    depth = cfg.transformer_depth_blocks_out[blk]
                else:
                    depth = cfg.depth_at(level) if level in cfg.attention_levels else 0
                blk += 1
                up = level != 0 and i == cfg.res_blocks_at(level)
                plan_out.append(("res_attn" if depth > 0 else "res", out_ch, up, depth, dis))
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

        plan_in, plan_out, _ = self.block_plan()
        layer_idx = 0
        hs = []
        h = x
        ctrl_in = control.get("input") if control is not None else None
        for i, (kind, _, depth, dis) in enumerate(plan_in):
            p = params["input_blocks"][str(i)]
            if kind == "conv":
                h = conv2d(p["0"], h, padding=1)
            elif kind == "down":
                h = downsample(p["0"], h)
            else:
                h = res_block(p["0"], h, emb)
                if kind == "res_attn":
                    h, layer_idx = spatial_transformer(
                        p["1"], h, context, cfg.heads_for(h.shape[-1]), depth, layer_idx, hooks,
                        disable_self_attn=dis)
            if ctrl_in is not None and i < len(ctrl_in) and ctrl_in[i] is not None:
                h = h + ctrl_in[i].to(h.dtype)
            if hooks.in_block is not None:
                h = hooks.in_block(h, i, timesteps)
            hs.append(h)
            if hooks.in_block_after is not None:
                h = hooks.in_block_after(h, i, timesteps)

        md = cfg.middle_depth()
        if md >= -1:
            mp = params["middle_block"]
            h = res_block(mp["0"], h, emb)
            if md >= 0:
                h, layer_idx = spatial_transformer(
                    mp["1"], h, context, cfg.heads_for(h.shape[-1]), md, layer_idx, hooks)
                h = res_block(mp["2"], h, emb)
        if control is not None and control.get("middle"):
            h = h + control["middle"][0].to(h.dtype)

        ctrl_out = list(control.get("output", [])) if control is not None else []
        for i, (kind, _, up, depth, dis) in enumerate(plan_out):
            p = params["output_blocks"][str(i)]
            skip = hs.pop()
            if ctrl_out:
                skip = skip + ctrl_out.pop().to(h.dtype)
            if hooks.out_block is not None:
                h, skip = hooks.out_block(h, skip, i)
            h = torch.cat([h, skip], dim=-1)
            h = res_block(p["0"], h, emb)
            if kind == "res_attn":
                h, layer_idx = spatial_transformer(
                    p["1"], h, context, cfg.heads_for(h.shape[-1]), depth, layer_idx, hooks,
                    disable_self_attn=dis)
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

        def btb(c, dis=False):
            k_in = cfg.context_dim if dis else c  # attn1 reads the context
            return {
                "norm1": norm(c), "norm2": norm(c), "norm3": norm(c),
                "attn1": {
                    "to_q": {"weight": lin(c, c)["weight"]},
                    "to_k": {"weight": lin(k_in, c)["weight"]},
                    "to_v": {"weight": lin(k_in, c)["weight"]},
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

        def st(c, depth, dis=False):
            return {
                "norm": norm(c),
                "proj_in": lin(c, c),
                "transformer_blocks": {str(d): btb(c, dis) for d in range(depth)},
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
        for i, (kind, out_ch, depth, dis) in enumerate(plan_in):
            if kind == "conv":
                params["input_blocks"][str(i)] = {"0": conv(cfg.in_channels, ch)}
            elif kind == "down":
                params["input_blocks"][str(i)] = {"0": {"op": conv(ch, ch)}}
            else:
                blk = {"0": resb(ch, out_ch)}
                ch = out_ch
                if kind == "res_attn":
                    blk["1"] = st(ch, depth, dis)
                params["input_blocks"][str(i)] = blk
            chs.append(ch)
        md = cfg.middle_depth()
        if md >= 0:
            params["middle_block"] = {"0": resb(ch, ch), "1": st(ch, md), "2": resb(ch, ch)}
        elif md == -1:
            params["middle_block"] = {"0": resb(ch, ch)}
        else:
            del params["middle_block"]
        for i, (kind, out_ch, up, depth, dis) in enumerate(plan_out):
            blk = {"0": resb(ch + chs.pop(), out_ch)}
            ch = out_ch
            if kind == "res_attn":
                blk["1"] = st(ch, depth, dis)
            if up:
                blk["2" if kind == "res_attn" else "1"] = {"conv": conv(ch, ch)}
            params["output_blocks"][str(i)] = blk
        params["out"] = {"0": norm(ch), "2": conv(ch, cfg.out_channels)}
        return params

    def num_transformer_layers(self) -> int:
        """SpatialTransformer count (16 for SD1.5, 11 for SDXL): the layer
        indices the Corresponder hooks see, one a SpatialTransformer whatever
        its depth, as the JAX package numbers them."""
        plan_in, plan_out, _ = self.block_plan()
        return (sum(k[0] == "res_attn" for k in plan_in)
                + int(self.config.middle_depth() >= 0)
                + sum(k[0] == "res_attn" for k in plan_out))
