"""SVD img2vid's temporal UNet: VideoResBlocks and temporal transformers.

Counterpart of stable_renderer_tpu/models/video_unet.py (reference
comfy/supported_models.py:257 SVD_img2vid, openaimodel.py:288-370
VideoResBlock, attention.py:729-880 SpatialVideoTransformer and
AlphaBlender, model_base.py SVD_img2vid).

The frame axis is the batch axis: a video denoise is one batched UNet call
whose temporal stages reduce across each group of ``num_frames`` rows. CFG
stacks a [cond, uncond] batch of 2T rows, which splits into two groups.

  * VideoResBlock: the spatial ResBlock (``unet.res_block``), then a
    temporal ResBlock whose 3x3x3 conv runs over (T, H, W), blended by the
    learned AlphaBlender (sigmoid(mix_factor)).
  * SpatialVideoTransformer: after each spatial BasicTransformerBlock
    (``unet.basic_transformer_block``, so the corresponder's and the model
    patches' hooks reach it), the tokens go to (B*S, T, C) through a
    temporal transformer block against each group's first-frame context,
    then are alpha-blended back.

The param tree is the SVD checkpoint's (time_stack.*, time_pos_embed.*,
time_mixer.mix_factor), so ``model.diffusion_model.*`` keys re-nest as
they are. Attention goes through ``layers.attention``: SVD's spatial
self-attention at 576x1024 (9216 and 2304 tokens) takes K1; the temporal
attention (T tokens) and the cross-attention stay plain.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.layers import (
    attention,
    conv2d,
    geglu,
    group_norm,
    layer_norm,
    linear,
    silu,
    timestep_embedding,
)
from stable_renderer_tpu_torch.models.unet import (
    AttnHooks,
    UNetConfig,
    UNetModel,
    basic_transformer_block,
    downsample,
    res_block,
    upsample,
)


@dataclass(frozen=True)
class VideoUNetConfig(UNetConfig):
    """UNetConfig and SVD's temporal settings (supported_models.py:257)."""

    video_kernel_size: int = 3
    max_time_embed_period: int = 10000


SVD_UNET_CONFIG = VideoUNetConfig(
    in_channels=8,            # 4 latent + 4 c_concat (the encoded init image)
    model_channels=320,
    channel_mult=(1, 2, 4, 4),
    attention_levels=(0, 1, 2),
    transformer_depth=1,
    head_dim=64,
    context_dim=1024,         # the CLIP vision embedding
    adm_in_channels=768,      # fps, motion-bucket and augmentation embeddings
)

TINY_VIDEO_UNET_CONFIG = VideoUNetConfig(
    in_channels=8,
    model_channels=32,
    num_res_blocks=1,
    channel_mult=(1, 2),
    attention_levels=(0, 1),
    num_heads=2,
    context_dim=32,       # the tiny vision tower's projection, as SVD's 1024 is ViT-H's
    adm_in_channels=768,  # SVD's ADM width: svd_adm_vector plugs in as it is
)


def alpha_blend(p: dict, spatial: torch.Tensor, temporal: torch.Tensor) -> torch.Tensor:
    """AlphaBlender (learned): a * spatial + (1 - a) * temporal with
    a = sigmoid(mix_factor), in the activation dtype."""
    a = torch.sigmoid(p["mix_factor"].float()).to(spatial.dtype)
    return spatial * a + temporal * (1.0 - a)


def conv3d_video(p: dict, x: torch.Tensor, kernel: int) -> torch.Tensor:
    """torch Conv3d over (T, H, W) on (N, T, H, W, C) activations; weight
    (O, I, kT, kH, kW). The input is viewed as a channels-last-3d NCDHW
    tensor, so F.conv3d runs without a layout copy."""
    b = p.get("bias")
    out = F.conv3d(x.permute(0, 4, 1, 2, 3), p["weight"].to(x.dtype),
                   None if b is None else b.to(x.dtype), padding=kernel // 2)
    return out.permute(0, 2, 3, 4, 1)


def temporal_res_block(p: dict, x: torch.Tensor, emb: torch.Tensor, kernel: int) -> torch.Tensor:
    """The time_stack ResBlock (dims=3, exchange_temb_dims): x is
    (nb, T, H, W, C), its GroupNorm statistics over all T frames of a group;
    emb (nb, T, emb_dim) is added per frame."""
    h = group_norm(p["in_layers"]["0"], x, act="silu")
    h = conv3d_video(p["in_layers"]["2"], h, kernel)
    emb_out = linear(p["emb_layers"]["1"], silu(emb))  # (nb, T, C)
    h = h + emb_out[:, :, None, None, :].to(h.dtype)
    h = group_norm(p["out_layers"]["0"], h, act="silu")
    return x + conv3d_video(p["out_layers"]["3"], h, kernel)


def video_res_block(p: dict, x: torch.Tensor, emb: torch.Tensor, kernel: int,
                    num_frames: int) -> torch.Tensor:
    """VideoResBlock: the spatial ResBlock, then the temporal 3D ResBlock
    over each group of ``num_frames`` rows, alpha-blended. x (nb*T, H, W, C)."""
    x = res_block(p, x, emb)
    nb = x.shape[0] // num_frames
    x5 = x.reshape((nb, num_frames) + tuple(x.shape[1:]))
    emb5 = emb.reshape(nb, num_frames, emb.shape[-1])
    mixed = temporal_res_block(p["time_stack"], x5, emb5, kernel)
    return alpha_blend(p["time_mixer"], x5, mixed).reshape(x.shape)


def temporal_transformer_block(p: dict, x: torch.Tensor, context: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """The time_stack BasicTransformerBlock with ff_in (attention.py:777-796):
    norm_in + ff_in residual, self-attention over the frames,
    cross-attention, feed-forward."""
    n = layer_norm(p["norm_in"], x)
    x = x + linear(p["ff_in"]["net"]["2"], geglu(p["ff_in"]["net"]["0"], n))
    n = layer_norm(p["norm1"], x)
    a1 = p["attn1"]
    q, k, v = linear(a1["to_q"], n), linear(a1["to_k"], n), linear(a1["to_v"], n)
    x = x + linear(a1["to_out"]["0"], attention(q, k, v, heads))
    if "attn2" in p:
        n = layer_norm(p["norm2"], x)
        a2 = p["attn2"]
        q, k, v = linear(a2["to_q"], n), linear(a2["to_k"], context), linear(a2["to_v"], context)
        x = x + linear(a2["to_out"]["0"], attention(q, k, v, heads))
    n = layer_norm(p["norm3"], x)
    return x + linear(p["ff"]["net"]["2"], geglu(p["ff"]["net"]["0"], n))


def spatial_video_transformer(
    p: dict,
    x: torch.Tensor,        # (nb*T, H, W, C)
    context: torch.Tensor,  # (nb*T, Lc, context_dim)
    heads: int,
    depth: int,
    layer_idx: int,
    hooks: AttnHooks,
    max_period: int,
    num_frames: int,
) -> Tuple[torch.Tensor, int]:
    """SpatialVideoTransformer.forward (attention.py:812-880): spatial blocks
    interleaved with temporal mixing blocks over the frame axis. Returns the
    output and the next transformer index."""
    b, h, w, c = x.shape
    nb, s = b // num_frames, h * w
    n = linear(p["proj_in"], group_norm(p["norm"], x).reshape(b, s, c))

    # the frame-index embedding, tiled over the groups
    frame_idx = torch.arange(num_frames, dtype=torch.float32, device=x.device)
    t_emb = timestep_embedding(frame_idx, c, max_period=max_period).to(n.dtype)
    emb = linear(p["time_pos_embed"]["2"], silu(linear(p["time_pos_embed"]["0"], t_emb)))
    emb = emb.repeat(nb, 1)  # (nb*T, C)

    # each group's first-frame context, one copy a pixel
    time_ctx = context[::num_frames]  # (nb, Lc, D)
    time_ctx = time_ctx[:, None].expand((nb, s) + tuple(time_ctx.shape[1:])).reshape(
        (nb * s,) + tuple(time_ctx.shape[1:]))

    for d in range(depth):
        n = basic_transformer_block(p["transformer_blocks"][str(d)], n, context, heads,
                                    layer_idx, hooks)
        x_mix = n + emb[:, None, :]
        # (nb*T, S, C) -> (nb*S, T, C): attend over the frames a pixel
        x_mix = x_mix.reshape(nb, num_frames, s, c).transpose(1, 2).reshape(nb * s, num_frames, c)
        x_mix = temporal_transformer_block(p["time_stack"][str(d)], x_mix, time_ctx, heads)
        x_mix = x_mix.reshape(nb, s, num_frames, c).transpose(1, 2).reshape(nb * num_frames, s, c)
        n = alpha_blend(p["time_mixer"], n, x_mix)
    n = linear(p["proj_out"], n)
    return n.reshape(b, h, w, c) + x, layer_idx + 1


class VideoUNetModel(UNetModel):
    """SVD's temporal UNet: frames ride the batch axis, and every res block
    and transformer gains a temporal stage. ``apply(params, x, timesteps,
    context, y)`` with x (T, H, W, in_channels)."""

    def __init__(self, config: VideoUNetConfig = SVD_UNET_CONFIG,
                 num_frames: Optional[int] = None):
        """``num_frames=None`` takes the whole batch as one frame sequence;
        the KSampler pins it to T, so CFG's 2T batch splits into [cond,
        uncond] groups (the reference's num_video_frames)."""
        super().__init__(config)
        self.num_frames = num_frames

    def apply(
        self,
        params: dict,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        context: torch.Tensor,
        y: Optional[torch.Tensor] = None,
        control: Optional[dict] = None,
        hooks: AttnHooks = AttnHooks(),
    ) -> torch.Tensor:
        cfg = self.config
        t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
        emb = linear(params["time_embed"]["2"], silu(linear(params["time_embed"]["0"], t_emb)))
        if cfg.adm_in_channels is not None and y is not None:
            y_emb = linear(params["label_emb"]["0"]["0"], y.to(x.dtype))
            emb = emb + linear(params["label_emb"]["0"]["2"], silu(y_emb))

        plan_in, plan_out, _ = self.block_plan()
        kernel, period = cfg.video_kernel_size, cfg.max_time_embed_period
        nf = self.num_frames or x.shape[0]
        layer_idx = 0
        hs = []
        h = x
        ctrl_in = control.get("input") if control is not None else None
        for i, (kind, _, depth, _dis) in enumerate(plan_in):
            p = params["input_blocks"][str(i)]
            if kind == "conv":
                h = conv2d(p["0"], h, padding=1)
            elif kind == "down":
                h = downsample(p["0"], h)
            else:
                h = video_res_block(p["0"], h, emb, kernel, nf)
                if kind == "res_attn":
                    h, layer_idx = spatial_video_transformer(
                        p["1"], h, context, cfg.heads_for(h.shape[-1]), depth, layer_idx, hooks,
                        period, nf)
            if ctrl_in is not None and i < len(ctrl_in) and ctrl_in[i] is not None:
                h = h + ctrl_in[i].to(h.dtype)
            hs.append(h)

        mp = params["middle_block"]
        h = video_res_block(mp["0"], h, emb, kernel, nf)
        h, layer_idx = spatial_video_transformer(
            mp["1"], h, context, cfg.heads_for(h.shape[-1]), max(cfg.middle_depth(), 1),
            layer_idx, hooks, period, nf)
        h = video_res_block(mp["2"], h, emb, kernel, nf)
        if control is not None and control.get("middle"):
            h = h + control["middle"][0].to(h.dtype)

        ctrl_out = list(control.get("output", [])) if control is not None else []
        for i, (kind, _, up, depth, _dis) in enumerate(plan_out):
            p = params["output_blocks"][str(i)]
            skip = hs.pop()
            if ctrl_out:
                skip = skip + ctrl_out.pop().to(h.dtype)
            if hooks.out_block is not None:
                h, skip = hooks.out_block(h, skip, i)
            h = video_res_block(p["0"], torch.cat([h, skip], dim=-1), emb, kernel, nf)
            if kind == "res_attn":
                h, layer_idx = spatial_video_transformer(
                    p["1"], h, context, cfg.heads_for(h.shape[-1]), depth, layer_idx, hooks,
                    period, nf)
            if up:
                h = upsample(p["2" if kind == "res_attn" else "1"], h)

        # the JAX package's Normalize default, eps 1e-6
        h = group_norm(params["out"]["0"], h, act="silu")
        return conv2d(params["out"]["2"], h, padding=1)

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        """The base UNet tree and SVD's temporal parameters (time_stack,
        time_pos_embed, time_mixer) grafted onto every res block and
        transformer, drawn from ``generator`` as the JAX package's ``init``
        draws them (fan-in scaled normals, zero biases, unit norms, zero mix
        factors)."""
        cfg = self.config
        params = super().init(generator, dtype=dtype, device=device)

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        def lin(i, o):
            return {"weight": (randn(o, i) / math.sqrt(i)).to(dtype), "bias": zeros(o)}

        def conv3(i, o, k):
            return {"weight": (randn(o, i, k, k, k) / math.sqrt(i * k ** 3)).to(dtype),
                    "bias": zeros(o)}

        def norm(c):
            return {"weight": torch.ones(c, dtype=dtype, device=device), "bias": zeros(c)}

        k = cfg.video_kernel_size

        def time_res(c):
            return {"in_layers": {"0": norm(c), "2": conv3(c, c, k)},
                    "emb_layers": {"1": lin(cfg.time_embed_dim, c)},
                    "out_layers": {"0": norm(c), "3": conv3(c, c, k)}}

        def attn(c, k_in):
            return {"to_q": {"weight": lin(c, c)["weight"]},
                    "to_k": {"weight": lin(k_in, c)["weight"]},
                    "to_v": {"weight": lin(k_in, c)["weight"]},
                    "to_out": {"0": lin(c, c)}}

        def time_btb(c):
            d_ff = c * 4
            return {"norm_in": norm(c),
                    "ff_in": {"net": {"0": {"proj": lin(c, d_ff * 2)}, "2": lin(d_ff, c)}},
                    "norm1": norm(c), "norm2": norm(c), "norm3": norm(c),
                    "attn1": attn(c, c), "attn2": attn(c, cfg.context_dim),
                    "ff": {"net": {"0": {"proj": lin(c, d_ff * 2)}, "2": lin(d_ff, c)}}}

        def graft_res(block: dict) -> None:
            c = block["out_layers"]["0"]["weight"].shape[0]
            block["time_stack"] = time_res(c)
            block["time_mixer"] = {"mix_factor": zeros(1)}

        def graft_st(block: dict) -> None:
            c = block["norm"]["weight"].shape[0]
            block["time_stack"] = {str(d): time_btb(c) for d in range(len(block["transformer_blocks"]))}
            block["time_pos_embed"] = {"0": lin(c, c * 4), "2": lin(c * 4, c)}
            block["time_mixer"] = {"mix_factor": zeros(1)}

        for group in ("input_blocks", "output_blocks"):
            for blk in params[group].values():
                if "in_layers" in blk.get("0", {}):
                    graft_res(blk["0"])
                if "transformer_blocks" in blk.get("1", {}):
                    graft_st(blk["1"])
        graft_res(params["middle_block"]["0"])
        graft_st(params["middle_block"]["1"])
        graft_res(params["middle_block"]["2"])
        return params


def svd_adm_vector(fps_id: float, motion_bucket_id: float, augmentation_level: float,
                   n: int = 1, device=None) -> torch.Tensor:
    """SVD's ADM conditioning (model_base.py SVD_img2vid encode_adm): three
    256-wide timestep embeddings of (fps_id, motion_bucket_id,
    augmentation), (n, 768) f32."""
    parts = [timestep_embedding(torch.tensor([float(v)], device=device), 256)
             for v in (fps_id, motion_bucket_id, augmentation_level)]
    y = torch.cat(parts, dim=-1)
    return y.expand(n, y.shape[-1])
