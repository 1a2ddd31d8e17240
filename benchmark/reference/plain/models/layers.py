"""Shared neural-net layers as functions over checkpoint-layout param dicts.

Counterpart of stable_renderer_tpu/models/layers.py. Parameters keep the
torch checkpoint layout (Linear weight (out, in), Conv2d weight
(O, I, kH, kW)); activations are NHWC at every public function. Inside
``conv2d`` the NHWC tensor is viewed as a channels_last NCHW tensor, so
``F.conv2d`` runs without a layout copy.

The reference's copy: every attention is the plain einsum-softmax, every
int8 conv the exact int32 convolution of ``quant.conv2d_q``, every float conv
``F.conv2d`` and every GroupNorm the plain statistics. Linears are plain
PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from benchmark.reference.plain.models import quant as _quant
from benchmark.reference.plain.ops.attention import attention_plain


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """torch nn.Linear: weight (out, in), optional bias."""
    b = p.get("bias")
    return F.linear(x, p["weight"].to(x.dtype), None if b is None else b.to(x.dtype))




def conv2d(p: dict, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch nn.Conv2d on NHWC activations; weight (O, I, kH, kW), or an int8
    leaf from ``quant.quantize_tree`` (``weight_q`` HWIO), which takes the
    exact int32 convolution of ``quant.conv2d_q``."""
    if "weight_q" in p:
        return _quant.conv2d_q(p, x, stride=stride, padding=padding)
    if _quant._CAL.active:
        _quant._CAL.record(p, x)
    w = p["weight"]
    b = p.get("bias")
    out = F.conv2d(
        x.permute(0, 3, 1, 2), w.to(x.dtype),
        None if b is None else b.to(x.dtype), stride=stride, padding=padding,
    )
    return out.permute(0, 2, 3, 1)


def norm_act_conv(pnorm: dict, pconv: dict, x: torch.Tensor,
                  num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm -> SiLU -> conv3x3 (pad 1), the ResBlock hot chain."""
    return conv2d(pconv, group_norm(pnorm, x, num_groups, eps, act="silu"), padding=1)


def _groups(c: int, num_groups: int) -> int:
    g = num_groups
    while c % g:  # tiny test configs have c < 32
        g //= 2
    return g


def _group_norm_rows(p: dict, x: torch.Tensor, g: int, eps: float):
    """Per-(N, C) f32 scale and shift of GroupNorm over channels-last x:
    statistics accumulate in f32 from the activation dtype's squares."""
    n, c = x.shape[0], x.shape[-1]
    spatial = math.prod(x.shape[1:-1])
    xf = x.reshape(n, spatial, c)
    s1 = xf.sum(1, dtype=torch.float32)
    s2 = xf.square().sum(1, dtype=torch.float32)
    cnt = float(spatial * (c // g))
    mean_g = s1.reshape(n, g, c // g).sum(-1) / cnt
    var_g = torch.clamp(s2.reshape(n, g, c // g).sum(-1) / cnt - mean_g * mean_g, min=0.0)
    rstd_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(c // g, dim=-1)
    rstd_c = rstd_g.repeat_interleave(c // g, dim=-1)
    scale = rstd_c * p["weight"].float()
    shift = p["bias"].float() - mean_c * scale
    return scale, shift


def group_norm(p: dict, x: torch.Tensor, num_groups: int = 32, eps: float = 1e-6,
               act: Optional[str] = None) -> torch.Tensor:
    """torch nn.GroupNorm over channels-last input, with an optional fused
    activation (``act="silu"``). Statistics accumulate in f32; the normalize
    multiply-add runs in the activation dtype, as in the JAX package."""
    orig_dtype = x.dtype
    n, c = x.shape[0], x.shape[-1]
    g = _groups(c, num_groups)
    spatial = math.prod(x.shape[1:-1])
    scale, shift = _group_norm_rows(p, x, g, eps)
    bshape = (n,) + (1,) * (x.dim() - 2) + (c,)
    out = x * scale.reshape(bshape).to(orig_dtype) + shift.reshape(bshape).to(orig_dtype)
    if act == "silu":
        out = F.silu(out)
    elif act is not None:
        raise ValueError(f"unknown group_norm act {act!r}")
    return out


def layer_norm(p: Optional[dict], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    orig_dtype = x.dtype
    mean = x.mean(-1, dtype=torch.float32, keepdim=True)
    m2 = x.square().mean(-1, dtype=torch.float32, keepdim=True)
    var = torch.clamp(m2 - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    scale, shift = rstd, -mean * rstd
    if p is not None and "weight" in p:
        scale = rstd * p["weight"].float()
        shift = -mean * scale
        if p.get("bias") is not None:
            shift = shift + p["bias"].float()
    return x * scale.to(orig_dtype) + shift.to(orig_dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu_quick(x: torch.Tensor) -> torch.Tensor:
    """CLIP's quick-gelu: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def geglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    """GEGLU feed-forward gate; jax.nn.gelu's default is the tanh form."""
    a, b = linear(p["proj"], x).chunk(2, dim=-1)
    return a * F.gelu(b, approximate="tanh")


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding: t (N,) -> (N, dim) f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention over packed head dims (B, L, H*D). Both
    unmasked and masked (CLIP's causal mask) take the plain einsum-softmax."""
    if mask is None:
        return attention_plain(q, k, v, heads)
    b, lq, hd = q.shape
    d = hd // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2)
    kh = k.reshape(b, -1, heads, d).transpose(1, 2)
    vh = v.reshape(b, -1, heads, d).transpose(1, 2)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    w = torch.softmax(logits + mask, dim=-1).to(v.dtype)
    return torch.matmul(w, vh).transpose(1, 2).reshape(b, lq, hd)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling on NHWC."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, h * 2, w * 2, c)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
