"""Shared neural-net layers as functions over checkpoint-layout param dicts.

Counterpart of stable_renderer_tpu/models/layers.py. Parameters keep the
torch checkpoint layout (Linear weight (out, in), Conv2d weight
(O, I, kH, kW)); activations are NHWC at every public function. Inside
``conv2d`` the NHWC tensor is viewed as a channels_last NCHW tensor, so
``F.conv2d`` runs without a layout copy.

Kernel routing, as in the JAX package:
  * ``attention``: K1 (``ops/flash_attention.attention_pallas``) when the K/V
    length is >= 2048;
  * ``conv2d``: an int8 leaf (``weight_q``) that passes the int8 gate goes to
    K3 (``ops/conv_kernel.conv3x3_kernel``) on the card, or on the CPU when
    the switch is on; any other int8 leaf to ``quant.conv2d_q``; a float leaf
    to K3 when ``use_pallas_conv(True)`` is set and ``_pallas_conv_gate``
    passes; otherwise ``F.conv2d``;
  * ``norm_act_conv``: under the same switch and gate, plain group statistics
    and K3 with the per-(N, C) scale and shift in its prologue;
  * ``group_norm``: K4 (``ops/group_norm_kernel``) when
    ``_group_norm_pallas_on`` is set and the shape passes the JAX gate.
The gates are the JAX package's, measured on a TPU; they are kept as they are
so that the same convs and norms route, and are to be measured again on the
H100. On the card K3's float mode takes bf16 activations, so a float conv
routes to it only for bf16 activations (or on the CPU, where the plain
version takes any type). Linears stay plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from stable_renderer_tpu_torch.models import quant as _quant
from stable_renderer_tpu_torch.ops.conv_kernel import conv3x3_kernel
from stable_renderer_tpu_torch.ops.flash_attention import attention_pallas
from stable_renderer_tpu_torch.ops.group_norm_kernel import fits_gate, group_norm_kernel


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """torch nn.Linear: weight (out, in), optional bias."""
    b = p.get("bias")
    return F.linear(x, p["weight"].to(x.dtype), None if b is None else b.to(x.dtype))


_conv_pallas_on = False  # set by ops.conv_kernel.use_pallas_conv
_group_norm_pallas_on = False  # K4 routing switch, off by default as in the JAX package


def _pallas_conv_gate(h: int, w: int, cin: int, cout: int) -> bool:
    """The JAX package's routing table for float 3x3 convs (measured on a
    TPU, models/layers.py:40-54 there): K3 at >= 64^2 spatial with >= 128
    channels in and out, except 256^2 with cin >= 512."""
    px = h * w
    if px < 64 * 64 or cin < 128 or cout < 128:
        return False
    if px == 256 * 256 and cin >= 512:
        return False
    return True


def _int8_gate(wq: torch.Tensor, p: dict, x: torch.Tensor, stride: int, padding: int) -> bool:
    """The JAX package's int8 gate (models/layers.py:75-79 there): 3x3
    stride-1 pad-1 with a calibrated scale, >= 32^2 spatial, >= 128 channels
    in and out."""
    return (stride == 1 and padding == 1 and tuple(wq.shape[:2]) == (3, 3) and "a_scale" in p
            and x.shape[1] * x.shape[2] >= 32 * 32 and x.shape[3] >= 128
            and wq.shape[-1] >= 128)


def _float_route(x: torch.Tensor) -> bool:
    """K3's float mode on the card takes bf16 activations."""
    return x.device.type == "cpu" or x.dtype == torch.bfloat16


# weight tensor -> {dtype: its HWIO copy}; an entry lives as long as its weight
_hwio_cache = WeakIdKeyDictionary()


def _hwio(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The (kH, kW, I, O) copy K3 takes, made once per weight tensor and
    dtype (weights are not changed in place)."""
    views = _hwio_cache.setdefault(w, {})
    if dtype not in views:
        views[dtype] = w.to(dtype).permute(2, 3, 1, 0).contiguous()
    return views[dtype]


def conv2d(p: dict, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch nn.Conv2d on NHWC activations; weight (O, I, kH, kW), or an int8
    leaf from ``quant.quantize_tree`` (``weight_q`` HWIO). Routing: see the
    module docstring."""
    if "weight_q" in p:
        wq = p["weight_q"]
        if (x.device.type == "cuda" or _conv_pallas_on) and _int8_gate(wq, p, x, stride, padding):
            return conv3x3_kernel(x, wq, p.get("bias"), a_scale=p["a_scale"],
                                  w_scale=p["w_scale"], out_dtype=x.dtype)
        return _quant.conv2d_q(p, x, stride=stride, padding=padding)
    if _quant._CAL.active:
        _quant._CAL.record(p, x)
    w = p["weight"]
    b = p.get("bias")
    if (_conv_pallas_on and stride == 1 and padding == 1 and tuple(w.shape[2:]) == (3, 3)
            and _float_route(x) and _pallas_conv_gate(x.shape[1], x.shape[2], x.shape[3],
                                                      w.shape[0])):
        return conv3x3_kernel(x, _hwio(w, x.dtype), b, out_dtype=x.dtype)
    out = F.conv2d(
        x.permute(0, 3, 1, 2), w.to(x.dtype),
        None if b is None else b.to(x.dtype), stride=stride, padding=padding,
    )
    return out.permute(0, 2, 3, 1)


def norm_act_conv(pnorm: dict, pconv: dict, x: torch.Tensor,
                  num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm -> SiLU -> conv3x3 (pad 1), the ResBlock hot chain. Routed
    (switch on, float leaf, gate passes): the group statistics are plain
    torch and the normalize + SiLU run as K3's prologue, inside the conv's
    kernel call. Otherwise ``group_norm(act="silu")`` then ``conv2d`` (int8
    leaves keep their own quantize; a calibration run records the conv's
    input there)."""
    n, h, w, c = x.shape
    wt = pconv.get("weight")
    eligible = (_conv_pallas_on and "weight_q" not in pconv and not _quant._CAL.active
                and tuple(wt.shape[2:]) == (3, 3) and _float_route(x)
                and _pallas_conv_gate(h, w, c, wt.shape[0]))
    if not eligible:
        return conv2d(pconv, group_norm(pnorm, x, num_groups, eps, act="silu"), padding=1)
    scale, shift = _group_norm_rows(pnorm, x, _groups(c, num_groups), eps)
    return conv3x3_kernel(x, _hwio(wt, x.dtype), pconv.get("bias"), pre_scale=scale,
                          pre_shift=shift, pre_act="silu", out_dtype=x.dtype)


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
    multiply-add runs in the activation dtype, as in the JAX package. K4
    takes the shapes its gate admits when ``_group_norm_pallas_on`` is set."""
    orig_dtype = x.dtype
    n, c = x.shape[0], x.shape[-1]
    g = _groups(c, num_groups)
    spatial = math.prod(x.shape[1:-1])
    if _group_norm_pallas_on and c % 128 == 0 and spatial >= 8 and fits_gate(spatial, c):
        out = group_norm_kernel(x.reshape(n, spatial, c), p["weight"], p["bias"], groups=g,
                                eps=eps, act=act)
        return out.reshape(x.shape)
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
    """Multi-head attention over packed head dims (B, L, H*D). Unmasked
    attention takes the K1 routing (kernel when K/V length >= 2048); masked
    attention (CLIP's causal mask) is the plain einsum-softmax."""
    if mask is None:
        return attention_pallas(q, k, v, heads)
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
