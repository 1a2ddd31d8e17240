"""Fused GroupNorm (+ SiLU): the K4 kernel's wrapper and its plain version.

Counterpart of stable_renderer_tpu/ops/group_norm_pallas.py. The kernel is
``csrc/group_norm.cu`` (CUDA C++ for sm_90a; see its header: partial sums
per S-chunk, a fixed-order reduction per group, one normalize pass).
``group_norm_kernel`` launches it for CUDA tensors and uses the plain
``group_norm_kernel_reference`` only for CPU tensors.

Semantics are the kernel's, which differ from ``layers.group_norm`` in two
roundings: the squares are taken in f32, and the normalize multiply-add runs
in f32 before the one cast to x's type. ``models.layers.group_norm`` routes
here when ``layers._group_norm_pallas_on`` is set and the shape passes the
JAX package's gate (C % 128 == 0, S >= 8, S * C <= 2 * 2^20).
"""

from __future__ import annotations

from typing import Optional

import torch

MAX_ELEMENTS = 2 * 1024 * 1024  # the JAX gate on S * C (ops/group_norm_pallas.py:47)
_TARGET_BLOCKS = 264  # statistics blocks: two per SM of an H100


def fits_gate(spatial: int, channels: int) -> bool:
    return spatial * channels <= MAX_ELEMENTS


def group_norm_kernel_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                                groups: int = 32, eps: float = 1e-6,
                                act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch over (N, S, C) with the kernel's arithmetic: f32
    statistics of f32 squares, f32 normalize, one cast at the end."""
    n, s, c = x.shape
    xf = x.float()
    s1 = xf.sum(1)
    s2 = (xf * xf).sum(1)
    cnt = float(s * (c // groups))
    mean_g = s1.reshape(n, groups, c // groups).sum(-1) / cnt
    var_g = torch.clamp(s2.reshape(n, groups, c // groups).sum(-1) / cnt - mean_g * mean_g,
                        min=0.0)
    rstd_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(c // groups, dim=-1)
    rstd_c = rstd_g.repeat_interleave(c // groups, dim=-1)
    scale = rstd_c * weight.float()
    shift = bias.float() - mean_c * scale
    y = xf * scale[:, None, :] + shift[:, None, :]
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _check(x, weight, bias) -> None:
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"group_norm_kernel: {name} is on {t.device}, not {x.device} (CUDA)")
    if x.dim() != 3 or not x.is_contiguous() or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("group_norm_kernel: x must be a contiguous (N, S, C) bf16 or f32 tensor")
    if x.data_ptr() % 16:
        raise ValueError("group_norm_kernel: x must be 16-byte aligned")
    c = x.shape[2]
    if c % 8:
        raise ValueError(f"group_norm_kernel: C {c} must be a multiple of 8")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (c,) or t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"group_norm_kernel: {name} must be (C,) bf16 or f32")


def group_norm_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      groups: int = 32, eps: float = 1e-6,
                      act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm (+ SiLU with ``act="silu"``) over (N, S, C). CUDA tensors
    launch K4; CPU tensors take the plain version."""
    if act not in (None, "silu"):
        raise ValueError(f"group_norm_kernel: unknown activation {act!r}")
    if x.shape[-1] % groups:
        raise ValueError(f"group_norm_kernel: C {x.shape[-1]} is not a multiple of {groups}")
    if x.device.type == "cpu":
        return group_norm_kernel_reference(x, weight, bias, groups, eps, act)
    _check(x, weight, bias)
    from stable_renderer_tpu_torch.kernels import _build

    if weight.dtype != bias.dtype:
        weight, bias = weight.float(), bias.float()
    weight, bias = weight.contiguous(), bias.contiguous()
    lib = _build.load_library()
    n, s, c = x.shape
    chunks = min(s, max(1, -(-_TARGET_BLOCKS // n)))
    rows = -(-s // chunks)
    chunks = -(-s // rows)
    y = torch.empty_like(x)
    scratch = torch.empty((n * chunks * 2 * c + 2 * n * c,), dtype=torch.float32, device=x.device)
    part, scale, shift = scratch.split([n * chunks * 2 * c, n * c, n * c])
    with torch.cuda.device(x.device):
        rc = lib.sr_group_norm(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), int(weight.dtype == torch.bfloat16),
            y.data_ptr(), part.data_ptr(), scale.data_ptr(), shift.data_ptr(), n, s, c, groups,
            chunks, rows, float(eps), int(act == "silu"), int(x.dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "group_norm_kernel")
    group_norm_kernel.launches += 1
    return y


group_norm_kernel.launches = 0
