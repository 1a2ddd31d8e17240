"""Fused GroupNorm (+ SiLU): the K4 kernel's wrapper and its plain version.

Counterpart of stable_renderer_tpu/ops/group_norm_pallas.py. The kernel is
``csrc/group_norm.cu`` (CUDA C++ for sm_90a, one launch a call; see its
header: a thread-block cluster per (n, channel slice) whose CTAs split S and
exchange the group sums through distributed shared memory).
``group_norm_kernel`` launches it for CUDA tensors and uses the plain
``group_norm_kernel_reference`` only for CPU tensors; ``gn_geometry`` picks
the launch.

Semantics are the kernel's, which differ from ``layers.group_norm`` in two
roundings: the squares are taken in f32, and the normalize multiply-add runs
in f32 before the one cast to x's type. ``models.layers.group_norm`` routes
here when ``layers._group_norm_pallas_on`` is set and the shape passes the
JAX package's gate (C % 128 == 0, S >= 8, S * C <= 2 * 2^20).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from stable_renderer_tpu_torch.device import on_device

MAX_ELEMENTS = 2 * 1024 * 1024  # the JAX gate on S * C (ops/group_norm_pallas.py:47)
# the kernel's limits (csrc/group_norm.cu)
VEC = 8                 # channels a vector (16 bytes of bf16)
MAX_THREADS = 512       # threads a CTA
MAX_PASSES = 8          # vectors a thread keeps in registers
MAX_CLUSTER = 16        # CTAs a cluster (above 8 not portable; H100 allows 16)
MAX_SLICE = 1024        # channels a slice
RED_FLOATS = MAX_THREADS * (2 * VEC + 1)  # the per-thread sums (padded), then partials
STATIC_SMEM = 4 * (RED_FLOATS + 2 * MAX_SLICE)  # bytes a CTA
SMEM_LIMIT = 48 * 1024  # static shared memory a CTA may have
SEGMENT_BYTES = 64      # a slice's row is at least this long where the channels allow
# CTAs of one launch that the H100 runs at once, by cluster size: one CTA an
# SM, and clusters of 4 or more fill 120 of its 132 SMs (cudaOccupancyMax-
# ActiveClusters for the frame's shapes: 66 clusters of 2, 30 of 4, 15 of 8, 7
# of 16). A second wave of clusters doubles a call's time, so the cluster is
# the largest that keeps the launch to one wave.
WAVE_CTAS = {1: 132, 2: 132, 4: 120, 8: 120, 16: 112}


class GnGeometry(NamedTuple):
    """One launch of K4: channels a slice (a whole number of groups and of
    8-channel vectors), CTAs a cluster (they split S), rows a CTA, rows a pass
    (threads = slice / 8 x rows a pass), passes, and whether x stays in
    registers between the statistics and the normalize."""

    slice_channels: int
    cluster: int
    rows_per_cta: int
    rows_per_pass: int
    passes: int
    resident: bool

    @property
    def threads(self) -> int:
        """Threads a CTA: slice / 8 x rows a pass, rounded up to whole warps."""
        return -(-self.slice_channels // VEC * self.rows_per_pass // 32) * 32


@functools.lru_cache(maxsize=None)
def gn_geometry(n: int, s: int, c: int, groups: int, elem_bytes: int,
                cluster: Optional[int] = None) -> GnGeometry:
    """The launch for x (n, s, c) with ``elem_bytes`` bytes an element: the
    narrowest slice of whole groups, vectors and 32-byte sectors whose rows
    are at least SEGMENT_BYTES long, then the largest cluster (a power of
    two) that keeps the launch to one wave (WAVE_CTAS) and leaves room for the
    cluster's partials, then rows a pass balanced so that every pass is
    full. ``cluster`` forces the cluster size (scripts/sweep_torch_group_norm.py)."""
    if c % groups or c % VEC:
        raise ValueError(f"group_norm_kernel: C {c} must be a multiple of {groups} groups "
                         f"and of {VEC}")
    cpg = c // groups
    unit = math.lcm(cpg, VEC, 32 // elem_bytes)
    want = max(unit, SEGMENT_BYTES // elem_bytes)
    cs = next((k for k in range(unit, c + 1, unit) if c % k == 0 and k >= want), c)
    if cs > MAX_SLICE:
        raise ValueError(f"group_norm_kernel: a slice of whole groups needs {cs} channels "
                         f"(C {c}, {groups} groups); the kernel takes at most {MAX_SLICE}")
    vpr = cs // VEC
    room = RED_FLOATS // (2 * (cs // cpg)) - 1  # the cluster's partials and statistics
    clusters = n * (c // cs)
    if cluster is None:
        cluster = next((r for r in (16, 8, 4, 2) if r <= min(MAX_CLUSTER, s, room)
                        and clusters * r <= WAVE_CTAS[r]), 1)
    elif not 1 <= cluster <= min(MAX_CLUSTER, s, room):
        raise ValueError(f"group_norm_kernel: a cluster of {cluster} CTAs does not fit "
                         f"{(n, s, c)}")
    rpc = -(-s // cluster)
    cluster = -(-s // rpc)  # no CTA without rows
    passes = -(-rpc // max(1, min(rpc, MAX_THREADS // 32 * 32 // vpr)))
    rpp = -(-rpc // passes)
    return GnGeometry(cs, cluster, rpc, rpp, passes, passes <= MAX_PASSES)


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
    launch K4 (one kernel, nothing allocated but y); CPU tensors take the
    plain version."""
    if act not in (None, "silu"):
        raise ValueError(f"group_norm_kernel: unknown activation {act!r}")
    if x.shape[-1] % groups:
        raise ValueError(f"group_norm_kernel: C {x.shape[-1]} is not a multiple of {groups}")
    if x.device.type == "cpu":
        return group_norm_kernel_reference(x, weight, bias, groups, eps, act)
    _check(x, weight, bias)
    return _launch(x, weight, bias, groups, eps, act,
                   gn_geometry(*x.shape, groups, x.element_size()))


def _launch(x, weight, bias, groups, eps, act, geometry: GnGeometry) -> torch.Tensor:
    """One K4 launch with the given geometry (scripts/sweep_torch_group_norm.py
    passes others than gn_geometry's pick)."""
    from stable_renderer_tpu_torch.kernels import _build

    if weight.dtype != bias.dtype:
        weight, bias = weight.float(), bias.float()
    weight, bias = weight.contiguous(), bias.contiguous()
    lib = _build.load_library()
    n, s, c = x.shape
    y = torch.empty_like(x)
    with on_device(x.device):
        rc = lib.sr_group_norm(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), int(weight.dtype == torch.bfloat16),
            y.data_ptr(), n, s, c, groups, *geometry, float(eps), int(act == "silu"),
            int(x.dtype == torch.float32), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "group_norm_kernel")
    group_norm_kernel.launches += 1
    return y


def max_active_clusters(n: int, s: int, c: int, groups: int, geometry: GnGeometry,
                        x_f32: bool = False) -> int:
    """cudaOccupancyMaxActiveClusters for a K4 launch: how many of its
    clusters the card holds at once (0 or less: the launch cannot run)."""
    from stable_renderer_tpu_torch.kernels import _build

    return _build.load_library().sr_group_norm_max_clusters(n, s, c, groups, *geometry,
                                                            int(x_f32))


group_norm_kernel.launches = 0
