"""Fused 3x3 conv: the K3 kernel's wrapper, its plain version and its switch.

Counterpart of stable_renderer_tpu/ops/conv_pallas.py. The kernel is
``csrc/conv3x3.cu`` (CUDA C++ for sm_90a: an elementwise pass that applies
the prologue and the quantize once per input, then an implicit GEMM on wgmma
fed by TMA; see its header). The wrapper keeps one K-contiguous copy of each
weight tensor it is given, with its TMA tensor maps, and picks the GEMM's tile
shape per call (``conv_tiles``). ``conv3x3_kernel`` has ``conv3x3_pallas``'s
contract:

  * 3x3, stride 1, pad 1, NHWC input, HWIO weights;
  * an optional prologue ``x * pre_scale[n, c] + pre_shift[n, c]`` (then
    SiLU with ``pre_act="silu"``) computed in f32 and applied to in-image
    pixels only: the zero halo stays zero after it;
  * bias and an optional SiLU epilogue in f32;
  * int8 mode when ``w`` is int8: the activation is quantized on the card as
    ``round_half_even(x * (1 / a_scale))`` clipped to +-127 (the reciprocal
    once in f32; with the prologue, from its f32 output), int32 accumulation,
    dequantized by ``acc * (a_scale * w_scale[o]) + bias``.

CUDA tensors launch the kernel; CPU tensors take the plain version
``conv3x3_kernel_reference``, which repeats the kernel's arithmetic; any other
device raises. On the card the float mode takes bf16 activations and bf16
weights; int8 mode takes bf16 or f32 activations.

``use_pallas_conv`` is the counterpart of the JAX switch: it routes eligible
float 3x3 convs of ``models.layers`` (``conv2d`` and ``norm_act_conv``) to
this kernel. Int8 convs that pass the int8 gate take the kernel on the card
whether it is set or not (the JAX package's int8 mode turns it on).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

_BIAS_NONE, _BIAS_F32, _BIAS_BF16 = 0, 1, 2

# --- the GEMM's tile shape ------------------------------------------------------
# csrc/conv3x3.cu's compiled table (kConfigs): output channels a block (BN),
# consumer warpgroups, 64-pixel blocks a warpgroup, and the dynamic shared
# memory a block of that shape takes (bytes; the .cu asserts it at compile time)
TILE_CONFIGS = ((128, 2, 1, 214_176), (160, 2, 1, 214_144), (256, 2, 1, 214_096),
                (128, 2, 2, 218_208), (160, 2, 2, 230_480))
SMS = 132             # the H100's streaming multiprocessors
TILE_W = 16           # output pixels a warp: one tile row
K_BYTES = 128         # bytes of K a chunk: one 128-byte-swizzled TMA box row
# the picker's cost model, in SM clocks: a tap of one K chunk is 4 products of
# 64 x BN x 32 bytes per 64-pixel block at 2048 bf16 (4096 int8) multiply-adds
# a clock and SM, 2 BN clocks a block, or its loads (its B tile and a ninth of
# the patch) from L2 at L2_BYTES_PER_CLOCK a SM when all the SMs load at
# once, whichever is longer; a block takes ceil(tiles / SMs) tiles. The
# constant is fitted to scripts/sweep_torch_conv.py's times of every
# compiled tile shape at the frame's shape classes on an H100 80GB HBM3
# (700 W): from 35 to 40 the picks came within 0.4% of the best shape a
# frame, weighted by launches (2% off at 34, 4% at 42), in the sweep it was
# fitted to, and within 1.1% in a later one
L2_BYTES_PER_CLOCK = 38.0


class ConvTiles(NamedTuple):
    """A GEMM launch of K3 for one conv (``conv_tiles`` picks one)."""
    bn: int        # output channels a block
    nwg: int       # consumer warpgroups
    mb: int        # 64-pixel blocks a warpgroup
    rows: int      # output rows a tile (a tile is rows x TILE_W pixels x bn channels)
    cs: int        # channel stride of the GEMM's A (cin, padded to 16 in int8)
    smem: int      # dynamic shared memory a block, bytes
    grid: tuple    # (pixel tiles, output-channel tiles)
    threads: int   # a block's threads: the consumers and one producer warpgroup


def tile_candidates(n: int, h: int, w: int, cin: int, cout: int, int8: bool) -> list:
    """Every launch K3 can make of this conv: one per compiled tile shape."""
    cs = -(-cin // 16) * 16 if int8 else cin
    return [ConvTiles(bn, nwg, mb, 4 * nwg * mb, cs, smem,
                      (n * -(-h // (4 * nwg * mb)) * -(-w // TILE_W), -(-cout // bn)),
                      128 * (nwg + 1))
            for bn, nwg, mb, smem in TILE_CONFIGS]


def _modelled_clocks(t: ConvTiles, int8: bool) -> float:
    tiles = t.grid[0] * t.grid[1]
    chunks = -(-t.cs * (1 if int8 else 2) // K_BYTES)
    patch = (t.rows + 2) * (TILE_W + 2) * K_BYTES
    tap = max(2.0 * t.bn * t.mb * t.nwg, (t.bn * K_BYTES + patch / 9) / L2_BYTES_PER_CLOCK)
    return math.ceil(tiles / SMS) * 9 * chunks * tap


@functools.lru_cache(maxsize=None)
def conv_tiles(n: int, h: int, w: int, cin: int, cout: int, int8: bool) -> ConvTiles:
    """Pick K3's launch for an (n, h, w, cin) -> cout conv: the candidate
    with the least modelled time, larger tiles first on a tie (kept per
    shape: the frame calls each shape many times)."""
    return min(tile_candidates(n, h, w, cin, cout, int8),
               key=lambda t: (_modelled_clocks(t, int8), -t.rows * t.bn))


def conv3x3_kernel_reference(x, w, bias=None, *, act=None, pre_scale=None, pre_shift=None,
                             pre_act=None, a_scale=None, w_scale=None, out_dtype=None):
    """Plain PyTorch with the kernel's exact semantics (see the module
    docstring). Float mode sums in f32: on the card TF32 must be off, as
    ``device.keep_f32`` leaves it."""
    from stable_renderer_tpu_torch.models.quant import int_conv

    out_dtype = out_dtype or x.dtype
    int8_mode = w.dtype == torch.int8
    xs = x
    if pre_scale is not None:
        bshape = (x.shape[0], 1, 1, x.shape[-1])
        xf = x.float() * pre_scale.float().reshape(bshape)
        if pre_shift is not None:
            xf = xf + pre_shift.float().reshape(bshape)
        if pre_act == "silu":
            xf = F.silu(xf)
        xs = xf if int8_mode else xf.to(x.dtype)
    if int8_mode:
        a_s = torch.as_tensor(a_scale, dtype=torch.float32, device=x.device)
        q = torch.clamp(torch.round(xs.float() * torch.reciprocal(a_s)), -127, 127)
        acc = int_conv(q.to(torch.int8), w, stride=1, padding=1)
        out = acc.float() * (a_s * w_scale.float())
    else:
        out = F.conv2d(xs.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                       padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.float()
    if act == "silu":
        out = F.silu(out)
    return out.to(out_dtype)


def _check(x, w, bias, pre_scale, pre_shift, a_scale, w_scale, out_dtype) -> None:
    int8_mode = w.dtype == torch.int8
    tensors = [("x", x), ("w", w), ("bias", bias), ("pre_scale", pre_scale),
               ("pre_shift", pre_shift), ("a_scale", a_scale), ("w_scale", w_scale)]
    for name, t in tensors:
        if t is not None and (t.device.type != "cuda" or t.device != x.device):
            raise ValueError(f"conv3x3_kernel: {name} is on {t.device}, not {x.device} (CUDA)")
    if x.dim() != 4 or w.dim() != 4 or not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("conv3x3_kernel: x must be a contiguous (N, H, W, Cin) tensor and w "
                         "a contiguous (3, 3, Cin, Cout) tensor")
    n, h, wd, cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"conv3x3_kernel: w{tuple(w.shape)} does not match x{tuple(x.shape)}")
    cout = w.shape[3]
    if cin % 8 or cout % 8:
        raise ValueError(f"conv3x3_kernel: Cin {cin} and Cout {cout} must be multiples of 8")
    if int8_mode:
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"conv3x3_kernel: int8 mode takes bf16 or f32 x, not {x.dtype}")
        if a_scale is None or w_scale is None:
            raise ValueError("conv3x3_kernel: int8 mode needs a_scale and w_scale")
        if a_scale.numel() != 1 or a_scale.dtype != torch.float32:
            raise ValueError("conv3x3_kernel: a_scale must be one f32 value")
        if w_scale.shape != (cout,) or w_scale.dtype != torch.float32:
            raise ValueError("conv3x3_kernel: w_scale must be (Cout,) f32")
    elif x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"conv3x3_kernel: the float mode takes bf16 x and w on the card, not "
                         f"{x.dtype} and {w.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv3x3_kernel: out_dtype {out_dtype} (bf16 or f32 only)")
    if bias is not None and (bias.shape != (cout,) or bias.dtype not in (torch.bfloat16,
                                                                         torch.float32)):
        raise ValueError("conv3x3_kernel: bias must be (Cout,) bf16 or f32")
    for name, t in (("pre_scale", pre_scale), ("pre_shift", pre_shift)):
        if t is not None and (t.shape != (n, cin) or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"conv3x3_kernel: {name} must be a contiguous (N, Cin) f32 tensor")
    if pre_shift is not None and pre_scale is None:
        raise ValueError("conv3x3_kernel: pre_shift without pre_scale")
    for name, t in (("x", x), ("w", w), ("pre_scale", pre_scale), ("pre_shift", pre_shift)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"conv3x3_kernel: {name} must be 16-byte aligned (vector loads)")


def conv3x3_kernel(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                   act: Optional[str] = None, pre_scale: Optional[torch.Tensor] = None,
                   pre_shift: Optional[torch.Tensor] = None, pre_act: Optional[str] = None,
                   a_scale=None, w_scale: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """3x3 stride-1 pad-1 conv on NHWC with the fused prologue, epilogue and
    int8 mode. CUDA tensors launch K3 with ``conv_tiles``'s launch; CPU
    tensors take the plain version."""
    return _launch(x, w, bias, act=act, pre_scale=pre_scale, pre_shift=pre_shift,
                   pre_act=pre_act, a_scale=a_scale, w_scale=w_scale, out_dtype=out_dtype)


def _launch(x, w, bias=None, *, act=None, pre_scale=None, pre_shift=None, pre_act=None,
            a_scale=None, w_scale=None, out_dtype=None, tiles: Optional[ConvTiles] = None):
    """conv3x3_kernel with a given launch ``tiles`` (one of
    ``tile_candidates``; default ``conv_tiles``'s pick): the sweep script and
    the card tests run every candidate."""
    for a in (act, pre_act):
        if a not in (None, "silu"):
            raise ValueError(f"conv3x3_kernel: unknown activation {a!r}")
    if x.device.type == "cpu":
        return conv3x3_kernel_reference(x, w, bias, act=act, pre_scale=pre_scale,
                                        pre_shift=pre_shift, pre_act=pre_act, a_scale=a_scale,
                                        w_scale=w_scale, out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    int8_mode = w.dtype == torch.int8
    if int8_mode and a_scale is not None and not isinstance(a_scale, torch.Tensor):
        a_scale = torch.tensor(float(a_scale), dtype=torch.float32, device=x.device)
    _check(x, w, bias, pre_scale, pre_shift, a_scale, w_scale, out_dtype)
    from stable_renderer_tpu_torch.kernels import _build

    lib = _build.load_library()
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    tiles = tiles or conv_tiles(n, h, wd, cin, cout, int8_mode)
    out = torch.empty((n, h, wd, cout), dtype=out_dtype, device=x.device)
    bias_kind = (_BIAS_NONE if bias is None
                 else _BIAS_BF16 if bias.dtype == torch.bfloat16 else _BIAS_F32)
    # scratch (see csrc/conv3x3.cu): A's values with the prologue and quantize
    # applied, channels padded to 16 bytes in int8 mode
    cs = tiles.cs
    act_buf = None
    if int8_mode or pre_scale is not None:
        act_buf = torch.empty((n * h * wd * cs,), dtype=w.dtype, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        rc = lib.sr_conv3x3(
            ptr(x), _weight_map(lib, w, cs, tiles.bn), ptr(bias), bias_kind, ptr(pre_scale),
            ptr(pre_shift), ptr(a_scale), ptr(w_scale), ptr(out), ptr(act_buf), n, h, wd, cin,
            cout, cs, int(int8_mode), int(x.dtype == torch.float32),
            int(out_dtype == torch.float32), int(act == "silu"), int(pre_scale is not None),
            int(pre_act == "silu"), tiles.bn, tiles.nwg, tiles.mb,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "conv3x3_kernel")
    conv3x3_kernel.launches += 1
    return out


conv3x3_kernel.launches = 0


# weight tensor -> {cs: its K-major copy, (cs, bn): that copy's tensor map};
# an entry lives as long as its weight
_k_major_cache = WeakIdKeyDictionary()


def _k_major(w: torch.Tensor, cs: int) -> torch.Tensor:
    """The HWIO weights as (Cout, 3, 3, cs) rows, K contiguous, channels
    zero-padded to ``cs``: what the kernel's B tile reads. Made once per weight
    tensor (weights are not changed in place)."""
    copies = _k_major_cache.setdefault(w, {})
    if cs not in copies:
        wt = w.permute(3, 0, 1, 2)
        if cs != w.shape[2]:
            wt = F.pad(wt, (0, cs - w.shape[2]))
        copies[cs] = wt.contiguous()
    return copies[cs]


def _weight_map(lib, w: torch.Tensor, cs: int, bn: int) -> int:
    """The address of the TMA tensor map (128 bytes of host memory) of
    ``_k_major(w, cs)`` for blocks of ``bn`` output channels, encoded once
    and kept beside the copy."""
    from stable_renderer_tpu_torch.kernels import _build

    copies = _k_major_cache.setdefault(w, {})
    if (cs, bn) not in copies:
        wt = _k_major(w, cs)
        buf = ctypes.create_string_buffer(128)
        _build.check(lib.sr_conv3x3_weight_map(buf, wt.data_ptr(), wt.shape[0], cs,
                                               int(wt.dtype == torch.int8), bn),
                     "conv3x3_kernel weight map")
        copies[(cs, bn)] = buf
    return ctypes.addressof(copies[(cs, bn)])


def use_pallas_conv(enable: bool = True) -> None:
    """Route eligible float 3x3 convs (``models.layers.conv2d`` and
    ``norm_act_conv``) through K3; the shape gate is
    ``layers._pallas_conv_gate``, kept from the JAX package."""
    from stable_renderer_tpu_torch.models import layers

    layers._conv_pallas_on = enable
