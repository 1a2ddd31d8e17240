"""Int8 conv-path quantization: calibrated static activation scales.

Counterpart of stable_renderer_tpu/models/quant.py, with the same scheme and
the same tree layout, so a quantized JAX tree converts leaf by leaf:

  * weights: per-output-channel symmetric int8, quantized once, stored HWIO
    (``weight_q`` (kH, kW, I, O) int8) with ``w_scale`` (O,) f32;
  * activations: per-tensor symmetric int8, a STATIC scale when calibrated
    (``a_scale``, 0-d f32: max|x| / 127 over a representative batch), the
    dynamic max|x| / 127 otherwise;
  * accumulation in int32, dequantized by (act_scale * w_scale[O]) in f32.

Only convolution weights quantize (``weight`` with 4 dims); norms and linears
pass through. The first and last convs stay in the float type
(``DEFAULT_SKIP_RE``). ``layers.conv2d`` sends an int8 3x3 stride-1 conv that
passes the int8 gate to the K3 kernel (``ops/conv_kernel.py``) and every
other int8 conv to ``conv2d_q`` here, which is plain PyTorch.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

logger = logging.getLogger("sr_torch.quant")

# conv paths kept in the float type under the default skip policy: the UNet's
# first (input_blocks.0.0) and last (out.2) convs, the VAE's conv_in/conv_out
# and the 1x1 quant bridges
DEFAULT_SKIP_RE = re.compile(
    r"(^|\.)(input_blocks\.0\.0|out\.2|conv_in|conv_out|post_quant_conv|quant_conv)($|\.)"
)


def quantize_conv_params(p: Dict[str, Any], a_scale: Optional[float] = None) -> Dict[str, Any]:
    """{"weight": (O, I, kH, kW), "bias"?} -> int8 HWIO + per-O scale.

    ``a_scale``: calibrated max|activation| of this conv's input; stored as
    the static per-tensor quant step (max / 127) under ``a_scale``."""
    w = p["weight"].float()
    o = w.shape[0]
    s = torch.clamp(w.reshape(o, -1).abs().amax(1) / 127.0, min=1e-12)  # (O,)
    q = torch.clamp(torch.round(w / s[:, None, None, None]), -127, 127)
    out: Dict[str, Any] = {
        "weight_q": q.to(torch.int8).permute(2, 3, 1, 0).contiguous(),
        "w_scale": s,
    }
    if a_scale is not None:
        # the step is computed in Python double, then rounded to f32, as in JAX
        out["a_scale"] = torch.tensor(max(float(a_scale), 1e-8) / 127.0, dtype=torch.float32,
                                      device=w.device)
    if p.get("bias") is not None:
        out["bias"] = p["bias"]
    return out


def _is_conv_leaf(node: Any) -> bool:
    if not isinstance(node, dict):
        return False
    w = node.get("weight")
    return w is not None and getattr(w, "ndim", 0) == 4


def quantize_tree(params: Any,
                  act_scales: Optional[Dict[str, Any]] = None,
                  skip_re: Optional[re.Pattern] = DEFAULT_SKIP_RE,
                  min_pixels: int = 0,
                  _path: str = "",
                  _missed: Optional[List[str]] = None) -> Any:
    """Quantize every conv leaf dict (a dict with a 4-D ``weight``) of a
    checkpoint-layout tree; norms and linears pass through.

    ``act_scales``: {dotted.path: max_abs | (max_abs, pixels)} from
    ``calibrate_act_scales``; convs in it get a static activation scale. When
    ``act_scales`` is given, convs ABSENT from it stay in the float type (a
    calibration miss has no measured range, and the dynamic path is never
    taken silently; the misses are logged). With ``act_scales=None`` every
    conv takes the dynamic path. ``skip_re``: conv paths kept in the float
    type. ``min_pixels``: convs whose calibrated input H*W is below this stay
    in the float type."""
    top = _missed is None and act_scales is not None
    if top:
        _missed = []
    if isinstance(params, dict):
        if _is_conv_leaf(params):
            if skip_re is not None and skip_re.search(_path):
                return params
            a = act_scales.get(_path) if act_scales else None
            if act_scales is not None and a is None:
                if _missed is not None:
                    _missed.append(_path)
                return params  # calibration miss: keep the float type, never dynamic
            px = None
            if isinstance(a, (tuple, list)):
                a, px = a
            if min_pixels and px is not None and px < min_pixels:
                return params
            return quantize_conv_params(params, a_scale=a)
        out = {
            k: quantize_tree(v, act_scales, skip_re, min_pixels,
                             _path=f"{_path}.{k}" if _path else str(k), _missed=_missed)
            for k, v in params.items()
        }
        if top and _missed:
            logger.warning(
                "int8 quantization: %d conv(s) missing from act_scales kept in the float "
                "type (calibration never reached them): %s",
                len(_missed), ", ".join(_missed[:8]) + ("..." if len(_missed) > 8 else ""))
        return out
    return params


# --- calibration -------------------------------------------------------------


class _Calibration:
    """While ``active``, ``layers.conv2d`` records max|input| per conv leaf,
    keyed by the leaf dict's id and mapped back to the dotted tree path that
    was registered before the run."""

    active: bool = False

    def __init__(self) -> None:
        self.maxima: Dict[int, torch.Tensor] = {}
        self.paths: Dict[int, str] = {}
        self.pixels: Dict[int, int] = {}

    def record(self, p: Dict[str, Any], x: torch.Tensor) -> None:
        i = id(p)
        if i not in self.paths:
            return  # a conv dict built on the fly: skip
        m = x.abs().amax().float()
        prev = self.maxima.get(i)
        self.maxima[i] = m if prev is None else torch.maximum(prev, m)
        px = int(x.shape[1] * x.shape[2]) if x.dim() == 4 else 0
        self.pixels[i] = max(self.pixels.get(i, 0), px)


_CAL = _Calibration()


def _register_paths(tree: Any, path: str, out: Dict[int, str]) -> None:
    if not isinstance(tree, dict):
        return
    if _is_conv_leaf(tree):
        out[id(tree)] = path
        return
    for k, v in tree.items():
        _register_paths(v, f"{path}.{k}" if path else str(k), out)


@torch.no_grad()
def calibrate_act_scales(apply_fn: Callable, params: Any, *args: Any) -> Dict[str, tuple]:
    """Run ``apply_fn(params, *args)`` once, eagerly, while recording the
    max|input| and the input's spatial size of every conv in ``params``;
    returns {dotted.path: (max_abs, pixels)}.

    Feed a representative batch (for an SD UNet: latents at each of the
    sampler schedule's sigmas x the cfg batch). The conv leaf dicts must be
    the SAME objects as in ``params`` (paths are keyed by ``id()``), and one
    calibration runs at a time (the collector is module state). A warning
    names every registered conv the run never reached (those stay in the
    float type in ``quantize_tree``)."""
    _CAL.__init__()
    _register_paths(params, "", _CAL.paths)
    _CAL.active = True
    try:
        apply_fn(params, *args)
    finally:
        _CAL.active = False
    maxima = {path: _CAL.maxima[i] for i, path in _CAL.paths.items() if i in _CAL.maxima}
    pixels = {path: _CAL.pixels.get(i, 0) for i, path in _CAL.paths.items() if i in _CAL.maxima}
    missed = sorted(set(_CAL.paths.values()) - set(maxima))
    if missed:
        logger.warning(
            "calibration missed %d/%d conv(s) (path not executed by the run, or a dict "
            "rebuild hid it): %s", len(missed), len(_CAL.paths),
            ", ".join(missed[:8]) + ("..." if len(missed) > 8 else ""))
    _CAL.__init__()
    # one host transfer for all maxima
    values = torch.stack(list(maxima.values())).cpu().tolist() if maxima else []
    return {k: (float(v), pixels[k]) for k, v in zip(maxima, values)}


def quant_act(x: torch.Tensor):
    """Per-tensor dynamic symmetric int8: (q, scale)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax() / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return q.to(torch.int8), s


def int_conv(q: torch.Tensor, w_q: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Exact int32 convolution of int8 NHWC ``q`` with int8 HWIO ``w_q``.

    On the card: im2col (in (kH, kW, I) order, matching HWIO rows) and
    ``torch._int_mm``, which accumulates in int32. On the CPU: a float64
    convolution, exact here because every product is at most 127 * 127 and
    every sum at most 9 * I * 127^2 < 2^53."""
    kh, kw, ci, co = w_q.shape
    if q.device.type == "cpu":
        out = F.conv2d(q.double().permute(0, 3, 1, 2), w_q.double().permute(3, 2, 0, 1),
                       stride=stride, padding=padding)
        return out.permute(0, 2, 3, 1).to(torch.int32)
    n, h, w, _ = q.shape
    if padding:
        q = F.pad(q, (0, 0, padding, padding, padding, padding))
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    if kh == kw == 1 and stride == 1:
        cols = q.reshape(n * ho * wo, ci)
    else:
        taps = [q[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
                for dy in range(kh) for dx in range(kw)]
        cols = torch.cat(taps, dim=-1).reshape(n * ho * wo, kh * kw * ci)
    acc = torch._int_mm(cols.contiguous(), w_q.reshape(kh * kw * ci, co))
    return acc.reshape(n, ho, wo, co)


def conv2d_q(p: Dict[str, Any], x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Int8 conv with int32 accumulation and f32 dequantization.

    Static ``a_scale`` (calibrated): the quantize divides by the step;
    without it the scale is the dynamic max|x| / 127."""
    if "a_scale" in p:
        s_x = p["a_scale"]
        q = torch.clamp(torch.round(x.float() / s_x), -127, 127).to(torch.int8)
    else:
        q, s_x = quant_act(x)
    acc = int_conv(q, p["weight_q"], stride=stride, padding=padding)
    out = acc.float() * (s_x * p["w_scale"])
    if p.get("bias") is not None:
        out = out + p["bias"].float()
    return out.to(x.dtype)
