"""The work of one frame, counted on the reference's towers.

One pass of a frame's model work runs on the ``meta`` device at the cell's
shapes and in the served types, under ``FlopCounterMode`` and a recorder of
every attention call and every convolution: the UNet evaluations with their
CFG batch, the VAE encode and decode, no text tower (conditioning is cached
per prompt). Nothing of the port is counted, so the numbers are the model's,
whatever a later change to the port computes them with.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.plain.models import layers, quant
from benchmark.harness.weights import DTYPES


@dataclass
class FrameWork:
    """A frame's model FLOPs and the calls the kernel rooflines read:
    ``attention`` (b, heads, lq, lk, d, elem_bytes) and ``convs``
    (n, h, w, cin, cout, kh, kw, stride, padding, elem_bytes, path)."""

    flops: float = 0.0
    attention: List[tuple] = field(default_factory=list)
    convs: List[tuple] = field(default_factory=list)

    def scaled(self, k: float) -> "FrameWork":
        return FrameWork(self.flops * k, [a + (k,) for a in self.attention],
                         [c + (k,) for c in self.convs])


class _ConvRecorder(TorchDispatchMode):
    """Notes every aten convolution with the conv leaf's tree path, which
    ``layers.conv2d`` hands the calibration collector just before."""

    def __init__(self, out: list):
        super().__init__()
        self.out, self.path = out, ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.convolution.default:
            x, w = args[0], args[1]
            stride, padding = args[3], args[4]
            n, cin, h, wd = x.shape
            self.out.append((n, h, wd, cin, w.shape[0], w.shape[2], w.shape[3], stride[0],
                             padding[0], x.element_size(), self.path))
        return func(*args, **kwargs)


class _PathCollector:
    """Stands in for the calibration collector: remembers the path of the
    conv leaf about to run."""

    active = True

    def __init__(self, paths: dict, rec: _ConvRecorder):
        self.paths, self.rec = paths, rec

    def record(self, p, x) -> None:
        self.rec.path = self.paths.get(id(p), "")


def count_frame(ref_towers: dict, config: dict, traffic: dict) -> FrameWork:
    """The model work of one engine frame of ``traffic`` (stream, sequential
    or bake: a bake frame is its submit's work over the submit's frames)."""
    render = traffic["render"]
    h, w = traffic["size"]
    types = config["types"]
    udt, vdt = DTYPES[types["unet"]], DTYPES[types["vae"]]
    unet, vae = ref_towers["unet"], ref_towers["vae"]
    up = unet.init(dtype=udt, device="meta")
    vp = vae.init(dtype=vdt, device="meta")
    steps = int(render["steps"])
    cfg_pair = 1 if float(render["cfg_scale"]) == 1.0 else 2
    mode = traffic["mode"]
    frames = int(traffic.get("bake_interval", 1)) if mode == "bake" else 1
    if mode == "stream":
        evals, batch = 1, steps * cfg_pair
    else:
        evals, batch = steps, frames * cfg_pair
    lh, lw = h // 8, w // 8
    ucfg = unet.config
    ctx = torch.empty((batch, 77, ucfg.context_dim), dtype=udt, device="meta")
    y = None if ucfg.adm_in_channels is None else torch.empty(
        (batch, ucfg.adm_in_channels), dtype=udt, device="meta")
    work = FrameWork()
    paths: dict = {}
    quant._register_paths(up, "unet", paths)
    quant._register_paths(vp, "vae", paths)
    plain_attention = layers.attention_plain

    def noted(q, k, v, heads):
        work.attention.append((q.shape[0], heads, q.shape[1], k.shape[1],
                               q.shape[2] // heads, q.element_size()))
        return plain_attention(q, k, v, heads)

    rec = _ConvRecorder(work.convs)
    saved = quant._CAL
    layers.attention_plain = noted
    quant._CAL = _PathCollector(paths, rec)
    try:
        with FlopCounterMode(display=False) as fc, rec, torch.no_grad():
            for _ in range(evals):
                x = torch.empty((batch, lh, lw, ucfg.in_channels), dtype=udt, device="meta")
                t = torch.empty((batch,), dtype=torch.float32, device="meta")
                unet.apply(up, x, t, ctx, y)
            vae.encode(vp, torch.empty((frames, h, w, 3), dtype=vdt, device="meta"))
            vae.decode(vp, torch.empty((frames, lh, lw, 4), dtype=vdt, device="meta"))
    finally:
        layers.attention_plain = plain_attention
        quant._CAL = saved
    work.flops = float(fc.get_total_flops())
    return work.scaled(1.0 / frames)


def int8_k3_convs(work: FrameWork) -> List[Tuple]:
    """The convs of ``work`` that the calibrated int8 path sends to K3: 3x3,
    stride 1, pad 1, at least 32 x 32 pixels and 128 channels in and out,
    and not on the float skip list (the first and last convs, the VAE's
    bridges)."""
    out = []
    for c in work.convs:
        n, h, w, cin, cout, kh, kw, stride, pad, eb, path, k = c
        if (kh, kw, stride, pad) != (3, 3, 1, 1) or h * w < 32 * 32 or cin < 128 or cout < 128:
            continue
        if quant.DEFAULT_SKIP_RE.search(path.split(".", 1)[1] if "." in path else path):
            continue
        out.append(c)
    return out
