"""The control: the reference in the program's place, one precision lower.

The configurations state a bf16 UNet (with calibrated int8 3x3 convs where
the render asks), and an f32 VAE and text towers with TF32 off. The control
computes each one step below: the UNet's float linears and convs in fp8
(e4m3: weights with a scale per output row, inputs with one scale a call),
its int8 convs in int4 (weights re-quantized with a scale per output
channel to levels -7..7, inputs on a step 127 / 7 times the calibrated int8
step), and the f32 towers with TF32 on. It then runs as the program does,
and the benchmark's own comparison judges its frames against the reference:
a ``correct`` comparison has to call it wrong.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable

import torch

from benchmark.reference.plain.ops.gbuffer import RENDER_MODE_NORMAL
from benchmark.reference.programs import Reference, bg_noise, frame_key, make_corresponder
from benchmark.reference.scene import prompt_text

FP8_MAX = 448.0


def _fp8(w: torch.Tensor) -> torch.Tensor:
    wf = w.float()
    s = torch.clamp(wf.reshape(wf.shape[0], -1).abs().amax(1) / FP8_MAX, min=1e-12)
    s = s.reshape((-1,) + (1,) * (wf.dim() - 1))
    return ((wf / s).to(torch.float8_e4m3fn).float() * s).to(w.dtype)


def _fp8_act(x: torch.Tensor) -> torch.Tensor:
    s = torch.clamp(x.float().abs().amax() / FP8_MAX, min=1e-12)
    return ((x.float() / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)


def _int4(p: dict) -> dict:
    wq, ws = p["weight_q"], p["w_scale"]
    w = wq.float() * ws  # HWIO, scale per O
    s4 = torch.clamp(w.reshape(-1, w.shape[-1]).abs().amax(0) / 7.0, min=1e-12)
    q4 = torch.clamp(torch.round(w / s4), -7, 7).to(torch.int8)
    return dict(p, weight_q=q4, w_scale=s4, a_scale=p["a_scale"] * (127.0 / 7.0))


@contextlib.contextmanager
def fp8_unet_inputs(unet):
    """While the UNet evaluates, its float linears and convs take fp8 inputs."""
    from benchmark.reference.plain.models import layers
    from benchmark.reference.plain.models import unet as unet_mod

    real_linear, real_conv = layers.linear, layers.conv2d
    state = {"on": False}

    def linear(p, x):
        return real_linear(p, _fp8_act(x) if state["on"] else x)

    def conv2d(p, x, stride=1, padding=0):
        if state["on"] and "weight_q" not in p:
            x = _fp8_act(x)
        return real_conv(p, x, stride=stride, padding=padding)

    real_apply = unet.apply

    def apply(*a, **kw):
        state["on"] = True
        try:
            return real_apply(*a, **kw)
        finally:
            state["on"] = False

    saved = [(m, n, getattr(m, n)) for m in (layers, unet_mod) for n in ("linear", "conv2d")]
    for m, n, _ in saved:
        setattr(m, n, linear if n == "linear" else conv2d)
    unet.apply = apply
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
        del unet.apply


def lower_unet(tree):
    if isinstance(tree, dict):
        if "weight_q" in tree:
            return _int4(tree)
        return {k: (_fp8(v) if k == "weight" and torch.is_tensor(v) and v.dim() >= 2
                    else lower_unet(v)) for k, v in tree.items()}
    return tree


@contextlib.contextmanager
def tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def control_frames(config: dict, weights: dict, traffic: dict, seed: int, device,
                   frames: Iterable[int], capture: Iterable[int]):
    """The control's presented ``frames`` and, for the stream, its state
    entering each frame of ``capture`` (the stream replays from frame 0):
    (frame, state, kv), as the benchmark's driver hands them on."""
    render = dict(traffic["render"], size=traffic["size"])
    size = tuple(traffic["size"])
    scene = traffic["scene"]
    stream = bool(render.get("stream"))
    capture = set(capture)
    out, states = {}, {}
    ctl = Reference(config, weights, render, device)
    with tf32(), torch.no_grad(), fp8_unet_inputs(ctl.unet):
        if render.get("int8_conv"):
            ctl.quantize_convs(size)
        ctl.unet_params = lower_unet(ctl.unet_params)
        ctx, nctx, y_cond, y_uncond = ctl.conditioning(
            prompt_text(scene, render.get("prompt", "")), 1, size)
        bg = bg_noise(size, device)
        corr = make_corresponder(traffic["corresponder"])
        state = kv = None
        frames = sorted(frames)
        for f in range(frames[-1] + 1) if stream else frames:
            gbuf, pack = ctl.draw(scene, f, size, RENDER_MODE_NORMAL, bg)
            key = frame_key(seed, f, device)
            if stream:
                if f in capture:
                    states[f] = (f, state, kv)
                images, state, kv = ctl.render_stream(
                    pack["color"][None], pack["noise"][None], pack["id"][None], state, key,
                    ctx, nctx, kv, corr, stream_init=f == 0)
            else:
                images = ctl.render(corr, pack["color"][None], pack["noise"][None],
                                    pack["id"][None], ctx, nctx, key, y_cond, y_uncond,
                                    normal_maps=pack["normal"][None])
            if f in frames:
                out[f] = ctl.display(gbuf, images).cpu().numpy()
    return out, states


def control_checks(config: dict, traffic: dict, seed: int, device, window: Iterable[int]
                   ) -> Dict[str, float]:
    """The benchmark's numbers for the control in the program's place: its
    start frames and the ``window`` frames, judged by the reference (which
    follows the control's own stream state into each window frame)."""
    from benchmark.harness.compare import frame_checks
    from benchmark.harness.weights import make_weights
    from benchmark.reference import replay

    window = sorted(window)
    start = list(range(int(traffic["check_start_frames"])))
    lag = int(traffic["render"]["steps"]) if traffic["render"].get("stream") else 0
    lag = int(traffic.get("check_follow_frames", lag))
    weights = make_weights(config, seed, device)
    got, states = control_frames(config, weights, traffic, seed, device, start + window,
                                 [f - lag for f in window])
    want = replay.frames(config, weights, traffic, seed, device, start,
                         {f: states.get(f - lag) for f in window})
    return frame_checks(got, want, start, window)
