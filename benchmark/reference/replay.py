"""The reference's presented frames for the frames a run checks."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from benchmark.reference.plain.ops.gbuffer import RENDER_MODE_NORMAL
from benchmark.reference.programs import (
    Reference,
    bg_noise,
    frame_key,
    make_corresponder,
)
from benchmark.reference.scene import prompt_text


def frames(config: dict, weights: dict, traffic: dict, seed: int, device,
           start: Iterable[int], window: Dict[int, Optional[tuple]]) -> Dict[int, object]:
    """{frame index: (H, W, 4) uint8 numpy} of the realtime cell's frames:
    ``start`` replayed from frame 0 with the reference's own stream state,
    and each frame ``f`` of ``window`` from the (frame ``g``, state, kv)
    given for it: the program's stream state entering frame ``g`` = ``f``
    less the stream's depth, from which the reference runs frames ``g`` ..
    ``f`` with its own state (None for the sequential program, whose frames
    stand alone)."""
    render = dict(traffic["render"], size=traffic["size"])
    size = tuple(traffic["size"])
    scene = traffic["scene"]
    stream = bool(render.get("stream"))
    ref = Reference(config, weights, render, device)
    if render.get("int8_conv"):
        ref.quantize_convs(size)
    text = prompt_text(scene, render.get("prompt", ""))
    ctx, nctx, y_cond, y_uncond = ref.conditioning(text, 1, size)
    bg = bg_noise(size, device)
    corr = make_corresponder(traffic["corresponder"])
    out: Dict[int, object] = {}

    def one(f: int, state=None, kv=None, init=False):
        gbuf, pack = ref.draw(scene, f, size, RENDER_MODE_NORMAL, bg)
        key = frame_key(seed, f, device)
        if stream:
            images, state, kv = ref.render_stream(
                pack["color"][None], pack["noise"][None], pack["id"][None], state, key, ctx,
                nctx, kv, corr, stream_init=init)
        else:
            images = ref.render(corr, pack["color"][None], pack["noise"][None],
                                pack["id"][None], ctx, nctx, key, y_cond, y_uncond,
                                normal_maps=pack["normal"][None])
        return ref.display(gbuf, images).cpu().numpy(), state, kv

    start = sorted(start)
    with torch.no_grad():
        state = kv = None
        for f in range(start[-1] + 1 if start else 0):
            img, state, kv = one(f, state, kv, init=f == 0) if stream else one(f)
            if f in start:
                out[f] = img
        state = kv = None
        for f, carried in sorted(window.items()):
            if stream:
                g, state, kv = carried
                for i in range(g, f + 1):
                    img, state, kv = one(i, state, kv, init=state is None)
                out[f] = img
            else:
                out[f] = one(f)[0]
    return out
