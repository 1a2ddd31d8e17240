"""Random weights for a configuration, made on the device from the seed.

The trees have the checkpoint layout and the shapes of the reference's
towers (their ``init`` run on the ``meta`` device gives the layout), and are
drawn in one ``torch.randn`` call a tower, in the type the tower is served
in: fan-in scaled normals for the UNet and the VAE, N(0, 0.02^2) for the
text towers (OpenCLIP's positional table N(0, 0.01^2)), zero biases and unit
norm scales, the scales of the port's own ``init``. Every leaf is a view of
its tower's one buffer. The same trees go to the program and the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _leaves(tree, path=()) -> List[Tuple[tuple, torch.Size]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leaves(v, path + (k,))
        return out
    return [(path, tree.shape)]


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _std(path: tuple, shape, text: bool) -> float:
    """0 for zeros, -1 for ones, else the normal's standard deviation."""
    name = path[-1]
    if name.endswith("bias"):
        return 0.0
    if len(shape) == 1:
        return -1.0
    if text:
        return 0.01 if name == "positional_embedding" else 0.02
    return 1.0 / math.sqrt(math.prod(shape[1:]))


def draw_tree(init_fn, text: bool, generator: torch.Generator, dtype, device) -> dict:
    """``init_fn(device="meta")`` gives the layout; one draw fills it."""
    meta = init_fn()
    leaves = _leaves(meta)
    total = sum(math.prod(s) for p, s in leaves if _std(p, s, text) > 0)
    buf = torch.randn((total,), generator=generator, device=device, dtype=dtype)
    tree: dict = {}
    at = 0
    for path, shape in leaves:
        std = _std(path, shape, text)
        if std == 0.0:
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        elif std < 0:
            leaf = torch.ones(shape, dtype=dtype, device=device)
        else:
            n = math.prod(shape)
            leaf = buf[at:at + n].view(shape).mul_(std)
            at += n
        _set(tree, path, leaf)
    return tree


def make_weights(config: dict, seed: int, device) -> Dict[str, dict]:
    """{"unet", "vae", "clip"[, "clip_g"]} trees for ``config`` (a
    configuration file's dict) from ``seed``, in the file's types."""
    from benchmark.reference.programs import build_towers

    t = build_towers(config)
    types = config["types"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, text in (("unet", False), ("vae", False), ("clip", True), ("clip_g", True)):
        tower = t.get(name)
        if tower is None:
            continue
        dtype = DTYPES[types["unet" if name == "unet" else ("vae" if name == "vae" else "clip")]]
        out[name] = draw_tree(lambda tw=tower: tw.init(device="meta"), text, gen, dtype, device)
    return out
