"""LoRA loading and weight merging (incl. LCM-LoRA).

Counterpart of stable_renderer_tpu/models/lora.py (reference: comfy/lora.py
model_lora_keys_unet / clip + load_lora, comfy/model_patcher.py weight
patches; BASELINE's realtime config merges an LCM LoRA into dreamshaper_8).
LoRAs merge into the param tree once, at load: merged weights cost nothing
at inference.

Key formats: comfy / kohya ``lora_unet_{path_with_underscores}.lora_up.weight``
/ ``.lora_down.weight`` / ``.alpha`` and ``lora_te_*`` for the text encoder;
diffusers-style ``{name}.lora.up.weight`` suffixes group the same way. The
module names are matched against the tree's own (LDM) names with dots turned
to underscores, as the JAX package does: a file named in diffusers' module
names (``lora_unet_down_blocks_0_attentions_0_...``) matches nothing and is
skipped, module by module, with a log line (ROADMAP queue 3).

The merge is the JAX package's arithmetic, in numpy on the host so that the
bits match: ``W + strength * (alpha / rank) * up @ down`` in f32, cast to the
weight's own dtype (the file's; the pipeline casts afterwards).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from stable_renderer_tpu_torch.models.weights import flatten, nest
from stable_renderer_tpu_torch.utils.log import get_logger

logger = get_logger("sr_tpu.lora")


def _target_lookup(params: dict) -> Dict[str, str]:
    """{dotted_path_with_underscores: dotted_path} for every weight leaf."""
    out = {}
    for path in flatten(params):
        if path.endswith(".weight"):
            base = path[: -len(".weight")]
            out[base.replace(".", "_")] = base
    return out


def parse_lora(flat: Mapping[str, Any], prefix: str) -> Dict[str, dict]:
    """Group lora tensors by target module name (without the lora prefix)."""
    groups: Dict[str, dict] = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        rest = key[len(prefix):]
        for marker, slot in (
            (".lora_up.weight", "up"),
            (".lora_down.weight", "down"),
            (".lora.up.weight", "up"),
            (".lora.down.weight", "down"),
            (".alpha", "alpha"),
        ):
            if rest.endswith(marker):
                groups.setdefault(rest[: -len(marker)], {})[slot] = value
                break
    return groups


def _f32(t) -> np.ndarray:
    """A tensor or array as a host f32 numpy array, exact for f16 and bf16
    (numpy converts halves many times faster than torch's CPU cast; a bf16
    word is the upper half of its f32)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t, np.float32)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return (t.view(torch.int16).numpy().astype(np.int32) << 16).view(np.float32)
    return t.numpy().astype(np.float32, copy=False)


def merge_lora(params: dict, lora_flat: Mapping[str, Any], strength: float = 1.0,
               prefix: str = "lora_unet_") -> Tuple[dict, int]:
    """(params with ``W += strength * (alpha/rank) * up @ down`` merged in,
    the number of modules applied). Unmatched lora modules are logged and
    skipped (comfy load_lora). The JAX package's ``merge_lora`` returns the
    tree alone and logs the count."""
    lookup = _target_lookup(params)
    groups = parse_lora(lora_flat, prefix)
    flat_params = flatten(params)
    merged = dict(flat_params)
    n_applied = 0
    for name, g in groups.items():
        if "up" not in g or "down" not in g:
            continue
        target = lookup.get(name)
        if target is None:
            logger.debug(f"lora key {name} has no matching weight; skipped")
            continue
        orig = flat_params[target + ".weight"]
        w = _f32(orig)
        up, down = _f32(g["up"]), _f32(g["down"])
        rank = down.shape[0]
        alpha = float(_f32(g["alpha"])) if "alpha" in g else float(rank)
        scale = strength * alpha / rank
        if w.ndim == 4:  # conv: (O, I, kh, kw)
            delta = (up.reshape(up.shape[0], -1) @ down.reshape(down.shape[0], -1)).reshape(w.shape)
        else:
            delta = up @ down
        # w + scale * delta, in place (f32 adds commute bit for bit)
        out = np.add(np.multiply(delta, scale, out=delta), w, out=delta)
        if isinstance(orig, torch.Tensor):
            merged[target + ".weight"] = torch.from_numpy(out).to(device=orig.device,
                                                                  dtype=orig.dtype)
        else:
            merged[target + ".weight"] = out.astype(orig.dtype)
        n_applied += 1
    logger.info(f"merged LoRA: {n_applied}/{len(groups)} modules applied (strength={strength})")
    return nest(merged, ""), n_applied
