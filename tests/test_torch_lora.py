"""The port's LoRA merge (models/lora.py) against the JAX package's, on the
CPU. The merge is numpy arithmetic in both packages, so the merged leaves
must match bit for bit, at every leaf dtype.
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RANK = 4


def _params(dtype) -> dict:
    """A small tree with linear, 1x1-projection and 3x3-conv leaves, in LDM
    names, as numpy arrays of ``dtype``."""
    rng = np.random.default_rng(0)

    def a(*shape):
        return np.asarray(rng.standard_normal(shape), dtype)

    return {
        "input_blocks": {"1": {"1": {
            "proj_in": {"weight": a(24, 24), "bias": a(24)},
            "transformer_blocks": {"0": {"attn1": {"to_q": {"weight": a(24, 24)},
                                                   "to_out": {"0": {"weight": a(24, 24)}}}}},
        }}},
        "out": {"2": {"weight": a(4, 24, 3, 3), "bias": a(4)}},
    }


def _lora(alpha, file_dtype=np.float16, names=None) -> dict:
    """A kohya-style file over the tree's three weights: up (out, rank),
    down (rank, in), a conv's down (rank, in, 3, 3) and up (out, rank, 1, 1)."""
    rng = np.random.default_rng(1)
    names = names or {
        "input_blocks_1_1_proj_in": ((24, RANK), (RANK, 24)),
        "input_blocks_1_1_transformer_blocks_0_attn1_to_q": ((24, RANK), (RANK, 24)),
        "out_2": ((4, RANK, 1, 1), (RANK, 24, 3, 3)),
        "no_such_module": ((4, RANK), (RANK, 4)),
    }
    flat = {}
    for name, (up, down) in names.items():
        flat[f"lora_unet_{name}.lora_up.weight"] = np.asarray(
            rng.standard_normal(up) * 0.1, file_dtype)
        flat[f"lora_unet_{name}.lora_down.weight"] = np.asarray(
            rng.standard_normal(down) * 0.1, file_dtype)
        if alpha is not None:
            flat[f"lora_unet_{name}.alpha"] = np.asarray(alpha, file_dtype)
    return flat


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    else:
        x = np.asarray(x)
        x = x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x
    return x.tobytes()


@pytest.mark.parametrize("leaf_dtype", ["float16", "float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [None, 8.0])
def test_merge_lora_matches_jax_bit_for_bit(leaf_dtype, alpha):
    """Linear, projection and conv LoRAs, with and without ``alpha``, at
    strength 0.7: every merged leaf equals JAX's bit for bit and keeps its
    dtype; unmerged leaves are untouched; the module with no target is
    skipped."""
    from stable_renderer_tpu.models.lora import merge_lora as j_merge
    from stable_renderer_tpu.models.weights import flatten as j_flatten

    from stable_renderer_tpu_torch.models.lora import merge_lora
    from stable_renderer_tpu_torch.models.weights import flatten

    dt = ml_dtypes.bfloat16 if leaf_dtype == "bfloat16" else np.dtype(leaf_dtype)
    params, lora = _params(dt), _lora(alpha)
    ref = j_flatten(j_merge(params, lora, 0.7))
    out, n = merge_lora(_torch(params), _torch(lora), 0.7)
    out = flatten(out)
    assert n == 3 and sorted(out) == sorted(ref)
    before = j_flatten(params)
    for k, v in out.items():
        assert v.dtype == _torch(before[k]).dtype, k
        assert _bits(v) == _bits(ref[k]), k
        moved = k.endswith("weight") and "to_out" not in k
        assert (_bits(v) != _bits(before[k])) == moved, k


def test_diffusers_named_lora_applies_nothing_in_either_package():
    """A kohya file named in diffusers' module names (as the public LCM-LoRA
    for SD1.5 is) matches none of the LDM-named weights: both packages apply
    0 modules and leave every leaf as it was (ROADMAP queue 3 keeps this
    property of the JAX package)."""
    from stable_renderer_tpu.models.lora import merge_lora as j_merge
    from stable_renderer_tpu.models.weights import flatten as j_flatten

    from stable_renderer_tpu_torch.models.lora import merge_lora
    from stable_renderer_tpu_torch.models.weights import flatten

    params = _params(np.float32)
    names = {"down_blocks_0_attentions_0_proj_in": ((24, RANK), (RANK, 24)),
             "down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q": ((24, RANK),
                                                                           (RANK, 24)),
             "conv_out": ((4, RANK, 1, 1), (RANK, 24, 3, 3))}
    lora = _lora(4.0, names=names)
    ref = j_flatten(j_merge(params, lora, 1.0))
    out, n = merge_lora(_torch(params), _torch(lora), 1.0)
    assert n == 0
    before = j_flatten(params)
    for k, v in flatten(out).items():
        assert _bits(v) == _bits(ref[k]) == _bits(before[k]), k
