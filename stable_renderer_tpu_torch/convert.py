"""Turn a JAX parameter tree (as numpy arrays) into the port's tree.

The two packages share the checkpoint layout (Linear (out, in), Conv
(O, I, kH, kW), the same nested key names), so conversion is leaf by leaf with
no renaming: ``params_from_numpy`` carries any tree across (the UNet, the
towers, the CLIP vision tower, the style adapter, PhotoMaker's projections
and FuseModule). ``gligen_from_numpy`` rebuilds a GLIGEN patch, whose
fusers and PositionNet are trees held by an object. ``train_state_from_numpy``
carries a training state (params, optax's AdamW state, step) across.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stable_renderer_tpu_torch.device import resolve_device


# int8 conv leaves (models/quant.py): their dequantization scales stay f32
_F32_KEYS = ("w_scale", "a_scale")


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Nested dict of array-likes -> the same dict of tensors on ``device``
    (default: the card). Floating leaves are cast to ``dtype`` when given,
    except the int8 leaves' f32 scales (``w_scale``, ``a_scale``); integer
    leaves keep their type."""
    return _convert(tree, resolve_device(device), dtype)


def _convert(tree, device: torch.device, dtype: Optional[torch.dtype]):
    if isinstance(tree, dict):
        return {k: _convert(v, device, None if k in _F32_KEYS else dtype)
                for k, v in tree.items()}
    if tree is None:
        return None
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch view
        arr = arr.astype(np.float32)
    t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def gligen_from_numpy(fusers, fuser_heads, position_net, key_dim: int, device=None,
                      dtype: Optional[torch.dtype] = None):
    """A JAX ``Gligen``'s parts (its fuser trees by transformer index, their
    head counts, the PositionNet tree and the key width) -> the port's
    ``Gligen`` on ``device`` (default: the card)."""
    from stable_renderer_tpu_torch.models.gligen import Gligen

    return Gligen([params_from_numpy(f, device, dtype) for f in fusers],
                  [int(h) for h in fuser_heads], params_from_numpy(position_net, device, dtype),
                  int(key_dim))


def train_state_from_numpy(state, device=None):
    """A JAX ``TrainState`` (``parallel/train.py``) as numpy leaves -> the
    port's: the params by ``params_from_numpy``, optax's AdamW state
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())`` as
    ``AdamWState(count, mu, nu)``, the step as an int. A JAX run can then
    continue in the port (``diffusion_train_step``)."""
    from stable_renderer_tpu_torch.parallel.train import AdamWState, TrainState

    params, opt_state, step = state
    adam, *empty = opt_state
    if any(len(e) for e in empty) or not {"count", "mu", "nu"} <= set(adam._fields):
        raise ValueError("want optax.adamw's state: (ScaleByAdamState, EmptyState(), "
                         "EmptyState())")
    dev = resolve_device(device)
    return TrainState(_convert(params, dev, None),
                      AdamWState(int(np.asarray(adam.count)), _convert(adam.mu, dev, None),
                                 _convert(adam.nu, dev, None)),
                      int(np.asarray(step)))
