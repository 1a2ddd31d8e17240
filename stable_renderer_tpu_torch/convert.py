"""Turn a JAX parameter tree (as numpy arrays) into the port's tree.

The two packages share the checkpoint layout (Linear (out, in), Conv
(O, I, kH, kW), the same nested key names), so conversion is leaf by leaf with
no renaming.
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
