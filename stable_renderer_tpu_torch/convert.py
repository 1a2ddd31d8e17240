"""Turn a JAX parameter tree (as numpy arrays) into the port's tree.

The two packages share the checkpoint layout (Linear (out, in), Conv
(O, I, kH, kW), the same nested key names), so conversion is leaf by leaf with
no renaming.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def params_from_numpy(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """Nested dict of array-likes -> the same dict of tensors on ``device``.
    Floating leaves are cast to ``dtype`` when given; integer leaves keep
    their type."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if tree is None:
        return None
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch view
        arr = arr.astype(np.float32)
    t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
