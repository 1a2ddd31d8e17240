"""Where the port's entry points put their tensors.

Entry points run on the card: a ``device`` left as ``None`` means the first
CUDA device, and raises where there is none. Running on the CPU is asked for
by name (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
