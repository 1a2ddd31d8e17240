"""Where the port's entry points put their tensors.

Entry points run on the card: a ``device`` left as ``None`` means the first
CUDA device, and raises where there is none. Running on the CPU is asked for
by name (``device="cpu"``), as the tests do.

f32 stays f32: the card entry points (``DiffusionPipeline`` construction,
``Engine`` construction, ``bench_torch.main``) call ``keep_f32``, which turns
off TF32 for matmuls and cuDNN convolutions. torch's default runs f32 convs
on the card as TF32 (about three decimal digits), which the JAX package's
f32 towers (the loaded VAE, the ControlNet hint towers) never do.
"""

from __future__ import annotations

import contextlib

import torch


def keep_f32() -> None:
    """Turn off TF32 for f32 matmuls and cuDNN convolutions (process-wide
    switches; torch's card default for convolutions is on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_switches() -> str:
    """The two TF32 switches, as the card entry points print them."""
    return (f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
            f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def on_device(device: torch.device):
    """A CUDA device's context for a kernel launch, entered only when the
    device is not already current (entering one costs the host time on every
    call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` without a host sync: a blocking copy from
    pageable memory waits for all the stream's earlier work, so a CUDA
    target gets a pinned copy sent with ``non_blocking`` (the pinned block
    is not reused before the copy has run)."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
