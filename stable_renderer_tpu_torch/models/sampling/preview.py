"""Sampling progress and latent previews.

Counterpart of stable_renderer_tpu/models/sampling/preview.py (the
reference's comfy/utils.py ProgressBar and latent_preview.py's
Latent2RGBPreviewer). ``latent2rgb`` turns an SD1.5 latent into an
approximate RGB preview with the standard linear factors.
``progress_step_callback`` wraps a sampler step callback so that the host
hears of every step: the JAX package sends it out of its compiled loop with
an ordered ``io_callback``; the port's sampler loop runs on the host, so the
report is a direct call. A preview copies the step's RGB to the host, which
waits for the card: it runs only when a caller asks for progress.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import numpy as np
import torch

# SD1.5 latent -> RGB linear factors (latent_preview.py)
SD15_LATENT_RGB = np.asarray(
    [
        [0.3512, 0.2297, 0.3227],
        [0.3250, 0.4974, 0.2350],
        [-0.2829, 0.1762, 0.2721],
        [-0.2120, -0.2616, -0.7177],
    ],
    np.float32,
)


def latent2rgb(latent: torch.Tensor, factors=SD15_LATENT_RGB) -> torch.Tensor:
    """(..., h, w, 4) latent -> (..., h, w, 3) approximate RGB in [0, 1]."""
    f = torch.as_tensor(factors, dtype=torch.float32, device=latent.device)
    return torch.clamp((latent.float() @ f + 1.0) / 2.0, 0.0, 1.0)


def progress_step_callback(
    on_step: Callable,
    total_steps: int,
    preview: bool = True,
    inner: Optional[Callable] = None,
) -> Callable:
    """A sampler step callback that reports progress to the host:
    ``on_step(step_index, total, preview_rgb_or_None)`` once a step, the
    preview as a numpy array. ``inner`` (e.g. the corresponder's callback)
    runs first, then the report."""

    def cb(x, denoised, sigma, i):
        if inner is not None:
            x = inner(x, denoised, sigma, i)
        rgb = latent2rgb(denoised).cpu().numpy() if preview else None
        on_step(int(i), total_steps, rgb)
        return x

    return cb


class ConsoleProgress:
    """Minimal tqdm-style console progress sink."""

    def __init__(self, label: str = "sampling"):
        self.label = label

    def __call__(self, step: int, total: int, preview) -> None:
        pct = int(100 * (step + 1) / max(total, 1))
        sys.stderr.write(f"\r{self.label}: {step + 1}/{total} [{pct:3d}%]")
        if step + 1 >= total:
            sys.stderr.write("\n")
        sys.stderr.flush()
