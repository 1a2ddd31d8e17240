"""k-diffusion samplers as a host loop over sigmas.

Counterpart of stable_renderer_tpu/models/sampling/samplers.py (reference
comfy/k_diffusion/sampling.py). The JAX package runs the loop as one
``lax.scan``; here it is a Python loop with the sigmas on the host, so the
per-step branches cost no device round trip. Ported so far: ``euler`` and
``lcm``.

``denoise_model`` is (x, sigma) -> denoised (x0 space), built by
cfg.make_denoiser; ``step_callback`` is the Corresponder.step_finished hook,
(x, denoised, sigma, i) -> x.

Re-noise draws (lcm) come from ``generator``, or from ``step_noise``: an
explicit list of one tensor per step, which lets a test hand in the draws the
JAX package made.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

SAMPLER_NAMES = ["euler", "lcm"]


def sample(
    denoise_model: Callable,
    noise: torch.Tensor,                          # (B, h, w, C) unit-variance noise
    sigmas: torch.Tensor,                         # (steps+1,) descending, ends at 0
    latent_image: Optional[torch.Tensor] = None,  # img2img init latent
    sampler: str = "euler",
    generator: Optional[torch.Generator] = None,
    step_callback: Optional[Callable] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Run the denoise loop; returns the final latent. x0 = latent +
    noise * sigma_max (comfy.sample.sample)."""
    if sampler not in SAMPLER_NAMES:
        raise NotImplementedError(f"sampler {sampler!r} is not ported yet (have {SAMPLER_NAMES})")
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32).cpu()
    n_steps = sigmas.shape[0] - 1
    if step_noise is not None and len(step_noise) < n_steps:
        raise ValueError(f"step_noise holds {len(step_noise)} draws for {n_steps} steps")
    x = noise * sigmas[0]
    if latent_image is not None:
        x = x + latent_image
    for i in range(n_steps):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        denoised = denoise_model(x, sigma)
        if sampler == "euler":
            d = (x - denoised) / torch.clamp(sigma, min=1e-8)
            x_new = x + d * (sigma_next - sigma)
        else:  # lcm: jump to x0, re-noise to the next sigma
            if step_noise is not None:
                fresh = step_noise[i].to(device=x.device, dtype=x.dtype)
            else:  # drawn every step, as the JAX scan does, so streams line up
                fresh = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
            x_new = denoised + sigma_next * fresh if sigma_next > 0 else denoised
        if step_callback is not None:
            x_new = step_callback(x_new, denoised, sigma, i)
        x = x_new
    return x
