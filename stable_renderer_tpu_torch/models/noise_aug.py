"""CLIP-embedding noise augmentation for unCLIP (SD2.1-unclip) checkpoints,
and the SD x4 upscaler's image augmentation.

Counterpart of stable_renderer_tpu/models/noise_aug.py (reference
comfy/ldm/modules/encoders/noise_aug_modules.py
CLIPEmbeddingNoiseAugmentation, diffusionmodules/upscaling.py
AbstractLowScaleModel.q_sample, comfy/model_base.py:271-295 unclip_adm): the
CLIP-vision image embedding is diffused forward to a chosen noise level with
the squaredcos_cap_v2 schedule, and the ADM vector fed to the UNet's
label_emb is ``concat([noised_embed, timestep_emb(level)])``. The shipped
SD21UnclipL/H configs set no CLIP data statistics, so scale and unscale are
the identity, as in the JAX package.

The schedules are float64 numpy, equal to the JAX package's bit for bit.
Randomness is passed in: each draw takes a ``torch.Generator`` or a noise
tensor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from stable_renderer_tpu_torch.models.layers import timestep_embedding


def betas_squaredcos_cap_v2(timesteps: int = 1000, max_beta: float = 0.999) -> np.ndarray:
    """The squaredcos_cap_v2 beta schedule (ldm make_beta_schedule):
    beta_t = min(1 - alpha_bar((t+1)/T) / alpha_bar(t/T), max_beta) with
    alpha_bar(u) = cos^2((u + 0.008) / 1.008 * pi/2)."""

    def alpha_bar(u: float) -> float:
        return float(np.cos((u + 0.008) / 1.008 * np.pi / 2) ** 2)

    betas = [min(1.0 - alpha_bar((i + 1) / timesteps) / alpha_bar(i / timesteps), max_beta)
             for i in range(timesteps)]
    return np.asarray(betas, np.float64)


def betas_linear(timesteps: int = 1000, linear_start: float = 1e-4,
                 linear_end: float = 2e-2) -> np.ndarray:
    """The ldm "linear" schedule (sqrt-space linspace, make_beta_schedule)."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps, dtype=np.float64) ** 2


@dataclasses.dataclass(frozen=True)
class NoiseAugmentor:
    """q_sample over an embedding vector + a timestep embedding of the level.

    ``timestep_dim`` is the embedding width D (768 for SD21UnclipL, 1024 for
    SD21UnclipH); the ADM vector is 2*D wide. ``schedule``:
    "squaredcos_cap_v2" (unCLIP) or "linear" (SD_X4Upscaler's
    ImageConcatWithNoiseAugmentation, model_base.py:452: max_noise_level 350
    over a 1000-step table).
    """

    timestep_dim: int
    max_noise_level: int = 1000
    schedule: str = "squaredcos_cap_v2"
    num_timesteps: int = 1000
    linear_start: float = 1e-4
    linear_end: float = 2e-2

    def _alphas_cumprod(self) -> np.ndarray:
        if self.schedule == "linear":
            betas = betas_linear(self.num_timesteps, self.linear_start, self.linear_end)
        else:
            betas = betas_squaredcos_cap_v2(self.num_timesteps)
        return np.cumprod(1.0 - betas)

    @property
    def sqrt_alphas_cumprod(self) -> np.ndarray:
        return np.sqrt(self._alphas_cumprod()).astype(np.float32)

    @property
    def sqrt_one_minus_alphas_cumprod(self) -> np.ndarray:
        return np.sqrt(1.0 - self._alphas_cumprod()).astype(np.float32)

    def q_sample(self, x: torch.Tensor, noise_level: int,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Forward-diffuse ``x`` to ``noise_level`` (upscaling.py:44-52):
        sqrt(ac[t]) x + sqrt(1 - ac[t]) noise, the noise passed in or drawn
        from ``generator`` in x's shape and dtype."""
        t = int(np.clip(noise_level, 0, self.num_timesteps - 1))
        a = float(self.sqrt_alphas_cumprod[t])
        s = float(self.sqrt_one_minus_alphas_cumprod[t])
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        return a * x + s * noise.to(device=x.device, dtype=x.dtype)

    def augment(self, embed: torch.Tensor, noise_level: int,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, D) embed -> (noised (B, D), the level's timestep embedding
        (B, D)): CLIPEmbeddingNoiseAugmentation.forward with identity data
        statistics."""
        embed = torch.as_tensor(embed).float()
        if embed.dim() == 1:
            embed = embed[None]
        t = int(np.clip(noise_level, 0, self.max_noise_level - 1))
        z = self.q_sample(embed, t, generator, noise)
        lvl = torch.full((embed.shape[0],), float(t), dtype=torch.float32, device=embed.device)
        return z, timestep_embedding(lvl, self.timestep_dim)


def unclip_adm(entries: List[dict], augmentor: NoiseAugmentor,
               generator: Optional[torch.Generator] = None,
               noise_augment_merge: float = 0.05,
               noise: Optional[Sequence[torch.Tensor]] = None) -> Optional[torch.Tensor]:
    """Fold unCLIPConditioning entries into the (1, 2*D) ADM vector
    (model_base.py unclip_adm): each entry's image embeds are
    noise-augmented at round((max - 1) * noise_augmentation), weighted by
    ``strength`` and summed; with more than one row the merged embedding
    (its first D columns) is re-augmented at ``noise_augment_merge``.

    The draws come in order: one (1, D) draw a row, then the merge's. They
    are ``noise[i]`` when ``noise`` is given (the JAX package draws row i
    from ``fold_in(key, i)`` and the merge from ``fold_in(key, 10_000)``),
    else from ``generator``."""
    if not entries:
        return None
    draws = iter(noise) if noise is not None else None

    def draw():
        return next(draws) if draws is not None else None

    rows = []
    for e in entries:
        embeds = torch.as_tensor(e["embeds"]).float()
        if embeds.dim() == 1:
            embeds = embeds[None]
        strength = float(e.get("strength", 1.0))
        level = int(round((augmentor.max_noise_level - 1) * float(e.get("noise_augmentation",
                                                                        0.0))))
        for row in range(embeds.shape[0]):
            z, lvl_emb = augmentor.augment(embeds[row: row + 1], level, generator, draw())
            rows.append(torch.cat([z, lvl_emb], dim=1) * strength)
    if len(rows) > 1:
        merged = torch.stack(rows).sum(0)
        level = int(round((augmentor.max_noise_level - 1) * noise_augment_merge))
        z, lvl_emb = augmentor.augment(merged[:, : augmentor.timestep_dim], level, generator,
                                       draw())
        return torch.cat([z, lvl_emb], dim=1)
    return rows[0]
