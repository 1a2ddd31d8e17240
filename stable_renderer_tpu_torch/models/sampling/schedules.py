"""Noise schedule and sigma <-> timestep mapping for the SD model family.

Counterpart of stable_renderer_tpu/models/sampling/schedules.py (reference
comfy/model_sampling.py ModelSamplingDiscrete, comfy/samplers.py
calculate_sigmas). Schedules are tiny host numpy arrays, computed once per
(scheduler, steps, denoise). Ported so far: the ``sgm_uniform`` scheduler.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SCHEDULER_NAMES = ["sgm_uniform"]


@dataclass
class ModelSampling:
    """Discrete eps-prediction schedule (ModelSamplingDiscrete semantics).

    SD1.5: linear-sqrt betas 0.00085 -> 0.012 over 1000 steps;
    sigma_t = sqrt((1 - abar_t) / abar_t)."""

    beta_start: float = 0.00085
    beta_end: float = 0.012
    num_timesteps: int = 1000
    prediction: str = "eps"  # 'eps' | 'v' | 'lcm'
    sigma_data: float = 0.5
    timestep_scaling: float = 10.0
    sigmas: np.ndarray = field(init=False)
    log_sigmas: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5, self.num_timesteps,
                            dtype=np.float64) ** 2
        alphas_cumprod = np.cumprod(1.0 - betas)
        self.sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod).astype(np.float32)
        self.log_sigmas = np.log(self.sigmas)

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    def timestep(self, sigma: np.ndarray) -> np.ndarray:
        """sigma -> NEAREST table timestep (model_sampling.py:125-128)."""
        log_sigma = np.log(np.maximum(sigma, 1e-10))
        return np.abs(log_sigma[..., None] - self.log_sigmas[None]).argmin(-1).astype(np.float32)

    def sigma(self, timestep: np.ndarray) -> np.ndarray:
        t = np.clip(timestep, 0, self.num_timesteps - 1)
        low_idx = np.floor(t).astype(np.int64)
        high_idx = np.ceil(t).astype(np.int64)
        w = t - low_idx
        return np.exp((1 - w) * self.log_sigmas[low_idx]
                      + w * self.log_sigmas[high_idx]).astype(np.float32)


def _sigmas_sgm_uniform(ms: ModelSampling, n: int) -> np.ndarray:
    start = ms.timestep(np.asarray(ms.sigma_max))
    end = ms.timestep(np.asarray(ms.sigma_min))
    ts = np.linspace(start, end, n + 1, dtype=np.float64)[:-1]
    return np.asarray([float(ms.sigma(np.asarray(t))) for t in ts] + [0.0], np.float32)


def calculate_sigmas(ms: ModelSampling, scheduler: str, steps: int,
                     denoise: float = 1.0) -> np.ndarray:
    """(steps+1,) descending sigma schedule ending in 0. ``denoise < 1``
    keeps the tail of a longer schedule (img2img from a mid-noise level)."""
    if denoise <= 0:
        raise ValueError("denoise must be in (0, 1]")
    if denoise < 1.0 - 1e-6:
        return calculate_sigmas(ms, scheduler, int(steps / denoise), 1.0)[-(steps + 1):]
    if scheduler == "sgm_uniform":
        return _sigmas_sgm_uniform(ms, steps)
    raise NotImplementedError(f"scheduler {scheduler!r} is not ported yet (have {SCHEDULER_NAMES})")
