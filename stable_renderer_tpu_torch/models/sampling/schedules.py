"""Noise schedule and sigma <-> timestep mapping for the SD model family.

Counterpart of stable_renderer_tpu/models/sampling/schedules.py (reference
comfy/model_sampling.py ModelSamplingDiscrete, comfy/samplers.py
calculate_sigmas and its karras / exponential / sgm_uniform / simple /
ddim_uniform schedules, comfy/k_diffusion/sampling.py get_sigmas_*).
Schedules are tiny host numpy arrays, computed once per (scheduler, steps,
denoise), in both packages, so they agree to float32 rounding.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SCHEDULER_NAMES = [
    "normal",
    "karras",
    "exponential",
    "sgm_uniform",
    "simple",
    "ddim_uniform",
]


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


def sigmas_karras(n: int, sigma_min: float, sigma_max: float, rho: float = 7.0) -> np.ndarray:
    """The Karras ramp between explicit sigma bounds (KarrasScheduler)."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def sigmas_exponential(n: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    sigmas = np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), n))
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def sigmas_polyexponential(n: int, sigma_min: float, sigma_max: float,
                           rho: float = 1.0) -> np.ndarray:
    """k_diffusion get_sigmas_polyexponential: a polynomial ramp in log sigma."""
    ramp = np.linspace(1, 0, n, dtype=np.float64) ** rho
    sigmas = np.exp(ramp * (np.log(sigma_max) - np.log(sigma_min)) + np.log(sigma_min))
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def sigmas_vp(n: int, beta_d: float = 19.9, beta_min: float = 0.1,
              eps_s: float = 1e-3) -> np.ndarray:
    """k_diffusion get_sigmas_vp: the continuous VP-SDE schedule."""
    t = np.linspace(1, eps_s, n, dtype=np.float64)
    sigmas = np.sqrt(np.exp(beta_d * t ** 2 / 2 + beta_min * t) - 1)
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def sigmas_sd_turbo(ms: ModelSampling, steps: int, denoise: float = 1.0) -> np.ndarray:
    """SDTurboScheduler: 1-10 steps on fixed high timesteps."""
    start_step = 10 - int(10 * denoise)
    timesteps = np.flip(np.arange(1, 11) * 100 - 1)[start_step:start_step + steps]
    sigs = ms.sigma(timesteps.astype(np.float32))
    return np.concatenate([sigs, [0.0]]).astype(np.float32)


def _sigmas_normal(ms: ModelSampling, n: int) -> np.ndarray:
    start = ms.timestep(np.asarray(ms.sigma_max))
    end = ms.timestep(np.asarray(ms.sigma_min))
    ts = np.linspace(start, end, n, dtype=np.float64)
    return np.asarray([float(ms.sigma(np.asarray(t))) for t in ts] + [0.0], np.float32)


def _sigmas_sgm_uniform(ms: ModelSampling, n: int) -> np.ndarray:
    start = ms.timestep(np.asarray(ms.sigma_max))
    end = ms.timestep(np.asarray(ms.sigma_min))
    ts = np.linspace(start, end, n + 1, dtype=np.float64)[:-1]
    return np.asarray([float(ms.sigma(np.asarray(t))) for t in ts] + [0.0], np.float32)


def _sigmas_simple(ms: ModelSampling, n: int) -> np.ndarray:
    ss = len(ms.sigmas) / n
    sigs = [float(ms.sigmas[-(1 + int(x * ss))]) for x in range(n)]
    return np.asarray(sigs + [0.0], np.float32)


def _sigmas_ddim_uniform(ms: ModelSampling, n: int) -> np.ndarray:
    ss = max(len(ms.sigmas) // n, 1)
    sigs = [float(ms.sigmas[x]) for x in range(1, len(ms.sigmas), ss)][-n:]
    return np.asarray(sigs[::-1] + [0.0], np.float32)


def calculate_sigmas(ms: ModelSampling, scheduler: str, steps: int,
                     denoise: float = 1.0) -> np.ndarray:
    """(steps+1,) descending sigma schedule ending in 0. ``denoise < 1``
    keeps the tail of a longer schedule (img2img from a mid-noise level)."""
    if denoise <= 0:
        raise ValueError("denoise must be in (0, 1]")
    if denoise < 1.0 - 1e-6:
        return calculate_sigmas(ms, scheduler, int(steps / denoise), 1.0)[-(steps + 1):]
    if scheduler == "karras":
        return sigmas_karras(steps, ms.sigma_min, ms.sigma_max)
    if scheduler == "exponential":
        return sigmas_exponential(steps, ms.sigma_min, ms.sigma_max)
    if scheduler == "normal":
        return _sigmas_normal(ms, steps)
    if scheduler == "sgm_uniform":
        return _sigmas_sgm_uniform(ms, steps)
    if scheduler == "simple":
        return _sigmas_simple(ms, steps)
    if scheduler == "ddim_uniform":
        return _sigmas_ddim_uniform(ms, steps)
    raise ValueError(f"Unknown scheduler '{scheduler}' (have {SCHEDULER_NAMES})")
