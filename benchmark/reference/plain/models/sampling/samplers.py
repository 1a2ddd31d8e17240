"""k-diffusion samplers as a host loop over sigmas.

Counterpart of stable_renderer_tpu/models/sampling/samplers.py (reference
comfy/k_diffusion/sampling.py:129-851, comfy/extra_samplers/uni_pc.py:580-877).
The JAX package runs the loop as one ``lax.scan`` with ``lax.cond`` branches;
here it is a Python loop with the sigmas on the host, so every branch is a
plain ``if`` on host floats and the per-step scalars (ancestral sigmas, LMS
and UniPC coefficients) are host math that costs no device round trip. Where
the JAX package departs from comfy, the port follows the JAX package: ``ddim``
runs as ``euler`` and ``ddpm`` as the ancestral step; the two-stage samplers
skip their second evaluation when the next sigma is 0; UniPC's last step is
predictor-only.

``denoise_model`` is (x, sigma) -> denoised (x0 space), built by
cfg.make_denoiser; ``step_callback`` is the Corresponder.step_finished hook,
(x, denoised, sigma, i) -> x. Sigmas reach both as 0-d f32 CPU tensors.

Noise. Each draw comes from ``generator``, or from ``step_noise``: one entry
per step, a tensor, or a tuple with one tensor per draw site of the step
(``dpmpp_sde`` draws twice a step). That lets a test hand in the draws the
JAX package made. The SDE samplers (``dpmpp_sde``, ``dpmpp_2m_sde``,
``dpmpp_3m_sde``) draw by ``sde_noise``: ``"brownian"`` (default) takes
unit-variance increments of one deterministic Brownian motion over the run's
sigma range (``BrownianBridge``, the JAX package's ``brownian_increment``,
seeded from ``generator.initial_seed()`` with no draw, so one generator seed
gives one motion and the card is not read), ``"iid"`` a fresh gaussian, ``"zero"`` nothing (every draw of every sampler is
then zero). ``step_noise`` entries replace whatever the site would draw,
Brownian increments included. Under ``parallel.mesh.dp_context`` (a render
whose frames are split over ranks) every draw is this rank's rows of the
whole batch's, so a split render draws what the whole one does, and
``dpm_adaptive``'s error norm sums over every rank's frames.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference.plain.parallel.mesh import FrameShard, active_dp, randn_frames

SAMPLER_NAMES = [
    "euler",
    "euler_ancestral",
    "heun",
    "heunpp2",
    "dpm_2",
    "dpm_2_ancestral",
    "lms",
    "dpmpp_2s_ancestral",
    "dpmpp_sde",
    "dpmpp_2m",
    "dpmpp_2m_sde",
    "dpmpp_3m_sde",
    "ddim",
    "ddpm",
    "lcm",
    "dpm_fast",
    "dpm_adaptive",
    "uni_pc",
    "uni_pc_bh2",
]

SDE_NOISE_MODES = ("brownian", "iid", "zero")


def _log(s: float) -> float:
    return math.log(max(s, 1e-10))


def _to_d(x: torch.Tensor, sigma: float, denoised: torch.Tensor) -> torch.Tensor:
    return (x - denoised) / max(sigma, 1e-8)


def _sig(v: float) -> torch.Tensor:
    """A host sigma as the 0-d f32 CPU tensor the denoiser takes."""
    return torch.tensor(v, dtype=torch.float32)


def _ancestral_step(sigma_from: float, sigma_to: float, eta: float = 1.0):
    """(sigma_down, sigma_up) of an ancestral step (k_diffusion
    get_ancestral_step), on host floats."""
    sigma_up = min(sigma_to, eta * math.sqrt(max(
        sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2) / max(sigma_from ** 2, 1e-12), 0.0)))
    sigma_down = math.sqrt(max(sigma_to ** 2 - sigma_up ** 2, 0.0))
    return sigma_down, sigma_up


def _lms_coeffs(sigmas: Sequence[float], i: int, cur_order: int, max_order: int = 4) -> List[float]:
    """Linear-multistep coefficients (k_diffusion sampling.py:265-276): the
    integral over [t_i, t_{i+1}] of each Lagrange basis polynomial through
    t_i, ..., t_{i-cur_order+1}, in closed form (degree <= 3) in float64.
    Zero for j >= cur_order."""
    n = len(sigmas)
    t = [sigmas[min(max(i - k, 0), n - 1)] for k in range(max_order)]
    t_i, t_ip1 = sigmas[i], sigmas[min(i + 1, n - 1)]
    out = []
    for j in range(max_order):
        if j >= cur_order:
            out.append(0.0)
            continue
        poly = np.zeros(max_order)
        poly[0] = 1.0
        for k in range(cur_order):
            if k == j:
                continue
            denom = t[j] - t[k]
            shifted = np.concatenate([[0.0], poly[:-1]])  # * tau
            poly = (shifted - t[k] * poly) / (denom if abs(denom) > 0 else 1.0)
        m = np.arange(max_order)
        out.append(float(np.sum(poly * (t_ip1 ** (m + 1) - t_i ** (m + 1)) / (m + 1))))
    return out


def _mix_seed(root: int, index: int) -> int:
    """A 63-bit generator seed for (root, heap index): splitmix64's
    finalizer over the pair, standing in for ``jax.random.fold_in``."""
    z = (root + 0x9E3779B97F4A7C15 * (index + 1)) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


class BrownianBridge:
    """A deterministic Brownian motion W on the sigma range [t_lo, t_hi]
    (the JAX package's ``brownian_increment``; k_diffusion
    BrownianTreeNoiseSampler semantics with the identity sigma transform).

    W(t_lo) = 0 and W(t_hi) ~ N(0, t_hi - t_lo); W(t) is refined by ``depth``
    levels of dyadic Brownian-bridge bisection, each midpoint drawn from a
    torch generator seeded by (``seed``, heap index) on ``device``, where the
    JAX package folds the heap index into its key. So every query of one t
    gives the same W(t), increments over adjacent intervals add up, and
    ``increment`` has unit variance. The draws of a heap index are kept, so
    the bisection paths that queries share are drawn once. The card's Philox
    draws and the CPU's differ; compare devices with the increments handed
    in (``sample(step_noise=...)``)."""

    def __init__(self, seed: int, t_lo: float, t_hi: float, shape, device=None,
                 depth: int = 26, shard: Optional[FrameShard] = None):
        self.seed, self.t_lo, self.shape, self.depth = int(seed), float(t_lo), tuple(shape), depth
        self.shard = shard  # draws are this rank's rows of the whole batch's
        self.span = max(float(t_hi) - self.t_lo, 1e-12)
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self._draws: dict = {}

    def _normal(self, heap: int) -> torch.Tensor:
        z = self._draws.get(heap)
        if z is None:
            g = torch.Generator(device=self.device).manual_seed(_mix_seed(self.seed, heap))
            draw = torch.randn if self.shard is None else self.shard.randn
            z = self._draws[heap] = draw(self.shape, generator=g, device=self.device)
        return z

    def w(self, t: float) -> torch.Tensor:
        """W(t), f32 of ``shape`` on ``device``."""
        u = min(max((float(t) - self.t_lo) / self.span, 0.0), 1.0)
        wa = torch.zeros(self.shape, device=self.device)
        wb = self._normal(1) * math.sqrt(self.span)
        lo, hi, heap = 0.0, 1.0, 2
        for _ in range(self.depth):
            mid = 0.5 * (lo + hi)
            # bridge midpoint: mean of the endpoints + N(0, len / 4), len in sigma units
            wm = 0.5 * (wa + wb) + self._normal(heap) * (0.5 * math.sqrt((hi - lo) * self.span))
            if u >= mid:
                wa, lo, heap = wm, mid, heap * 2 + 1
            else:
                wb, hi, heap = wm, mid, heap * 2
        frac = min(max((u - lo) / max(hi - lo, 1e-20), 0.0), 1.0)
        return wa + (wb - wa) * frac

    def increment(self, s_from: float, s_to: float) -> torch.Tensor:
        """(W(s_to) - W(s_from)) / sqrt(|s_to - s_from|)."""
        inc = self.w(s_to) - self.w(s_from)
        return inc / math.sqrt(max(abs(float(s_to) - float(s_from)), 1e-12))


class _Draws:
    """The run's noise: per-step gaussians (ancestral, ddpm, lcm re-noise)
    and SDE increments, from ``step_noise`` where it is given, else from the
    generator or the Brownian bridge."""

    def __init__(self, x, generator, step_noise, sde_noise, brownian, sigmas):
        self.x, self.generator, self.step_noise = x, generator, step_noise
        self.zero = sde_noise == "zero"
        self.bridge = None
        if brownian and not self.zero and step_noise is None:
            # the root seed folds 0x42B into the generator's seed, as the JAX
            # package folds it into its key: no draw, so no read of the card
            root = generator.initial_seed() if generator is not None else torch.initial_seed()
            self.bridge = BrownianBridge(_mix_seed(root, 0x42B), sigmas[max(len(sigmas) - 2, 0)],
                                         sigmas[0], x.shape, x.device, shard=active_dp())

    def _given(self, i: int, site: int) -> torch.Tensor:
        d = self.step_noise[i]
        if isinstance(d, (tuple, list)):
            d = d[site]
        return d.to(device=self.x.device, dtype=self.x.dtype)

    def gaussian(self, i: int, site: int = 0) -> torch.Tensor:
        if self.zero:
            return torch.zeros_like(self.x)
        if self.step_noise is not None:
            return self._given(i, site)
        return randn_frames(self.x.shape, generator=self.generator, device=self.x.device,
                            dtype=self.x.dtype)

    def sde(self, i: int, site: int, s_from: float, s_to: float) -> torch.Tensor:
        if self.bridge is None:  # "iid", "zero" or draws handed in
            return self.gaussian(i, site)
        return self.bridge.increment(s_from, s_to).to(self.x.dtype)


def sample(
    denoise_model: Callable,
    noise: torch.Tensor,                          # (B, h, w, C) unit-variance noise
    sigmas: torch.Tensor,                         # (steps+1,) descending, ends at 0
    latent_image: Optional[torch.Tensor] = None,  # img2img init latent
    sampler: str = "euler",
    generator: Optional[torch.Generator] = None,
    step_callback: Optional[Callable] = None,
    step_noise: Optional[Sequence] = None,
    eta: float = 1.0,
    sde_noise: str = "brownian",
) -> torch.Tensor:
    """Run the denoise loop; returns the final latent. x0 = latent +
    noise * sigma_max (comfy.sample.sample). See the module docstring for
    ``generator``, ``step_noise`` and ``sde_noise``."""
    if sampler not in SAMPLER_NAMES:
        raise ValueError(f"Unknown sampler '{sampler}' (have {SAMPLER_NAMES})")
    if sde_noise not in SDE_NOISE_MODES:
        raise ValueError(f"Unknown sde_noise '{sde_noise}' (have {SDE_NOISE_MODES})")
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32).cpu()
    sig = [float(s) for s in sigmas]
    n_steps = len(sig) - 1
    if step_noise is not None and len(step_noise) < n_steps:
        raise ValueError(f"step_noise holds {len(step_noise)} draws for {n_steps} steps")
    x = noise * sig[0]
    if latent_image is not None:
        x = x + latent_image
    if sampler.startswith("uni_pc"):
        return _sample_unipc(denoise_model, x, sig, step_callback,
                             "bh2" if sampler == "uni_pc_bh2" else "bh1")
    if sampler == "dpm_fast":
        return _sample_dpm_fast(denoise_model, x, sig, step_callback)
    if sampler == "dpm_adaptive":
        return _sample_dpm_adaptive(denoise_model, x, sig, step_callback)

    draws = _Draws(x, generator, step_noise, sde_noise,
                   sde_noise == "brownian" and sampler.endswith("sde"), sig)
    model = denoise_model
    old = old2 = None        # previous denoised (2m, 2m_sde, 3m_sde)
    h_1 = h_2 = 0.0          # previous step sizes in log sigma (2m_sde, 3m_sde)
    d_hist: List[torch.Tensor] = []  # lms: d at steps i, i-1, ... (newest first)
    for i in range(n_steps):
        s, sn = sig[i], sig[i + 1]
        denoised = model(x, sigmas[i])

        if sampler in ("euler", "ddim"):
            x_new = x + _to_d(x, s, denoised) * (sn - s)

        elif sampler in ("euler_ancestral", "ddpm"):
            s_down, s_up = _ancestral_step(s, sn, eta)
            x_new = x + _to_d(x, s, denoised) * (s_down - s)
            x_new = x_new + draws.gaussian(i) * s_up

        elif sampler == "heun":
            d = _to_d(x, s, denoised)
            x_new = x + d * (sn - s)
            if sn > 0:
                d2 = _to_d(x_new, sn, model(x_new, sigmas[i + 1]))
                x_new = x + 0.5 * (d + d2) * (sn - s)

        elif sampler == "heunpp2":
            # three regimes by distance from the end (sampling.py:797-851)
            d = _to_d(x, s, denoised)
            dt = sn - s
            s_nn = sig[min(i + 2, n_steps)]
            if sn == sig[n_steps]:
                x_new = x + d * dt
            else:
                x_2 = x + d * dt
                d_2 = _to_d(x_2, sn, model(x_2, sigmas[i + 1]))
                if s_nn == sig[n_steps]:
                    w2 = sn / (2 * sig[0])
                    x_new = x + (d * (1 - w2) + d_2 * w2) * dt
                else:
                    x_3 = x_2 + d_2 * (s_nn - sn)
                    d_3 = _to_d(x_3, s_nn, model(x_3, sigmas[min(i + 2, n_steps)]))
                    w = 3 * sig[0]
                    w2, w3 = sn / w, s_nn / w
                    x_new = x + (d * (1 - w2 - w3) + d_2 * w2 + d_3 * w3) * dt

        elif sampler == "dpm_2":
            d = _to_d(x, s, denoised)
            if sn > 0:
                s_mid = math.exp(0.5 * (_log(s) + _log(sn)))
                x_2 = x + d * (s_mid - s)
                d_2 = _to_d(x_2, s_mid, model(x_2, _sig(s_mid)))
                x_new = x + d_2 * (sn - s)
            else:
                x_new = x + d * (sn - s)

        elif sampler == "dpm_2_ancestral":
            s_down, s_up = _ancestral_step(s, sn, eta)
            d = _to_d(x, s, denoised)
            if s_down > 0:
                s_mid = math.exp(0.5 * (_log(s) + _log(s_down)))
                x_2 = x + d * (s_mid - s)
                d_2 = _to_d(x_2, s_mid, model(x_2, _sig(s_mid)))
                x_new = x + d_2 * (s_down - s) + draws.gaussian(i) * s_up
            else:
                x_new = x + d * (s_down - s)

        elif sampler == "lms":
            d_hist = [_to_d(x, s, denoised)] + d_hist[:3]
            coeffs = _lms_coeffs(sig, i, min(i + 1, 4))
            x_new = x
            for c, dk in zip(coeffs, d_hist):
                x_new = x_new + c * dk

        elif sampler == "dpmpp_2s_ancestral":
            s_down, s_up = _ancestral_step(s, sn, eta)
            if s_down > 0:
                t, t_next = -_log(s), -_log(s_down)
                h = t_next - t
                s_half = t + 0.5 * h
                x_2 = (math.exp(-s_half) / math.exp(-t)) * x - math.expm1(-h * 0.5) * denoised
                denoised_2 = model(x_2, _sig(math.exp(-s_half)))
                x_new = (math.exp(-t_next) / math.exp(-t)) * x - math.expm1(-h) * denoised_2
                x_new = x_new + draws.gaussian(i) * s_up
            else:
                x_new = x + _to_d(x, s, denoised) * (s_down - s)

        elif sampler == "dpmpp_sde":
            if sn > 0:
                r = 0.5
                t, t_next = -_log(s), -_log(sn)
                h = t_next - t
                s_mid = t + h * r
                fac = 1 / (2 * r)
                sd, su = _ancestral_step(math.exp(-t), math.exp(-s_mid), eta)
                s_ = -_log(sd)
                x_2 = (math.exp(-s_) / math.exp(-t)) * x - math.expm1(t - s_) * denoised
                x_2 = x_2 + draws.sde(i, 0, s, math.exp(-s_mid)) * su
                denoised_2 = model(x_2, _sig(math.exp(-s_mid)))
                sd2, su2 = _ancestral_step(math.exp(-t), math.exp(-t_next), eta)
                t_next_ = -_log(sd2)
                denoised_d = (1 - fac) * denoised + fac * denoised_2
                x_new = (math.exp(-t_next_) / math.exp(-t)) * x \
                    - math.expm1(t - t_next_) * denoised_d
                x_new = x_new + draws.sde(i, 1, s, sn) * su2
            else:
                x_new = x + _to_d(x, s, denoised) * (sn - s)

        elif sampler == "dpmpp_2m":
            if sn > 0:
                t, t_next = -_log(s), -_log(sn)
                h = t_next - t
                if i == 0:
                    denoised_d = denoised
                else:
                    r = (t + _log(sig[i - 1])) / max(h, 1e-8)
                    denoised_d = (1 + 1 / (2 * r)) * denoised - (1 / (2 * r)) * old
                x_new = (sn / max(s, 1e-8)) * x - math.expm1(-h) * denoised_d
            else:
                x_new = denoised
            old = denoised

        elif sampler == "dpmpp_2m_sde":
            # midpoint solver_type (comfy default), sampling.py:663-719
            t, t_s = -_log(s), -_log(sn)
            h = t_s - t
            if sn > 0:
                eta_h = eta * h
                x_new = (sn / max(s, 1e-8)) * math.exp(-eta_h) * x \
                    + (-math.expm1(-h - eta_h)) * denoised
                if i > 0:
                    r = h_1 / max(h, 1e-8)
                    x_new = x_new + 0.5 * (-math.expm1(-h - eta_h)) * (1 / max(r, 1e-8)) \
                        * (denoised - old)
                if eta:
                    amt = sn * math.sqrt(max(-math.expm1(-2 * eta_h), 0.0))
                    x_new = x_new + draws.sde(i, 0, s, sn) * amt
            else:
                x_new = denoised
            old, h_1 = denoised, h

        elif sampler == "dpmpp_3m_sde":
            t, t_s = -_log(s), -_log(sn)
            h = t_s - t
            if sn > 0:
                h_eta = h * (eta + 1)
                x_new = math.exp(-h_eta) * x + (-math.expm1(-h_eta)) * denoised
                phi_2 = math.expm1(-h_eta) / h_eta + 1
                phi_3 = phi_2 / h_eta - 0.5
                if i >= 1:
                    r0 = h_1 / max(h, 1e-8)
                    d1_0 = (denoised - old) / max(r0, 1e-8)
                    if i >= 2:
                        r1 = h_2 / max(h, 1e-8)
                        d1_1 = (old - old2) / max(r1, 1e-8)
                        d1 = d1_0 + (d1_0 - d1_1) * (r0 / max(r0 + r1, 1e-8))
                        d2 = (d1_0 - d1_1) / max(r0 + r1, 1e-8)
                        x_new = x_new + (phi_2 * d1 - phi_3 * d2)
                    else:
                        x_new = x_new + phi_2 * d1_0
                if eta:
                    amt = sn * math.sqrt(max(-math.expm1(-2 * h * eta), 0.0))
                    x_new = x_new + draws.sde(i, 0, s, sn) * amt
            else:
                x_new = denoised
            old2, old, h_2, h_1 = old, denoised, h_1, h

        else:  # lcm: jump to x0, re-noise to the next sigma
            fresh = draws.gaussian(i)  # drawn every step, as the JAX scan does
            x_new = denoised + sn * fresh if sn > 0 else denoised

        if step_callback is not None:
            x_new = step_callback(x_new, denoised, sigmas[i], i)
        x = x_new
    return x


# ---------------------------------------------------------------------------
# DPM-Solver fast / adaptive (reference comfy/k_diffusion/sampling.py:327-534).
# Works in t = -log(sigma); eps(x, t) = (x - denoise(x, sigma)) / sigma.


def _dpm_eps(model, x, t: float) -> torch.Tensor:
    sigma = math.exp(-t)
    return (x - model(x, _sig(sigma))) / sigma


def _dpm_1_step(x, t: float, t_next: float, eps):
    return x - math.exp(-t_next) * math.expm1(t_next - t) * eps


def _dpm_2_step(model, x, t: float, t_next: float, eps, r1: float = 0.5, eps_r1=None):
    h = t_next - t
    s1 = t + r1 * h
    if eps_r1 is None:
        u1 = x - math.exp(-s1) * math.expm1(r1 * h) * eps
        eps_r1 = _dpm_eps(model, u1, s1)
    x_2 = (x - math.exp(-t_next) * math.expm1(h) * eps
           - math.exp(-t_next) / (2 * r1) * math.expm1(h) * (eps_r1 - eps))
    return x_2, eps_r1


def _dpm_3_step(model, x, t: float, t_next: float, eps, r1: float = 1.0 / 3,
                r2: float = 2.0 / 3, eps_r1=None):
    h = t_next - t
    s1, s2 = t + r1 * h, t + r2 * h
    if eps_r1 is None:
        u1 = x - math.exp(-s1) * math.expm1(r1 * h) * eps
        eps_r1 = _dpm_eps(model, u1, s1)
    u2 = (x - math.exp(-s2) * math.expm1(r2 * h) * eps
          - math.exp(-s2) * (r2 / r1) * (math.expm1(r2 * h) / (r2 * h) - 1.0) * (eps_r1 - eps))
    eps_r2 = _dpm_eps(model, u2, s2)
    return (x - math.exp(-t_next) * math.expm1(h) * eps
            - math.exp(-t_next) / r2 * (math.expm1(h) / h - 1.0) * (eps_r2 - eps))


def _sample_dpm_fast(model, x, sig: List[float], step_callback):
    """sample_dpm_fast: ``steps`` model evaluations in order-3 segments
    (orders 3, ..., 3 and the remainder), over t from -log(sigma_max) to
    -log of the last nonzero sigma."""
    nfe = len(sig) - 1
    t_start, t_end = -_log(sig[0]), -_log(sig[-2])
    m = nfe // 3 + 1
    ts = [k / m * (t_end - t_start) + t_start for k in range(m + 1)]
    orders = [3] * (m - 2) + [2, 1] if nfe % 3 == 0 else [3] * (m - 1) + [nfe % 3]
    for i, order in enumerate(orders):
        t, t_next = ts[i], ts[i + 1]
        eps = _dpm_eps(model, x, t)
        denoised = x - math.exp(-t) * eps
        if order == 1:
            x_new = _dpm_1_step(x, t, t_next, eps)
        elif order == 2:
            x_new, _ = _dpm_2_step(model, x, t, t_next, eps)
        else:
            x_new = _dpm_3_step(model, x, t, t_next, eps)
        if step_callback is not None:
            x_new = step_callback(x_new, denoised, _sig(math.exp(-t)), i)
        x = x_new
    return x


def _sample_dpm_adaptive(model, x, sig: List[float], step_callback,
                         rtol: float = 0.05, atol: float = 0.0078, h_init: float = 0.05,
                         accept_safety: float = 0.81, max_iters: int = 64):
    """dpm_solver_adaptive, order 3: an embedded 2/3 pair (three model
    evaluations an iteration) with the PID step-size controller (pcoeff 0,
    icoeff 1, dcoeff 0), at most ``max_iters`` iterations, eta 0.

    Each iteration accepts or rejects its step from an error norm computed on
    the device, so it reads that norm on the host: one host sync an
    iteration. The step size and the accepted t stay host floats (f32, as
    the JAX package's loop carries them)."""
    f32 = np.float32
    t_end = f32(-_log(sig[-2]))
    s, h = f32(-_log(sig[0])), f32(h_init)
    x_prev = x
    iters = 0
    while s < t_end - f32(1e-5) and iters < max_iters:
        t = min(t_end, f32(s + h))
        eps = _dpm_eps(model, x, float(s))
        denoised = x - math.exp(-float(s)) * eps
        x_low, eps_r1 = _dpm_2_step(model, x, float(s), float(t), eps, r1=1.0 / 3)
        x_high = _dpm_3_step(model, x, float(s), float(t), eps, eps_r1=eps_r1)
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()), min=atol)
        sq = ((x_low - x_high) / delta) ** 2
        dp = active_dp()
        if dp is None:
            ms = torch.mean(sq)
        else:  # the whole batch's mean
            ms = dp.all_reduce_(sq.sum()) / (sq.numel() * dp.size)
        error = f32(torch.sqrt(ms).item())  # host sync
        factor = f32(1.0) + np.arctan((f32(1.0) / (error + f32(1e-8))) ** f32(1.0 / 3.0)
                                      - f32(1.0))
        if factor >= f32(accept_safety):
            if step_callback is not None:
                x_high = step_callback(x_high, denoised, _sig(math.exp(-float(s))), iters)
            x, x_prev, s = x_high, x_low, t
        h = f32(h * factor)
        iters += 1
    return x


# ---------------------------------------------------------------------------
# UniPC (predictor-corrector multistep), x0 prediction, bh1 / bh2.
# Reference: comfy/extra_samplers/uni_pc.py:580-877. There t IS sigma
# (SigmaConvert): lambda = -log(sigma), alpha = 1/sqrt(1+sigma^2), VP std =
# sigma * alpha; x is carried in VP space (x_vp = x * alpha) and divided by
# alpha(t_last) at the end. The coefficients are host float64 solves.


def _unipc_coeffs(rks: List[float], hh: float, variant: str, order: int, max_order: int = 3):
    """(rhos_p, rhos_c) of the UniPC ``R @ rhos = b`` systems (uni_pc.py
    :610-655) for a step of ``order``: rhos_p solves the first order - 1
    ratios (0.5 at order 2), rhos_c all ``order`` (0.5 at order 1)."""
    h_phi_1 = math.expm1(hh)
    b_h = hh if variant == "bh1" else math.expm1(hh)
    b, h_phi_k, factorial = [], h_phi_1 / hh - 1.0, 1.0
    for i in range(max_order):
        b.append(h_phi_k * factorial / b_h)
        factorial *= i + 2
        h_phi_k = h_phi_k / hh - 1.0 / factorial

    def solve(k: int) -> np.ndarray:
        r = np.array([[rks[j] ** i for j in range(k)] for i in range(k)], np.float64)
        return np.linalg.solve(r, np.asarray(b[:k], np.float64))

    rhos_p = np.array([0.5]) if order == 2 else solve(order - 1) if order > 2 else np.zeros(0)
    rhos_c = np.array([0.5]) if order == 1 else solve(order)
    return rhos_p, rhos_c


def _sample_unipc(model, x, sig: List[float], step_callback, variant: str, max_order: int = 3):
    """UniPC multistep predictor-corrector: one model evaluation a step (the
    corrector's, at the predicted point, reused as the next step's model
    output); the last step is predictor-only (use_corrector=False, :741).
    The step callback sees the VP-space x, as in the JAX package."""
    steps = len(sig) - 1
    order = max(1, min(max_order, steps - 1))
    ts = list(sig)
    ts[-1] = max(ts[-1], 1e-3)  # the reference clamps the trailing 0 sigma (:853-857)

    def alpha(s: float) -> float:
        return 1.0 / math.sqrt(1.0 + s * s)

    def model_x0(x_vp, s: float):
        return model(x_vp / alpha(s), _sig(s))

    x_vp = x * alpha(ts[0])
    m_hist = [model_x0(x_vp, ts[0])] * max_order  # m_hist[k]: model at prev_k (0 newest)
    lam_hist = [-_log(ts[0])] * max_order

    def predict(x_vp, t_prev: float, t_cur: float, step_order: int):
        lam_p0 = -_log(t_prev)
        h = -_log(t_cur) - lam_p0
        hh = -h  # predict x0
        sigma_t, sigma_p0, alpha_t = t_cur * alpha(t_cur), t_prev * alpha(t_prev), alpha(t_cur)
        b_h = hh if variant == "bh1" else math.expm1(hh)
        k_act = step_order - 1
        rks = [(lam_hist[min(k + 1, max_order - 1)] - lam_p0) / (h if h != 0 else 1.0)
               for k in range(k_act)] + [1.0]
        d1s = [(m_hist[min(k + 1, max_order - 1)] - m_hist[0]) / rks[k] for k in range(k_act)]
        rhos_p, rhos_c = _unipc_coeffs(rks, hh, variant, step_order, max_order)
        x_t_ = (sigma_t / max(sigma_p0, 1e-10)) * x_vp - alpha_t * math.expm1(hh) * m_hist[0]
        x_pred = x_t_
        if step_order > 1:
            pred_res = sum(float(rhos_p[k]) * d1s[k] for k in range(k_act))
            x_pred = x_t_ - alpha_t * b_h * pred_res
        return x_t_, x_pred, rhos_c, d1s, alpha_t, b_h

    for i in range(1, steps):
        # order ramp-up and lower_order_final (uni_pc.py:714-737)
        step_order = min(max(min(i, order, steps + 1 - i), 1), order)
        x_t_, x_pred, rhos_c, d1s, alpha_t, b_h = predict(x_vp, ts[i - 1], ts[i], step_order)
        model_t = model_x0(x_pred, ts[i])
        res = float(rhos_c[step_order - 1]) * (model_t - m_hist[0])
        for k, d1 in enumerate(d1s):
            res = res + float(rhos_c[k]) * d1
        x_vp = x_t_ - alpha_t * b_h * res
        m_hist = [model_t] + m_hist[:-1]
        lam_hist = [-_log(ts[i])] + lam_hist[:-1]
        if step_callback is not None:
            x_vp = step_callback(x_vp, model_t, _sig(ts[i]), i - 1)
    x_vp = predict(x_vp, ts[-2], ts[-1], 1)[1]
    if step_callback is not None:
        x_vp = step_callback(x_vp, m_hist[0], _sig(ts[-1]), steps - 1)
    return x_vp / alpha(ts[-1])
