"""The sampler and scheduler zoo of the port against the JAX package on the
CPU: every scheduler's sigmas, every one of the 19 samplers on a toy
denoiser with JAX's own draws handed in (per-step gaussians by JAX's split,
SDE increments from JAX's ``brownian_increment``), and the port's Brownian
bridge (deterministic, additive, unit variance; mirrors
tests/test_samplers_zoo.py's checks of the JAX bridge)."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_renderer_tpu.models.sampling import samplers as jsamplers
from stable_renderer_tpu.models.sampling import schedules as jsched
from stable_renderer_tpu_torch.models.sampling import samplers as tsamplers
from stable_renderer_tpu_torch.models.sampling import schedules as tsched

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)
SDE = ("dpmpp_sde", "dpmpp_2m_sde", "dpmpp_3m_sde")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_name_lists_match_jax():
    assert tsamplers.SAMPLER_NAMES == jsamplers.SAMPLER_NAMES
    assert tsched.SCHEDULER_NAMES == jsched.SCHEDULER_NAMES


@pytest.mark.parametrize("scheduler", jsched.SCHEDULER_NAMES)
@pytest.mark.parametrize("steps", [1, 4, 20])
@pytest.mark.parametrize("denoise", [1.0, 0.6])
def test_scheduler_sigmas_match_jax(scheduler, steps, denoise):
    """Host numpy in both packages: equal to f32 rounding (1 ulp)."""
    ref = jsched.calculate_sigmas(jsched.ModelSampling(), scheduler, steps, denoise)
    out = tsched.calculate_sigmas(tsched.ModelSampling(), scheduler, steps, denoise)
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1.2e-7, atol=0)


def test_sigma_helpers_match_jax():
    ms_j, ms_t = jsched.ModelSampling(), tsched.ModelSampling()
    for name, args in (("sigmas_karras", (7, 0.03, 14.6)), ("sigmas_exponential", (7, 0.03, 14.6)),
                       ("sigmas_polyexponential", (7, 0.03, 14.6, 1.5)), ("sigmas_vp", (7,))):
        np.testing.assert_allclose(getattr(tsched, name)(*args), getattr(jsched, name)(*args),
                                   rtol=1.2e-7, err_msg=name)
    for steps, denoise in ((1, 1.0), (4, 1.0), (3, 0.5)):
        np.testing.assert_allclose(tsched.sigmas_sd_turbo(ms_t, steps, denoise),
                                   jsched.sigmas_sd_turbo(ms_j, steps, denoise), rtol=1.2e-7)


def test_unknown_scheduler_raises():
    with pytest.raises(ValueError, match="Unknown scheduler"):
        tsched.calculate_sigmas(tsched.ModelSampling(), "nope", 4)


def _toy(xp):
    def den(x, sigma):
        return x / (1.0 + sigma * sigma) + 0.1 * xp.tanh(x)
    return den


_j_increment = jax.jit(jsamplers.brownian_increment, static_argnames=("shape", "dtype", "depth"))


def jax_draws(sampler, sigmas, shape, key, sde_noise="brownian"):
    """The draws JAX's ``sample(key=key)`` makes at each step, in the port's
    ``step_noise`` layout: one tensor a step, or one a draw site."""
    n = len(sigmas) - 1
    sig = jnp.asarray(sigmas)
    root = jax.random.fold_in(key, 0x42B)
    lo, hi = sig[max(len(sigmas) - 2, 0)], sig[0]
    out, k = [], key
    for i in range(n):
        k, sub = jax.random.split(k)
        s, sn = sig[i], sig[i + 1]
        if sampler in SDE and sde_noise == "brownian":
            def inc(a, b):
                return _t(_j_increment(root, a, b, lo, hi, shape=shape, dtype=jnp.float32))
            if sampler == "dpmpp_sde":
                t, t_next = -jsamplers._log(s), -jsamplers._log(sn)
                s_mid = jnp.exp(-(t + (t_next - t) * 0.5))
                out.append((inc(s, s_mid), inc(s, sn)))
            else:
                out.append(inc(s, sn))
        elif sampler == "dpmpp_sde":
            out.append((_t(jax.random.normal(sub, shape)),
                        _t(jax.random.normal(jax.random.fold_in(sub, 1), shape))))
        else:
            out.append(_t(jax.random.normal(sub, shape)))
    return out


def _run_both(sampler, sigmas, noise, latent, **kw):
    key = jax.random.PRNGKey(5)

    def cb(x, d, s, i):
        return x * 0.99 + 0.01 * d

    ref = jsamplers.sample(_toy(jnp), jnp.asarray(noise), jnp.asarray(sigmas),
                           latent_image=jnp.asarray(latent), sampler=sampler, key=key,
                           step_callback=cb, **kw)
    draws = jax_draws(sampler, sigmas, noise.shape, key, kw.get("sde_noise", "brownian"))
    out = tsamplers.sample(_toy(torch), _t(noise), torch.from_numpy(sigmas),
                           latent_image=_t(latent), sampler=sampler, step_callback=cb,
                           step_noise=draws, **kw)
    return out, ref


@pytest.mark.parametrize("sampler", jsamplers.SAMPLER_NAMES)
def test_sampler_matches_jax_with_its_draws(rng, sampler):
    """Six karras steps (every regime of heunpp2, LMS up to order 4, UniPC
    and 3M up to order 3), the step callback on, JAX's draws passed in."""
    sig = tsched.calculate_sigmas(tsched.ModelSampling(), "karras", 6)
    noise = rng.standard_normal((1, 6, 6, 4)).astype(np.float32)
    latent = rng.standard_normal((1, 6, 6, 4)).astype(np.float32)
    out, ref = _run_both(sampler, sig, noise, latent)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("sampler", SDE)
@pytest.mark.parametrize("sde_noise", ["zero", "iid"])
def test_sde_sampler_noise_modes_match_jax(rng, sampler, sde_noise):
    """``sde_noise="zero"`` (no draw) and ``"iid"`` (JAX's per-step
    gaussians) at 4 sgm_uniform steps."""
    sig = tsched.calculate_sigmas(tsched.ModelSampling(), "sgm_uniform", 4)
    noise = rng.standard_normal((1, 6, 6, 4)).astype(np.float32)
    latent = rng.standard_normal((1, 6, 6, 4)).astype(np.float32)
    out, ref = _run_both(sampler, sig, noise, latent, sde_noise=sde_noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_zero_noise_needs_no_draws(rng):
    """With ``sde_noise="zero"`` every draw is zero, so a generator-less run
    of an ancestral sampler is deterministic and equals JAX's."""
    sig = tsched.calculate_sigmas(tsched.ModelSampling(), "normal", 4)
    noise = rng.standard_normal((1, 6, 6, 4)).astype(np.float32)
    ref = jsamplers.sample(_toy(jnp), jnp.asarray(noise), jnp.asarray(sig),
                           sampler="euler_ancestral", sde_noise="zero")
    out = tsamplers.sample(_toy(torch), _t(noise), torch.from_numpy(sig),
                           sampler="euler_ancestral", sde_noise="zero")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _count_evals(sampler, steps):
    calls = []

    def den(x, sigma):
        calls.append(float(sigma))
        return _toy(torch)(x, sigma)

    sig = tsched.calculate_sigmas(tsched.ModelSampling(), "sgm_uniform", steps)
    tsamplers.sample(den, torch.ones((1, 4, 4, 4)), torch.from_numpy(sig), sampler=sampler,
                     generator=torch.Generator().manual_seed(0))
    return len(calls)


@pytest.mark.parametrize("sampler", jsamplers.SAMPLER_NAMES)
def test_model_evaluations_a_run(sampler):
    """The evaluations of a 4-step run, which set K1's launches a frame
    (5 an evaluation + 2): one a step, two for the two-stage samplers but on
    the last step, 9 for heunpp2; dpm_adaptive's depend on the data."""
    want = {"heun": 7, "dpm_2": 7, "dpm_2_ancestral": 7, "dpmpp_2s_ancestral": 7,
            "dpmpp_sde": 7, "heunpp2": 9}.get(sampler, 4)
    got = _count_evals(sampler, 4)
    if sampler == "dpm_adaptive":
        assert got % 3 == 0 and got >= 3
    else:
        assert got == want


def test_unknown_sampler_and_noise_mode_raise():
    x, sig = torch.zeros((1, 2, 2, 4)), torch.tensor([1.0, 0.0])
    with pytest.raises(ValueError, match="Unknown sampler"):
        tsamplers.sample(_toy(torch), x, sig, sampler="nope")
    with pytest.raises(ValueError, match="sde_noise"):
        tsamplers.sample(_toy(torch), x, sig, sampler="dpmpp_sde", sde_noise="pink")


def test_brownian_bridge_is_deterministic_additive_and_unit_variance():
    shape = (4096,)
    br = tsamplers.BrownianBridge(1234, 0.03, 14.6, shape)
    again = tsamplers.BrownianBridge(1234, 0.03, 14.6, shape)
    a, b, c = 14.6, 5.0, 0.7
    i1 = br.increment(a, b)
    torch.testing.assert_close(i1, again.increment(a, b), rtol=0, atol=0)
    torch.testing.assert_close(br.increment(a, b), i1, rtol=0, atol=0)
    # additive: sqrt-weighted increments over [a, b] and [b, c] sum to [a, c]
    whole = br.increment(a, c) * math.sqrt(a - c)
    parts = i1 * math.sqrt(a - b) + br.increment(b, c) * math.sqrt(b - c)
    torch.testing.assert_close(parts, whole, rtol=1e-4, atol=1e-4)
    for lo_hi in ((a, b), (b, c), (2.0, 1.9)):
        inc = br.increment(*lo_hi)
        assert abs(float(inc.mean())) < 0.1 and abs(float(inc.std()) - 1.0) < 0.1
    other = tsamplers.BrownianBridge(99, 0.03, 14.6, shape).increment(a, b)
    assert float((other - i1).abs().max()) > 0.1


def test_sde_sampler_draws_from_generator_and_bridge(rng):
    """Without ``step_noise`` the SDE samplers take the bridge seeded from
    the generator: the same generator seed gives the same latent."""
    sig = torch.from_numpy(tsched.calculate_sigmas(tsched.ModelSampling(), "karras", 4))
    x = _t(rng.standard_normal((1, 4, 4, 4)).astype(np.float32))
    runs = [tsamplers.sample(_toy(torch), x, sig, sampler="dpmpp_2m_sde",
                             generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert float((runs[0] - runs[2]).abs().max()) > 1e-3
