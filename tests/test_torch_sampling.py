"""Sampling and correspondence: the port's schedules, CFG denoiser, samplers,
segment math, vertex averaging and frame packing against the JAX package on
the same inputs (f32, CPU). Random draws are made once (numpy or JAX) and
handed to both sides."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_renderer_tpu.data.framebuffers import GBuffer as JGBuffer
from stable_renderer_tpu.engine.render_exec import _pack_arrays as j_pack
from stable_renderer_tpu.models import unet as junet
from stable_renderer_tpu.models.sampling import cfg as jcfg
from stable_renderer_tpu.models.sampling import samplers as jsamplers
from stable_renderer_tpu.models.sampling import schedules as jsched
from stable_renderer_tpu.ops import correspondence as jcorr
from stable_renderer_tpu.ops import math as jmath
from stable_renderer_tpu_torch.data.framebuffers import GBuffer
from stable_renderer_tpu_torch.engine.render_exec import _pack_arrays
from stable_renderer_tpu_torch.models import unet as tunet
from stable_renderer_tpu_torch.models.sampling import cfg as tcfg
from stable_renderer_tpu_torch.models.sampling import samplers as tsamplers
from stable_renderer_tpu_torch.models.sampling import schedules as tsched
from stable_renderer_tpu_torch.ops import correspondence as tcorr
from stable_renderer_tpu_torch.ops import math as tmath

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _id_maps(rng, b=2, h=16, w=16):
    """(B, H, W, 4) id maps: vertex ids shared across frames, a band of
    non-AI pixels (map_index 2048) and a background corner of zeros."""
    ids = np.zeros((b, h, w, 4), np.int32)
    ids[..., 0], ids[..., 1] = 1, 1
    ids[..., 2] = rng.integers(0, 9, (b, h, w))
    ids[..., 3] = rng.integers(0, 40, (b, h, w))
    ids[:, :, : w // 4, 2] = 2048
    ids[:, : h // 4, -(w // 4):] = 0
    return ids


@pytest.mark.parametrize("steps", [1, 4, 8])
@pytest.mark.parametrize("denoise", [1.0, 0.5])
def test_sgm_uniform_sigmas_match_jax(steps, denoise):
    for pred in ("eps", "lcm"):
        ref = jsched.calculate_sigmas(jsched.ModelSampling(prediction=pred), "sgm_uniform",
                                      steps, denoise)
        out = tsched.calculate_sigmas(tsched.ModelSampling(prediction=pred), "sgm_uniform",
                                      steps, denoise)
        np.testing.assert_array_equal(out, ref)


def test_timestep_from_sigma_matches_jax(rng):
    ms = jsched.ModelSampling()
    sig = np.concatenate([ms.sigmas[::37], rng.uniform(0.0, 15.0, 50), [0.0]]).astype(np.float32)
    ref = jcfg.timestep_from_sigma(jnp.asarray(ms.log_sigmas), jnp.asarray(sig))
    out = tcfg.timestep_from_sigma(torch.from_numpy(ms.log_sigmas), torch.from_numpy(sig))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.dtype == torch.float32 and np.all(out.numpy() == np.round(out.numpy()))


@pytest.mark.parametrize("prediction", ["eps", "v", "lcm", "x0"])
def test_calculate_denoised_matches_jax(rng, prediction):
    x, out = rng.standard_normal((2, 4, 4, 4)).astype(np.float32), rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    sigma, t = np.float32(3.7), np.float32(741.0)
    ref = jcfg.calculate_denoised(prediction, jnp.asarray(x), jnp.asarray(out), jnp.asarray(sigma), jnp.asarray(t))
    got = tcfg.calculate_denoised(prediction, _t(x), _t(out), torch.tensor(sigma), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _toy_denoiser(xp):
    def den(x, sigma):
        return x / (1.0 + sigma * sigma) + 0.1 * xp.tanh(x)
    return den


@pytest.mark.parametrize("sampler", ["lcm", "euler"])
def test_sample_matches_jax_with_its_draws(rng, sampler):
    """The port's sampler fed the re-noise draws the JAX scan makes:
    fold_in/split per step (samplers.py:251-255)."""
    sig = tsched.calculate_sigmas(tsched.ModelSampling(), "sgm_uniform", 4)
    noise = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    latent = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(5)

    def jcb(x, d, s, i):
        return x * 0.99 + 0.01 * d

    ref = jsamplers.sample(_toy_denoiser(jnp), jnp.asarray(noise), jnp.asarray(sig),
                           latent_image=jnp.asarray(latent), sampler=sampler, key=key,
                           step_callback=jcb)
    draws, k = [], key
    for _ in range(4):
        k, sub = jax.random.split(k)
        draws.append(_t(jax.random.normal(sub, noise.shape)))
    out = tsamplers.sample(_toy_denoiser(torch), _t(noise), torch.from_numpy(sig),
                           latent_image=_t(latent), sampler=sampler,
                           step_callback=lambda x, d, s, i: x * 0.99 + 0.01 * d,
                           step_noise=draws)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_sampler_draws_from_generator(rng):
    sig = torch.tensor([2.0, 1.0, 0.5, 0.0])
    x = _t(rng.standard_normal((1, 4, 4, 4)).astype(np.float32))
    a = tsamplers.sample(_toy_denoiser(torch), x, sig, sampler="lcm",
                         generator=torch.Generator().manual_seed(1))
    b = tsamplers.sample(_toy_denoiser(torch), x, sig, sampler="lcm",
                         generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b)
    with pytest.raises(NotImplementedError):
        tsamplers.sample(_toy_denoiser(torch), x, sig, sampler="dpmpp_2m")


def test_cfg_denoiser_with_overlap_hooks_matches_jax(rng):
    """CFG over the tiny UNet with the corresponder's hooks on the positive
    rows only (cfg.py wrap_hooks), two frames."""
    c = junet.TINY_UNET_CONFIG
    tm = tunet.UNetModel(tunet.UNetConfig(
        model_channels=c.model_channels, num_res_blocks=c.num_res_blocks,
        channel_mult=c.channel_mult, attention_levels=c.attention_levels,
        num_heads=c.num_heads, context_dim=c.context_dim))
    tp = tm.init(torch.Generator().manual_seed(4))
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    cond, unc = (rng.standard_normal((2, 77, 64)).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ms = jsched.ModelSampling(prediction="lcm")
    jh = jcorr.OverlapCorresponder(update_corrmap=False, layer_range=None).attn_hooks(None)
    th = tcorr.OverlapCorresponder(update_corrmap=False, layer_range=None).attn_hooks(None)
    jden = jcfg.make_denoiser(junet.UNetModel(c), jp, jnp.asarray(cond), jnp.asarray(unc),
                              jnp.asarray(ms.log_sigmas), cfg_scale=2.0, prediction="lcm",
                              hooks=jh)
    tden = tcfg.make_denoiser(tm, tp, _t(cond), _t(unc), torch.from_numpy(ms.log_sigmas),
                              cfg_scale=2.0, prediction="lcm", hooks=th)
    sigma = np.float32(ms.sigmas[700])
    ref = jax.jit(jden)(jnp.asarray(x), jnp.asarray(sigma))
    np.testing.assert_allclose(tden(_t(x), torch.tensor(sigma)).numpy(), np.asarray(ref), **TOL)


def test_math_ops_match_jax(rng):
    a = rng.standard_normal((2, 8, 8, 3)).astype(np.float32) * 2 + 1
    b = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    for fn in ("map_mean_std",):
        for x, y in zip(getattr(tmath, fn)(_t(a)), getattr(jmath, fn)(jnp.asarray(a))):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(tmath.adain(_t(a), _t(b)).numpy(),
                               np.asarray(jmath.adain(jnp.asarray(a), jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(tmath.downsample_mean(_t(a), 4).numpy(),
                               np.asarray(jmath.downsample_mean(jnp.asarray(a), 4)), **TOL)
    np.testing.assert_array_equal(tmath.resize_nearest(_t(a), 5, 13).numpy(),
                                  np.asarray(jmath.resize_nearest(jnp.asarray(a), 5, 13)))


def test_group_average_dump_segment_matches_jax(rng):
    """Out-of-range ids (negative, >= num_segments) and masked rows go to the
    dump segment and keep their own values (ops/math.py:50-56)."""
    vals = rng.standard_normal((200, 4)).astype(np.float32)
    ids = rng.integers(-5, 40, 200).astype(np.int32)
    valid = rng.random(200) > 0.2
    for v in (None, valid):
        ref = jmath.group_average_by_id(jnp.asarray(vals), jnp.asarray(ids), 32,
                                        valid=None if v is None else jnp.asarray(v))
        out = tmath.group_average_by_id(_t(vals), _t(ids), 32, valid=None if v is None else _t(v))
        for x, y in zip(out, ref):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


def test_latent_ids_and_kv_broadcast_match_jax(rng):
    ids = _id_maps(rng)
    for x, y in zip(tcorr.latent_vertex_ids(_t(ids), 5, 7),
                    jcorr.latent_vertex_ids(jnp.asarray(ids), 5, 7)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    k, v = (rng.standard_normal((3, 6, 8)).astype(np.float32) for _ in range(2))
    for frames in ((1,), (2, 0)):
        for x, y in zip(tcorr.broadcast_kv_injection(_t(k), _t(v), frames),
                        jcorr.broadcast_kv_injection(jnp.asarray(k), jnp.asarray(v), frames)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("adain_mode", ["content", "reference"])
def test_vertex_average_injection_matches_jax(rng, adain_mode):
    latent = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ids = _id_maps(rng)
    ref = jcorr.vertex_average_injection(jnp.asarray(latent), jnp.asarray(ids), 0.3,
                                         num_segments=64, adain_mode=adain_mode)
    out = tcorr.vertex_average_injection(_t(latent), _t(ids), 0.3, num_segments=64,
                                         adain_mode=adain_mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not np.allclose(out.numpy(), latent)  # the averaging did something


@pytest.mark.parametrize("sigma_index", [999, 100])
def test_overlap_step_callback_matches_jax(rng, sigma_index):
    """The step callback injects only while the timestep is >= 500."""
    ms = jsched.ModelSampling()
    latent = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ids = _id_maps(rng)
    sigma = np.float32(ms.sigmas[sigma_index])
    jcb = jcorr.OverlapCorresponder(vertex_segments=64, update_corrmap=False).make_step_callback(
        jnp.asarray(ids), jnp.asarray(ms.log_sigmas))
    tcb = tcorr.OverlapCorresponder(vertex_segments=64, update_corrmap=False).make_step_callback(
        _t(ids), torch.from_numpy(ms.log_sigmas))
    ref = jcb(jnp.asarray(latent), None, jnp.asarray(sigma), 0)
    out = tcb(_t(latent), None, torch.tensor(sigma), 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert np.allclose(out.numpy(), latent) == (sigma_index < 500)


def test_pack_arrays_matches_jax(rng):
    h = w = 16
    fields = dict(
        color=rng.random((h, w, 4)).astype(np.float32),
        id=rng.integers(0, 50, (h, w, 4)).astype(np.int32),
        pos=rng.standard_normal((h, w, 3)).astype(np.float32),
        normal_depth=rng.random((h, w, 4)).astype(np.float32),
        noise=rng.standard_normal((h, w, 4)).astype(np.float32),
        canny=(rng.random((h, w, 3)) > 0.5).astype(np.float32),
    )
    fields["color"][4:9, 4:9, 3] = 1.0
    bg = rng.standard_normal((1, h, w, 4)).astype(np.float32)
    ref = j_pack(JGBuffer(**{k: jnp.asarray(v) for k, v in fields.items()}), jnp.asarray(bg))
    out = _pack_arrays(GBuffer(**{k: _t(v) for k, v in fields.items()}), _t(bg))
    assert set(out) == set(ref)
    for name in ref:
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), err_msg=name, **TOL)
