"""The port's progress callback and latent preview
(``models/sampling/preview.py``) against the JAX package's, on the CPU."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)


def test_latent2rgb_matches_jax():
    from stable_renderer_tpu.models.sampling.preview import latent2rgb as j_latent2rgb

    from stable_renderer_tpu_torch.models.sampling.preview import latent2rgb

    z = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(np.float32) * 2.0
    ref = np.asarray(j_latent2rgb(jnp.asarray(z)))
    out = latent2rgb(torch.from_numpy(z))
    assert out.shape == (2, 8, 8, 3) and out.dtype == torch.float32
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0
    assert (out == 0).any() and (out == 1).any()  # the clamp is exercised
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    bf = latent2rgb(torch.from_numpy(z).to(torch.bfloat16))
    assert bf.dtype == torch.float32


def test_progress_callback_reports_each_step_after_the_inner_callback():
    """``on_step(i, total, preview)`` once a step, with the preview of that
    step's denoised latent (a host numpy array) after the inner callback
    ran; the sampler's result is the inner callback's."""
    from stable_renderer_tpu_torch.models.sampling import ModelSampling, calculate_sigmas, sample
    from stable_renderer_tpu_torch.models.sampling.preview import (
        latent2rgb,
        progress_step_callback,
    )

    calls = []
    target = torch.full((1, 8, 8, 4), 0.3)

    def inner(x, denoised, sigma, i):
        calls.append(("inner", i))
        return x + 1.0

    def on_step(i, total, preview):
        calls.append(("report", i, total, preview))

    sigmas = torch.as_tensor(calculate_sigmas(ModelSampling(), "sgm_uniform", 4),
                             dtype=torch.float32)
    cb = progress_step_callback(on_step, total_steps=4, preview=True, inner=inner)
    out = sample(lambda x, s: target, torch.zeros_like(target), sigmas, sampler="euler",
                 step_callback=cb)
    plain = sample(lambda x, s: target, torch.zeros_like(target), sigmas, sampler="euler",
                   step_callback=inner)
    assert [c[:2] for c in calls[:8]] == [("inner", 0), ("report", 0), ("inner", 1),
                                          ("report", 1), ("inner", 2), ("report", 2),
                                          ("inner", 3), ("report", 3)]
    reports = [c for c in calls if c[0] == "report"]
    assert all(c[2] == 4 for c in reports)
    for c in reports:
        assert isinstance(c[3], np.ndarray) and c[3].shape == (1, 8, 8, 3)
        np.testing.assert_allclose(c[3], latent2rgb(target).numpy())
    torch.testing.assert_close(out, plain)
    # no preview: None handed over; no inner callback: x unchanged
    seen = []
    cb = progress_step_callback(lambda i, t, p: seen.append((i, p)), 4, preview=False)
    x = torch.ones(1, 2, 2, 4)
    assert cb(x, x, 1.0, 2) is x and seen == [(2, None)]


def test_console_progress(capsys):
    from stable_renderer_tpu_torch.models.sampling.preview import ConsoleProgress

    bar = ConsoleProgress("frame")
    for i in range(3):
        bar(i, 3, None)
    err = capsys.readouterr().err
    assert "frame: 1/3 [ 33%]" in err and "frame: 3/3 [100%]\n" in err
