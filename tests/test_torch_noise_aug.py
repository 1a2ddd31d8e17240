"""The port's models/noise_aug.py against the JAX package's, on the CPU.

The beta schedules are float64 numpy in both packages and agree bit for bit.
The draws are JAX's, passed in: ``q_sample`` and ``augment`` take JAX's
``normal(key, shape)``, ``unclip_adm`` one ``normal(fold_in(key, i), (1, D))``
a row and ``normal(fold_in(key, 10_000), (1, D))`` for the merge. The
augmented vectors then agree within TOL (f32: the timestep embedding's sin
and cos of arguments up to 1000, a few ulps apart).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stable_renderer_tpu.models.noise_aug as jna
import stable_renderer_tpu_torch.models.noise_aug as pna

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
RNG = np.random.default_rng(21)


def jnormal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape)))


def jax_aug_noise(monkeypatch):
    """Wrap the port's noise_aug so that its draws from a generator seeded
    with s are JAX's for PRNGKey(s), as the JAX executor's KSampler draws
    them: ``q_sample``'s ``normal(key, shape)``, and ``unclip_adm``'s
    ``normal(fold_in(key, i), (1, D))`` a row and ``fold_in(key, 10_000)``
    for the merge. The executor looks both up at call time."""
    real_adm, real_q = pna.unclip_adm, pna.NoiseAugmentor.q_sample

    def adm(entries, augmentor, generator=None, noise_augment_merge=0.05, noise=None):
        if noise is None and generator is not None and entries:
            key = jax.random.PRNGKey(generator.initial_seed())
            rows = sum(1 if torch.as_tensor(e["embeds"]).dim() == 1
                       else torch.as_tensor(e["embeds"]).shape[0] for e in entries)
            d = augmentor.timestep_dim
            noise = [jnormal(jax.random.fold_in(key, i), (1, d)) for i in range(rows)]
            if rows > 1:
                noise.append(jnormal(jax.random.fold_in(key, 10_000), (1, d)))
        return real_adm(entries, augmentor, generator, noise_augment_merge, noise)

    def q_sample(self, x, noise_level, generator=None, noise=None):
        if noise is None and generator is not None:
            noise = jnormal(jax.random.PRNGKey(generator.initial_seed()), tuple(x.shape))
        return real_q(self, x, noise_level, generator, noise)

    monkeypatch.setattr(pna, "unclip_adm", adm)
    monkeypatch.setattr(pna.NoiseAugmentor, "q_sample", q_sample)


@pytest.mark.parametrize("fn, args", [
    ("betas_squaredcos_cap_v2", ()), ("betas_squaredcos_cap_v2", (500, 0.5)),
    ("betas_linear", ()), ("betas_linear", (1000, 1e-4, 2e-2)), ("betas_linear", (300, 1e-3, 1e-2)),
])
def test_beta_schedules_bit_for_bit(fn, args):
    got, want = getattr(pna, fn)(*args), getattr(jna, fn)(*args)
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("schedule, max_level", [("squaredcos_cap_v2", 1000), ("linear", 350)])
def test_tables_bit_for_bit(schedule, max_level):
    kw = dict(timestep_dim=8, max_noise_level=max_level, schedule=schedule)
    p, j = pna.NoiseAugmentor(**kw), jna.NoiseAugmentor(**kw)
    assert p.sqrt_alphas_cumprod.tobytes() == j.sqrt_alphas_cumprod.tobytes()
    assert (p.sqrt_one_minus_alphas_cumprod.tobytes()
            == j.sqrt_one_minus_alphas_cumprod.tobytes())


@pytest.mark.parametrize("level", [0, 35, 349, 2000])
def test_q_sample_matches_jax(level):
    """The x4 upscaler's image augmentation (linear schedule): JAX's draw."""
    aug_p = pna.NoiseAugmentor(timestep_dim=1, max_noise_level=350, schedule="linear")
    aug_j = jna.NoiseAugmentor(timestep_dim=1, max_noise_level=350, schedule="linear")
    x = RNG.uniform(size=(1, 6, 5, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(aug_j.q_sample(jnp.asarray(x), level, key))
    got = aug_p.q_sample(torch.from_numpy(x), level, noise=jnormal(key, x.shape))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_q_sample_draws_from_the_generator():
    aug = pna.NoiseAugmentor(timestep_dim=4)
    x = torch.zeros(2, 4)
    a = aug.q_sample(x, 500, torch.Generator().manual_seed(1))
    b = aug.q_sample(x, 500, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and float(a.abs().max()) > 0


@pytest.mark.parametrize("level", [0, 99, 999])
def test_augment_matches_jax(level):
    d = 16
    p, j = pna.NoiseAugmentor(timestep_dim=d), jna.NoiseAugmentor(timestep_dim=d)
    embed = RNG.standard_normal((d,)).astype(np.float32)  # 1-d: one row
    key = jax.random.PRNGKey(level)
    zj, lj = j.augment(jnp.asarray(embed), level, key)
    zp, lp = p.augment(torch.from_numpy(embed), level, noise=jnormal(key, (1, d)))
    assert tuple(zp.shape) == tuple(lp.shape) == (1, d)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), **TOL)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)


def _entries(pack, specs, d):
    return [{"embeds": pack(e), "strength": s, "noise_augmentation": a} for e, s, a in specs]


@pytest.mark.parametrize("rows", [(1,), (1, 1, 1), (2, 1)])
def test_unclip_adm_matches_jax(rows):
    """One entry, three entries (the merge path, re-augmented at 0.05 and
    the level embedding discarded), and a two-row entry beside another."""
    d = 32
    specs = [(RNG.standard_normal((n, d) if n > 1 else (d,)).astype(np.float32),
              float(RNG.uniform(0.3, 1.5)), float(RNG.uniform(0.0, 0.4))) for n in rows]
    aug_p, aug_j = pna.NoiseAugmentor(timestep_dim=d), jna.NoiseAugmentor(timestep_dim=d)
    key = jax.random.PRNGKey(abs(7 - 10))  # the KSampler's key for seed 7
    want = np.asarray(jna.unclip_adm(_entries(jnp.asarray, specs, d), aug_j, key))
    n_rows = sum(rows)
    draws = [jnormal(jax.random.fold_in(key, i), (1, d)) for i in range(n_rows)]
    if n_rows > 1:
        draws.append(jnormal(jax.random.fold_in(key, 10_000), (1, d)))
    got = pna.unclip_adm(_entries(torch.from_numpy, specs, d), aug_p, noise=draws)
    assert tuple(got.shape) == want.shape == (1, 2 * d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_unclip_adm_empty_and_generator():
    aug = pna.NoiseAugmentor(timestep_dim=8)
    assert pna.unclip_adm([], aug) is None
    e = [{"embeds": torch.ones(8), "strength": 1.0, "noise_augmentation": 0.5}] * 2
    a = pna.unclip_adm(e, aug, torch.Generator().manual_seed(4))
    b = pna.unclip_adm(e, aug, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.shape == (1, 16)
