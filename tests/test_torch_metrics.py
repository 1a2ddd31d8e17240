"""The port's metrics (``ops/metrics.py``) against the JAX package's, on the
CPU: every metric within 1e-5 relative on the same seeded frames, id maps and
(for LPIPS) the same random VGG16 + linear-head flat dict."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REL = dict(rtol=1e-5, atol=0.0)


def _frames(n: int = 4, size: int = 32, seed: int = 0) -> np.ndarray:
    """Frames that flicker a little around a shared image."""
    rng = np.random.default_rng(seed)
    base = rng.random((1, size, size, 3)).astype(np.float32)
    return np.clip(base + rng.normal(0, 0.1, (n, size, size, 3)), 0, 1).astype(np.float32)


def _id_maps(n: int = 4, size: int = 32, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = np.zeros((n, size, size, 4), np.int32)
    ids[..., :2] = 1
    ids[..., 2] = rng.integers(0, 9, (n, size, size))
    ids[..., 3] = rng.integers(0, 60, (n, size, size))
    ids[:, :5] = 0  # background rows: not counted
    return ids


@pytest.mark.parametrize("name", ["temporal_flicker_l1", "temporal_flicker_ssim", "ssim",
                                  "ssim_hwc", "vertex_flicker"])
def test_metric_matches_jax(name):
    from stable_renderer_tpu.ops import metrics as jm

    from stable_renderer_tpu_torch.ops import metrics as tm

    f = _frames()
    t = torch.from_numpy
    if name == "vertex_flicker":
        ids = _id_maps()
        ref = jm.vertex_flicker(jnp.asarray(f), jnp.asarray(ids), num_segments=64)
        out = tm.vertex_flicker(t(f), t(ids), num_segments=64)
    elif name == "ssim":
        ref, out = jm.ssim(jnp.asarray(f[:2]), jnp.asarray(f[2:])), tm.ssim(t(f[:2]), t(f[2:]))
    elif name == "ssim_hwc":
        ref, out = jm.ssim(jnp.asarray(f[0]), jnp.asarray(f[1])), tm.ssim(t(f[0]), t(f[1]))
    else:
        ref, out = getattr(jm, name)(jnp.asarray(f)), getattr(tm, name)(t(f))
    assert out.dim() == 0 and out.dtype == torch.float32 and float(out) > 0
    np.testing.assert_allclose(float(out), float(ref), **REL)


def test_stable_sequences_score_zero():
    from stable_renderer_tpu_torch.ops import metrics as tm

    still = torch.from_numpy(np.repeat(_frames(1), 3, axis=0))
    ids = np.repeat(_id_maps(1), 3, axis=0)
    ids[..., 3] = np.arange(32 * 32).reshape(32, 32)  # a vertex a pixel, in every frame
    assert float(tm.temporal_flicker_l1(still)) == 0.0
    assert abs(float(tm.temporal_flicker_ssim(still))) < 1e-6
    assert float(tm.vertex_flicker(still, torch.from_numpy(ids), num_segments=1024)) < 1e-6


@functools.lru_cache(maxsize=None)
def _lpips_flat(seed: int = 0) -> dict:
    """A random flat dict in the VGG16 + LPIPS key layout (He-scaled convs,
    positive linear heads)."""
    rng = np.random.default_rng(seed)
    chans = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    idxs = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    flat, in_c = {}, 3
    for i, o in zip(idxs, chans):
        flat[f"features.{i}.weight"] = (rng.normal(size=(o, in_c, 3, 3))
                                        * np.sqrt(2.0 / (9 * in_c))).astype(np.float32)
        flat[f"features.{i}.bias"] = (rng.normal(size=o) * 0.01).astype(np.float32)
        in_c = o
    for k, c in enumerate((64, 128, 256, 512, 512)):
        flat[f"lin{k}.model.1.weight"] = np.abs(rng.normal(size=(1, c, 1, 1))).astype(np.float32)
    return flat


def test_lpips_matches_jax():
    """LPIPS per pair and LPIPS flicker at 32x32, the flat dict given as
    numpy arrays to both; identical frames score 0."""
    from stable_renderer_tpu.ops.metrics import lpips as j_lpips, lpips_flicker as j_flicker

    from stable_renderer_tpu_torch.ops.metrics import lpips, lpips_flicker

    flat = _lpips_flat()
    f = _frames(n=4)
    a, b = f[:2], f[2:]
    ref = np.asarray(j_lpips(flat, jnp.asarray(a), jnp.asarray(b)))
    out = lpips(flat, torch.from_numpy(a), torch.from_numpy(b))
    assert out.shape == (2,) and (out > 0).all()
    np.testing.assert_allclose(out.numpy(), ref, **REL)
    np.testing.assert_allclose(float(lpips_flicker(torch.from_numpy(f), flat)),
                               float(j_flicker(jnp.asarray(f), flat)), **REL)
    assert float(lpips(flat, torch.from_numpy(a), torch.from_numpy(a)).abs().max()) < 1e-6
