"""The realtime frame's options against the JAX package, on the CPU.

The grouped reductions of ``ops/math.py``, ``vertex_noise``, the three legacy
weightings of ``vertex_average_injection``, ``ops/canny.py`` and the tiny
frame with ``weighting="view_normal"`` and with ``vertex_noise``. Randomness
is passed in: the JAX package's draws (its per-id table, fallback and
background noise) go to the port, which then must give JAX's result exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

AVG_TOL = dict(atol=1e-5, rtol=1e-5)


def _ids(rng, n: int, num_segments: int) -> np.ndarray:
    """Ids with many repeats, a few out of range on both sides."""
    return rng.integers(-2, num_segments + 3, n).astype(np.int32)


def test_group_first_by_id_matches_jax_exactly():
    """The winner is the row of least ``order`` (ties: the lowest row), the
    same on both sides, with a validity mask and out-of-range ids."""
    from stable_renderer_tpu.ops.math import group_first_by_id as j_first

    from stable_renderer_tpu_torch.ops.math import group_first_by_id

    rng = np.random.default_rng(0)
    n, s = 500, 45
    values = rng.standard_normal((n, 3)).astype(np.float32)
    ids = _ids(rng, n, 37)  # ids 37-39 in range: some segments stay empty
    order = rng.integers(0, 60, n).astype(np.int32)  # ties on purpose
    valid = rng.random(n) > 0.2
    for v in (None, valid):
        jr, jw = j_first(jnp.asarray(values), jnp.asarray(ids), jnp.asarray(order), s,
                         valid=None if v is None else jnp.asarray(v))
        r, w = group_first_by_id(torch.from_numpy(values), torch.from_numpy(ids),
                                 torch.from_numpy(order), s,
                                 valid=None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        assert w.dtype == torch.int32 and (w == -1).any() and (w >= 0).any()


def _jax_randn_draws(key, s: int, n: int, c: int):
    """The draws the JAX package's group_randn_by_id makes for ``key``."""
    table = np.array(jax.random.normal(key, (s, c), dtype=jnp.float32))
    fallback = np.array(jax.random.normal(jax.random.fold_in(key, 1), (n, c)))
    return torch.from_numpy(table), torch.from_numpy(fallback)


def test_group_randn_by_id_with_passed_in_table_matches_jax_exactly():
    from stable_renderer_tpu.ops.math import group_randn_by_id as j_randn

    from stable_renderer_tpu_torch.ops.math import group_randn_by_id

    rng = np.random.default_rng(1)
    n, s, c = 400, 50, 4
    ids = _ids(rng, n, s)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(j_randn(key, jnp.asarray(ids), s, c))
    table, fallback = _jax_randn_draws(key, s, n, c)
    out = group_randn_by_id(None, torch.from_numpy(ids), s, c, table=table, fallback=fallback)
    np.testing.assert_array_equal(out.numpy(), ref)
    # from a generator: one value an id, shared by every row of the id
    gen = torch.Generator().manual_seed(0)
    drawn = group_randn_by_id(gen, torch.from_numpy(ids), s, c)
    t = torch.from_numpy(ids)
    for i in (3, 17):
        rows = drawn[t == i]
        assert len(rows) > 1 and torch.equal(rows, rows[:1].expand_as(rows))


def test_grouped_averages_match_jax():
    from stable_renderer_tpu.ops.math import (
        group_frame_distance_average as j_frame,
        group_weighted_average_by_id as j_weighted,
    )

    from stable_renderer_tpu_torch.ops.math import (
        group_frame_distance_average,
        group_weighted_average_by_id,
    )

    rng = np.random.default_rng(2)
    n, s, f = 600, 41, 3
    values = rng.standard_normal((n, 4)).astype(np.float32)
    ids = _ids(rng, n, s)
    weights = rng.random(n).astype(np.float32) + 0.05
    frames = rng.integers(0, f, n).astype(np.int32)
    valid = rng.random(n) > 0.15
    t = torch.from_numpy
    for v in (None, valid):
        jv = None if v is None else jnp.asarray(v)
        tv = None if v is None else t(v)
        np.testing.assert_allclose(
            group_weighted_average_by_id(t(values), t(ids), t(weights), s, valid=tv).numpy(),
            np.asarray(j_weighted(jnp.asarray(values), jnp.asarray(ids), jnp.asarray(weights),
                                  s, valid=jv)), **AVG_TOL)
        np.testing.assert_allclose(
            group_frame_distance_average(t(values), t(ids), t(frames), s, f, valid=tv).numpy(),
            np.asarray(j_frame(jnp.asarray(values), jnp.asarray(ids), jnp.asarray(frames), s, f,
                               valid=jv)), **AVG_TOL)


def _id_maps(rng, b: int, size: int, vertices: int = 40) -> np.ndarray:
    ids = np.zeros((b, size, size, 4), np.int32)
    ids[..., :2] = 1
    ids[..., 2] = rng.integers(0, 9, (b, size, size))
    ids[..., 3] = rng.integers(0, vertices, (b, size, size))  # many pixels share a vertex
    ids[:, :3] = 0  # background rows
    ids[:, -2:, :, 2] = 2048  # NON_AI_MAP_INDEX: not valid either
    return ids


def test_vertex_noise_with_passed_in_draws_matches_jax_exactly():
    from stable_renderer_tpu.ops.correspondence import vertex_noise as j_noise

    from stable_renderer_tpu_torch.ops.correspondence import vertex_noise

    rng = np.random.default_rng(3)
    b, size, h, s = 2, 32, 16, 64
    ids = _id_maps(rng, b, size)
    ids[0, 10, :, 3] = 70  # out of range: the fallback draw
    key = jax.random.PRNGKey(9)
    ref = np.asarray(j_noise(key, jnp.asarray(ids), h, h, 4, num_segments=s))
    table, fallback = _jax_randn_draws(key, s, b * h * h, 4)
    indep = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 7),
                                                        (b * h * h, 4))))
    out = vertex_noise(None, torch.from_numpy(ids), h, h, 4, num_segments=s, table=table,
                       fallback=fallback, indep=indep)
    assert out.shape == (b, h, h, 4)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("weighting", ["average", "frame_distance", "pixel_distance",
                                       "view_normal"])
@pytest.mark.parametrize("adain_mode", ["content", "reference"])
def test_vertex_average_weightings_match_jax(weighting, adain_mode):
    from stable_renderer_tpu.ops.correspondence import vertex_average_injection as j_inject

    from stable_renderer_tpu_torch.ops.correspondence import vertex_average_injection

    rng = np.random.default_rng(4)
    b, size, h = 3, 32, 16
    ids = _id_maps(rng, b, size)
    latent = rng.standard_normal((b, h, h, 4)).astype(np.float32)
    normals = rng.random((b, size, size, 3)).astype(np.float32)
    kw = dict(num_segments=64, weighting=weighting, adain_mode=adain_mode)
    ref = j_inject(jnp.asarray(latent), jnp.asarray(ids), 0.3,
                   normal_maps=jnp.asarray(normals), **kw)
    out = vertex_average_injection(torch.from_numpy(latent), torch.from_numpy(ids), 0.3,
                                   normal_maps=torch.from_numpy(normals), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **AVG_TOL)
    if weighting != "average":  # each scheme is its own mix
        avg = vertex_average_injection(torch.from_numpy(latent), torch.from_numpy(ids), 0.3,
                                       normal_maps=torch.from_numpy(normals),
                                       **dict(kw, weighting="average"))
        assert (out - avg).abs().max() > 1e-4


def _canny_images(rng, n: int, size: int) -> np.ndarray:
    """Smooth shapes with noise: discs and bars of random colours."""
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    imgs = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        img = np.full((size, size, 3), rng.random(3), np.float32)
        for _ in range(4):
            cy, cx, r = rng.uniform(0, size, 2).tolist() + [rng.uniform(4, size / 3)]
            img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.random(3)
            x0 = int(rng.integers(0, size - 8))
            img[:, x0:x0 + 6] = rng.random(3)
        imgs[i] = np.clip(img + rng.normal(0, 0.03, img.shape), 0, 1)
    return imgs


def assert_canny_agrees(out: np.ndarray, ref: np.ndarray, images: np.ndarray, low: float,
                        high: float, max_share: float = 1.0) -> None:
    """Edge maps equal but at pixels that f32 rounding may flip
    (``ops.canny.unstable_pixels``), and those at most ``max_share`` of the
    pixels."""
    from stable_renderer_tpu_torch.ops.canny import unstable_pixels

    assert out.shape == ref.shape == images.shape and set(np.unique(out)) <= {0.0, 1.0}
    differ = (out != ref).any(-1)
    unstable = unstable_pixels(torch.from_numpy(np.asarray(images)), low, high).numpy()
    assert not (differ & ~unstable).any(), np.argwhere(differ & ~unstable)
    assert differ.mean() <= max_share, differ.sum()


def test_canny_matches_jax():
    """Edge maps equal, but for at most 0.1% of the pixels, each of them
    where the normalized gradient lies within 1e-5 of a threshold or of a
    neighbour in the suppression (or next to such a pixel): there the two
    packages' blur and Sobel sums, which differ in the last bits, may decide
    differently."""
    from stable_renderer_tpu.ops.canny import canny as j_canny

    from stable_renderer_tpu_torch.ops.canny import canny

    rng = np.random.default_rng(5)
    imgs = _canny_images(rng, 3, 96)
    for lo, hi in ((0.4, 0.8), (0.1, 0.3)):
        ref = np.asarray(j_canny(jnp.asarray(imgs), low_threshold=lo, high_threshold=hi))
        out = canny(torch.from_numpy(imgs), low_threshold=lo, high_threshold=hi).numpy()
        assert ref[..., 0].sum() > 100  # edges were found
        assert_canny_agrees(out, ref, imgs, lo, hi, max_share=1e-3)


@functools.lru_cache(maxsize=None)
def _pipelines():
    """A tiny JAX pipeline (2 Euler steps, cfg 2) and the port's over the
    same params: Euler draws nothing, so only the starting noise differs
    between the packages' randomness."""
    from test_torch_frame import _port_pipeline

    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(prompt="a ball", steps=2, cfg_scale=2.0, sampler="euler", scheduler="sgm_uniform")
    jpipe = JPipe.from_random(JConfig(**kw), tiny=True, seed=1)
    return jpipe, _port_pipeline(jpipe, RenderConfig(**kw))


def _engine_data(with_noise: bool):
    """Two 32x32 frames of both packages' EngineData, the same arrays."""
    from stable_renderer_tpu.data.engine_data import EngineData as JEngineData
    from stable_renderer_tpu.data.sprite import EnvPrompt as JEnv, Sprite as JSprite

    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite

    n, s = 2, 32
    rng = np.random.default_rng(11)
    arrays = dict(frame_indices=np.arange(n, dtype=np.int32),
                  color_maps=rng.random((n, s, s, 3)).astype(np.float32),
                  normal_maps=rng.random((n, s, s, 3)).astype(np.float32),
                  id_maps=_id_maps(rng, n, s))
    if with_noise:
        arrays["noise_maps"] = rng.standard_normal((n, s // 8, s // 8, 4)).astype(np.float32)
    jed = JEngineData(**{k: jnp.asarray(v) for k, v in arrays.items()},
                      sprite_infos={1: JSprite(spriteID=1, prompt="a shiny ball")},
                      env_prompts=(JEnv("a ball"),))
    ed = EngineData(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                    sprite_infos={1: Sprite(spriteID=1, prompt="a shiny ball")},
                    env_prompts=(EnvPrompt("a ball"),))
    return jed, ed


def test_view_normal_frame_matches_jax():
    """``render`` over two tiny frames with weighting="view_normal": the
    normal maps reach the step callback, and the frame moves from the
    "average" frame."""
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap

    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    jpipe, pipe = _pipelines()
    jed, ed = _engine_data(with_noise=True)
    kw = dict(vertex_segments=64, update_corrmap=False, step_finished_inject_ratio=0.5)
    ref = jpipe.render(jed, corresponder=JOverlap(weighting="view_normal", **kw))
    out = pipe.render(ed, corresponder=OverlapCorresponder(weighting="view_normal", **kw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)
    avg = pipe.render(ed, corresponder=OverlapCorresponder(**kw))
    assert (out - avg).abs().max() > 1e-4


def test_vertex_noise_frame_matches_jax(monkeypatch):
    """``render`` without noise maps and ``RenderConfig.vertex_noise``: the
    starting noise is one draw a vertex; the port's pipeline gets the JAX
    program's draws (key = PRNGKey(seed)) passed into its vertex_noise."""
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap

    from stable_renderer_tpu_torch.engine import pipeline as pipeline_mod
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder, vertex_noise

    jpipe, pipe = _pipelines()
    assert pipe.config.vertex_noise and jpipe.config.vertex_noise
    jed, ed = _engine_data(with_noise=False)
    kw = dict(vertex_segments=64, update_corrmap=False)
    ref = jpipe.render(jed, corresponder=JOverlap(**kw))
    key = jax.random.PRNGKey(jpipe.config.seed)
    n, h, s = 2, 16, 262144  # tiny VAE: 32 / 2; JAX's default segment count
    table, fallback = _jax_randn_draws(key, s, n * h * h, 4)
    indep = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 7),
                                                        (n * h * h, 4))))
    calls = []

    def passed_in(generator, id_maps, height, width, channels=4, **kw_):
        calls.append((height, width, channels))
        return vertex_noise(generator, id_maps, height, width, channels, table=table,
                            fallback=fallback, indep=indep, **kw_)

    monkeypatch.setattr(pipeline_mod, "vertex_noise", passed_in)
    out = pipe.render(ed, corresponder=OverlapCorresponder(**kw))
    assert calls == [(h, h, 4)]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)
    # from the generator, the noise is one draw a vertex in both frames
    monkeypatch.undo()
    gen = torch.Generator().manual_seed(0)
    noise = vertex_noise(gen, ed.id_maps, h, h, 4, num_segments=64)
    vids = ed.id_maps[:, ::2, ::2, 3]
    rows = noise[(vids == 7) & (ed.id_maps[:, ::2, ::2, 2] != 2048) & (ed.id_maps[:, ::2, ::2, 0] != 0)]
    assert len(rows) > 2 and torch.equal(rows, rows[:1].expand_as(rows))
