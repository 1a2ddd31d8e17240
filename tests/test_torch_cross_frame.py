"""All-frames attention (stable_renderer_tpu_torch/parallel/ring_attention.py
and ``OverlapCorresponder(all_frames=True)``) and the host-only modules of the
bake slice (data/spherical_cache.py, utils/media.py, data/loaders.py) against
the JAX package's, on the CPU.

Inputs come from numpy seeds. Tolerances: cross-frame attention 1e-5 (f32);
the denoise through the tiny pipeline 2e-4 (the frame bar of
tests/test_torch_frame.py); the loaders' images exact and their pooled noise
1e-5; the host-only modules exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stable_renderer_tpu.parallel import ring_attention as jra
from stable_renderer_tpu_torch.parallel import ring_attention as pra

torch.set_num_threads(1)

ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
FRAME_TOL = dict(atol=2e-4, rtol=2e-4)


# --- cross_frame_attention ------------------------------------------------------


@pytest.mark.parametrize("n,l,c,heads", [(3, 16, 32, 4), (2, 24, 48, 3), (4, 8, 40, 1)])
def test_cross_frame_attention_matches_jax(n, l, c, heads):
    rng = np.random.default_rng(n * 100 + l)
    q, k, v = (rng.standard_normal((n, l, c)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jra.cross_frame_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               heads))
    out = pra.cross_frame_attention(*(torch.from_numpy(a) for a in (q, k, v)), heads)
    np.testing.assert_allclose(out.numpy(), ref, **ATTN_TOL)
    # the plain version is the CPU route; frames do mix (not per-frame attention)
    np.testing.assert_array_equal(
        pra.cross_frame_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                            heads).numpy(), out.numpy())
    per_frame = pra._mha(*(torch.from_numpy(a) for a in (q, k, v)), heads)
    assert not np.allclose(per_frame.numpy(), ref, atol=1e-3)


def test_cross_frame_attention_fold_equals_dense():
    """The card's route folds the batch into the query sequence: on the CPU
    the fold through attention_pallas's plain path gives the dense answer."""
    from stable_renderer_tpu_torch.ops.flash_attention import attention_pallas

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 16, 32)).astype(np.float32))
               for _ in range(3))
    folded = attention_pallas(q.reshape(1, 48, 32), k.reshape(1, 48, 32), v.reshape(1, 48, 32),
                              4).reshape(3, 16, 32)
    np.testing.assert_allclose(folded.numpy(), pra.cross_frame_attention_reference(
        q, k, v, 4).numpy(), **ATTN_TOL)


def test_ring_form_raises():
    """The ring form takes a torch DeviceMesh (tests/test_torch_mesh.py runs
    it over gloo ranks) and raises for anything else; with no mesh it is one
    rank's ring, the dense function."""
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 4, 8)).astype(np.float32))
    with pytest.raises(TypeError, match="DeviceMesh"):
        pra.ring_cross_frame_attention(x, x, x, 2, object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        OverlapCorresponder(all_frames=True, layer_range=None, mesh=object()).attn_hooks(None)
    np.testing.assert_allclose(pra.ring_cross_frame_attention(x, x, x, 2, None).numpy(),
                               pra.cross_frame_attention(x, x, x, 2).numpy(), **ATTN_TOL)


def test_all_frames_hook_gates_layers():
    """Outside ``layer_range`` the hook is the plain per-frame attention."""
    from stable_renderer_tpu_torch.models.layers import attention
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
               for _ in range(3))
    hooks = OverlapCorresponder(all_frames=True, layer_range=(3,)).attn_hooks(None)
    np.testing.assert_array_equal(hooks.attn(q, k, v, 2, 1).numpy(), attention(q, k, v, 2).numpy())
    np.testing.assert_array_equal(hooks.attn(q, k, v, 2, 3).numpy(),
                                  pra.cross_frame_attention(q, k, v, 2).numpy())


def test_all_frames_denoise_matches_jax():
    """``DiffusionPipeline.render`` of a three-frame EngineData with
    OverlapCorresponder(all_frames=True, layer_range=None): every
    self-attention of the positive rows attends to all frames' K/V, and the
    vertex averaging runs across frames. Euler draws nothing and the noise
    maps give the initial noise, so both packages run on the same inputs."""
    from test_torch_frame import _port_pipeline

    from stable_renderer_tpu.data.engine_data import EngineData as JEngineData
    from stable_renderer_tpu.data.sprite import EnvPrompt as JEnv, Sprite as JSprite
    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig
    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(prompt="a ball", steps=2, cfg_scale=2.0, sampler="euler", scheduler="sgm_uniform")
    jpipe = JPipe.from_random(JConfig(**kw), tiny=True, seed=2)
    pipe = _port_pipeline(jpipe, RenderConfig(**kw))
    n, s = 3, 32
    rng = np.random.default_rng(12)
    ids = np.zeros((n, s, s, 4), np.int32)
    ids[..., :2] = 1
    ids[..., 2] = rng.integers(0, 9, (n, s, s))
    ids[..., 3] = rng.integers(0, 40, (n, s, s))
    ids[:, :4] = 0
    arrays = dict(
        frame_indices=np.arange(n, dtype=np.int32),
        color_maps=rng.random((n, s, s, 3)).astype(np.float32),
        noise_maps=rng.standard_normal((n, s // 8, s // 8, 4)).astype(np.float32),
        normal_maps=rng.random((n, s, s, 3)).astype(np.float32),
        id_maps=ids,
    )
    jed = JEngineData(**{k: jnp.asarray(v) for k, v in arrays.items()},
                      sprite_infos={1: JSprite(spriteID=1, prompt="a shiny ball")},
                      env_prompts=(JEnv("a ball"),))
    ed = EngineData(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                    sprite_infos={1: Sprite(spriteID=1, prompt="a shiny ball")},
                    env_prompts=(EnvPrompt("a ball"),))
    corr_kw = dict(vertex_segments=64, update_corrmap=False, all_frames=True, layer_range=None)
    ref = np.asarray(jpipe.render(jed, corresponder=JOverlap(**corr_kw)))
    out = pipe.render(ed, corresponder=OverlapCorresponder(**corr_kw)).numpy()
    np.testing.assert_allclose(out, ref, **FRAME_TOL)
    # all-frames attention moved the frames: not the per-frame K/V injection
    plain = pipe.render(ed, corresponder=OverlapCorresponder(
        vertex_segments=64, update_corrmap=False, layer_range=None)).numpy()
    assert np.abs(plain - out).max() > 1e-3


# --- spherical_cache --------------------------------------------------------------


def test_spherical_cache_matches_jax():
    from stable_renderer_tpu.data import spherical_cache as jsc
    from stable_renderer_tpu_torch.data import spherical_cache as psc

    rng = np.random.default_rng(7)
    dirs = rng.standard_normal((40, 3))
    queries = rng.standard_normal((30, 3))
    caches = (psc.SphereCache(angle_threshold=25.0), jsc.SphereCache(angle_threshold=25.0))
    for i, d in enumerate(dirs):
        assert caches[0].put(d, i) == caches[1].put(d, i)
    assert len(caches[0]) == len(caches[1])
    for d in queries:
        assert caches[0].get(d) == caches[1].get(d)
    assert [(v.theta, v.phi) for v in caches[0].view_points] == [
        (v.theta, v.phi) for v in caches[1].view_points]
    for d in dirs[:5]:
        p, j = psc.ViewPoint.from_direction(d), jsc.ViewPoint.from_direction(d)
        assert (p.theta, p.phi) == (j.theta, j.phi)
        np.testing.assert_array_equal(p.direction(), j.direction())
        assert p.angle_to(psc.ViewPoint(30.0, 60.0)) == j.angle_to(jsc.ViewPoint(30.0, 60.0))


# --- media -------------------------------------------------------------------------


def test_media_matches_jax(tmp_path):
    from stable_renderer_tpu.utils import media as jm
    from stable_renderer_tpu_torch.utils import media as pm

    rng = np.random.default_rng(8)
    rgba = rng.random((6, 5, 4)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(pm.to_uint8(rgba), jm.to_uint8(rgba))
    np.testing.assert_array_equal(pm.rgba_to_rgb(rgba, (0.2, 0.3, 0.4)),
                                  jm.rgba_to_rgb(rgba, (0.2, 0.3, 0.4)))
    np.testing.assert_array_equal(pm.rgba_to_rgb(rgba[..., :3]), jm.rgba_to_rgb(rgba[..., :3]))
    np.testing.assert_array_equal(pm.rgba_threshold(rgba, 0.3), jm.rgba_threshold(rgba, 0.3))
    assert pm.text_concat("a", "", "b", sep="; ") == jm.text_concat("a", "", "b", sep="; ")
    assert pm.text_replace("a red ball", "red", "blue") == jm.text_replace("a red ball", "red",
                                                                            "blue")
    frames = [rng.random((8, 8, 4)).astype(np.float32) for _ in range(3)]
    for mod, sub in ((pm, "port"), (jm, "jax")):
        mod.write_gif(frames, tmp_path / f"{sub}.gif", fps=4.0)
        mod.write_png_sequence(frames, tmp_path / sub, stem="f")
    with Image.open(tmp_path / "port.gif") as a, Image.open(tmp_path / "jax.gif") as b:
        assert a.n_frames == b.n_frames == 3
        assert a.info["duration"] == b.info["duration"] == 250
    for i in range(3):
        a = np.asarray(Image.open(tmp_path / "port" / f"f_{i}.png"))
        np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path / "jax" / f"f_{i}.png")))
        np.testing.assert_array_equal(a, pm.to_uint8(frames[i])[..., :3])
    with pytest.raises(ValueError):
        pm.write_gif([], tmp_path / "none.gif")
    try:
        import rembg  # noqa: F401
    except ImportError:
        for mod in (pm, jm):
            with pytest.raises(ImportError, match="rembg"):
                mod.remove_bg(rgba)


# --- loaders -----------------------------------------------------------------------


def _dumps(tmp_path, n: int = 3, h: int = 16, w: int = 16):
    """Map-output directories as the engine writes them (color/*.png,
    normal/*.png, id/*.npy, noise/*.npy), indices out of listing order."""
    rng = np.random.default_rng(9)
    for sub in ("color", "normal", "id", "noise"):
        (tmp_path / sub).mkdir()
    for i in (10, 2, 5)[:n]:
        for sub in ("color", "normal"):
            img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / sub / f"{sub}_{i}.png")
        ids = np.zeros((h, w, 4), np.int32)
        ids[4:12, 4:12] = [1, 1, 2, i]
        np.save(tmp_path / "id" / f"id_{i}.npy", ids)
        np.save(tmp_path / "noise" / f"noise_{i}.npy",
                rng.standard_normal((h, w, 4)).astype(np.float32))
    return tmp_path


def test_loaders_match_jax(tmp_path):
    from stable_renderer_tpu.data import loaders as jl
    from stable_renderer_tpu_torch.data import loaders as pl

    d = _dumps(tmp_path)
    for kw in ({}, {"frame_start": 1, "num_frames": 1}):
        np.testing.assert_array_equal(pl.load_image_sequence(d / "color", **kw),
                                      jl.load_image_sequence(d / "color", **kw))
        np.testing.assert_allclose(pl.load_noise_sequence(d / "noise", **kw),
                                   jl.load_noise_sequence(d / "noise", **kw), **ATTN_TOL)
        p_ids, j_ids = pl.load_id_sequence(d / "id", **kw), jl.load_id_sequence(d / "id", **kw)
        assert p_ids.frame_indices == j_ids.frame_indices
        np.testing.assert_array_equal(p_ids.tensor.numpy(), np.asarray(j_ids.tensor))
    with pytest.raises(ValueError):
        pl.load_image_sequence(d / "id")
    dirs = dict(color_dir=d / "color", id_dir=d / "id", noise_dir=d / "noise",
                normal_dir=d / "normal", prompt="a beach")
    ped = pl.virtual_engine_data(device="cpu", **dirs)
    jed = jl.virtual_engine_data(**dirs)
    assert ped.frame_count == jed.frame_count == 3
    assert ped.env_prompts[0].prompt == jed.env_prompts[0].prompt == "a beach"
    for name in ("color_maps", "id_maps", "masks", "normal_maps", "frame_indices"):
        np.testing.assert_array_equal(getattr(ped, name).numpy(),
                                      np.asarray(getattr(jed, name)), err_msg=name)
    np.testing.assert_allclose(ped.noise_maps.numpy(), np.asarray(jed.noise_maps), **ATTN_TOL)
    assert ped.depth_maps is None and ped.color_maps.device.type == "cpu"
    with pytest.raises(ValueError):
        pl.virtual_engine_data(device="cpu")
