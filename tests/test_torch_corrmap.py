"""The port's id maps and CorrespondMap (stable_renderer_tpu_torch/data/
idmap.py and corrmap.py) against the JAX package's, on the CPU.

Inputs come from numpy seeds; both packages get the same arrays. Tolerances:
ids, masks, ``written`` and the ``first`` / ``replace`` modes' values exact;
the ``_avg`` modes' values within 1e-6 (sums of a few f32 colors whose order
of additions is the backends' own); dump/Load exact on the uint8 grid.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_renderer_tpu.data import corrmap as jcm
from stable_renderer_tpu.data import idmap as jid
from stable_renderer_tpu_torch.data import corrmap as pcm
from stable_renderer_tpu_torch.data import idmap as pid

torch.set_num_threads(1)

AVG_TOL = 1e-6
K = 2            # 4 view bins
MAP = 8          # 8x8 map: 64 cells a bin
H = W = 16       # frame


def _ids(seed: int, n: int = 1) -> np.ndarray:
    """(n, H, W, 4) int32 id maps with collisions: sprites and materials in
    {1, 2}, map indices in [-1, K*K] plus the non-AI sentinel, vertex ids in
    [-1, MAP*MAP + 3], and all-zero background."""
    rng = np.random.default_rng(seed)
    ids = np.stack([
        rng.integers(1, 3, (n, H, W)),
        rng.integers(1, 3, (n, H, W)),
        rng.choice([-1, 0, 1, 2, 3, 4, 2048], (n, H, W), p=[.05, .25, .2, .2, .2, .05, .05]),
        rng.integers(-1, MAP * MAP + 4, (n, H, W)) // 3,  # about 3 pixels a cell
    ], -1).astype(np.int32)
    ids[rng.random((n, H, W)) < 0.15] = 0
    return ids


def _map_state(seed: int, c: int = 4):
    rng = np.random.default_rng(seed)
    values = rng.random((K * K, MAP * MAP, c)).astype(np.float32)
    written = rng.random((K * K, MAP * MAP)) < 0.3
    return values, written


def _pt(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# --- idmap -------------------------------------------------------------------


def test_idmap_functions_match_jax():
    ids = _ids(0, n=2)
    frames = np.array([3, 7], np.int32)
    np.testing.assert_array_equal(pid.id_masks(_pt(ids)).numpy(),
                                  np.asarray(jid.id_masks(jnp.asarray(ids))))
    info, valid = pid.vertex_screen_info(_pt(ids), _pt(frames))
    jinfo, jvalid = jid.vertex_screen_info(jnp.asarray(ids), jnp.asarray(frames))
    np.testing.assert_array_equal(info.numpy(), np.asarray(jinfo))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    vid, fvalid = pid.flat_correspondence(_pt(ids))
    jvid, jfvalid = jid.flat_correspondence(jnp.asarray(ids))
    np.testing.assert_array_equal(vid.numpy(), np.asarray(jvid))
    np.testing.assert_array_equal(fvalid.numpy(), np.asarray(jfvalid))


def test_idmap_non_square_ratios_match_jax():
    """The reference's swapped ratios (x / height, y / width) on a 6x10 map."""
    ids = np.ones((1, 6, 10, 4), np.int32)
    info, _ = pid.vertex_screen_info(_pt(ids), torch.tensor([0]))
    jinfo, _ = jid.vertex_screen_info(jnp.asarray(ids), jnp.asarray([0]))
    np.testing.assert_array_equal(info.numpy(), np.asarray(jinfo))
    assert info[9, 4].item() == 9 / 6  # x = 9 over the height


def test_idmap_wrapper_matches_jax(tmp_path):
    ids = _ids(1, n=3)
    for i, f in zip((12, 2, 7), ids):
        # frame 7 dumped channels-first, as some of the reference's dumps are
        np.save(tmp_path / f"id_{i}.npy", np.moveaxis(f, -1, 0) if i == 7 else f)
    for kw in ({}, {"frame_start": 1, "num_frames": 1},
               {"use_frame_indices_from_filename": False}):
        m = pid.IDMap.from_directory(tmp_path, **kw)
        j = jid.IDMap.from_directory(tmp_path, **kw)
        assert m.frame_indices == j.frame_indices
        assert (m.height, m.width, len(m), m.frame_count) == (j.height, j.width, len(j),
                                                               j.frame_count)
        np.testing.assert_array_equal(m.tensor.numpy(), np.asarray(j.tensor))
        np.testing.assert_array_equal(m.masks.numpy(), np.asarray(j.masks))
        np.testing.assert_array_equal(m[0].numpy(), np.asarray(j[0]))
        for a, b in zip(m.create_vertex_screen_info(), j.create_vertex_screen_info()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    m = pid.IDMap.from_tensor([5], _pt(ids[0]))
    assert m.frame_indices == [5] and tuple(m.tensor.shape) == (1, H, W, 4)
    with pytest.raises(ValueError):
        pid.IDMap(tensor=torch.zeros((2, 4, 4, 3), dtype=torch.int32))


# --- corrmap_update -------------------------------------------------------------

_VARIANTS = ("no_mask", "mask", "inverse_mask", "sprite_material", "ignore_obj_mat_id", "rgb")


@pytest.mark.parametrize("variant", _VARIANTS)
@pytest.mark.parametrize("mode", pcm._MODES)
def test_corrmap_update_matches_jax(mode, variant):
    """One frame's scatter in both packages: ``written`` exact; values exact
    in first / replace, within AVG_TOL in the _avg modes."""
    values, written = _map_state(10)
    ids = _ids(11)[0]
    rng = np.random.default_rng(12)
    color = rng.random((H, W, 3 if variant == "rgb" else 4)).astype(np.float32)
    mask = (rng.random((H, W)) < 0.6).astype(np.float32)
    kw = {}
    if variant == "mask":
        kw["mask"] = mask
    elif variant == "inverse_mask":  # CorrespondMap.update's inverse_masks
        kw["mask"] = 1.0 - mask
    elif variant in ("sprite_material", "ignore_obj_mat_id"):
        kw.update(sprite_id=1, material_id=2, ignore_obj_mat_id=variant == "ignore_obj_mat_id")
    pv, pw = pcm.corrmap_update(
        _pt(values), _pt(written), _pt(color), _pt(ids), mode=mode,
        **{k: _pt(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    for name in ("sprite_id", "material_id"):
        if name in jkw:
            jkw[name] = jnp.int32(jkw[name])
    jv, jw = jcm.corrmap_update(jnp.asarray(values), jnp.asarray(written), jnp.asarray(color),
                                jnp.asarray(ids), mode=mode, num_bins=K * K, **jkw)
    assert pv.dtype == torch.float32 and pw.dtype == torch.bool
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    assert pw.sum() > torch.from_numpy(written).sum()  # the frame wrote cells
    if mode.endswith("_avg"):
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=AVG_TOL, rtol=0)
    else:
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_correspond_map_update_frames_match_jax():
    """CorrespondMap.update over 3 frames with id_masks inverted, as the
    bake's DefaultCorresponder calls it, in each mode."""
    ids = _ids(20, n=3)
    color = np.random.default_rng(21).random((3, H, W, 4)).astype(np.float32)
    for mode in pcm._MODES:
        m = pcm.CorrespondMap(k=K, height=MAP, width=MAP, device="cpu")
        j = jcm.CorrespondMap(k=K, height=MAP, width=MAP)
        m.update(_pt(color), _pt(ids), spriteID=1, materialID=1, mode=mode,
                 masks=pid.id_masks(_pt(ids)), inverse_masks=True)
        j.update(jnp.asarray(color), jnp.asarray(ids), spriteID=1, materialID=1, mode=mode,
                 masks=jid.id_masks(jnp.asarray(ids)), inverse_masks=True)
        np.testing.assert_array_equal(m.written.numpy(), np.asarray(j.written))
        tol = AVG_TOL if mode.endswith("_avg") else 0.0
        np.testing.assert_allclose(m.values.numpy(), np.asarray(j.values), atol=tol, rtol=0)
        assert m.written.any()
        for i in range(K * K):
            np.testing.assert_array_equal(m.get_map(i).numpy(), np.asarray(j.get_map(i)))
            np.testing.assert_array_equal(m.get_written_flag_map(i).numpy(),
                                          np.asarray(j.get_written_flag_map(i)))
    m.clear()
    assert not m.written.any() and not m.values.any()


def test_sharded_forms_raise():
    """The sharded forms take a torch DeviceMesh (tests/test_torch_mesh.py
    runs them over gloo ranks) and raise for anything else."""
    m = pcm.CorrespondMap(k=K, height=MAP, width=MAP, device="cpu")
    frames = torch.zeros((2, 4, 4, 3))
    ids = torch.zeros((2, 4, 4, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="DeviceMesh"):
        m.update_batch(frames, ids, object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        pcm.corrmap_update_sharded(m.values, m.written, frames, ids, object())
    with pytest.raises(ValueError, match="mode"):
        pcm.corrmap_update_sharded(m.values, m.written, frames, ids, None, mode="last")


# --- dump / Load ------------------------------------------------------------------


def _baked(seed: int, height: int = MAP, width: int = MAP):
    rng = np.random.default_rng(seed)
    values = rng.random((K * K, height * width, 4)).astype(np.float32)
    written = rng.random((K * K, height * width)) < 0.5
    return values, written


def _quantized(values: np.ndarray) -> np.ndarray:
    return np.clip(255.0 * values, 0, 255).astype(np.uint8).astype(np.float32) / 255.0


@pytest.mark.parametrize("zip_", [False, True])
def test_dump_load_round_trip(tmp_path, zip_):
    """A non-square map through dump and Load: values on the uint8 grid
    (truncated), written exact, meta kept; a second dump without force
    gets a fresh name."""
    values, written = _baked(30, 6, 10)
    m = pcm.CorrespondMap.from_numpy(values, written, k=K, height=6, width=10, name="ball",
                                     device="cpu")
    path = m.dump(tmp_path, zip=zip_)
    assert path.endswith("ball.zip" if zip_ else "ball")
    assert m.dump(tmp_path, zip=zip_).endswith("ball_1.zip" if zip_ else "ball_1")
    back = pcm.CorrespondMap.Load(path, device="cpu")
    assert (back.name, back.k, back.height, back.width, back.channel_count) == (
        "ball", K, 6, 10, 4)
    assert back.values.device.type == "cpu"
    np.testing.assert_array_equal(back.values.numpy(), _quantized(values))
    np.testing.assert_array_equal(back.written.numpy(), written)


@pytest.mark.parametrize("zip_", [False, True])
def test_dump_interchange_with_jax(tmp_path, zip_):
    """A map dumped by JAX loads in the port, and a port dump loads in JAX,
    to the same arrays; both dumps hold the same PNG pixels."""
    from PIL import Image

    values, written = _baked(40)
    j = jcm.CorrespondMap(name="j", k=K, height=MAP, width=MAP, values=jnp.asarray(values),
                          written=jnp.asarray(written))
    m = pcm.CorrespondMap.from_numpy(values, written, name="p", device="cpu")
    jpath = j.dump(tmp_path / "jax", zip=zip_)
    ppath = m.dump(tmp_path / "port", zip=zip_)
    from_jax = pcm.CorrespondMap.Load(jpath, device="cpu")
    from_port = jcm.CorrespondMap.Load(ppath)
    for a, b in ((from_jax.values.numpy(), np.asarray(from_port.values)),
                 (from_jax.written.numpy(), np.asarray(from_port.written))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(from_jax.values.numpy(), _quantized(values))
    if not zip_:
        for i in range(K * K):
            for f in (f"{i}.png", f"{i}_written.png"):
                a, b = Image.open(tmp_path / "jax" / "j" / f), Image.open(tmp_path / "port" / "p" / f)
                assert a.mode == b.mode
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_from_numpy_takes_a_jax_map():
    values, written = _baked(50)
    j = jcm.CorrespondMap(k=K, height=MAP, width=MAP, values=jnp.asarray(values),
                          written=jnp.asarray(written))
    m = pcm.CorrespondMap.from_numpy(np.asarray(j.values), np.asarray(j.written), device="cpu")
    assert (m.k, m.height, m.width, m.channel_count) == (K, MAP, MAP, 4)
    np.testing.assert_array_equal(m.values.numpy(), values)
    np.testing.assert_array_equal(m.written.numpy(), written)
    with pytest.raises(ValueError):
        pcm.CorrespondMap.from_numpy(values, written[:, :5], device="cpu")
