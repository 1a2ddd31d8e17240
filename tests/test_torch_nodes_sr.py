"""The port's stable-rendering node pack (workflow/nodes_sr.py) against the
JAX package's, node by node on the CPU, from files written under
``tmp_path``: the sequence loaders and their legacy forms, the two noise
nodes (with JAX's draws handed to ``noise_from_id_map`` /
``identical_noise``), VirtualEngineDataNode, RGBA to RGB, RGBA threshold,
RemoveBGNode, TextConcat, TextReplace and SimpleVideoCombine (outputs under
``tmp_path``). f32: TOL."""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stable_renderer_tpu.workflow.executor as je
import stable_renderer_tpu_torch.workflow.executor as pe
import stable_renderer_tpu_torch.workflow.nodes_sr as psr

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)


class _N:
    def __init__(self, type, widgets=None):
        self.type, self.widgets, self.id, self.inputs = type, list(widgets or []), 1, {}


def run_both(name, widgets=(), **inputs):
    """The node in both packages: (JAX's outputs, the port's). Inputs are
    numpy arrays (converted per package) or package pairs (jax, port)."""
    def conv(v, jax_side):
        if isinstance(v, tuple) and len(v) == 2 and not isinstance(v[0], (int, float)):
            return v[0] if jax_side else v[1]
        if isinstance(v, np.ndarray):
            return jnp.asarray(v) if jax_side else torch.from_numpy(v.copy())
        return v

    jctx = je.InferenceContext(model_dirs=(), jit_cache={})
    pctx = pe.InferenceContext(model_dirs=(), device=torch.device("cpu"))
    ref = je.NODE_REGISTRY[name](jctx, _N(name, widgets),
                                 **{k: conv(v, True) for k, v in inputs.items()})
    out = pe.NODE_REGISTRY[name](pctx, _N(name, widgets),
                                 **{k: conv(v, False) for k, v in inputs.items()})
    return ref, out, jctx, pctx


def close(out, ref, **tol):
    if isinstance(ref, dict):
        assert sorted(out) == sorted(ref)
        for k in ref:
            close(out[k], ref[k], **tol)
        return
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **(tol or TOL))


def _write_images(d: Path, n=3, size=64, mode="RGB", seed=0):
    from PIL import Image

    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    ch = 4 if mode == "RGBA" else 3
    for i in range(n):
        Image.fromarray((rng.uniform(size=(size, size, ch)) * 255).astype(np.uint8),
                        mode).save(d / f"frame_{i}.png")
    return sorted(str(p) for p in d.glob("*.png"))


def test_image_sequence_loader_matches_jax(tmp_path):
    _write_images(tmp_path / "seq", n=4)
    for widgets, inputs in (([str(tmp_path / "seq"), 1, 2, "SD15"], {}),
                            ([0, 3, "SD15"], {"directory": str(tmp_path / "seq")})):
        (ref,), (out,), _, _ = run_both("ImageSequenceLoader", widgets, **inputs)
        assert out.shape == (len(ref), 512, 512, 3)
        close(out, ref)
    with pytest.raises(ValueError, match="SD15 or SDXL"):
        run_both("ImageSequenceLoader", [str(tmp_path / "seq"), 0, 1, "SD3"])


def test_noise_and_id_sequence_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    (tmp_path / "noise").mkdir()
    (tmp_path / "ids").mkdir()
    for i in range(3):
        np.save(tmp_path / "noise" / f"noise_{i}.npy",
                rng.standard_normal((128, 128, 4)).astype(np.float32))
        ids = np.zeros((16, 16, 4), np.int32)
        ids[4:12, 4:12] = [1, 1, 0, i + 1]
        np.save(tmp_path / "ids" / f"id_{i + 5}.npy", ids)
    (ref,), (out,), _, _ = run_both("NoiseSequenceLoader", [str(tmp_path / "noise"), 0, 3, "SD15"])
    assert out["noise"].shape == (3, 64, 64, 4)
    close(out, ref)
    (ref,), (out,), _, _ = run_both("IDSequenceLoader", [1, 2], directory=str(tmp_path / "ids"))
    assert out.frame_indices == ref.frame_indices == [6, 7]
    assert torch.equal(out.tensor, torch.from_numpy(np.array(ref.tensor)))


def test_legacy_loaders_match_jax(tmp_path):
    files = _write_images(tmp_path / "rgba", n=3, size=16, mode="RGBA", seed=2)
    (ref_img, ref_mask), (img, mask), _, _ = run_both("LegacyImageSequenceLoader",
                                                      imgs=list(reversed(files)))
    close(img, ref_img)
    close(mask, ref_mask)
    rng = np.random.default_rng(3)
    paths = []
    for i, layout in enumerate(("hwc", "chw", "hwc")):
        t = rng.standard_normal((16, 16, 4)).astype(np.float32)
        p = tmp_path / f"map_{i + 2}.npy"
        np.save(p, np.moveaxis(t, -1, 0) if layout == "chw" else t)
        paths.append(str(p))
    widget = ",\n".join(paths[::-1] + [str(tmp_path / "absent_9.npy")])
    (ref,), (out,), _, _ = run_both("LegacyNoiseSequenceLoader", [widget])
    close(out, ref)
    ids = []
    for i in range(2):
        a = np.zeros((16, 16, 4), np.int32)
        a[2:9, 3:7] = [1, 2, 0, 5 + i]
        p = tmp_path / f"id_{i + 4}.npy"
        np.save(p, a)
        ids.append(str(p))
    (ref,), (out,), _, _ = run_both("LegacyIDSequenceLoader", data_paths=ids)
    assert out.frame_indices == ref.frame_indices == [4, 5]
    assert torch.equal(out.tensor, torch.from_numpy(np.array(ref.tensor)))
    with pytest.raises(ValueError, match="no existing"):
        run_both("LegacyIDSequenceLoader", [str(tmp_path / "absent.npy")])


def _id_maps(frame_indices):
    ids = np.zeros((2, 64, 64, 4), np.int32)
    ids[0, 12:20, 25:31] = [1, 1, 0, 7]
    ids[1, 37:40, 50:58] = [1, 1, 0, 7]
    ids[0, 40:44, 8:12, :3] = [2, 1, 0]
    ids[0, 40:44, 8:12, 3] = np.arange(4)[None] + 11
    from stable_renderer_tpu.data.idmap import IDMap as JIDMap

    from stable_renderer_tpu_torch.data.idmap import IDMap

    return (JIDMap(jnp.asarray(ids), frame_indices=list(frame_indices)),
            IDMap(torch.from_numpy(ids), frame_indices=list(frame_indices)))


def _jax_id_map_draws(key, n_segments: int, n_rows: int, size: int):
    """JAX's CreateNoiseSequenceFromIdMap draws for one field: the base
    field, then group_randn_by_id's table and fallback from fold_in(key, 7)."""
    k7 = jax.random.fold_in(key, 7)
    return tuple(torch.from_numpy(np.asarray(a)) for a in (
        jax.random.normal(key, (1, size, size, 4), jnp.float32),
        jax.random.normal(k7, (n_segments, 4), jnp.float32),
        jax.random.normal(jax.random.fold_in(k7, 1), (n_rows, 4))))


@pytest.mark.parametrize("how,frames", [("nearest", (0, 1)), ("mean", (8, 9)), ("max", (0, 1)),
                                        ("min", (3, 9))])
def test_noise_from_id_map_with_jax_draws(how, frames):
    """The node's function of its draws, given JAX's, equals the JAX node
    (the vertex's pixels share one draw across frames); the port's node with
    its own draws has the same structure."""
    jm, pm = _id_maps(frames)
    (ref,), (own,), _, _ = run_both("CreateNoiseSequenceFromIdMap", [42, "SD15", how],
                                    id_map=(jm, pm))
    info, valid = pm.create_vertex_screen_info()
    n_seg = int(torch.where(valid, info[:, 3].to(torch.int32), 0).max()) + 1
    key = jax.random.PRNGKey(42)
    draws = [_jax_id_map_draws(k, n_seg, info.shape[0], 512)
             for k in (key, jax.random.fold_in(key, 1))]
    out = psr.noise_from_id_map(pm, 512, how, draws)
    close(out, ref)
    assert own["noise"].shape == out["noise"].shape == (2, 64, 64, 4)
    if how == "nearest":
        # vertex 7's first pixels, (y 12, x 25) in frame 0 and (37, 50) in
        # frame 1, land at full-res (96, 200) and (296, 400): latent cells
        # (12, 25) and (37, 50) of the nearest downsample
        for lat in (out, own):
            torch.testing.assert_close(lat["noise"][0, 12, 25], lat["noise"][1, 37, 50])
    else:
        assert torch.equal(own["samples"], torch.zeros_like(own["samples"]))


def test_identical_noise_with_jax_draws():
    (ref,), (own,), _, _ = run_both("CreateIdenticalNoiseSequence", [7, 3, "SD15"])
    key = jax.random.PRNGKey(7)
    lat = torch.from_numpy(np.asarray(jax.random.normal(key, (1, 64, 64, 4), jnp.float32)))
    noise = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.fold_in(key, 1), (1, 64, 64, 4), jnp.float32)))
    close(psr.identical_noise(3, lat, noise), ref)
    assert torch.equal(own["noise"][0], own["noise"][2])
    assert not torch.equal(own["noise"], own["samples"])
    for mod in (je, pe):
        with pytest.raises(ValueError, match="larger than 0"):
            mod.NODE_REGISTRY["CreateIdenticalNoiseSequence"](
                None, _N("CreateIdenticalNoiseSequence", [7, 0, "SD15"]))


def test_virtual_engine_data_node_matches_jax():
    jm, pm = _id_maps((3, 4))
    rng = np.random.default_rng(5)
    color = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    (ref,), (out,), jctx, pctx = run_both(
        "VirtualEngineDataNode", color_maps=color, id_maps=(jm, pm),
        noise_maps=({"noise": jnp.asarray(noise)}, {"noise": torch.from_numpy(noise)}),
        normal_maps=color[..., ::-1].copy())
    assert pctx.engine_data is out and jctx.engine_data is ref
    for f in ("frame_indices", "color_maps", "id_maps", "noise_maps", "normal_maps", "masks"):
        close(getattr(out, f).float(), np.asarray(getattr(ref, f), np.float32))
    assert out.depth_maps is None and ref.depth_maps is None
    with pytest.raises(ValueError, match="at least one map"):
        run_both("VirtualEngineDataNode")


def test_image_processing_nodes_match_jax():
    rng = np.random.default_rng(6)
    rgba = rng.uniform(size=(2, 16, 16, 4)).astype(np.float32)
    (ref,), (out,), _, _ = run_both("RGBAToRGB", ["#336699"], image=rgba)
    close(out, ref)
    (ref,), (out,), _, _ = run_both("RGBAThreshold", [0.4], image=rgba)
    close(out, ref)
    img = np.full((2, 24, 20, 3), 0.2, np.float32) + rng.normal(0, 0.01, (2, 24, 20, 3)).astype(
        np.float32)
    img[:, 6:18, 5:15] = rng.uniform(size=(2, 12, 10, 3))
    (ref,), (out,), _, _ = run_both("RemoveBGNode", image=img)
    close(out, ref)
    for bad in (["12345"], ["zzzzzz"]):
        with pytest.raises(ValueError, match="hex"):
            run_both("RGBAToRGB", bad, image=rgba)


def test_text_nodes_match_jax():
    for name, widgets, inputs in (("TextConcat", ["a", "b"], {}),
                                  ("TextConcat", ["b"], {"text_a": "x"}),
                                  ("TextReplace", ["a cat", "cat", "dog"], {}),
                                  ("TextReplace", [], {"text": "aXa", "pattern": "X",
                                                       "replace": "-"})):
        ref, out, _, _ = run_both(name, widgets, **inputs)
        assert out == ref


@pytest.mark.parametrize("fmt", ["webp", "gif"])
def test_simple_video_combine_matches_jax(tmp_path, monkeypatch, fmt):
    from PIL import Image, ImageSequence

    import stable_renderer_tpu.utils.paths as jpaths
    import stable_renderer_tpu_torch.utils.paths as ppaths

    monkeypatch.setattr(jpaths, "OUTPUT_DIR", tmp_path / "jax")
    monkeypatch.setattr(ppaths, "OUTPUT_DIR", tmp_path / "port")
    frames = np.random.default_rng(7).uniform(size=(3, 16, 16, 4)).astype(np.float32)
    (ref,), (out,), jctx, pctx = run_both(
        "SimpleVideoCombine", [0.5, True, 10, 0, "clip", True, fmt], images=frames)
    assert Path(out).name == Path(ref).name == f"clip_00000.{fmt}"
    assert pctx.status_messages[0].replace("port", "jax") == jctx.status_messages[0]
    got = [np.asarray(f.convert("RGBA")) for f in ImageSequence.Iterator(Image.open(out))]
    want = [np.asarray(f.convert("RGBA")) for f in ImageSequence.Iterator(Image.open(ref))]
    assert len(got) == len(want) == 4  # pingpong: 0 1 2 1
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
