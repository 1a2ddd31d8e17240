"""The port's example and parity scripts (scripts/*_torch.py) on the CPU.

Each runs in process through its ``main(argv)`` with ``--device cpu --size
64`` and 2 frames, its run directory in tmp_path. ``multi_obj_example_torch``
(BASELINE config 5, raster only) draws what scripts/multi_obj_example.py
draws, within the raster bars (tri_id exact, z 1e-4, bary 2e-4, presented
uint8 colour within one step). The parity scripts write under ``--out`` and
leave the repository's PARITY.json and PARITY.md as they were. Vertex ids
past ``vertex_segments`` (diffusion_ab's scene has more ids than its
OverlapCorresponder's 4096 segments at 512x512) are dropped from the
averages in both packages alike.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import stable_renderer_tpu.engine as J
import stable_renderer_tpu_torch.engine as P
from stable_renderer_tpu_torch.workflow import Workflow as PWorkflow
from test_torch_cli import BARY_TOL, Z_TOL, _record_raster, _sphere_obj
from test_torch_workflow_loader import miku_control

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SIZE = 64


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    from stable_renderer_tpu.utils import paths as jpaths
    from stable_renderer_tpu_torch.utils import paths as ppaths

    monkeypatch.setattr(jpaths, "OUTPUT_DIR", tmp_path / "jax-outputs")
    monkeypatch.setattr(ppaths, "OUTPUT_DIR", tmp_path / "outputs")
    J.Engine._reset()
    P.Engine._reset()
    yield
    J.Engine._reset()
    P.Engine._reset()


def _frames(d: Path) -> list:
    files = sorted(d.glob("frame_*.png"), key=lambda f: int(f.stem.split("_")[1]))
    return [np.asarray(Image.open(f)) for f in files]


@pytest.mark.parametrize("name, extra", [
    ("bake_ball_torch", []),
    ("bake_ball_torch", ["--no-diffusion"]),
    ("boat_example_torch", []),
    ("boat_example_torch", ["--obj", "{obj}"]),
    ("corrmap_render_example_torch", []),
    ("miku_controlnet_example_torch", []),
    ("miku_controlnet_example_torch", ["--obj", "{obj}", "--workflow", "{workflow}"]),
    ("multi_obj_example_torch", []),
])
def test_example_script_runs(tmp_path, monkeypatch, name, extra):
    """Without --obj and --workflow the boat and miku scripts draw a sphere
    with the settings written in the script; with them, the given files."""
    files = {"obj": str(_sphere_obj(tmp_path)), "workflow": str(tmp_path / "wf.json")}
    Path(files["workflow"]).write_text(json.dumps(miku_control()))
    extra = [a.format(**files) for a in extra]
    loaded = []
    load = P.Mesh.Load.__func__
    monkeypatch.setattr(P.Mesh, "Load", classmethod(
        lambda cls, path, *a, **k: loaded.append(str(path)) or load(cls, path, *a, **k)))
    out = _script(name).main(["--device", "cpu", "--size", str(SIZE), "--frames", "2", *extra])
    assert loaded == ([files["obj"]] if "--obj" in extra else [])
    assert out.parent == tmp_path / "outputs"
    frames = _frames(out / "frames" if name == "bake_ball_torch" else out)
    assert len(frames) == 2
    for img in frames:
        assert img.shape == (SIZE, SIZE, 3) and img.max() > img.min()
    if name == "bake_ball_torch":  # diffused frames write the map; the G-buffer bake none
        from stable_renderer_tpu_torch.data.corrmap import CorrespondMap

        written = int(CorrespondMap.Load(out / "bake_ball", device="cpu").written.sum())
        assert (written > 0) == (not extra)
    if name == "miku_controlnet_example_torch":
        n_specs = (len(PWorkflow.from_dict(miku_control()).build_config().controlnets)
                   if "--workflow" in extra else 2)
        assert len(P.Engine._instance.DiffusionManager.pipeline.controlnets) == n_specs
        assert any((out / "maps").iterdir())


def test_multi_obj_matches_jax(tmp_path, monkeypatch):
    rec = _record_raster(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["multi_obj_example.py", "--frames", "2", "--size",
                                      str(SIZE)])
    _script("multi_obj_example").main()
    J.Engine._reset()
    out = _script("multi_obj_example_torch").main(["--device", "cpu", "--frames", "2",
                                                   "--size", str(SIZE)])
    (jdir,) = (tmp_path / "jax-outputs").iterdir()
    assert len(rec["jax"]) == len(rec["port"]) == 6  # 3 draws a frame
    for d, ((jz, jt, jb), (pz, pt, pb)) in enumerate(zip(rec["jax"], rec["port"])):
        np.testing.assert_array_equal(pt, jt, err_msg=f"draw {d} tri_id")
        hit = jt >= 0
        np.testing.assert_allclose(pz[hit], jz[hit], atol=Z_TOL, rtol=0)
        np.testing.assert_allclose(pb[hit], jb[hit], atol=BARY_TOL, rtol=0)
    jframes, pframes = _frames(jdir), _frames(out)
    assert len(jframes) == len(pframes) == 2
    for j, p in zip(jframes, pframes):
        assert np.abs(p.astype(int) - j.astype(int)).max() <= 1
        assert p.max() > p.min()


def test_parity_scripts_write_under_out(tmp_path):
    """diffusion_ab_torch and flicker_parity_torch write their PARITY.json
    (and PARITY.md) under --out; the repository's stay byte-identical."""
    before = {f: (REPO / f).read_bytes() for f in ("PARITY.json", "PARITY.md")}
    ab = _script("diffusion_ab_torch").main(["--device", "cpu", "--frames", "3", "--size",
                                            str(SIZE), "--out", str(tmp_path / "ab")])
    data = json.loads((tmp_path / "ab" / "PARITY.json").read_text())
    assert data["diffusion_ab"] == json.loads(json.dumps(ab))
    for run in ("overlap_off", "overlap_on"):
        assert all(np.isfinite(v) for v in ab[run].values())
        assert np.isfinite(ab["latent_level"][run]["vertex_flicker_latent"])
    assert ab["config"]["weights"] == "random-tiny" and ab["config"]["device"] == "cpu"

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), np.uint8)).save(
            frames / f"frame_{i}.png")
    report = _script("flicker_parity_torch").main(["--device", "cpu", "--ours", str(frames),
                                                  "--out", str(tmp_path / "fp")])
    assert report["ours"]["frames"] == 3 and report["ours"]["flicker_l1"] > 0
    assert json.loads((tmp_path / "fp" / "PARITY.json").read_text()) == report
    assert (tmp_path / "fp" / "PARITY.md").read_text().startswith("# Temporal-flicker")
    assert {f: (REPO / f).read_bytes() for f in before} == before


def test_flicker_parity_without_fixtures(tmp_path):
    """Without --fixtures and --ours, the report holds the metric
    definitions only, as the JAX script's does without its fixtures."""
    report = _script("flicker_parity_torch").main(["--device", "cpu",
                                                   "--out", str(tmp_path / "fp")])
    assert list(report) == ["metric_defs"]


def test_flicker_parity_with_fixtures(tmp_path):
    """--fixtures scores the reference's dumped sequences (color pngs, id
    maps) and holds --ours to them."""
    rng = np.random.default_rng(2)
    fixtures = tmp_path / "example-map-outputs"
    for name in ("miku-sphere", "ours"):
        d = fixtures / name / "color" if name != "ours" else tmp_path / "ours"
        d.mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), np.uint8)).save(
                d / f"frame_{i}.png")
    report = _script("flicker_parity_torch").main([
        "--device", "cpu", "--fixtures", str(fixtures), "--ours", str(tmp_path / "ours"),
        "--out", str(tmp_path / "fp")])
    assert list(report) == ["metric_defs", "reference/miku-sphere", "ours", "parity"]
    ref = report["reference/miku-sphere"]
    assert ref["frames"] == 3 and ref["flicker_l1"] > 0
    for k in ("flicker_l1", "flicker_ssim"):
        assert report["parity"][k]["reference"] == ref[k]
        assert report["parity"][k]["ours"] == report["ours"][k]


def test_vertex_ids_past_segments_match_jax():
    """diffusion_ab's moving scene at 64x64 (2304 vertex ids) against 1024
    segments: the ids past the segment count are left out of the averages,
    in the port as in the JAX package (vertex_flicker and the step-finished
    vertex averaging)."""
    import jax.numpy as jnp

    from stable_renderer_tpu.ops.correspondence import vertex_average_injection as j_inject
    from stable_renderer_tpu.ops.metrics import vertex_flicker as j_flicker
    from stable_renderer_tpu_torch.ops.correspondence import vertex_average_injection
    from stable_renderer_tpu_torch.ops.metrics import vertex_flicker

    jab = _script("diffusion_ab")
    color, ids = _script("diffusion_ab_torch").moving_scene(3, SIZE)
    jcolor, jids = jab.moving_scene(3, SIZE)
    np.testing.assert_array_equal(color.numpy(), np.asarray(jcolor))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    segments = 1024
    assert int(ids[..., 3].max()) > segments
    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    got = vertex_flicker(torch.from_numpy(frames), ids, num_segments=segments).item()
    want = float(j_flicker(jnp.asarray(frames), jids, num_segments=segments))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
    assert got != pytest.approx(vertex_flicker(torch.from_numpy(frames), ids,
                                               num_segments=4096).item(), rel=1e-3)
    latent = rng.normal(size=(3, SIZE // 8, SIZE // 8, 4)).astype(np.float32)
    got = vertex_average_injection(torch.from_numpy(latent), ids, 0.8, num_segments=segments)
    want = j_inject(jnp.asarray(latent), jids, 0.8, num_segments=segments)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
