"""The port's command line (cli.py, __main__.py) against the JAX package's, on the CPU.

The parser has the JAX CLI's subcommands and flags, plus ``--device``. The
raster-only ``render`` of a mesh file draws the same frames as the JAX CLI
within the raster bars of the port's K2 comparisons: tri_id exact, z 1e-4,
bary 2e-4, and the presented uint8 colour within one step wherever tri_id
agrees. ``render`` with the tiny pipeline, ``bake`` then ``replay``,
``bench`` and ``validate`` run on the CPU; ``execute`` runs a tiny workflow
on dumped maps as the JAX CLI's does; ``upscale`` runs a zoo file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import stable_renderer_tpu.engine as J
import stable_renderer_tpu_torch.engine as P
from stable_renderer_tpu import cli as jcli
from stable_renderer_tpu_torch import cli as pcli

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SIZE = 64
Z_TOL = 1e-4
BARY_TOL = 2e-4


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    """Fresh scene graphs, and both packages' run directories in tmp_path."""
    from stable_renderer_tpu.utils import paths as jpaths
    from stable_renderer_tpu_torch.utils import paths as ppaths

    monkeypatch.setattr(jpaths, "OUTPUT_DIR", tmp_path / "jax-outputs")
    monkeypatch.setattr(ppaths, "OUTPUT_DIR", tmp_path / "outputs")
    J.Engine._reset()
    P.Engine._reset()
    yield
    J.Engine._reset()
    P.Engine._reset()


def _jax_parser() -> argparse.ArgumentParser:
    """The parser the JAX CLI's main() builds (caught at parse_args)."""

    class Built(Exception):
        pass

    def caught(self, *args, **kwargs):
        raise Built(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = caught
    try:
        jcli.main([])
    except Built as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("the JAX CLI's main() did not parse")


def _commands(parser) -> dict:
    """subcommand -> {option string: default}."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {s: a.default for a in p._actions for s in a.option_strings if s != "-h"
                   and s != "--help"} for name, p in sub.choices.items()}


def test_parser_has_jax_commands_and_flags():
    jax_cmds, port_cmds = _commands(_jax_parser()), _commands(pcli.build_parser())
    assert list(port_cmds) == list(jax_cmds)
    for name, flags in jax_cmds.items():
        extra = {"--device"} | ({"--out"} if name == "validate" else set())
        assert set(port_cmds[name]) == set(flags) | extra, name
        for flag, default in flags.items():
            assert port_cmds[name][flag] == default, (name, flag)
        assert port_cmds[name]["--device"] is None


def _sphere_obj(tmp_path) -> Path:
    return chip_smoke.write_mesh(P.Mesh.Sphere(1.0, 12), tmp_path / "sphere.obj", "obj")


def _record_raster(monkeypatch) -> dict:
    """Wrap the rasterize_auto each package's frame draws with (the JAX
    frame program's, the port's render_exec's) so every draw's visibility
    buffer (z, tri_id, bary) is kept, as numpy; the JAX frame is jitted, so
    its buffers leave through jax.debug.callback."""
    import jax

    from stable_renderer_tpu.engine import frame_program as jexec
    from stable_renderer_tpu_torch.engine import render_exec as pexec

    rec = {"jax": [], "port": []}
    jorig, porig = jexec.rasterize_auto, pexec.rasterize_auto

    def jwrap(*a, **k):
        vis = jorig(*a, **k)
        jax.debug.callback(lambda z, t, b: rec["jax"].append((np.asarray(z), np.asarray(t),
                                                              np.asarray(b))),
                           vis.z, vis.tri_id, vis.bary, ordered=True)
        return vis

    def pwrap(*a, **k):
        vis = porig(*a, **k)
        rec["port"].append(tuple(t.numpy().copy() for t in (vis.z, vis.tri_id, vis.bary)))
        return vis

    monkeypatch.setattr(jexec, "rasterize_auto", jwrap)
    monkeypatch.setattr(pexec, "rasterize_auto", pwrap)
    return rec


def _frames(d: Path, n: int) -> list:
    return [np.asarray(Image.open(d / f"frame_{i}.png")) for i in range(n)]


def test_render_raster_only_matches_jax(tmp_path, monkeypatch, capsys):
    obj = _sphere_obj(tmp_path)
    rec = _record_raster(monkeypatch)
    argv = ["render", "--no-diffusion", "--size", str(SIZE), "--frames", "2", "--obj", str(obj)]
    assert jcli.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    J.Engine._reset()
    assert pcli.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2 frames -> " in out and "(fps " in out
    launches = json.loads(out.split("kernel launches over 2 frames: ")[1].splitlines()[0])
    assert launches == {"flash_attention": 0, "rasterize_kernel": 0, "conv3x3_kernel": 0,
                        "group_norm_kernel": 0}  # the CPU runs the plain versions
    assert len(rec["jax"]) == len(rec["port"]) == 2
    for f, ((jz, jt, jb), (pz, pt, pb), jimg, pimg) in enumerate(zip(
            rec["jax"], rec["port"], _frames(tmp_path / "jax", 2), _frames(tmp_path / "port", 2))):
        np.testing.assert_array_equal(pt, jt, err_msg=f"frame {f} tri_id")
        hit = jt >= 0
        assert hit.mean() > 0.2
        np.testing.assert_allclose(pz[hit], jz[hit], atol=Z_TOL, rtol=0)
        np.testing.assert_allclose(pb[hit], jb[hit], atol=BARY_TOL, rtol=0)
        assert pimg.shape == jimg.shape == (SIZE, SIZE, 3)
        diff = np.abs(pimg.astype(int) - jimg.astype(int))
        assert diff.max() <= 1, f"frame {f}: colour differs by {diff.max()}"
        assert pimg.max() > pimg.min()


def test_render_tiny_diffusion(tmp_path, monkeypatch, capsys):
    """The tiny pipeline (size < 256) on a mesh file: finite decoded frames,
    written and not constant."""
    decoded = []
    monkeypatch.setattr(P.Engine, "beforeFrameEnd", lambda self: decoded.append(
        self.RenderManager.last_diffusion_frames))
    obj = _sphere_obj(tmp_path)
    assert pcli.main(["render", "--size", str(SIZE), "--frames", "2", "--obj", str(obj),
                      "--prompt", "a ball", "--out", str(tmp_path / "r"), "--device",
                      "cpu"]) == 0
    assert len(decoded) == 2 and all(bool(torch.isfinite(d).all()) for d in decoded)
    for img in _frames(tmp_path / "r", 2):
        assert img.shape == (SIZE, SIZE, 3) and img.max() > img.min()


def test_bake_then_replay(tmp_path, capsys):
    """bake (tiny pipeline, 4 frames, k=3) dumps a map with written cells;
    replay draws it: the ball shows the map's colours."""
    from stable_renderer_tpu_torch.data.corrmap import CorrespondMap

    bake = tmp_path / "bake"
    assert pcli.main(["bake", "--size", str(SIZE), "--frames", "4", "--k", "3",
                      "--out", str(bake), "--device", "cpu"]) == 0
    assert "corrmap ->" in capsys.readouterr().out
    cmap = CorrespondMap.Load(bake / "bake", device="cpu")
    assert cmap.k == 3 and int(cmap.written.sum()) > 0
    assert len(list((bake / "frames").glob("frame_*.png"))) == 4
    P.Engine._reset()
    replay = tmp_path / "replay"
    assert pcli.main(["replay", "--size", str(SIZE), "--frames", "2", "--map", str(bake / "bake"),
                      "--out", str(replay), "--device", "cpu"]) == 0
    assert "replayed -> " in capsys.readouterr().out
    for img in _frames(replay, 2):
        assert img.shape == (SIZE, SIZE, 3) and img.max() > img.min()


def test_upscale_command_runs(tmp_path, capsys):
    """``upscale`` runs on the CPU (the last command that waited for a later
    slice, ROADMAP 1.13): a written RRDBNet file upscales a PNG x4 and prints
    the JAX CLI's line (tests/test_torch_upscale.py holds it to the JAX CLI)."""
    from stable_renderer_tpu_torch.models.upscale import RRDBConfig, RRDBNet
    from stable_renderer_tpu_torch.models.weights import flatten

    tree = RRDBNet(RRDBConfig(16, 1, 8, 4)).init(torch.Generator().manual_seed(0))
    torch.save(flatten(tree), str(tmp_path / "m.pth"))
    Image.fromarray(np.full((10, 12, 3), 128, np.uint8)).save(tmp_path / "i.png")
    out = tmp_path / "o.png"
    assert pcli.main(["upscale", "--model", str(tmp_path / "m.pth"), "--image",
                      str(tmp_path / "i.png"), "--out", str(out), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == f"RRDBNet: 12x10 -> 48x40 -> {out}"
    assert np.asarray(Image.open(out)).shape == (40, 48, 3)


def test_execute_matches_jax(tmp_path, monkeypatch, capsys):
    """``execute --device cpu`` of a tiny workflow (the checkpoint's tiny
    fallback models, EngineData from dumped colour, id, noise, normal and
    depth maps, a KSampler) writes the JAX CLI's frames within one uint8
    step: the JAX fallback models and its draws are handed to the port."""
    from test_torch_executor import jax_noise, port_loader_outputs
    from test_torch_workflow_loader import ENGINE_DATA_OUTPUTS, _graph

    import stable_renderer_tpu.workflow.executor as je
    import stable_renderer_tpu_torch.workflow.executor as pe

    rng = np.random.default_rng(0)
    dirs = {k: tmp_path / k for k in ("color", "id", "noise", "normal", "depth")}
    for d in dirs.values():
        d.mkdir()
    for i in range(2):
        for k in ("color", "normal", "depth"):
            Image.fromarray((rng.uniform(size=(32, 32, 3)) * 255).astype(np.uint8)).save(
                dirs[k] / f"{k}_{i}.png")
        ids = np.zeros((32, 32, 4), np.int32)
        ids[8:24, 8:24] = [1, 1, 0, 3]
        np.save(dirs["id"] / f"id_{i}.npy", ids)
        np.save(dirs["noise"] / f"noise_{i}.npy",
                rng.standard_normal((32, 32, 4)).astype(np.float32))
    wf = _graph([(1, "CheckpointLoaderSimple", ["absent.safetensors"], ["MODEL", "CLIP", "VAE"]),
                 (2, "CLIPTextEncode", ["a boat"], ["CONDITIONING"]),
                 (3, "CLIPTextEncode", ["blurry"], ["CONDITIONING"]),
                 (4, "EngineData", [], ENGINE_DATA_OUTPUTS),
                 (5, "VAEEncode", [], ["LATENT"]),
                 (6, "KSampler", [3, "fixed", 2, 2.0, "euler", "normal", 1.0], ["LATENT"]),
                 (7, "VAEDecode", [], ["IMAGE"]),
                 (8, "InferenceOutput", [], [])],
                [(1, 1, 2, "clip"), (1, 1, 3, "clip"), (4, 0, 5, "pixels"), (1, 2, 5, "vae"),
                 (1, 0, 6, "model"), (2, 0, 6, "positive"), (3, 0, 6, "negative"),
                 (5, 0, 6, "latent_image"), (6, 0, 7, "samples"), (1, 2, 7, "vae"),
                 (7, 0, 8, "images")])
    (tmp_path / "wf.json").write_text(json.dumps(wf))
    node = pe.WorkflowNode(id=1, type="CheckpointLoaderSimple", widgets=[], inputs={},
                           output_names=[])
    models = port_loader_outputs(*je.checkpoint_loader(je.InferenceContext(), node))
    monkeypatch.setattr(pe, "tiny_models", lambda device, generator: models)
    jax_noise(monkeypatch, {3})
    args = ["execute", "--workflow", str(tmp_path / "wf.json"),
            *[a for k, d in dirs.items() for a in (f"--{k}-dir", str(d))]]
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert pcli.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert "2 frames -> " in capsys.readouterr().out
    port, ref = _frames(tmp_path / "port", 2), _frames(tmp_path / "jax", 2)
    for a, b in zip(port, ref):
        assert a.shape == (32, 32, 3) and a.max() > a.min()
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_model_dirs_read_extra_model_paths(tmp_path, monkeypatch):
    """``--model-dir`` plus an extra_model_paths.yaml (given, or found in the
    working directory) expand as in the JAX CLI."""
    (tmp_path / "base" / "ckpt").mkdir(parents=True)
    (tmp_path / "base" / "lora").mkdir()
    yml = tmp_path / "paths.yaml"
    yml.write_text(f"a111:\n  base_path: {tmp_path / 'base'}\n  checkpoints: ckpt\n"
                   "  loras: |\n    lora\n    missing\n")
    for extra in (["--extra-model-paths", str(yml)], []):
        argv = ["execute", "--workflow", "wf.json", "--model-dir", "m1", *extra]
        monkeypatch.chdir(tmp_path)
        (tmp_path / "extra_model_paths.yaml").write_text(yml.read_text())
        got = pcli._model_dirs(pcli.build_parser().parse_args(argv))
        want = jcli._model_dirs(_jax_parser().parse_args(argv))
        assert got == want == ("m1", str(tmp_path / "base" / "ckpt"),
                               str(tmp_path / "base" / "lora"))


def test_bench_runs_bench_torch(monkeypatch, capsys):
    monkeypatch.setenv("SR_BENCH_QUICK", "1")
    monkeypatch.setenv("SR_BENCH_FRAMES", "2")
    assert pcli.main(["bench", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["unit"] == "fps" and line["value"] > 0 and "(cpu)" in line["metric"]


def test_validate_writes_under_out(tmp_path, monkeypatch, capsys):
    """validate runs the port's five example scripts and two parity scripts
    (each a subprocess, faked here) and writes <--out>/PARITY.json; the
    repository's PARITY.json and PARITY.md stay as they were. Without a
    checkpoint it skips."""
    before = {f: (REPO / f).read_bytes() for f in ("PARITY.json", "PARITY.md")}
    assert pcli.main(["validate"]) == 0
    assert "SKIPPED" in capsys.readouterr().out
    ran = []

    def fake_run(argv, cwd=None, **kwargs):
        ran.append((argv, cwd))
        return subprocess.CompletedProcess(argv, 0, "", "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    ckpt = tmp_path / "sd15.safetensors"
    ckpt.write_bytes(b"")
    out = tmp_path / "validate"
    assert pcli.main(["validate", "--ckpt", str(ckpt), "--out", str(out), "--device",
                      "cpu"]) == 0
    scripts = [argv[1] for argv, _ in ran]
    assert scripts == [f"scripts/{n}_torch.py" for n in (
        "bake_ball", "boat_example", "corrmap_render_example", "miku_controlnet_example",
        "multi_obj_example", "diffusion_ab", "flicker_parity")]
    assert all((REPO / s).exists() for s in scripts)
    assert all(cwd == pcli.REPO_ROOT and argv[-2:] == ["--device", "cpu"] for argv, cwd in ran)
    assert ran[5][0][ran[5][0].index("--out") + 1] == str(out.resolve() / "diffusion_ab")
    data = json.loads((out / "PARITY.json").read_text())
    assert all(v["ok"] for v in data["validate"]["steps"].values())
    assert {f: (REPO / f).read_bytes() for f in before} == before


def test_main_module_runs_nothing_at_import():
    code = "import stable_renderer_tpu_torch.__main__; print('imported')"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "imported", out.stderr
    out = subprocess.run([sys.executable, "-m", "stable_renderer_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0 and "render" in out.stdout and "validate" in out.stdout
