"""f32 stays f32: the port's card entry points turn TF32 off.

torch's default on the card runs f32 convolutions as TF32 (about three
decimal digits), which the JAX package's f32 towers (the loaded VAE, the
ControlNet hint towers) never do. ``device.keep_f32`` turns both switches
off, and the card entry points call it: ``DiffusionPipeline`` construction
(``from_random``, ``from_checkpoint``), ``Engine`` construction (``Run`` and
``Bake`` construct one) and ``bench_torch.main``. On the CPU the switches
are flags only: each test sets both to True (torch's card default for
convolutions) and checks that the entry point, run with ``device="cpu"``,
leaves both False. On the card, ``tests/test_torch_cuda.py`` holds an f32
conv path reached through an entry point to the CPU.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402
from stable_renderer_tpu_torch import device as tdev  # noqa: E402
from test_torch_checkpoint_pipeline import _write_checkpoint, tiny_towers  # noqa: E402,F401

torch.set_num_threads(1)


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 switches on for the test, restored afterwards."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def _both_off() -> bool:
    return not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_keep_f32_turns_both_switches_off(tf32_on):
    tdev.keep_f32()
    assert _both_off()
    assert tdev.tf32_switches() == "matmul.allow_tf32=False cudnn.allow_tf32=False"


def test_from_random_keeps_f32(tf32_on):
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline

    DiffusionPipeline.from_random(tiny=True, device="cpu")
    assert _both_off()


def test_from_checkpoint_keeps_f32(tf32_on, tiny_towers, tmp_path):  # noqa: F811
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline

    path = tmp_path / "tiny.safetensors"
    _write_checkpoint(path)
    DiffusionPipeline.from_checkpoint(str(path), device="cpu")
    assert _both_off()


def test_engine_construction_keeps_f32(tf32_on):
    from stable_renderer_tpu_torch.engine.engine import Engine

    Engine._reset()
    try:
        Engine(winSize=(64, 64), device="cpu")
        assert _both_off()
    finally:
        Engine._reset()


def test_bench_keeps_f32_and_prints_the_switches(tf32_on, monkeypatch, capsys):
    """``SR_BENCH_QUICK=1 python bench_torch.py --device cpu``, in process:
    both switches off afterwards, and printed on stderr before the compile
    line."""
    for k in list(os.environ):
        if k.startswith("SR_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("SR_BENCH_QUICK", "1")
    monkeypatch.setenv("SR_BENCH_FRAMES", "2")
    bench_torch.main(["--device", "cpu"])
    assert _both_off()
    err = capsys.readouterr().err
    switches = err.index("# matmul.allow_tf32=False cudnn.allow_tf32=False")
    assert switches < err.index("# compile")
