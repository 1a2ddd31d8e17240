"""``bench_torch.py``, the port's counterpart of ``bench.py``: its mode
resolution against bench.py:55-89's outcomes, a quick run on the CPU through
the script's entry point, and the data-parallel mode's raise."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402

# bench.py:55-89: env knobs (and argv) -> (stream, stream_kv, int8), the
# sequential modes falling back from the realtime default, each component
# knob overriding on its own
MODES = [
    ({}, [], (True, True, True)),
    ({"SR_BENCH_PLAIN": "1"}, [], (False, False, False)),
    ({"SR_BENCH_QUICK": "1"}, [], (False, False, False)),
    ({"SR_BENCH_CONTROL": "1"}, [], (False, False, False)),
    ({"SR_BENCH_TAESD": "1"}, [], (False, False, False)),
    ({"SR_BENCH_DP": "1"}, [], (False, False, False)),
    ({}, ["--dp"], (False, False, False)),
    ({"SR_BENCH_INT8": "1"}, [], (True, True, True)),
    ({"SR_BENCH_PLAIN": "1", "SR_BENCH_INT8": "1"}, [], (False, False, True)),
    ({"SR_BENCH_TAESD": "1", "SR_BENCH_STREAM": "1", "SR_BENCH_STREAM_KV": "1",
      "SR_BENCH_INT8": "1"}, [], (True, True, True)),
    ({"SR_BENCH_STREAM": "0"}, [], (False, True, True)),
    ({"SR_BENCH_STREAM_KV": "0"}, [], (True, False, True)),
    ({"SR_BENCH_INT8": "0"}, [], (True, True, False)),
    ({"SR_BENCH_CONTROL": "1", "SR_BENCH_STREAM": "1"}, [], (True, False, False)),
    ({"SR_BENCH_STREAM": "yes"}, [], (False, True, True)),  # only "1" switches on
    ({"SR_BENCH_PLAIN": "0"}, [], (True, True, True)),
]


@pytest.mark.parametrize("env,argv,want", MODES, ids=[
    ",".join([f"{k[9:] if k.startswith('SR_BENCH_') else k}={v}" for k, v in env.items()]
             + argv) or "default" for env, argv, _ in MODES])
def test_resolve_mode_matches_bench_py(env, argv, want):
    mode = bench_torch.resolve_mode(env, argv)
    assert (mode["stream"], mode["stream_kv"], mode["int8"]) == want
    quick = env.get("SR_BENCH_QUICK") == "1"
    assert mode["size"] == (64 if quick else 512)
    assert mode["frames"] == (4 if quick else 8)
    assert mode["dp"] == ("--dp" in argv or env.get("SR_BENCH_DP") == "1")


def test_resolve_mode_frames_taesd_control_and_switched():
    mode = bench_torch.resolve_mode(
        {"SR_BENCH_FRAMES": "3", "SR_BENCH_TAESD": "1", "SR_BENCH_CONTROL": "1",
         "SR_PALLAS_CONV": "1"}, [])
    assert mode["frames"] == 3 and mode["taesd"] and mode["control"] and mode["switched"]
    assert not bench_torch.resolve_mode({"SR_PALLAS_CONV": "0"}, [])["switched"]
    assert bench_torch.metric_name(mode, "cuda") == (
        "engine-loop img2img fps @ 512x512, 4-step LCM cfg2 2xcontrol taesd (cuda)")
    default = bench_torch.resolve_mode({}, [])
    assert bench_torch.metric_name(default, "cuda") == (
        "engine-loop img2img fps @ 512x512, 4-step LCM cfg2 stream stream-kv int8 (cuda)")


def test_quick_run_on_the_cpu_prints_the_bench_line():
    """``SR_BENCH_QUICK=1 SR_BENCH_FRAMES=2 python bench_torch.py --device
    cpu``: the tiny pipeline's 64x64 engine loop; the last stdout line is
    bench.py's four-key JSON with the device type in the metric."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("SR_")}
    env.update(SR_BENCH_QUICK="1", SR_BENCH_FRAMES="2", OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"), "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "engine-loop img2img fps @ 64x64, 4-step LCM cfg2 (cpu)"
    assert line["unit"] == "fps" and line["value"] > 0
    # value and vs_baseline are each rounded from the one unrounded fps
    # (bench.py:266 too), so vs_baseline is fps / 2.5 rounded for an fps
    # within half a step of value: the roundings of that interval's ends
    # bound it (value / 2.5 rounded can differ from it by a step)
    lo, hi = (round((line["value"] + e) / 2.5, 3) for e in (-5e-4, 5e-4))
    assert lo <= line["vs_baseline"] <= hi
    assert "# compile" in run.stderr and "median" in run.stderr and "p90" in run.stderr


@pytest.mark.parametrize("how", ["flag", "env"])
def test_dp_waits_for_the_multi_device_slice(how, monkeypatch):
    """--dp and SR_BENCH_DP=1 both take the data-parallel mode, which, like
    the others, starts on the card without ``--device`` and raises without
    one (tests/test_torch_mesh.py runs it with ``--device cpu``)."""
    monkeypatch.delenv("SR_BENCH_DP", raising=False)
    if how == "env":
        monkeypatch.setenv("SR_BENCH_DP", "1")
    argv = ["--dp"] if how == "flag" else []
    assert bench_torch.resolve_mode(os.environ, argv)["dp"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the mode would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_torch.main(argv)


def test_default_device_is_the_card(monkeypatch):
    """Without ``--device`` the bench runs on the card and raises without
    one (here: none)."""
    for k in list(os.environ):
        if k.startswith("SR_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("SR_BENCH_QUICK", "1")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_torch.main([])
