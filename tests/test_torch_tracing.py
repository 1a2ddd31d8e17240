"""The engine's tracer (utils/timer.py) on the CPU: the spans of a frame in
``SR_TPU_PROFILE``'s trace, the stage totals, the cost of a span while no
profiler records, and the host-sync counter. The card's count is checked in
tests/test_torch_cuda.py."""

from __future__ import annotations

import json
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from stable_renderer_tpu_torch.engine import Engine
from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
from stable_renderer_tpu_torch.utils import timer
from stable_renderer_tpu_torch.utils.timer import SYNC_MARK, SYNC_WARNING, StageTimer

torch.set_num_threads(1)

SIZE = 32
STEPS = 4  # the tiny pipeline's LCM steps: one unet span each, a sequential frame
# the corresponder averages vertices while a step's timestep is at or above
# its stop (500): the first 2 of the 4 sgm_uniform steps
CORRESPOND = 2

# each span's parent span in a sequential diffusion frame
PARENTS = {
    "assemble": "frame", "conditioning": "assemble", "dispatch": "frame", "raster": "dispatch",
    "vae_encode": "dispatch", "unet": "dispatch", "correspond": "dispatch",
    "vae_decode": "dispatch", "post": "dispatch", "finish": "frame", "present": "frame",
}


@pytest.fixture(autouse=True)
def clean_scene():
    Engine._reset()
    yield
    Engine._reset()


def _run(frames: int, **kw):
    pipe = DiffusionPipeline.from_random(tiny=True, device="cpu")
    corr = OverlapCorresponder(vertex_segments=SIZE * SIZE, update_corrmap=False)
    return chip_smoke.run_engine(pipe, SIZE, frames, corr, device="cpu", **kw)[0]


def test_profile_trace_nests_the_frame_spans(monkeypatch, tmp_path):
    """SR_TPU_PROFILE's Chrome trace of a 2-frame diffusion run holds each
    stage as an ``sr.*`` span inside its parent stage, inside the ``sr.frame``
    of its frame, and each span carries its frame's index."""
    monkeypatch.setenv("SR_TPU_PROFILE", str(tmp_path))
    _run(2)
    (path,) = tmp_path.glob("trace_*.json")
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith(timer.SPAN_PREFIX)
             and e["name"] != SYNC_MARK]
    assert all(e["cat"] == "user_annotation" for e in spans)
    frames = [e for e in spans if e["name"] == "sr.frame"]
    assert [e["args"]["Concrete Inputs"] for e in frames] == [["0"], ["1"]]

    def inside(e, outer):
        return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    seen = {i: [] for i in range(2)}
    for e in spans:
        if e["name"] == "sr.frame":
            continue
        name = e["name"][len(timer.SPAN_PREFIX):]
        # the parent is the shortest other span that holds it
        parent = min((o for o in spans if o is not e and inside(e, o)), key=lambda o: o["dur"])
        assert parent["name"] == timer.SPAN_PREFIX + PARENTS[name], (name, parent["name"])
        index = int(e["args"]["Concrete Inputs"][0])
        assert inside(e, frames[index])
        seen[index].append(name)
    for names in seen.values():
        assert names.count("unet") == STEPS and names.count("correspond") == CORRESPOND
        assert set(names) == set(PARENTS)


def test_stage_totals_accumulate():
    """The stages' host seconds and counts, with no profiler: one dispatch
    a frame, ``STEPS`` UNet evaluations a frame."""
    eng = _run(3)
    t = eng.RenderManager.timer
    assert t.counts["dispatch"] == 3 and t.totals["dispatch"] > 0
    assert t.counts["frame"] == 3 and t.totals["frame"] >= t.totals["dispatch"]
    assert t.counts["unet"] == 3 * STEPS and 0 < t.totals["unet"] < t.totals["dispatch"]
    assert not t.host_syncs  # counted only while a profiler records


def test_no_annotation_without_a_profiler(monkeypatch):
    """While no profiler records, a span enters no profiler range; while one
    records, every span does."""
    entered = []
    enter = torch.autograd._record_function_with_args_enter

    def counting(name, *args):
        entered.append(name)
        return enter(name, *args)

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", counting)
    _run(2)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        eng = _run(1)
    assert len(entered) == sum(eng.RenderManager.timer.counts.values())


def test_host_sync_counts_in_the_innermost_span():
    """A synchronizing call's warning, fed through the tracer while a
    profiler records, counts in the innermost open span each time it comes
    (one call site twice: two), is marked there in the trace and never
    reaches the user; a sync span counts once whatever happens inside it;
    other warnings still reach the user; without a profiler nothing counts."""
    t = StageTimer()

    def sync():
        warnings.warn(f"{SYNC_WARNING} (Triggered internally at CUDAFunctions.cpp:162.)")

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with warnings.catch_warnings(record=True) as shown:
            warnings.simplefilter("default")
            with t.frame(0):
                with t.stage("dispatch"):
                    sync()
                    with timer.stage("unet"):
                        for _ in range(2):
                            sync()
                with t.stage("present_wait", sync=True):
                    sync()
                warnings.warn("not a sync")
    assert dict(t.host_syncs) == {"dispatch": 1, "unet": 2, "present_wait": 1}
    assert [str(w.message) for w in shown] == ["not a sync"]
    marks = [e for e in prof.events() if e.name == SYNC_MARK]
    assert sorted(e.cpu_parent.name for e in marks) == [
        "sr.dispatch", "sr.present_wait", "sr.unet", "sr.unet"]

    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with t.frame(1), t.stage("unet"):
            sync()
    assert t.host_syncs["unet"] == 2 and len(shown) == 1


def test_stage_below_the_engine_without_a_frame():
    """``stage()`` outside an engine frame records nothing anywhere."""
    t = StageTimer()
    with timer.stage("unet"):
        pass
    with t.frame(0):
        with timer.stage("unet"):
            pass
    with timer.stage("unet"):
        pass
    assert t.counts["unet"] == 1 and t.counts["frame"] == 1
