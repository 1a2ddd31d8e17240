"""Realtime cells: ``Engine.Run`` of the workload's scene in a closed loop.

The game loop begins the next frame as soon as the last is dispatched; no
arrival rate is offered. Set-up is weight creation, the pipeline (with the
int8 calibration when the render asks), the engine's prepare and the warm
frames; the window opens when frame ``warm_frames`` begins and closes at
the first frame end with a present past ``seconds``. A frame is completed when presented
(``frame_callback``). The record keeps every present and every frame begin
on the host clock, the RenderManager's ``dispatch`` stage totals over the
window (traced: up to the first profiled stretch) and, with ``trace``, two
profiled stretches of ``profile_frames`` frames each from 0.3 of the window
on (``harness/profile.py``).

Correctness (after the window, with the program's state freed): the
reference replays frames 0 .. ``check_start_frames`` - 1 from nothing, and
for ``check_window_frames`` window frames drawn from the seed it computes the
frame again from the inputs alone (sequential program) or, for the stream
program, from the state the program carried into the frame
``check_follow_frames`` earlier: the reference then runs the frame's last
stages, its decode and its present itself, with its own carried state, and
the start replay checks the hand-over of that state from frame 0.
Each presented uint8 frame is held to the reference's by the statistics of
``harness/compare.py``; the cell's limits file names the ones compared.
"""

from __future__ import annotations

import gc
import random
import sys
import time

import numpy as np


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    import torch

    from benchmark.harness import port
    from benchmark.harness.weights import make_weights

    tr = cell.traffic
    render = dict(tr["render"], size=tr["size"])
    h, w = tr["size"]
    stream = bool(render.get("stream"))
    lag = int(render["steps"]) if stream else 0
    # the frames the reference follows a window frame from the program's state
    follow = int(tr.get("check_follow_frames", lag))
    warm = int(tr["warm_frames"])
    from stable_renderer_tpu_torch.device import keep_f32

    keep_f32()
    weights = make_weights(cell.config, seed, device)
    pipe = port.pipeline(cell.config, weights, render, seed, device)
    corr = port.corresponder(tr["corresponder"])

    from stable_renderer_tpu_torch.engine import Engine

    rng = random.Random(int(seed))
    keep_n = int(tr["check_window_frames"])
    start_n = int(tr["check_start_frames"])
    st = {"begins": {}, "presents": [], "frames": {}, "reservoir": [], "seen": 0,
          "t_start": None, "t_end": None, "stretches": [], "timer0": None, "timer1": None,
          "states": {}, "ring": {}}

    def want(idx: int) -> bool:
        return idx < start_n or idx in st["reservoir"]

    def on_present(frame, idx):
        st["presents"].append((idx, time.perf_counter()))
        if want(idx):
            st["frames"][idx] = np.array(frame, copy=True)

    class CellApp(Engine):
        def beforePrepare(self):
            port.build_scene(tr["scene"])

        def beforeFrameBegin(self):
            now = time.perf_counter()
            f = self.RuntimeManager.FrameCount
            st["begins"][f] = now
            rm = self.RenderManager
            if f == warm:
                st["t_start"] = now
                st["timer0"] = _dispatch(self)
            if stream:
                # the program's state entering each of the last lag + 1 frames
                st["ring"][f] = (rm._stream_state, rm._stream_kv)
                st["ring"].pop(f - lag - 1, None)
            if st["t_start"] is not None and st["t_end"] is None:
                # reservoir of window frames to check, drawn from the seed
                st["seen"] += 1
                slot = st["seen"] - 1 if st["seen"] <= keep_n else rng.randrange(st["seen"])
                if slot < keep_n:
                    if slot < len(st["reservoir"]):
                        old = st["reservoir"][slot]
                        if old >= start_n:
                            st["frames"].pop(old, None)
                        st["states"].pop(old, None)
                        st["reservoir"][slot] = f
                    else:
                        st["reservoir"].append(f)
                    if stream:
                        st["states"][f] = (f - follow,) + st["ring"][f - follow]
            for s in st["stretches"]:
                if not s.done:
                    s.step()

        def beforeFrameEnd(self):
            now = time.perf_counter()
            if st["t_start"] is None:
                return
            ss = st["stretches"]
            if trace and len(ss) < 2 and (ss[-1].done if ss else now - st["t_start"] >= 0.3 * seconds):
                from benchmark.harness.profile import Stretch

                if not ss:  # the host's dispatch time is read before tracing slows it
                    st["timer1"] = _dispatch(self)
                ss.append(Stretch(int(tr["profile_frames"]), device, host=len(ss) == 1))
            # the window closes at the first frame end after ``seconds`` with a
            # present after it, so its end lies between two completions
            late = st["presents"] and st["presents"][-1][1] > st["t_start"] + seconds
            if late and all(s.done for s in ss) and (len(ss) == 2 or not trace):
                st["t_end"] = st["t_start"] + seconds
                if st["timer1"] is None:
                    st["timer1"] = _dispatch(self)
                self.stop()

    Engine._reset()
    CellApp.Run(winSize=(w, h), pipeline=pipe, corresponder=corr, frame_callback=on_present,
                max_frames=None, debug=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    record = _record(st, cell, tr, seconds, t0, lag, trace, device)
    # free the program before the reference runs
    del pipe, CellApp
    Engine._reset()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(cell, weights, st, seed, device)
    record["frame_stats"] = checks.pop("stats")
    record["checks"] = checks
    return record


def _dispatch(engine) -> tuple:
    """RenderManager's ``dispatch`` stage: (total seconds, frames) so far."""
    timer = engine.RenderManager.timer
    return timer.totals["dispatch"], timer.counts["dispatch"]


def _record(st, cell, tr, seconds, t0, lag, trace, device) -> dict:
    t_start, t_end = st["t_start"], st["t_end"]
    begun = [f for f, t in st["begins"].items() if t_start <= t <= t_end]
    presented = {i for i, _ in st["presents"]}
    d_tot = st["timer1"][0] - st["timer0"][0]
    d_cnt = st["timer1"][1] - st["timer0"][1]
    rec = {
        "t0": t0, "t_start": t_start, "t_end": t_end, "seconds": seconds, "lag": lag,
        "presents": st["presents"], "begins": st["begins"],
        "completions": [t for _, t in st["presents"]],
        "dispatch": (d_tot, d_cnt),
        "attempted": len(begun), "failed": sum(1 for f in begun if f not in presented),
        "mode": "stream" if lag else "sequential",
        "trace": None, "stretch_frames": int(tr.get("profile_frames", 0)),
        "device": _device(device),
    }
    if trace and len(st["stretches"]) == 2:
        rec["trace"] = st["stretches"][0].reduce()
        rec["trace_host"] = st["stretches"][1].reduce()
    from benchmark.reference.flops import count_frame
    from benchmark.reference.programs import build_towers

    rec["work"] = count_frame(build_towers(cell.config), cell.config, tr) if trace else None
    return rec


def _device(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def check(cell, weights, st, seed, device) -> dict:
    """The reference's frames against the presented ones
    (``harness/compare.py``)."""
    from benchmark.harness.compare import frame_checks
    from benchmark.reference import replay

    t = time.perf_counter()
    start_idx = list(range(int(cell.traffic["check_start_frames"])))
    window_idx = sorted(st["reservoir"])
    ref = replay.frames(cell.config, weights, cell.traffic, seed, device, start_idx,
                        {i: st["states"].get(i) for i in window_idx})
    out = frame_checks(st["frames"], ref, start_idx, window_idx)
    print(f"reference took {time.perf_counter() - t:.1f}s", file=sys.stderr, flush=True)
    return out
