"""The readers of the port's spans and host-sync marks: the
``host_syncs_per_frame`` metric and ``harness/spans.py``, on synthetic
records and traces and on a CPU profiler's trace of the port's tracer.

    python -m pytest benchmark/tests -q
"""

import os
import sys
import warnings
from types import SimpleNamespace

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import spans  # noqa: E402


def _metric(name):
    return cells.load_module(os.path.join(BENCH, "metrics", name + ".py"), "m_" + name)


def test_host_syncs_per_frame_counts_the_marks_of_the_host_stretch(monkeypatch):
    host = [("sr.host_sync", 0.1, 0.1), ("aten::item", 0.1, 0.2), ("sr.host_sync", 0.3, 0.3),
            ("sr.host_sync", 0.5, 0.5)]
    rec = {"trace": {"device": []}, "trace_host": {"host": host}, "stretch_frames": 2}
    read = _metric("host_syncs_per_frame").read
    assert read(rec) == pytest.approx(1.5)
    assert read(dict(rec, trace_host={"host": []})) == 0.0  # a program that makes no sync
    assert read({"trace": None, "work": None}) is None
    # a program whose tracer has no counter (before the counter existed) reads nothing
    from stable_renderer_tpu_torch.utils import timer

    monkeypatch.delattr(timer, "SYNC_MARK")
    assert read(rec) is None


def test_idle_by_span_names_each_gap_by_the_innermost_span():
    device = [("k", 1.0, 2.0), ("k", 3.0, 4.0), ("k", 6.0, 7.0), ("k", 9.0, 10.0)]
    rows = [("frame", 0.0, 8.0, 0.0), ("dispatch", 0.5, 5.0, 0.0), ("unet", 2.5, 2.6, 0.0),
            ("present", 5.5, 7.8, 0.0)]
    # gaps: 2-3 (middle 2.5: unet), 4-6 (middle 5: dispatch), 7-9 (middle 8: frame's own)
    assert spans.idle_by_span(device, rows) == pytest.approx(
        {"unet": 1.0, "dispatch": 2.0, "frame": 2.0})
    rows.append(("post", 7.5, 8.5, 0.0))
    assert spans.idle_by_span(device, rows) == pytest.approx(
        {"unet": 1.0, "dispatch": 2.0, "post": 2.0})
    assert spans.idle_by_span(device, [("frame", 0.0, 7.9, 0.0)]) == pytest.approx(
        {"frame": 3.0, spans.OUTSIDE: 2.0})
    assert spans.idle_by_span([], rows) == {}


def _event(eid, name, start, end, annotation=False, device="CPU"):
    return SimpleNamespace(id=eid, name=name, time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation, device_type=SimpleNamespace(name=device))


def test_span_rows_tie_kernels_to_the_spans_open_at_their_launch():
    """Times in us, as the profiler's. A kernel counts in every span open
    when its runtime call (the same correlation id) was made, whoever made
    it; the profiler's device-side copy of an annotation does not count; a
    sync mark counts in the innermost span."""
    events = [_event(1, "sr.frame", 0, 100, annotation=True),
              _event(2, "sr.unet", 10, 60, annotation=True),
              _event(3, "aten::mm", 20, 30),
              _event(70, "cudaLaunchKernel", 21, 22),
              _event(71, "cudaLaunchKernelExC", 40, 41),  # a ctypes launch: no torch op
              _event(72, "cuLaunchKernel", 80, 81),
              _event(73, "cudaMemcpyAsync", 101, 102),
              _event(5, "sr.host_sync", 45, 45),
              _event(70, "gemm", 50, 70, device="CUDA"),
              _event(71, "flash_wg", 70, 75, device="CUDA"),
              _event(72, "fill", 90, 91, device="CUDA"),
              _event(73, "Memcpy DtoH", 110, 112, device="CUDA"),
              _event(99, "orphan", 120, 122, device="CUDA"),
              _event(2, "sr.unet", 50, 75, annotation=True, device="CUDA")]
    rows, syncs = spans.span_rows(events)
    assert {n: d for n, _, _, d in rows} == pytest.approx({"frame": 26e-6, "unet": 25e-6})
    assert syncs == {"unet": 1}
    rows, syncs = spans.span_rows(events, window=(0.0, 5e-6))
    assert [n for n, *_ in rows] == ["frame"] and syncs == {}


def test_span_rows_of_the_ports_tracer_under_a_cpu_profiler():
    from torch.profiler import ProfilerActivity, profile

    from stable_renderer_tpu_torch.utils import timer

    t = timer.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with t.frame(0), t.stage("dispatch"):
            with timer.stage("unet"):
                warnings.warn(timer.SYNC_WARNING)
            with timer.stage("vae_decode"):
                pass
    rows, syncs = spans.span_rows(prof.events())
    assert sorted(n for n, *_ in rows) == ["dispatch", "frame", "unet", "vae_decode"]
    assert syncs == {"unet": 1}


def test_readings_of_a_synthetic_record():
    """The four span readings: UNet host ms with tracing off, UNet and VAE
    device ms, host syncs a frame; and the two coverage shares."""
    rows = [("frame", 0.0, 1.0, 0.8), ("dispatch", 0.1, 0.9, 0.8), ("unet", 0.2, 0.5, 0.5),
            ("vae_encode", 0.1, 0.2, 0.1), ("vae_decode", 0.6, 0.7, 0.2)]
    device = [("k", 0.0, 0.3), ("k", 0.35, 0.6), ("k", 0.6, 0.85)]  # idle 0.3-0.35: unet
    rec = {"stretch_frames": 2, "trace": {"seconds": 0.5},
           "trace_host": {"spans": rows, "syncs": {"unet": 8, "present_wait": 2},
                          "device": device, "host": [], "seconds": 1.0}}
    stages = ({"dispatch": 1.0, "unet": 0.6, "frame": 0.9}, {"dispatch": 10, "unet": 40,
                                                             "frame": 9}, 2.0)
    got = spans.readings(rec, stages)
    assert got["frames_per_s_untraced"] == pytest.approx(5.0)
    assert got["frames_per_s_traced"] == pytest.approx([4.0, 2.0])
    assert "frame" not in got["stage_host_ms"]
    assert got["unet_host_ms"] == pytest.approx(60.0)
    assert got["unet_device_ms"] == pytest.approx(250.0)
    assert got["vae_device_ms"] == pytest.approx(150.0)
    assert got["host_syncs"] == {"present_wait": 1.0, "unet": 4.0}
    assert got["stage_host_ms"]["dispatch"] == pytest.approx(100.0)
    assert got["kernel_share_in_frames"] == pytest.approx(0.8 / 0.8)
    assert got["idle_share_in_stages"] == pytest.approx(1.0)
    assert got["idle_ms"] == pytest.approx({"unet": 25.0})
