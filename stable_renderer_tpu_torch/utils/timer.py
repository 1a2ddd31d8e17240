"""Per-stage wall-clock timers, FPS counter, and torch.profiler hooks.

Counterpart of stable_renderer_tpu/utils/timer.py: every engine stage runs
under a StageTimer and the frame loop keeps an FPSCounter. ``trace()`` wraps
torch.profiler for a device trace, as the JAX package's wraps jax.profiler.
Stage times are host clock: on the card they measure what the host spends
enqueueing a stage, not the device's work.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque
from typing import Iterator


class StageTimer:
    """Accumulates wall-clock time per named stage."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.totals[name] / c if c else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(
                f"{name:<28s} total={self.totals[name]*1e3:9.2f}ms  "
                f"n={self.counts[name]:<5d} mean={self.mean(name)*1e3:8.3f}ms"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


class FPSCounter:
    """Sliding-window frames-per-second counter."""

    def __init__(self, window: int = 64):
        self._stamps: deque[float] = deque(maxlen=window)

    def tick(self) -> None:
        self._stamps.append(time.perf_counter())

    @property
    def fps(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / span if span > 0 else 0.0


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool = True) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed block (host, and the
    card's kernels when ``cuda``) and write it to ``log_dir`` as a Chrome
    trace, ``trace_<pid>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
