"""Stage timing and tracing, the FPS counter, and torch.profiler's trace.

Counterpart of stable_renderer_tpu/utils/timer.py. Each engine's
RenderManager owns one StageTimer, the engine's tracer: every stage of a
frame adds its host seconds to the tracer's totals, and while a torch
profiler records, the stage is also a span ``sr.<name>`` on the profiler's
clock, nested in the span around it, and the frame's host syncs are counted.
Code below the engine (the frame program, the pipeline, the sampler) reaches
the tracer of the frame that is running through ``stage()`` and ``staged()``.
Stage times are host clock: on the card they measure what the host spends
enqueueing a stage, not the device's work; a span's device time is that of
the kernels launched under it, read from the profiler's trace. ``trace()`` wraps
torch.profiler for a Chrome trace, as the JAX package's wraps jax.profiler.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os
import time
import warnings
from collections import defaultdict, deque
from typing import Iterator

import torch

SPAN_PREFIX = "sr."
# the trace's record of one host sync, in the span it happened in: a
# function-scope record, not a user annotation, so a trace reader that leaves
# the annotations (the spans) out still counts it
SYNC_MARK = "sr.host_sync"
SYNC_WARNING = "called a synchronizing CUDA operation"

# tracing is on while a torch profiler records: one flag read a span
_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter
# the tracer of the engine frame running in this thread, or None
_tracer: contextvars.ContextVar = contextvars.ContextVar("sr_tracer", default=None)
_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("timer", "name", "sync", "handle", "t0")

    def __init__(self, timer: "StageTimer", name: str, sync: bool) -> None:
        self.timer, self.name, self.sync = timer, name, sync

    def __enter__(self) -> None:
        timer = self.timer
        timer._open.append(self)
        # the frame index rides as the annotation's input (a trace that
        # records shapes shows it)
        self.handle = (torch.autograd._record_function_with_args_enter(
            SPAN_PREFIX + self.name, *timer._frame_arg) if _profiling() else None)
        self.t0 = _clock()

    def __exit__(self, *exc) -> None:
        dt = _clock() - self.t0
        timer = self.timer
        if self.sync and timer._counting:
            timer._count_sync(self.name)
        if self.handle is not None:
            torch.autograd._record_function_with_args_exit(self.handle)
        timer._open.pop()
        timer.totals[self.name] += dt
        timer.counts[self.name] += 1


class StageTimer:
    """One engine's tracer. ``stage(name)`` adds a block's host seconds to
    ``totals[name]`` and one to ``counts[name]``, and while a profiler
    records makes it the span ``sr.<name>``. ``frame(index)`` is the span
    ``sr.frame`` around one engine frame; while a profiler records, the
    frame's synchronizing CUDA calls (``torch.cuda.set_sync_debug_mode``'s
    warnings, kept from the user) go to ``host_syncs`` under the innermost
    open span's name, each also marked in the trace as ``SYNC_MARK``."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.host_syncs: dict[str, int] = defaultdict(int)
        self._open: list = []  # the open spans, innermost last
        self._frame_arg: tuple = ()
        self._counting = False

    def stage(self, name: str, sync: bool = False) -> _Span:
        """The block as stage ``name``. ``sync``: the block is one host sync
        that the debug mode does not see (an event's wait), counted once."""
        return _Span(self, name, sync)

    @contextlib.contextmanager
    def frame(self, index: int) -> Iterator[None]:
        """Engine frame ``index``: the span ``sr.frame``, whose stages below
        the engine reach this tracer, and whose host syncs are counted when
        a profiler records as it begins."""
        token = _tracer.set(self)
        self._frame_arg = (int(index),)
        try:
            with self.stage("frame"), (self._syncs_counted() if _profiling() else _NO_SPAN):
                yield
        finally:
            _tracer.reset(token)

    @contextlib.contextmanager
    def _syncs_counted(self) -> Iterator[None]:
        cuda = torch.cuda.is_available()
        mode = torch.cuda.get_sync_debug_mode() if cuda else 0
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="Synchronization debug mode")
            warnings.filterwarnings("always", message=SYNC_WARNING)
            shown = warnings.showwarning

            def show(message, category, filename, lineno, file=None, line=None):
                if str(message).startswith(SYNC_WARNING):
                    self._count_sync()
                else:
                    shown(message, category, filename, lineno, file, line)

            warnings.showwarning = show
            if cuda and mode == 0:
                torch.cuda.set_sync_debug_mode("warn")
            self._counting = True
            try:
                yield
            finally:
                self._counting = False
                if cuda:
                    torch.cuda.set_sync_debug_mode(mode)

    def _count_sync(self, span: str | None = None) -> None:
        """One host sync, in ``span`` or the innermost open span (at least
        the frame's; where that is a sync span, it counts itself once, on
        its exit)."""
        if span is None:
            top = self._open[-1]
            if top.sync:
                return
            span = top.name
        self.host_syncs[span] += 1
        with torch._C._profiler._RecordFunctionFast(SYNC_MARK):
            pass

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
        if self.host_syncs:
            lines.append("host syncs while profiled: " + ", ".join(
                f"{name} {n}" for name, n in sorted(self.host_syncs.items())))
        return "\n".join(lines)


def stage(name: str):
    """Stage ``name`` of the engine frame running in this thread; without
    one (a direct call of the pipeline), nothing."""
    timer = _tracer.get()
    return _NO_SPAN if timer is None else _Span(timer, name, False)


def staged(name: str):
    """Decorator: each call of the function is ``stage(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with stage(name):
                return fn(*args, **kwargs)
        return run
    return wrap


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
    trace, ``trace_<pid>.json``. Shapes are recorded, so each ``sr.*`` span
    shows its frame index (``Concrete Inputs``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=True)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
