"""The traced stretches: torch.profiler over steady parts of the window.

A stretch opens and closes at frame boundaries. The device is drained at
both ends (``torch.cuda.synchronize``) and the host waits PROFILE_MARGIN_S
after opening and before closing, because the tracer drops device events
that its host-clock mapping puts outside the recorded step. A warm-up step
of one frame comes first, whose events are dropped. A traced run makes two
stretches one after the other: the first records device activity alone,
which adds little host time, and gives the per-layer metrics and the device
operations of the breakdown; the second records the host's operations too,
and names the device's longest idle gaps by what the host was doing. Nothing
of a trace is written to disk.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Optional

PROFILE_MARGIN_S = 0.002
STRETCH = "srbench.stretch"


def _skip(e) -> bool:
    return (getattr(e, "is_user_annotation", False) or e.name == STRETCH
            or e.name.startswith("ProfilerStep"))


class Stretch:
    """Drive with ``step()`` once a frame boundary: boundary 0 opens the
    warm-up step, 1 the recorded stretch, ``1 + frames`` closes it."""

    def __init__(self, frames: int, device, host: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
        self.frames, self.device, self.host, self.at = int(frames), device, host, 0
        self.prof = profile(activities=acts,
                            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self._span = None
        self._torch = torch
        self.done = False
        self.host_open = self.host_drained = None

    def step(self) -> None:
        torch = self._torch
        if self.at == 0:
            self.prof.__enter__()
        elif self.at == 1:
            torch.cuda.synchronize(self.device)
            time.sleep(PROFILE_MARGIN_S)
            self.prof.step()
            if self.host:
                self._span = torch.profiler.record_function(STRETCH)
                self._span.__enter__()
            self.host_open = time.perf_counter()
        elif self.at == 1 + self.frames:
            torch.cuda.synchronize(self.device)
            self.host_drained = time.perf_counter()
            time.sleep(PROFILE_MARGIN_S)
            if self._span is not None:
                self._span.__exit__(None, None, None)
            self.prof.step()
            self.prof.__exit__(None, None, None)
            self.done = True
        self.at += 1

    def reduce(self) -> Optional[dict]:
        """{"seconds": the stretch's length on the host clock, from its
        opening to the drain at its close; "device": [(name, start_s,
        end_s)]; "host": [(name, start_s, end_s)]; "span": (start_s, end_s)
        of the host's stretch marker, or None} on the trace's clock."""
        if not self.done:
            return None
        span, device, host = None, [], []
        for e in self.prof.events():
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.name == STRETCH and e.device_type.name != "CUDA":
                span = (s, t)
            elif _skip(e):
                continue
            elif e.device_type.name == "CUDA":
                device.append((e.name, s, t))
            else:
                host.append((e.name, s, t))
        if span is not None:
            host = [(n, s, t) for n, s, t in host if t >= span[0] and s <= span[1]]
        return {"seconds": self.host_drained - self.host_open, "device": device,
                "host": host, "span": span}


def breakdown(ops_trace: dict, host_trace: Optional[dict], top: int = 10) -> dict:
    """The device operations that took most time (first stretch), and the
    longest idle gaps of the device between its first and last operation
    (second stretch), each named by the innermost host operation running at
    the gap's middle."""
    from benchmark.harness.stats import idle_gaps

    by_name = defaultdict(float)
    for n, s, t in ops_trace["device"]:
        by_name[n] += t - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    named = []
    if host_trace is not None and host_trace["device"]:
        dev = [(s, t) for _, s, t in host_trace["device"]]
        lo, hi = min(s for s, _ in dev), max(t for _, t in dev)
        for s, t in sorted(idle_gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:top]:
            mid = 0.5 * (s + t)
            covering = [(hs, ht, n) for n, hs, ht in host_trace["host"] if hs <= mid <= ht]
            name = (min(covering, key=lambda c: c[1] - c[0])[2] if covering
                    else "host: no operation")
            named.append([name, t - s])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
