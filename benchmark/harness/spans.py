"""The port's spans in a traced run of a cell: device and host time by
stage, host syncs by stage, and the device's idle gaps by the stage the
host was in.

    python3 -m benchmark.harness.spans --workload <cell> --seed <n> --seconds <s>

runs the cell once traced, as ``run.py --trace 1`` does, and prints one JSON
object with what the result line leaves out. The port's tracer
(``utils/timer.py``) opens a span ``sr.<stage>`` around each stage of a frame
and marks each host sync ``sr.host_sync`` in the innermost one. From the
second stretch (the one that records the host): each span's device seconds,
those of the kernels launched while it was open; host syncs by span; and the
idle seconds of the device summed by the innermost span the host was in at
each gap's middle. From the run's window up to the first stretch (where
``dispatch_host_ms`` is read): the tracer's host seconds by stage, with
tracing off. A program without the spans reads empty.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "sr."  # the port's span names: utils/timer.py SPAN_PREFIX
SYNC_MARK = "sr.host_sync"  # utils/timer.py SYNC_MARK
OUTSIDE = "(no span)"

Span = Tuple[str, float, float, float]  # name, host start s, host end s, device s


def _innermost(spans: Sequence[Span], at: float) -> str:
    """The name of the shortest span open at host time ``at``: spans nest,
    so that is the innermost one (``OUTSIDE`` where none is)."""
    holding = [(t - s, n) for n, s, t, _ in spans if s <= at <= t]
    return min(holding)[1] if holding else OUTSIDE


def span_rows(events, window: Optional[Tuple[float, float]] = None
              ) -> Tuple[List[Span], Dict[str, int]]:
    """The ``sr.*`` spans of a profiler's events (``prof.events()``) inside
    ``window`` (seconds), each with the device seconds of the kernels
    launched while it was open (a kernel found by the correlation id it
    shares with its runtime call, and that call's host time), and the host
    syncs by innermost span."""
    named, marks, launches, kernels = [], [], {}, []
    for e in events:
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type.name != "CPU":
            if not e.is_user_annotation:
                kernels.append((e.id, t - s))
        elif window is not None and (t < window[0] or s > window[1]):
            continue
        elif e.name == SYNC_MARK:
            marks.append(s)
        elif e.is_user_annotation and e.name.startswith(PREFIX):
            named.append((e.name[len(PREFIX):], s, t))
        elif e.name.startswith("cu"):  # a CUDA runtime or driver call
            launches[e.id] = s
    device_s = [0.0] * len(named)
    for kid, seconds in kernels:
        at = launches.get(kid)
        if at is not None:
            for i, (_, s, t) in enumerate(named):
                if s <= at <= t:
                    device_s[i] += seconds
    rows = [(n, s, t, d) for (n, s, t), d in zip(named, device_s)]
    syncs: Dict[str, int] = defaultdict(int)
    for at in marks:
        syncs[_innermost(rows, at)] += 1
    return rows, dict(syncs)


def idle_by_span(device: Sequence[Tuple[str, float, float]], spans: Sequence[Span]
                 ) -> Dict[str, float]:
    """The device's idle seconds between its first and last operation,
    summed by the innermost span holding each gap's middle (``OUTSIDE``
    where none does)."""
    from benchmark.harness.stats import idle_gaps

    dev = [(s, t) for _, s, t in device]
    if not dev:
        return {}
    out: Dict[str, float] = defaultdict(float)
    for s, t in idle_gaps(dev, min(s for s, _ in dev), max(t for _, t in dev)):
        out[_innermost(spans, 0.5 * (s + t))] += t - s
    return dict(out)


def readings(record: dict, stages: Tuple[dict, dict, float]) -> dict:
    """What a traced record and the tracer's (totals, counts, seconds) over
    the run's window give, a frame: stage host ms (tracing off; not
    ``frame``, whose span is still open when the window's end is read), span device and traced host ms, host syncs and device idle ms by
    span, the share of kernel time under ``sr.frame`` and of idle time
    inside a stage, and frames/s untraced and in each traced stretch."""
    totals, counts, seconds = stages
    frames = counts.get("dispatch", 0)
    totals = {k: v for k, v in totals.items() if k != "frame"}
    tr = record.get("trace_host") or {}
    rows, n = tr.get("spans", []), record["stretch_frames"]
    dev_ms, host_ms = defaultdict(float), defaultdict(float)
    for name, s, t, d in rows:
        dev_ms[name] += d * 1e3 / n
        host_ms[name] += (t - s) * 1e3 / n
    idle = idle_by_span(tr.get("device", []), rows)
    kernel_s = sum(t - s for _, s, t in tr.get("device", []))
    idle_s = sum(idle.values())
    in_stage = sum(v for k, v in idle.items() if k not in ("frame", OUTSIDE))
    return {
        "stage_host_ms": {k: v * 1e3 / frames for k, v in sorted(totals.items())} if frames else {},
        "span_device_ms": dict(sorted(dev_ms.items())),
        "span_host_ms_traced": dict(sorted(host_ms.items())),
        "host_syncs": {k: v / n for k, v in sorted(tr.get("syncs", {}).items())},
        "idle_ms": {k: v * 1e3 / n for k, v in sorted(idle.items())},
        "kernel_share_in_frames": (dev_ms["frame"] * n * 1e-3 / kernel_s) if kernel_s else None,
        "idle_share_in_stages": in_stage / idle_s if idle_s else None,
        "frames_per_s_untraced": frames / seconds if seconds else None,
        "frames_per_s_traced": [n / x["seconds"] for x in (record.get("trace"), tr) if x],
        "unet_host_ms": totals.get("unet", 0.0) * 1e3 / frames if frames else None,
        "unet_device_ms": dev_ms["unet"],
        "vae_device_ms": dev_ms["vae_encode"] + dev_ms["vae_decode"],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="A cell's traced run, read by span.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if root not in sys.path:
        sys.path.insert(0, root)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import profile

    torch.set_num_threads(1)

    class SpanStretch(profile.Stretch):
        def reduce(self):
            out = super().reduce()
            if out is not None and self.host:
                out["spans"], out["syncs"] = span_rows(self.prof.events(), out["span"])
            return out

    profile.Stretch = SpanStretch
    cell = cells.load_cell(args.workload, root)
    drv = cells.driver(cell)
    snaps = []
    dispatch = drv._dispatch

    def snapshot(engine):
        t = engine.RenderManager.timer
        snaps.append((dict(t.totals), dict(t.counts), time.perf_counter()))
        return dispatch(engine)

    drv._dispatch = snapshot
    rec = drv.run(cell, seed=args.seed, seconds=args.seconds, trace=True,
                  device=torch.device("cuda", 0), t0=t0)
    (tot0, cnt0, at0), (tot1, cnt1, at1) = snaps[0], snaps[1]
    window = ({k: v - tot0.get(k, 0.0) for k, v in tot1.items()},
              {k: v - cnt0.get(k, 0) for k, v in cnt1.items()}, at1 - at0)
    out = {"workload": args.workload, "seed": args.seed, "device": rec["device"],
           "correct": cells.correct_of(cells.judge(rec["checks"], cell.limits)),
           "metrics": {k: v["value"] for k, v in cells.read_metrics(rec, cell.per_layer).items()},
           **readings(rec, window)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
