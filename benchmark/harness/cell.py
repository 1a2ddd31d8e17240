"""One run of one cell: find its files by name, run its driver, reduce.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs`` entry -> its file) under a traffic mix
(``benchmark/workloads/<traffic>.json``), whose ``driver`` names
``benchmark/drivers/<driver>.py``. The cell's correctness limits are
``benchmark/limits/<cell>.json``. Each metric is ``benchmark/metrics/<name>.py``
with ``read(record) -> float | None``; a metric that finds nothing to read
returns None and is left out of the line. Nothing here names a cell, a
configuration or a metric: a later change adds one by adding files.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "stable_renderer_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    bench_dir: str = BENCH_DIR


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A benchmark file as a module, by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    bench_dir = os.path.join(root, "benchmark")

    def applies(m: dict) -> bool:
        return "workloads" not in m or name in m["workloads"]

    return Cell(
        name=name, chips=int(entry["chips"]),
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(bench_dir, "workloads", entry["traffic"] + ".json")),
        limits=_json(os.path.join(bench_dir, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        bench_dir=bench_dir,
    )


def driver(cell: Cell):
    return load_module(os.path.join(cell.bench_dir, "drivers", cell.traffic["driver"] + ".py"),
                       "srbench_driver_" + cell.traffic["driver"])


def read_metrics(record: dict, metrics: List[dict], bench_dir: str = BENCH_DIR
                 ) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        mod = load_module(os.path.join(bench_dir, "metrics", m["name"] + ".py"),
                          "srbench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        v = mod.read(record)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, Flax's
    or the JAX package's (whole names: the port's name only begins with it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_TOP))


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number the cell's limits name, beside its limit."""
    return {name: {"value": checks.get(name), "limit": limit} for name, limit in limits.items()}


def correct_of(judged: Dict[str, dict]) -> bool:
    """Every number within its limit; one missing or not finite fails."""
    return all(c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in judged.values())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """Run the cell once and return the result line's object."""
    record = driver(cell).run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                              t0=t0)
    metrics = read_metrics(record, cell.per_layer if trace else cell.end_to_end, cell.bench_dir)
    judged = judge(record["checks"], cell.limits)
    line = {
        "correct": correct_of(judged),
        "attempted": int(record["attempted"]),
        "failed": int(record["failed"]),
        "metrics": metrics,
        "device": dict(record["device"]),
    }
    if trace and record.get("trace") is not None:
        from benchmark.harness.profile import breakdown
        from benchmark.harness.stats import union_seconds

        tr = record["trace"]
        line["device"]["busy_s"] = union_seconds([(s, t) for _, s, t in tr["device"]])
        line["device"]["window_s"] = tr["seconds"]
        line["breakdown"] = breakdown(tr, record.get("trace_host"))
    line["checks"] = judged
    return line


def print_checks(judged: Dict[str, dict]) -> None:
    for name, c in judged.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
