"""The harness's own checks: names, files found by name, metric arithmetic,
no run without a card, and what the benchmark imports.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import stats  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in b["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)


def test_every_cell_reports_what_its_layer_metrics_move():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        target = e2e[m["moves"]]
        for w in m.get("workloads", [x["name"] for x in b["workloads"]]):
            assert "workloads" not in target or w in target["workloads"], (m["name"], w)
    for w in b["workloads"]:
        names = [m["name"] for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in names and len(names) >= 2


def test_every_cell_has_its_files():
    for w in bench()["workloads"]:
        cell = cells.load_cell(w["name"], ROOT)
        assert os.path.exists(os.path.join(BENCH, "drivers", cell.traffic["driver"] + ".py"))
        for m in cell.end_to_end + cell.per_layer:
            assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]


def test_new_config_workload_and_metric_are_found_by_name(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "benchmark/configs/sd15.json").read_text())
    cfg["name"] = "newcfg"
    (tmp_path / "benchmark/configs/newcfg.json").write_text(json.dumps(cfg))
    traffic = json.loads((tmp_path / "benchmark/workloads/stream-512.json").read_text())
    traffic["size"] = [256, 256]
    (tmp_path / "benchmark/workloads/stream-256.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/limits/newcfg-stream-256.json").write_text('{"start_mad": 1.0}')
    (tmp_path / "benchmark/metrics/new_metric.py").write_text(
        "def read(rec):\n    return 2.0 * rec['seconds']\n")
    b["configs"].append({"name": "newcfg", "source": "https://example.org", "why": "test",
                         "file": "benchmark/configs/newcfg.json", "reduced": []})
    b["workloads"].append({"name": "newcfg-stream-256", "config": "newcfg", "chips": 1,
                           "traffic": "stream-256", "why": "test"})
    b["end_to_end"].append({"name": "new_metric", "unit": "s", "better": "lower",
                            "bound": 0.1, "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = cells.load_cell("newcfg-stream-256", str(tmp_path))
    assert cell.config["name"] == "newcfg" and cell.traffic["size"] == [256, 256]
    assert cell.limits == {"start_mad": 1.0}
    assert "new_metric" in [m["name"] for m in cell.end_to_end]
    assert cells.driver(cell).__file__.startswith(str(tmp_path))
    got = cells.read_metrics({"seconds": 3.0}, [m for m in cell.end_to_end
                                                if m["name"] == "new_metric"], cell.bench_dir)
    assert got == {"new_metric": {"value": 6.0, "unit": "s"}}


@pytest.mark.parametrize("intervals,want", [
    ([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)], 3.0),
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),
    ([(2.0, 3.0), (0.0, 5.0)], 5.0),
    ([], 0.0),
])
def test_union_of_device_intervals(intervals, want):
    assert stats.union_seconds(intervals) == pytest.approx(want)


def test_idle_gaps_cover_what_no_interval_does():
    assert stats.idle_gaps([(1.0, 2.0), (1.5, 3.0), (4.0, 5.0)], 0.0, 6.0) == [
        (0.0, 1.0), (3.0, 4.0), (5.0, 6.0)]


def test_percentiles_of_all_gaps():
    gaps = stats.gaps_ms([0.0, 0.1, 0.2, 0.5, 0.6])
    assert gaps == pytest.approx([100.0, 100.0, 300.0, 100.0])
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95.0) == pytest.approx(95.05)
    assert stats.percentile(xs, 50.0) == pytest.approx(50.5)
    assert stats.percentile([7.0], 95.0) == 7.0


def _load_metric(name):
    return cells.load_module(os.path.join(BENCH, "metrics", name + ".py"), "m_" + name)


def test_rate_is_all_presents_in_the_window_over_its_seconds():
    presents = [(i, 0.25 * i) for i in range(20)]  # 4 frames/s from t = 0
    rec = {"completions": [t for _, t in presents], "seconds": 2.0,
           "presents": presents, "t_start": 1.0, "t_end": 3.0, "t0": 0.5, "lag": 4,
           "begins": {i: 0.25 * i - 0.1 for i in range(20)}}
    assert _load_metric("frames_per_s").read(rec) == pytest.approx(4.0)
    rec["t_end"] = 3.1  # 0.4 of the next frame's interval counts
    assert _load_metric("frames_per_s").read(rec) == pytest.approx(8.4 / 2.0)
    rec["t_end"] = 3.0
    assert _load_metric("setup_s").read(rec) == pytest.approx(0.5)
    assert _load_metric("frame_gap_p95_ms").read(rec) == pytest.approx(250.0)
    # each present shows the scene begun 4 frames and 0.1 s earlier: 1.1 s
    assert _load_metric("frame_latency_p95_ms").read(rec) == pytest.approx(1100.0)


def test_trace_metrics_read_nothing_without_a_trace():
    for name in ("kernels_per_frame", "device_idle_pct", "mfu_pct", "k1_roofline",
                 "k3_roofline"):
        assert _load_metric(name).read({"trace": None, "work": None}) is None


def test_device_idle_and_kernel_count_from_a_synthetic_trace():
    tr = {"seconds": 1.0, "device": [("flash_wg", 0.1, 0.3), ("gemm", 0.2, 0.4),
                                          ("Memcpy DtoH", 0.5, 0.6)], "host": []}
    rec = {"trace": tr, "stretch_frames": 2, "work": None}
    assert _load_metric("device_idle_pct").read(rec) == pytest.approx(60.0)
    assert _load_metric("kernels_per_frame").read(rec) == pytest.approx(1.0)


def test_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "sd15-stream-512", "--seed", "4294967311", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _py_files(BENCH):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "stable_renderer_tpu"), \
                (path, mod)


def test_the_reference_imports_nothing_of_the_port():
    for path in _py_files(os.path.join(BENCH, "reference")):
        for mod in _imports(path):
            assert mod.split(".")[0] != "stable_renderer_tpu_torch", (path, mod)
