#!/usr/bin/env python3
"""Time K2 and K4 of the PyTorch port on one GPU, for comparing two trees.

Run from the root of a tree; the script uses that tree's package (and its
chip_smoke.py for cuda_ms and bench_matrices), so the same script times an
older tree when copied into its scripts/ directory:

    python3 scripts/time_torch_k2_k4.py [--label NAME] [--rounds 3] [--out result.jsonl]

K2: the whole ``rasterize_kernel`` call at 512x512 on the bench sphere
(cull_backface=True), triangle setup included. K4: ``group_norm_kernel`` with
SiLU at chip_smoke's three timed shapes (bf16, 32 groups). For each: the
device time of one call by CUDA-graph replay with 10 calls captured a graph
(``ms``: the calls run back to back, and the host's cost of a replay, a few
microseconds, is spread over ten), the same with one call a graph
(``ms_one_call_a_graph``, as chip_smoke times K1 and K3), the per-call time with
the host's launch cost by CUDA events (``ms_with_host``), each the median of
``--rounds`` rounds, and the kernels one call launches, by name
(torch.profiler). ``floor``: one ``fill_`` of a single element, the least a
call can take by each of these clocks. Prints one JSON line (and appends it
to ``--out``) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def graph_ms(fn, calls: int, repeats: int = 20) -> float:
    """Device milliseconds of one call: ``calls`` calls captured in a CUDA
    graph, the graph replayed ``repeats`` times between two events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(repeats):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (repeats * calls)


def kernels_of(fn, calls: int = 3) -> list:
    """The kernels one call launches, by torch.profiler: a warm-up step of
    ``calls`` calls (dropped), then ``calls`` calls recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA" and not e.name.startswith("ProfilerStep")]
    return names[:len(names) // calls]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers
    from stable_renderer_tpu_torch.ops.group_norm_kernel import group_norm_kernel
    from stable_renderer_tpu_torch.ops.raster import vertex_stage
    from stable_renderer_tpu_torch.ops.raster_kernel import rasterize_kernel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)

    def timed(fn) -> dict:
        graph = [graph_ms(fn, 10) for _ in range(args.rounds)]
        one = [graph_ms(fn, 1) for _ in range(args.rounds)]
        host = [chip_smoke.cuda_ms(fn, 20) for _ in range(args.rounds)]
        names = kernels_of(fn)
        return {"ms": statistics.median(graph), "ms_rounds": graph,
                "ms_one_call_a_graph": statistics.median(one),
                "ms_with_host": statistics.median(host), "kernels_a_call": len(names),
                "kernel_names": sorted(set(n[:60] for n in names))}

    bufs = mesh_device_buffers(Mesh.Sphere(1.0, 48), dev)
    mv, proj = chip_smoke.bench_matrices(0)
    clip, _, _ = vertex_stage(bufs["positions"], bufs["normals"], torch.from_numpy(mv).to(dev),
                              torch.from_numpy(proj).to(dev))
    tris = bufs["tris"]
    cell = torch.zeros(1, device=dev)
    result = {"label": args.label, "card": card, "floor": timed(lambda: cell.fill_(1.0)),
              "k2_512_sphere": timed(lambda: rasterize_kernel(clip, tris, 512, 512, True))}
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in ((2, 1024, 640), (2, 256, 1920), (1, 4096, 512)):
        x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3).to(torch.bfloat16)
        w = torch.randn((shape[2],), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn((shape[2],), generator=gen, device=dev).to(torch.bfloat16)
        result["k4_" + "x".join(map(str, shape))] = timed(
            lambda: group_norm_kernel(x, w, b, groups=32, act="silu"))
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
