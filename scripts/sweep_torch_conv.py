#!/usr/bin/env python3
"""K3's compiled tile shapes on the card, at the frame's shape classes.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/sweep_torch_conv.py [--picked-only [--profile]] [--out result.jsonl]

Builds the kernels with ``-Xptxas -v`` (compiling again for the report when
the library is already built) and prints what ptxas says of K3's kernels
(registers, spills, and any wgmma it serialized: C7510-C7515); it stops
with an error if the report names no K3 kernel or any serialized wgmma. Then,
for every shape class of the int8 frame (int8) and of the switched frame
(bf16, with the GroupNorm+SiLU prologue where the frame has it), and for
every launch K3 can make of it (``ops.conv_kernel.tile_candidates``):
checks the kernel against its plain version (int8 bit for bit, bf16 within
one bf16 step + 1e-3) and times it by CUDA-graph replay (chip_smoke.graph_ms),
marking the launch the tile picker chooses. One JSON object a line.

``--picked-only`` skips the report and times only the tile shape the wrapper
picks, at the nine shapes chip_smoke.py phase 7 times (K3_TIMED_SHAPES),
beside the per-call time with the host's launch cost and, in bf16, cuDNN's
conv: it uses nothing but ``conv3x3_kernel``, its plain version and
chip_smoke.py's helpers, so this script and chip_smoke.py copied into an
older tree (scripts/ and the root) time that tree's K3 the same way (two
trees in turns in one call: parent, change, change, parent); ``--profile``
adds each kernel's device time by torch.profiler (the prep pass and the GEMM
apart).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cases():
    import chip_smoke

    out = [(s, "int8") for s in chip_smoke.K3_INT8_FRAME_SHAPES]
    out += [(k[:5], "bf16+prologue" if k[5] else "bf16")
            for k in chip_smoke.K3_SWITCHED_FRAME_SHAPES]
    return out


def profile_kernels(fn, calls: int = 10) -> dict:
    """Each device kernel's mean time per call of fn (ms), by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0:
            out[ev.key[:60]] = dt / 1e3 / calls
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--picked-only", action="store_true",
                    help="time the picked tile shape at the TIMED shapes (works in older trees)")
    ap.add_argument("--profile", action="store_true",
                    help="with --picked-only: each kernel's device time by torch.profiler")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from stable_renderer_tpu_torch.kernels import _build
    from stable_renderer_tpu_torch.ops import conv_kernel as tck

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    out_f = open(args.out, "w") if args.out else None

    def emit(rec):
        print(json.dumps(rec), flush=True)
        if out_f:
            out_f.write(json.dumps(rec) + "\n")

    if args.picked_only:
        _build.build()
        emit({"card": card})
    else:
        with contextlib.redirect_stdout(io.StringIO()):
            _build.build(verbose=True)
        lines = _build.ptxas_log.splitlines()
        # each K3 kernel's lines: its name, then its registers and spills
        print("\n".join(ln for i, ln in enumerate(lines) if "C751" in ln or
                        any("conv3x3_wgmma" in prev for prev in lines[max(0, i - 3):i + 1])))
        entries = [ln for ln in lines if "Compiling entry function" in ln and "conv3x3_wgmma" in ln]
        serialized = _build.serialized_wgmma(_build.ptxas_log)
        emit({"card": card, "conv3x3_wgmma_kernels": len(entries),
              "serialized_wgmma_lines": len(serialized) if entries else None})
        if not entries or serialized:
            sys.exit("ptxas's report names no conv3x3_wgmma kernel" if not entries else
                     f"ptxas serialized wgmma: {serialized[0]}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = 0
    for (n, h, w, cin, cout), mode in chip_smoke.K3_TIMED_SHAPES if args.picked_only else cases():
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(torch.bfloat16)
        wf = torch.randn((3, 3, cin, cout), generator=gen, device=dev) / (3.0 * cin ** 0.5)
        b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        kw = {}
        int8 = mode == "int8"
        if int8:
            ws = wf.abs().amax((0, 1, 2)) / 127.0
            wk = torch.clamp(torch.round(wf / ws), -127, 127).to(torch.int8)
            kw.update(a_scale=(x.float().abs().amax() / 127.0).reshape(()), w_scale=ws)
        else:
            wk = wf.to(torch.bfloat16)
        if mode == "bf16+prologue":
            kw.update(pre_scale=torch.rand((n, cin), generator=gen, device=dev) + 0.5,
                      pre_shift=torch.randn((n, cin), generator=gen, device=dev) * 0.5,
                      pre_act="silu")
        ref = tck.conv3x3_kernel_reference(x, wk, b, **kw).float()
        bnd, _ = chip_smoke.bound(chip_smoke.nbytes(x, wk, b, ref.to(torch.bfloat16),
                                                    kw.get("pre_scale"), kw.get("pre_shift")),
                                  2.0 * n * h * w * cout * 9 * cin, "int8" if int8 else "bf16")
        if args.picked_only:
            out = tck.conv3x3_kernel(x, wk, b, **kw)
            torch.cuda.synchronize()
            diff = (out.float() - ref).abs()
            ok = (diff.max().item() == 0.0 if int8 else
                  bool((diff <= chip_smoke.BF16_STEP * ref.abs() + chip_smoke.K3_BF16_ATOL).all()))
            failures += not ok
            rec = {"shape": f"{n}x{h}x{w}x{cin}->{cout}", "mode": mode, "ok": ok,
                   "max_abs_err": diff.max().item(), "bound_ms": bnd,
                   "ms": chip_smoke.graph_ms(lambda: tck.conv3x3_kernel(x, wk, b, **kw)),
                   "ms_with_host": chip_smoke.cuda_ms(lambda: tck.conv3x3_kernel(x, wk, b, **kw),
                                                      20)}
            if not int8:  # cuDNN's conv alone, channels_last bf16
                x_cl = x.permute(0, 3, 1, 2)
                w_cl = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                rec["library_ms"] = chip_smoke.graph_ms(
                    lambda: torch.nn.functional.conv2d(x_cl, w_cl, b, padding=1))
            if args.profile:
                rec["kernel_ms"] = profile_kernels(lambda: tck.conv3x3_kernel(x, wk, b, **kw))
            emit(rec)
            continue
        picked = tck.conv_tiles(n, h, w, cin, cout, int8)
        for t in tck.tile_candidates(n, h, w, cin, cout, int8):
            rec = {"shape": f"{n}x{h}x{w}x{cin}->{cout}", "mode": mode, "bn": t.bn,
                   "nwg": t.nwg, "mb": t.mb, "picked": t == picked,
                   "bound_ms": bnd}
            try:
                out = tck._launch(x, wk, b, tiles=t, **kw)
                torch.cuda.synchronize()
            except RuntimeError as e:
                rec["error"] = str(e)
                failures += 1
                emit(rec)
                continue
            diff = (out.float() - ref).abs()
            rec["max_abs_err"] = diff.max().item()
            ok = (rec["max_abs_err"] == 0.0 if int8 else
                  bool((diff <= chip_smoke.BF16_STEP * ref.abs() + chip_smoke.K3_BF16_ATOL).all()))
            rec["ok"] = ok
            failures += not ok
            if ok:
                rec["ms"] = chip_smoke.graph_ms(lambda: tck._launch(x, wk, b, tiles=t, **kw))
            emit(rec)
        del x, wk, ref
    if out_f:
        out_f.close()
    if failures:
        sys.exit(f"{failures} K3 launches failed or disagreed with the plain version")


if __name__ == "__main__":
    main()
