#!/usr/bin/env python3
"""Where K1's wgmma kernel (flash_wg) spends a K/V tile, by clock64 stamps.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/probe_torch_flash_tiles.py

Copies csrc/ to build/flash_tile_probe/csrc, adds clock64() stamps to
flash_wg's tile loop there (block (0, 0), warp 0 of each warpgroup, the first
64 tiles), builds that copy into its own library and runs the default route
at the all-frames levels 2 and 1, (8, 2048², 160) and (8, 8192², 80), and at
the UNet's (16, 4096², 40). For each warpgroup it prints the median clocks of
a tile between the stamps (tiles 4..27): waiting for the tile to land, for
its turn to issue (ping-pong), issuing S(j + 1) and P.V(j), thread 0's TMA
issue (produce), waiting for S, the softmax, waiting for P.V. The stamps add
a few instructions a tile, so the periods read a little long. The checkout's
own sources and library are not touched. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PROBE_DIR = ROOT / "build" / "flash_tile_probe"
SHAPES = ((8, 2048, 160), (8, 8192, 80), (16, 4096, 40))  # (BH, L, d)
STAMPS = ("start", "landed", "turn", "issued", "produced", "S done", "softmax", "PV done")

# (anchor in flash_attention.cu, text that replaces it): each anchor must
# occur exactly once, or the probe stops
PATCHES = (
    ("template <int DK, int DV, int BK, int R, int NWG, bool PP, bool SW32>\n__global__",
     "__device__ long long g_stamps[4][64][8];\n\n"
     "template <int DK, int DV, int BK, int R, int NWG, bool PP, bool SW32>\n__global__"),
    ("  auto tile = [&](int j, bool more) {\n",
     "  auto stamp = [&](int j, int k) {\n"
     "    if (blockIdx.x == 0 && blockIdx.y == 0 && lane == 0 && (warp & 3) == 0 && j < 64)\n"
     "      g_stamps[wg][j][k] = clock64();\n"
     "  };\n"
     "  auto tile = [&](int j, bool more) {\n"
     "    stamp(j, 0);\n"),
    ("    if (more) landed(j + 1);\n"
     "    if (PP) named_sync(1 + wg, 256);  // this warpgroup's turn to issue\n",
     "    if (more) landed(j + 1);\n    stamp(j, 1);\n"
     "    if (PP) named_sync(1 + wg, 256);  // this warpgroup's turn to issue\n    stamp(j, 2);\n"),
    ("      named_arrive(1 + (wg + 1) % NWG, 256);\n    produce(j + R - 2);",
     "      named_arrive(1 + (wg + 1) % NWG, 256);\n    stamp(j, 3);\n    produce(j + R - 2);"),
    ("    if (more) {\n      wgmma_wait<1>();  // S(j + 1); P.V(j) runs on\n"
     "      fence_regs<NS>(sc);\n      softmax(j + 1);\n    }\n    wgmma_wait<0>();\n"
     "    fence_regs<NO>(o);\n",
     "    stamp(j, 4);\n    if (more) {\n      wgmma_wait<1>();  // S(j + 1); P.V(j) runs on\n"
     "      fence_regs<NS>(sc);\n      stamp(j, 5);\n      softmax(j + 1);\n      stamp(j, 6);\n"
     "    }\n"
     "    wgmma_wait<0>();\n    fence_regs<NO>(o);\n    stamp(j, 7);\n"),
    ('extern "C" const char* sr_cuda_error_string(int code) {',
     'extern "C" int sr_debug_stamps(void* host, int bytes) {\n'
     "  return (int)cudaMemcpyFromSymbol(host, g_stamps, bytes);\n}\n\n"
     'extern "C" const char* sr_cuda_error_string(int code) {'),
)


def patched_sources() -> Path:
    """csrc/ copied under PROBE_DIR with the stamps in flash_attention.cu."""
    from stable_renderer_tpu_torch.kernels import _build

    dst = PROBE_DIR / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, dst)
    src = (dst / "flash_attention.cu").read_text()
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            sys.exit(f"flash_attention.cu changed: an anchor occurs {src.count(anchor)} times:\n"
                     f"{anchor}")
        src = src.replace(anchor, text)
    (dst / "flash_attention.cu").write_text(src)
    return dst


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    from stable_renderer_tpu_torch.kernels import _build
    from stable_renderer_tpu_torch.ops import flash_attention as tfa

    csrc = patched_sources()
    _build.NVCC_FLAGS = tuple(str(csrc) if f == str(_build.CSRC_DIR) else f
                              for f in _build.NVCC_FLAGS)
    _build.CSRC_DIR, _build.BUILD_DIR = csrc, PROBE_DIR / "kernels"
    _build.build(verbose=True)
    serialized = _build.serialized_wgmma(_build.ptxas_log or "")
    if serialized:
        sys.exit(f"the stamps made ptxas serialize wgmma: {serialized[0]}")
    lib = _build.load_library()
    lib.sr_debug_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda", 0)
    for bh, l, d in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn((bh, l, 1, d), generator=g, device=dev).bfloat16()
                   for _ in range(3))
        for _ in range(3):
            tfa._launch_bf16(q, k, v)
        torch.cuda.synchronize()
        stamps = np.zeros((4, 64, 8), dtype=np.int64)
        _build.check(lib.sr_debug_stamps(stamps.ctypes.data, stamps.nbytes), "sr_debug_stamps")
        print(f"(BH {bh}, L {l}, d {d}) the default route, block 0, tiles 4..27, median clocks "
              f"| {card}", flush=True)
        for wg in range(4):
            st = stamps[wg, 4:28]
            if not st[:, 0].any():
                continue
            steps = np.median(np.diff(st, axis=1), axis=0)
            print(f"  warpgroup {wg}: tile period {np.median(np.diff(st[:, 0])):.0f}; "
                  + ", ".join(f"{STAMPS[i]}->{STAMPS[i + 1]} {steps[i]:.0f}" for i in range(7))
                  + f", PV done->next start {np.median(st[1:, 0] - st[:-1, 7]):.0f}", flush=True)
    print(card)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
