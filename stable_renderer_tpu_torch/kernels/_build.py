"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the build
takes seconds). The library lives in ``build/kernels/`` at the repository
root, named by a hash of the sources and flags, so an edit to a kernel
rebuilds it and an unchanged tree reuses the last build.

Nothing here runs at import time: the first wrapper that launches a kernel
calls ``load_library()``. A missing compiler or a failed build raises; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build, if it built


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsr_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these exact sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c", "-o", str(obj),
               str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in jobs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    try:
        for cmd, log, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
            if verbose:
                print(log)
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernels' library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            # q, k, v, out, scratch, strides (12 int64), batch, heads, lq, lk, d,
            # scale, tile variant, stream
            lib.sr_flash_attention_bf16.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                                    ctypes.POINTER(ctypes.c_longlong),
                                                    *[i32] * 5, f32, i32, ptr]
            lib.sr_flash_attention_bf16.restype = i32
            lib.sr_flash_attention_bf16_scratch.argtypes = [i32] * 5
            lib.sr_flash_attention_bf16_scratch.restype = ctypes.c_longlong
            lib.sr_flash_attention_bf16_default.argtypes = [i32]
            lib.sr_flash_attention_bf16_default.restype = i32
            lib.sr_flash_attention_bf16_variant.argtypes = [i32]
            lib.sr_flash_attention_bf16_variant.restype = ctypes.c_char_p
            lib.sr_flash_attention_f32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, ptr]
            lib.sr_flash_attention_f32.restype = i32
            lib.sr_raster_tile.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i32, ptr]
            lib.sr_raster_tile.restype = i32
            # x, weights (cout, 3, 3, cs), bias, bias kind, pre_scale, pre_shift,
            # a_scale, w_scale, out, act scratch, n, h, w, cin, cout, cs, int8,
            # x f32, out f32, act silu, pre, pre silu, stream
            lib.sr_conv3x3.argtypes = [ptr, ptr, ptr, i32, *[ptr] * 6, *[i32] * 12, ptr]
            lib.sr_conv3x3.restype = i32
            # x, weight, bias, wb bf16, y, part, scale, shift, n, s, c, groups, chunks,
            # rows, eps, silu, x f32, stream
            lib.sr_group_norm.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr,
                                          *[i32] * 6, f32, i32, i32, ptr]
            lib.sr_group_norm.restype = i32
            lib.sr_cuda_error_string.argtypes = [i32]
            lib.sr_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = load_library().sr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
