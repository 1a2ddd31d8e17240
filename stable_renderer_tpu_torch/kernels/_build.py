"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the build
takes seconds). The sources share the headers ``csrc/*.cuh`` (``-I csrc``).
The library lives in ``build/kernels/`` at the repository root, named by a
hash of the sources, the headers and the flags, so an edit to a kernel or a
header rebuilds it and an unchanged tree reuses the last build.
``build(verbose=True)`` also gives ptxas's report of every kernel
(``-Xptxas -v``: registers, spills, and any wgmma it serialized), compiling
again for it when the library was already built.

Nothing here runs at import time: the first wrapper that launches a kernel
calls ``load_library()``. A missing compiler or a failed build raises; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-I", str(CSRC_DIR),
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build, if it built
ptxas_log: Optional[str] = None  # ptxas's report of this process's last verbose build


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list:
    return sorted(CSRC_DIR.glob("*.cuh"))


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
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsr_kernels_{h.hexdigest()[:16]}.so"


def serialized_wgmma(log: str) -> list:
    """The lines of a ptxas report saying that it serialized wgmma
    instructions (C7510-C7515), which it reports nowhere else."""
    return [ln for ln in log.splitlines() if re.search(r"C751[0-5]", ln)]


def _compile(nvcc: str, obj_dir: Path, tag: str, verbose: bool) -> list:
    """One nvcc a source, all started together; the objects' paths. With
    ``verbose``, ptxas's report goes to ``ptxas_log`` and stdout."""
    global ptxas_log
    jobs = []
    for src in sources():
        obj = obj_dir / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c", "-o", str(obj),
               str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in jobs]
    objs = [obj for _, obj, _ in jobs]
    for cmd, log, rc in logs:
        if rc != 0:
            for obj in objs:
                obj.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
    if verbose:
        ptxas_log = "\n".join(log for _, log, _ in logs)
        print(ptxas_log)
    return objs


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these exact sources exists.
    ``verbose``: compile with ``-Xptxas -v`` and keep ptxas's report in
    ``ptxas_log``; if the library exists, compile again for the report only
    (into a scratch directory) and keep the library."""
    global build_seconds
    out = library_path()
    if out.exists():
        if verbose:
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                _compile(find_nvcc(), Path(tmp), out.stem, True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    objs = _compile(nvcc, BUILD_DIR, f"{out.stem}.{os.getpid()}", verbose)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
    finally:
        for obj in objs:
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
            # q, k, v, out, scratch, bh, lq, lk, d, scale, stream
            lib.sr_flash_attention_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, *[i32] * 4, f32, ptr]
            lib.sr_flash_attention_f32.restype = i32
            lib.sr_flash_attention_f32_scratch.argtypes = [i32] * 4
            lib.sr_flash_attention_f32_scratch.restype = ctypes.c_longlong
            lib.sr_flash_attention_route.argtypes = [i32, i32]  # head dim, f32
            lib.sr_flash_attention_route.restype = ctypes.c_char_p
            # clip, vertices, tris, tris int64, triangles, height, width, cull,
            # constants out, tile ranges out, stream
            lib.sr_raster_setup.argtypes = [ptr, i32, ptr, *[i32] * 5, ptr, ptr, ptr]
            lib.sr_raster_setup.restype = i32
            # constants, tile ranges, triangles, z, tri_id, bary, height, width, stream
            lib.sr_raster_tiles.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, i32, i32, ptr]
            lib.sr_raster_tiles.restype = i32
            # x, weight tensor map, bias, bias kind, pre_scale, pre_shift, a_scale,
            # w_scale, out, act scratch, n, h, w, cin, cout, cs, int8, x f32,
            # out f32, act silu, pre, pre silu, bn, nwg, mb, stream
            lib.sr_conv3x3.argtypes = [ptr, ptr, ptr, i32, *[ptr] * 6, *[i32] * 15, ptr]
            lib.sr_conv3x3.restype = i32
            # map out (128 bytes), weights (cout, 3, 3, cs), cout, cs, int8, bn
            lib.sr_conv3x3_weight_map.argtypes = [ptr, ptr, *[i32] * 4]
            lib.sr_conv3x3_weight_map.restype = i32
            # x, weight, bias, wb bf16, y, n, s, c, groups, slice channels, cluster,
            # rows a CTA, rows a pass, passes, resident, eps, silu, x f32, stream
            lib.sr_group_norm.argtypes = [ptr, ptr, ptr, i32, ptr, *[i32] * 10, f32, i32, i32,
                                          ptr]
            lib.sr_group_norm.restype = i32
            # n, s, c, groups, slice channels, cluster, rows a CTA, rows a pass,
            # passes, resident, x f32
            lib.sr_group_norm_max_clusters.argtypes = [i32] * 11
            lib.sr_group_norm_max_clusters.restype = i32
            lib.sr_cuda_error_string.argtypes = [i32]
            lib.sr_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = load_library().sr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
