"""The native OBJ parser (C++ through ctypes).

Counterpart of stable_renderer_tpu/native/: ``objloader.cpp`` here is the
port's own copy of the single-pass parser (vertex dedup per (v, vt, vn),
fan triangulation, usemtl indices). ``g++`` builds it at first use into
``build/native/`` at the repository root, the library named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
reuses the last build; nothing is written into either package's directory.
Without a compiler, ``load_obj_native`` returns None, logged once, and
``Mesh.Load`` reads the file with the Python ``load_obj``. ``parses``
counts the files this process parsed natively.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from stable_renderer_tpu_torch.utils.log import get_logger

logger = get_logger("sr_tpu_torch.native")

SOURCE = Path(__file__).resolve().parent / "objloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
parses = 0  # files parsed by the native library in this process


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libobjloader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the parser unless a library for this exact source exists;
    raises if g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)  # concurrent builds each land a whole file
    finally:
        tmp.unlink(missing_ok=True)
    logger.info(f"built native obj loader: {out}")
    return out


def _ensure_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except Exception as e:  # noqa: BLE001 - no compiler, a failed build or load
            logger.warning(f"native OBJ parser unavailable ({e}); Mesh.Load uses load_obj")
            _build_failed = True
            return None
        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p]
        lib.obj_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.obj_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
        lib.obj_material_name.restype = ctypes.c_char_p
        lib.obj_material_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.obj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    return _ensure_lib() is not None


def load_obj_native(path: str | Path):
    """Parse an OBJ natively. Returns
    (positions (V,3), uvs (V,2), normals (V,3), tris (T,3), tri_mat (T,),
    material_names) or None when the native library is unavailable."""
    global parses
    lib = _ensure_lib()
    if lib is None:
        return None
    handle = lib.obj_parse(str(path).encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        counts = (ctypes.c_int64 * 3)()
        lib.obj_counts(handle, counts)
        nv, nt, nm = counts[0], counts[1], counts[2]
        pos = np.empty((nv, 3), np.float32)
        uv = np.empty((nv, 2), np.float32)
        nrm = np.empty((nv, 3), np.float32)
        tris = np.empty((nt, 3), np.int32)
        tri_mat = np.empty((nt,), np.int32)
        lib.obj_fill(
            handle,
            pos.ctypes.data_as(ctypes.c_void_p),
            uv.ctypes.data_as(ctypes.c_void_p),
            nrm.ctypes.data_as(ctypes.c_void_p),
            tris.ctypes.data_as(ctypes.c_void_p),
            tri_mat.ctypes.data_as(ctypes.c_void_p),
        )
        names = [lib.obj_material_name(handle, i).decode() for i in range(nm)]
    finally:
        lib.obj_free(handle)
    parses += 1
    return pos, uv, nrm, tris, tri_mat, names
