"""The port's mesh loading (engine/mesh.py Mesh.Load and load_obj,
engine/mesh_formats.py, native/) against the JAX package's, on the CPU.

Every file goes through both packages' ``Mesh.Load``, and every array of the
two meshes must be equal exactly (not within a tolerance: both run the same
numpy arithmetic), as must ``material_names`` and ``name``. The files come
from the writers of tests/test_mesh_formats.py and tests/test_native.py,
imported, and from chip_smoke.py's writers (a small sphere in each format).
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from stable_renderer_tpu.engine.mesh import Mesh as JMesh
from stable_renderer_tpu.engine.mesh import load_obj as j_load_obj
from stable_renderer_tpu_torch import native
from stable_renderer_tpu_torch.engine.mesh import Mesh as PMesh
from stable_renderer_tpu_torch.engine.mesh import load_obj as p_load_obj
from test_mesh_formats import (
    ASCII_FBX,
    DAE_DOC,
    QUAD_POS,
    QUAD_TRIS,
    _write_fbx,
    _write_glb,
)
from test_native import OBJ

torch.set_num_threads(1)

ARRAYS = ("positions", "normals", "uvs", "colors", "tris", "vertex_ids", "tangents",
          "bitangents", "tri_material")
REPO = Path(__file__).resolve().parents[1]


def assert_same_mesh(a, b) -> None:
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (f, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.material_names == b.material_names
    assert a.name == b.name


def _gltf_with_data_uri(glb: Path, out: Path) -> None:
    """The GLB's JSON with its BIN chunk as a base64 data URI (.gltf)."""
    data = glb.read_bytes()
    jlen = struct.unpack_from("<I", data, 12)[0]
    gltf = json.loads(data[20:20 + jlen])
    blen = struct.unpack_from("<I", data, 20 + jlen)[0]
    blob = data[28 + jlen:28 + jlen + blen]
    gltf["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                 + base64.b64encode(blob).decode())
    out.write_text(json.dumps(gltf))


def _stl_binary(path: Path) -> None:
    with open(path, "wb") as f:
        f.write(b"\x00" * 80 + struct.pack("<I", len(QUAD_TRIS)))
        for t in QUAD_POS[QUAD_TRIS.astype(int)]:
            f.write(np.zeros(3, np.float32).tobytes() + t.astype(np.float32).tobytes()
                    + struct.pack("<H", 0))


def _ply_ascii_quad(path: Path) -> None:
    rows = ["ply", "format ascii 1.0", "element vertex 4", "property float x",
            "property float y", "property float z", "property uchar red",
            "property uchar green", "property uchar blue", "element face 1",
            "property list uchar int vertex_indices", "end_header"]
    rows += [f"{x:g} {y:g} {z:g} {r} {g} {b}" for (x, y, z), (r, g, b) in
             zip(QUAD_POS, [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 255)])]
    path.write_text("\n".join(rows + ["4 0 1 2 3"]))


def _write(kind: str, d: Path) -> Path:
    """One file of ``kind``, written with the JAX tests' writers where they
    have one."""
    if kind == "obj":
        p = d / "quad.obj"
        p.write_text(OBJ)
    elif kind == "glb":
        p = d / "quad.glb"
        _write_glb(p)
    elif kind == "glb-moved":
        p = d / "moved.glb"
        _write_glb(p, translation=[10.0, 0.0, 0.0])
    elif kind == "gltf":
        _write_glb(d / "src.glb")
        p = d / "quad.gltf"
        _gltf_with_data_uri(d / "src.glb", p)
    elif kind == "stl":
        p = d / "quad.stl"
        _stl_binary(p)
    elif kind == "ply":
        p = d / "quad.ply"
        _ply_ascii_quad(p)
    elif kind == "dae":
        p = d / "quad.dae"
        p.write_text(DAE_DOC)
    elif kind == "fbx":
        p = d / "tri.fbx"
        _write_fbx(p)
    elif kind == "fbx-ascii":
        p = d / "a.fbx"
        p.write_text(ASCII_FBX)
    return p


@pytest.mark.parametrize("kind", ["obj", "glb", "glb-moved", "gltf", "stl", "ply", "dae", "fbx",
                                  "fbx-ascii"])
def test_load_matches_jax(tmp_path, kind):
    p = _write(kind, tmp_path)
    assert_same_mesh(PMesh.Load(p), JMesh.Load(p))


@pytest.mark.parametrize("fmt", chip_smoke.MESH_WRITERS)
def test_chip_smoke_writers_load_as_jax(tmp_path, fmt):
    """chip_smoke.py's writers (a 12-segment sphere with uvs, normals and two
    materials where the format has them) give files both packages load
    alike, and that check_loaded_mesh passes."""
    sphere = PMesh.Sphere(1.0, 12)
    p = chip_smoke.write_mesh(sphere, tmp_path / f"s{chip_smoke.MESH_WRITERS[fmt]}", fmt)
    mine = PMesh.Load(p)
    assert_same_mesh(mine, JMesh.Load(p))
    if fmt == "obj":  # the native parser and the Python one, array for array
        assert_same_mesh(mine, p_load_obj(p))
    assert chip_smoke.check_loaded_mesh(sphere, mine, fmt) == []


def test_native_parser_matches_load_obj(tmp_path):
    """The port's native parser against its own load_obj and JAX's, on the
    JAX tests' OBJ and on one with negative indices."""
    p = _write("obj", tmp_path)
    neg = tmp_path / "neg.obj"
    neg.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\nvt 1 1\nvn 0 0 1\n"
                   "usemtl a\nf -4/-2/-1 -3/-1/-1 -2/-2/-1\nf -3 -1 -2\n")
    for path in (p, neg):
        before = native.parses
        pos, uv, nrm, tris, tri_mat, names = native.load_obj_native(path)
        assert native.parses == before + 1
        for ref in (p_load_obj(path), j_load_obj(path)):
            np.testing.assert_array_equal(pos, ref.positions)
            np.testing.assert_array_equal(uv, ref.uvs)
            np.testing.assert_array_equal(tris, ref.tris)
            np.testing.assert_array_equal(tri_mat, ref.tri_material)
            assert names == ref.material_names
        assert_same_mesh(PMesh.Load(path), JMesh.Load(path))
    assert_same_mesh(p_load_obj(neg), j_load_obj(neg))
    assert native.load_obj_native(neg)[3].tolist() == [[0, 1, 2], [3, 4, 5]]


def test_native_builds_under_build_dir(tmp_path, monkeypatch):
    """The library lands in build/native/ (here a temporary one), named by
    the source's hash; nothing is written into either package's native/."""
    from stable_renderer_tpu import native as jax_native

    assert native.library_path().parent == REPO / "build" / "native"
    port_dir = REPO / "stable_renderer_tpu_torch" / "native"
    before = sorted(f.name for f in port_dir.iterdir() if f.name != "__pycache__")
    jax_native.available()  # the JAX package builds its own library where it keeps it
    jax_dir = REPO / "stable_renderer_tpu" / "native"
    jax_files = {f.name: f.stat().st_mtime_ns for f in jax_dir.iterdir()}
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    out = native.build()
    assert {f.name: f.stat().st_mtime_ns for f in jax_dir.iterdir()} == jax_files
    assert out.parent == tmp_path / "native" and out.exists()
    assert out.name.startswith("libobjloader_") and out.suffix == ".so"
    assert native.build() == out  # cached
    assert [f.name for f in (tmp_path / "native").iterdir()] == [out.name]
    assert sorted(f.name for f in port_dir.iterdir() if f.name != "__pycache__") == before
    assert before == ["__init__.py", "objloader.cpp"]
    monkeypatch.undo()
    lib = native.library_path()
    assert REPO / "stable_renderer_tpu" not in lib.parents
    assert REPO / "stable_renderer_tpu_torch" not in lib.parents


def test_load_without_native_uses_load_obj(tmp_path, monkeypatch):
    p = _write("obj", tmp_path)
    monkeypatch.setattr(native, "load_obj_native", lambda path: None)
    assert_same_mesh(PMesh.Load(p), j_load_obj(p))


def test_unknown_suffix_error(tmp_path):
    p = tmp_path / "x.3ds"
    p.write_bytes(b"\x00")
    with pytest.raises(ValueError) as jerr:
        JMesh.Load(p)
    with pytest.raises(ValueError) as perr:
        PMesh.Load(p)
    assert str(perr.value) == str(jerr.value)
    assert "Unsupported mesh format '.3ds'" in str(perr.value)


def test_loaded_mesh_device_buffers(tmp_path):
    """A GLB's uint16 indices reach the rasterizer as int32, uploaded once
    per mesh."""
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers

    m = PMesh.Load(_write("glb", tmp_path))
    bufs = mesh_device_buffers(m, "cpu")
    assert bufs["tris"].dtype == torch.int32
    assert mesh_device_buffers(m, "cpu") is bufs
