"""Host-side mesh parsers beyond OBJ: glTF 2.0 (.gltf/.glb), STL, PLY, DAE, FBX.

Counterpart of stable_renderer_tpu/engine/mesh_formats.py, function for
function: host numpy readers in place of the reference's assimp-backed
format support (reference: engine/static/mesh/mesh.py:155-318). glTF 2.0
(binary and JSON, node hierarchy flattened), STL (binary and ascii), PLY
(ascii and binary_little_endian), COLLADA (.dae, XML) and FBX in both
flavors (binary Kaydara node records with zlib arrays, and the ascii node
grammar, both feeding one geometry extractor).

The arrays then go to the device once, through the render executor's
per-mesh cache (``render_exec.mesh_device_buffers``).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

ParsedMesh = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                   np.ndarray, List[str]]
# (positions, uvs, normals, colors, tris, tri_material, material_names)


# ---------------------------------------------------------------------------
# glTF 2.0

_GLTF_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT2": 4, "MAT3": 9, "MAT4": 16}


def _read_glb(data: bytes) -> Tuple[dict, Optional[bytes]]:
    """GLB container: 12-byte header + JSON chunk + optional BIN chunk."""
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError("not a GLB file (bad magic)")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    off = 12
    gltf: Optional[dict] = None
    bin_chunk: Optional[bytes] = None
    while off + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8: off + 8 + clen]
        if ctype == 0x4E4F534A:  # 'JSON'
            gltf = json.loads(chunk)
        elif ctype == 0x004E4942:  # 'BIN\0'
            bin_chunk = chunk
        off += 8 + clen  # chunkLength includes the 4-byte alignment padding
    if gltf is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf, bin_chunk


def _gltf_buffers(gltf: dict, base_dir: Path, bin_chunk: Optional[bytes]) -> List[bytes]:
    import base64

    bufs: List[bytes] = []
    for i, b in enumerate(gltf.get("buffers", [])):
        uri = b.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise ValueError(f"buffer {i} has no uri and no GLB BIN chunk")
            bufs.append(bin_chunk)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            from urllib.parse import unquote

            bufs.append((base_dir / unquote(uri)).read_bytes())
    return bufs


def _gltf_accessor(gltf: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    if "sparse" in acc:
        raise ValueError("sparse glTF accessors not supported")
    n = acc["count"]
    ncomp = _GLTF_NCOMP[acc["type"]]
    dtype = np.dtype(_GLTF_DTYPES[acc["componentType"]])
    if "bufferView" not in acc:
        return np.zeros((n, ncomp) if ncomp > 1 else (n,), dtype)
    bv = gltf["bufferViews"][acc["bufferView"]]
    raw = buffers[bv["buffer"]]
    start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride") or dtype.itemsize * ncomp
    if stride == dtype.itemsize * ncomp:
        out = np.frombuffer(raw, dtype, count=n * ncomp, offset=start)
    else:  # interleaved vertex buffer: strided view then copy
        per = np.lib.stride_tricks.as_strided(
            np.frombuffer(raw, np.uint8, count=(n - 1) * stride + dtype.itemsize * ncomp,
                          offset=start),
            shape=(n, dtype.itemsize * ncomp), strides=(stride, 1))
        out = per.copy().view(dtype)
    out = out.reshape(n, ncomp) if ncomp > 1 else out.reshape(n)
    if acc.get("normalized") and dtype.kind in "iu":
        out = out.astype(np.float32) / np.iinfo(dtype).max
    return out


def _gltf_node_transforms(gltf: dict) -> Dict[int, np.ndarray]:
    """Flatten the node hierarchy: world matrix per node (column-vector
    convention, like the reference's pretransformed assimp import)."""

    def local(n: dict) -> np.ndarray:
        if "matrix" in n:
            return np.asarray(n["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        if "scale" in n:
            m = m @ np.diag([*n["scale"], 1.0])
        if "rotation" in n:  # quaternion x,y,z,w
            x, y, z, w = n["rotation"]
            r = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
            rm = np.eye(4)
            rm[:3, :3] = r
            m = rm @ m
        if "translation" in n:
            tm = np.eye(4)
            tm[:3, 3] = n["translation"]
            m = tm @ m
        return m

    nodes = gltf.get("nodes", [])
    world: Dict[int, np.ndarray] = {}

    def walk(idx: int, parent: np.ndarray) -> None:
        m = parent @ local(nodes[idx])
        world[idx] = m
        for c in nodes[idx].get("children", []):
            walk(c, m)

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    for root in scene.get("nodes", range(len(nodes))):
        walk(root, np.eye(4))
    for i in range(len(nodes)):  # orphan nodes: identity-rooted
        if i not in world:
            walk(i, np.eye(4))
    return world


def load_gltf(path: str | Path) -> ParsedMesh:
    path = Path(path)
    data = path.read_bytes()
    if path.suffix.lower() == ".glb" or data[:4] == b"glTF":
        gltf, bin_chunk = _read_glb(data)
    else:
        gltf, bin_chunk = json.loads(data), None
    for ext in gltf.get("extensionsRequired", []):
        raise ValueError(f"required glTF extension '{ext}' not supported")
    buffers = _gltf_buffers(gltf, path.parent, bin_chunk)
    world = _gltf_node_transforms(gltf)

    mat_names = [m.get("name", f"material_{i}")
                 for i, m in enumerate(gltf.get("materials", []))]
    pos_l, uv_l, nrm_l, col_l, tri_l, mat_l = [], [], [], [], [], []
    base = 0
    for node_idx, node in enumerate(gltf.get("nodes", [])):
        if "mesh" not in node:
            continue
        m = world.get(node_idx, np.eye(4))
        nrm_m = np.linalg.inv(m[:3, :3]).T  # normal matrix
        mesh = gltf["meshes"][node["mesh"]]
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:  # TRIANGLES only
                continue
            attrs = prim["attributes"]
            p = _gltf_accessor(gltf, buffers, attrs["POSITION"]).astype(np.float64)
            p = p @ m[:3, :3].T + m[:3, 3]
            v = p.shape[0]
            uv = (_gltf_accessor(gltf, buffers, attrs["TEXCOORD_0"])[:, :2]
                  if "TEXCOORD_0" in attrs else np.zeros((v, 2), np.float32))
            nrm = (_gltf_accessor(gltf, buffers, attrs["NORMAL"]) @ nrm_m.T
                   if "NORMAL" in attrs else np.zeros((v, 3)))
            col = (_gltf_accessor(gltf, buffers, attrs["COLOR_0"])[:, :3]
                   if "COLOR_0" in attrs else np.ones((v, 3), np.float32))
            if "indices" in prim:
                idx = _gltf_accessor(gltf, buffers, prim["indices"]).astype(np.int64)
            else:
                idx = np.arange(v, dtype=np.int64)
            tris = idx.reshape(-1, 3) + base
            pos_l.append(p.astype(np.float32))
            uv_l.append(np.asarray(uv, np.float32))
            nrm_l.append(np.asarray(nrm, np.float32))
            col_l.append(np.asarray(col, np.float32))
            tri_l.append(tris.astype(np.int32))
            mat_l.append(np.full((tris.shape[0],), prim.get("material", -1), np.int32))
            base += v
    if not pos_l:
        raise ValueError(f"no triangle geometry in {path}")
    pos = np.concatenate(pos_l)
    nrm = np.concatenate(nrm_l)
    tris_all = np.concatenate(tri_l)
    if not np.any(nrm):  # no NORMAL attribute anywhere: derive from faces
        from stable_renderer_tpu_torch.engine.mesh import _face_normals_to_vertices

        nrm = _face_normals_to_vertices(pos.astype(np.float32), tris_all)
    norms = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where(norms > 1e-12, nrm / np.maximum(norms, 1e-12), nrm)
    return (pos, np.concatenate(uv_l), nrm.astype(np.float32),
            np.concatenate(col_l), tris_all,
            np.concatenate(mat_l), mat_names)


# ---------------------------------------------------------------------------
# STL

def load_stl(path: str | Path) -> ParsedMesh:
    """Binary or ascii STL. STL has no shared vertices/uvs: vertices are
    deduplicated by exact position so vertex IDs are stable across frames."""
    raw = Path(path).read_bytes()
    is_ascii = raw[:5] == b"solid" and b"facet" in raw[:1024]
    if is_ascii:
        tokens = raw.decode("ascii", "ignore").split()
        verts = []
        it = iter(range(len(tokens)))
        i = 0
        while i < len(tokens):
            if tokens[i] == "vertex":
                verts.append([float(tokens[i + 1]), float(tokens[i + 2]),
                              float(tokens[i + 3])])
                i += 4
            else:
                i += 1
        tri_pts = np.asarray(verts, np.float32).reshape(-1, 3, 3)
    else:
        (n_tri,) = struct.unpack_from("<I", raw, 80)
        rec = np.frombuffer(raw, np.uint8, count=n_tri * 50, offset=84)
        rec = rec.reshape(n_tri, 50)
        tri_pts = rec[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3)
    flat = tri_pts.reshape(-1, 3)
    uniq, inv = np.unique(flat.round(6), axis=0, return_inverse=True)
    # map each flat vertex to its first occurrence for exact positions
    pos = np.zeros((uniq.shape[0], 3), np.float32)
    pos[inv] = flat
    tris = inv.reshape(-1, 3).astype(np.int32)
    from stable_renderer_tpu_torch.engine.mesh import _face_normals_to_vertices

    nrm = _face_normals_to_vertices(pos, tris)
    v = pos.shape[0]
    return (pos, np.zeros((v, 2), np.float32), nrm,
            np.ones((v, 3), np.float32), tris,
            np.full((tris.shape[0],), -1, np.int32), [])


# ---------------------------------------------------------------------------
# PLY

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str | Path) -> ParsedMesh:
    """PLY ascii / binary_little_endian: vertex x/y/z [nx/ny/nz] [u/v|s/t]
    [red/green/blue] + face vertex_indices (fan-triangulated)."""
    raw = Path(path).read_bytes()
    end = raw.find(b"end_header\n")
    if end < 0:
        raise ValueError("not a PLY file (no end_header)")
    header = raw[:end].decode("ascii", "ignore").splitlines()
    body = raw[end + len(b"end_header\n"):]
    fmt = "ascii"
    elements: List[Tuple[str, int, list]] = []  # (name, count, props)
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))
    if fmt == "binary_big_endian":
        raise ValueError("big-endian PLY not supported")

    verts: Dict[str, np.ndarray] = {}
    faces: List[List[int]] = []
    if fmt == "ascii":
        tokens = body.decode("ascii", "ignore").split("\n")
        ti = 0
        for name, count, props in elements:
            if name == "vertex":
                scalars = [p[2] for p in props if p[0] == "scalar"]
                arr = np.array(
                    [tokens[ti + r].split()[:len(scalars)] for r in range(count)],
                    np.float64)
                for ci, pname in enumerate(scalars):
                    verts[pname] = arr[:, ci]
                ti += count
            elif name == "face":
                for r in range(count):
                    vals = tokens[ti + r].split()
                    n = int(vals[0])
                    faces.append([int(x) for x in vals[1:1 + n]])
                ti += count
            else:
                ti += count
    else:  # binary_little_endian
        off = 0
        for name, count, props in elements:
            if all(p[0] == "scalar" for p in props):
                # p = ("scalar", <type>, <name>)
                dt = np.dtype([(p[2], "<" + _PLY_DTYPES[p[1]]) for p in props])
                arr = np.frombuffer(body, dt, count=count, offset=off)
                off += dt.itemsize * count
                if name == "vertex":
                    for p in props:
                        verts[p[2]] = arr[p[2]].astype(np.float64)
            else:  # list property (faces): parse row by row
                for _ in range(count):
                    cdt = np.dtype("<" + _PLY_DTYPES[props[0][1]])
                    idt = np.dtype("<" + _PLY_DTYPES[props[0][2]])
                    n = int(np.frombuffer(body, cdt, count=1, offset=off)[0])
                    off += cdt.itemsize
                    idxs = np.frombuffer(body, idt, count=n, offset=off)
                    off += idt.itemsize * n
                    if name == "face":
                        faces.append(idxs.astype(np.int64).tolist())

    if "x" not in verts:
        raise ValueError("PLY has no vertex x/y/z")
    pos = np.stack([verts["x"], verts["y"], verts["z"]], -1).astype(np.float32)
    v = pos.shape[0]
    tris: List[List[int]] = []
    for f in faces:
        for k in range(1, len(f) - 1):  # fan triangulation
            tris.append([f[0], f[k], f[k + 1]])
    tri = (np.asarray(tris, np.int32) if tris
           else np.zeros((0, 3), np.int32))
    if {"nx", "ny", "nz"} <= verts.keys():
        nrm = np.stack([verts["nx"], verts["ny"], verts["nz"]], -1).astype(np.float32)
    else:
        from stable_renderer_tpu_torch.engine.mesh import _face_normals_to_vertices

        nrm = _face_normals_to_vertices(pos, tri)
    if {"u", "v"} <= verts.keys():
        uv = np.stack([verts["u"], verts["v"]], -1).astype(np.float32)
    elif {"s", "t"} <= verts.keys():
        uv = np.stack([verts["s"], verts["t"]], -1).astype(np.float32)
    else:
        uv = np.zeros((v, 2), np.float32)
    if {"red", "green", "blue"} <= verts.keys():
        scale = 255.0 if verts["red"].max() > 1.0 else 1.0
        col = (np.stack([verts["red"], verts["green"], verts["blue"]], -1)
               / scale).astype(np.float32)
    else:
        col = np.ones((v, 3), np.float32)
    return (pos, uv, nrm, col, tri,
            np.full((tri.shape[0],), -1, np.int32), [])


# ---------------------------------------------------------------------------
# COLLADA (.dae) — XML interchange (reference loads it through assimp,
# engine/static/mesh/mesh.py:155-318)

def load_dae(path: str | Path) -> ParsedMesh:
    """COLLADA 1.4/1.5 mesh import: library_geometries sources + <triangles>/
    <polylist> (fan-triangulated), per-primitive materials, Z_UP -> Y_UP
    conversion per the asset tag. Node transforms from the first
    instance_geometry's <matrix> are baked into positions/normals."""
    import xml.etree.ElementTree as ET

    text = Path(path).read_text(encoding="utf-8", errors="ignore")
    # strip the default namespace so tags are addressable by local name
    import re as _re

    text = _re.sub(r'xmlns="[^"]+"', "", text, count=1)
    root = ET.fromstring(text)

    up = (root.findtext("asset/up_axis") or "Y_UP").strip()

    # geometry id -> baked node matrix (first instance wins)
    xforms: Dict[str, np.ndarray] = {}
    for node in root.iter("node"):
        m = np.eye(4, dtype=np.float32)
        mt = node.find("matrix")
        if mt is not None:
            m = np.array(mt.text.split(), np.float32).astype(np.float32).reshape(4, 4)
        for ig in node.findall("instance_geometry"):
            gid = (ig.get("url") or "").lstrip("#")
            xforms.setdefault(gid, m)

    all_pos: List[np.ndarray] = []
    all_uv: List[np.ndarray] = []
    all_nrm: List[np.ndarray] = []
    all_tris: List[np.ndarray] = []
    all_mat: List[np.ndarray] = []
    mat_names: List[str] = []
    base = 0

    for geom in root.iter("geometry"):
        mesh = geom.find("mesh")
        if mesh is None:
            continue
        sources = {}
        for src in mesh.findall("source"):
            arr = src.find("float_array")
            if arr is None or not arr.text:
                continue
            stride = 3
            acc = src.find("technique_common/accessor")
            if acc is not None:
                stride = int(acc.get("stride", 3))
            data = np.array(arr.text.split(), np.float32).astype(np.float32)
            sources[src.get("id")] = data.reshape(-1, stride)
        # <vertices> indirection: VERTEX input points here, which points at
        # the POSITION source
        vert_src = {}
        verts_el = mesh.find("vertices")
        if verts_el is not None:
            for inp in verts_el.findall("input"):
                if inp.get("semantic") == "POSITION":
                    vert_src[verts_el.get("id")] = inp.get("source", "").lstrip("#")

        xf = xforms.get(geom.get("id"), np.eye(4, dtype=np.float32))
        nrm_xf = xf[:3, :3]

        for prim in list(mesh.findall("triangles")) + list(mesh.findall("polylist")):
            inputs = []  # (offset, semantic, source_id)
            max_off = 0
            for inp in prim.findall("input"):
                off = int(inp.get("offset", 0))
                sid = inp.get("source", "").lstrip("#")
                sid = vert_src.get(sid, sid)
                inputs.append((off, inp.get("semantic"), sid))
                max_off = max(max_off, off)
            p_el = prim.find("p")
            if p_el is None or not p_el.text:
                continue
            idx = np.array(p_el.text.split(), np.int64).astype(np.int64)
            idx = idx.reshape(-1, max_off + 1)

            if prim.tag == "polylist":
                vcount = np.array((prim.findtext("vcount") or "").split(),
                                      np.int64).astype(np.int64)
                # fan-triangulate: corner rows per polygon -> triangle rows
                tri_rows = []
                row = 0
                for n in vcount:
                    for k in range(1, int(n) - 1):
                        tri_rows += [row, row + k, row + k + 1]
                    row += int(n)
                idx = idx[tri_rows]

            n_corner = idx.shape[0]
            pos_src = nrm_src = uv_src = None
            pos_col = nrm_col = uv_col = None
            for off, sem, sid in inputs:
                if sem == "VERTEX" or sem == "POSITION":
                    pos_src, pos_col = sources.get(sid), off
                elif sem == "NORMAL":
                    nrm_src, nrm_col = sources.get(sid), off
                elif sem == "TEXCOORD" and uv_src is None:
                    uv_src, uv_col = sources.get(sid), off
            if pos_src is None:
                continue
            pos = pos_src[idx[:, pos_col]][:, :3]
            pos = pos @ xf[:3, :3].T + xf[:3, 3]
            nrm = (nrm_src[idx[:, nrm_col]][:, :3] @ nrm_xf.T
                   if nrm_src is not None else None)
            uv = uv_src[idx[:, uv_col]][:, :2] if uv_src is not None else None

            if up == "Z_UP":  # to Y-up: (x, y, z) -> (x, z, -y)
                pos = np.stack([pos[:, 0], pos[:, 2], -pos[:, 1]], -1)
                if nrm is not None:
                    nrm = np.stack([nrm[:, 0], nrm[:, 2], -nrm[:, 1]], -1)

            mat = prim.get("material") or ""
            if mat not in mat_names:
                mat_names.append(mat)
            mid = mat_names.index(mat)

            all_pos.append(pos.astype(np.float32))
            all_nrm.append(nrm.astype(np.float32) if nrm is not None
                           else np.zeros_like(pos, dtype=np.float32))
            all_uv.append(uv.astype(np.float32) if uv is not None
                          else np.zeros((n_corner, 2), np.float32))
            tris = np.arange(n_corner, dtype=np.int32).reshape(-1, 3) + base
            all_tris.append(tris)
            all_mat.append(np.full((tris.shape[0],), mid, np.int32))
            base += n_corner

    if not all_pos:
        raise ValueError(f"no triangle geometry found in {path}")
    pos = np.concatenate(all_pos)
    nrm = np.concatenate(all_nrm)
    if not np.any(nrm):
        from stable_renderer_tpu_torch.engine.mesh import _face_normals_to_vertices

        nrm = _face_normals_to_vertices(pos, np.concatenate(all_tris))
    return (pos, np.concatenate(all_uv), nrm,
            np.ones((pos.shape[0], 3), np.float32),
            np.concatenate(all_tris), np.concatenate(all_mat), mat_names)


# ---------------------------------------------------------------------------
# binary FBX (.fbx) — Kaydara binary node records (reference via assimp)

def _fbx_read_node(buf: bytes, off: int, version: int):
    """One FBX node record; returns (node_dict | None, next_offset)."""
    if version >= 7500:
        end, n_props, _plen = struct.unpack_from("<QQQ", buf, off)
        name_len = buf[off + 24]
        off2 = off + 25
    else:
        end, n_props, _plen = struct.unpack_from("<III", buf, off)
        name_len = buf[off + 12]
        off2 = off + 13
    if end == 0:
        return None, off2 + name_len
    name = buf[off2 : off2 + name_len].decode("ascii", "ignore")
    off2 += name_len
    props = []
    import zlib

    for _ in range(n_props):
        code = chr(buf[off2]); off2 += 1
        if code in "CB":
            props.append(bool(buf[off2])); off2 += 1
        elif code == "Y":
            props.append(struct.unpack_from("<h", buf, off2)[0]); off2 += 2
        elif code == "I":
            props.append(struct.unpack_from("<i", buf, off2)[0]); off2 += 4
        elif code == "L":
            props.append(struct.unpack_from("<q", buf, off2)[0]); off2 += 8
        elif code == "F":
            props.append(struct.unpack_from("<f", buf, off2)[0]); off2 += 4
        elif code == "D":
            props.append(struct.unpack_from("<d", buf, off2)[0]); off2 += 8
        elif code in "SR":
            ln = struct.unpack_from("<I", buf, off2)[0]; off2 += 4
            raw = buf[off2 : off2 + ln]; off2 += ln
            props.append(raw.decode("utf-8", "ignore") if code == "S" else raw)
        elif code in "fdilb":
            n, enc, clen = struct.unpack_from("<III", buf, off2); off2 += 12
            dt = {"f": "<f4", "d": "<f8", "i": "<i4", "l": "<i8", "b": "u1"}[code]
            if enc:
                raw = zlib.decompress(buf[off2 : off2 + clen]); off2 += clen
            else:
                size = n * np.dtype(dt).itemsize
                raw = buf[off2 : off2 + size]; off2 += size
            props.append(np.frombuffer(raw, dt).copy())
        else:
            raise ValueError(f"unknown FBX property code {code!r}")
    children = []
    while off2 < end:
        child, off2 = _fbx_read_node(buf, off2, version)
        if child is None:
            break
        children.append(child)
    return {"name": name, "props": props, "children": children}, end


_FBX_ASCII_TOKEN = None  # compiled lazily (import-time regex cost)


def _fbx_ascii_nodes(text: str) -> List[dict]:
    """Parse ASCII FBX into the same {name, props, children} node dicts the
    binary reader produces (assimp's FBX/FBXParser.cpp covers this grammar in
    the reference's stack; here it's a ~60-line tokenizer).

    Grammar: ``Name: prop, prop, ... {  children  }`` where props are numbers,
    quoted strings, bare identifiers (Y/T/W), or ``*N`` array-length markers;
    array payloads appear as an ``a:`` child whose numeric props become the
    parent's array prop (matching the binary format's packed arrays)."""
    global _FBX_ASCII_TOKEN
    if _FBX_ASCII_TOKEN is None:
        import re

        _FBX_ASCII_TOKEN = re.compile(
            r'"[^"]*"|[A-Za-z_][A-Za-z0-9_]*\s*:|[{}]|[^\s{},]+')
    # strip ';' comments line-wise, then tokenize the whole document
    body = "\n".join(ln.split(";", 1)[0] for ln in text.splitlines())
    toks = _FBX_ASCII_TOKEN.findall(body)

    def parse_value(t: str):
        if t.startswith('"'):
            return t[1:-1]
        if t.startswith("*"):  # array length marker: metadata only
            return None
        try:
            return int(t)
        except ValueError:
            try:
                return float(t)
            except ValueError:
                return t  # bare identifier (Y, T, W, ...)

    pos = 0

    def parse_nodes(depth: int) -> List[dict]:
        nonlocal pos
        out: List[dict] = []
        while pos < len(toks):
            t = toks[pos]
            if t == "}":
                pos += 1
                return out
            if t.endswith(":"):
                name = t[:-1].rstrip()
                pos += 1
                props = []
                while pos < len(toks) and not toks[pos].endswith(":") \
                        and toks[pos] not in ("{", "}"):
                    v = parse_value(toks[pos])
                    if v is not None:
                        props.append(v)
                    pos += 1
                children: List[dict] = []
                if pos < len(toks) and toks[pos] == "{":
                    pos += 1
                    children = parse_nodes(depth + 1)
                # fold an `a:` numeric payload into the parent as one array
                if len(children) == 1 and children[0]["name"] == "a":
                    props = [np.asarray(children[0]["props"], np.float64)]
                    children = []
                out.append({"name": name, "props": props,
                            "children": children})
            else:  # stray token (shouldn't happen in valid files)
                pos += 1
        return out

    return parse_nodes(0)


def load_fbx(path: str | Path) -> ParsedMesh:
    """FBX, binary AND ascii: Objects/Geometry Vertices + PolygonVertexIndex
    (negative-terminated polygons, fan-triangulated) + LayerElementNormal/UV
    (ByDirect / ByPolygonVertex / IndexToDirect mappings). Binary files parse
    via the Kaydara record reader; ascii files via _fbx_ascii_nodes — both
    feed the same geometry extraction."""
    buf = Path(path).read_bytes()
    if buf.startswith(b"Kaydara FBX Binary"):
        version = struct.unpack_from("<I", buf, 23)[0]
        off = 27
        top = []
        while off < len(buf):
            node, off = _fbx_read_node(buf, off, version)
            if node is None:
                break
            top.append(node)
    else:
        try:
            text = buf.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"{path}: neither binary nor ascii FBX") from e
        top = _fbx_ascii_nodes(text)

    def find(nodes, name):
        return [n for n in nodes if n["name"] == name]

    geoms = []
    for objects in find(top, "Objects"):
        geoms += find(objects["children"], "Geometry")
        # FBX 6.x stores meshes under Model nodes
        geoms += [m for m in find(objects["children"], "Model")
                  if find(m["children"], "Vertices")]

    all_pos, all_uv, all_nrm, all_tris = [], [], [], []
    base = 0
    for g in geoms:
        ch = g["children"]
        verts = find(ch, "Vertices")
        pvi = find(ch, "PolygonVertexIndex")
        if not verts or not pvi:
            continue
        pos_flat = np.asarray(verts[0]["props"][0], np.float64).reshape(-1, 3)
        poly_idx = np.asarray(pvi[0]["props"][0], np.int64)

        # fan-triangulate: polygons end at (negative) index ~x
        corners = np.where(poly_idx < 0, -poly_idx - 1, poly_idx)
        tri_corner_rows = []
        start = 0
        for i, v in enumerate(poly_idx):
            if v < 0:  # polygon end
                for k in range(1, i - start):
                    tri_corner_rows += [start, start + k, start + k + 1]
                start = i + 1

        def layer_values(kind, value_name, index_name):
            els = find(ch, kind)
            if not els:
                return None
            el = els[0]["children"]
            vals = find(el, value_name)
            if not vals:
                return None
            ncomp = 3 if value_name == "Normals" else 2
            data = np.asarray(vals[0]["props"][0], np.float64).reshape(-1, ncomp)
            mapping = (find(el, "MappingInformationType") or [{"props": [""]}])[0]["props"][0]
            ref = (find(el, "ReferenceInformationType") or [{"props": [""]}])[0]["props"][0]
            if ref == "IndexToDirect":
                iname = find(el, index_name)
                if iname:
                    data = data[np.asarray(iname[0]["props"][0], np.int64)]
            if mapping == "ByControlPoint" or mapping == "ByVertice" or mapping == "ByVertex":
                data = data[corners]
            # ByPolygonVertex: already one row per corner
            return data

        nrm_c = layer_values("LayerElementNormal", "Normals", "NormalsIndex")
        uv_c = layer_values("LayerElementUV", "UV", "UVIndex")

        pos_c = pos_flat[corners]
        rows = np.asarray(tri_corner_rows, np.int64)
        all_pos.append(pos_c[rows].astype(np.float32))
        all_nrm.append(nrm_c[rows].astype(np.float32) if nrm_c is not None
                       else np.zeros((rows.size, 3), np.float32))
        all_uv.append(uv_c[rows].astype(np.float32) if uv_c is not None
                      else np.zeros((rows.size, 2), np.float32))
        all_tris.append(np.arange(rows.size, dtype=np.int32).reshape(-1, 3) + base)
        base += rows.size

    if not all_pos:
        raise ValueError(f"no mesh geometry found in {path}")
    pos = np.concatenate(all_pos)
    tris = np.concatenate(all_tris)
    nrm = np.concatenate(all_nrm)
    if not np.any(nrm):
        from stable_renderer_tpu_torch.engine.mesh import _face_normals_to_vertices

        nrm = _face_normals_to_vertices(pos, tris)
    return (pos, np.concatenate(all_uv), nrm,
            np.ones((pos.shape[0], 3), np.float32), tris,
            np.full((tris.shape[0],), -1, np.int32), [])


LOADERS = {
    ".gltf": load_gltf,
    ".glb": load_gltf,
    ".stl": load_stl,
    ".ply": load_ply,
    ".dae": load_dae,
    ".fbx": load_fbx,
}
