"""Meshes as host numpy vertex/index buffers: procedural and from files.

Counterpart of stable_renderer_tpu/engine/mesh.py: the ``Mesh`` dataclass with
the procedural ``Plane``, ``Sphere`` and ``Cube`` (reference mesh.py:448-470)
and ``Mesh.Load``, which reads OBJ (the native C++ parser in ``native/``,
else ``load_obj``) and the formats of ``mesh_formats.py`` (glTF/GLB, STL,
PLY, DAE, FBX). The arrays are the JAX package's, array for array: the same
numpy arithmetic. Vertex IDs are the vertex's index in the mesh (vertexID 0
is valid).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from pathlib import Path

import numpy as np

from benchmark.reference.plain.utils.log import get_logger

logger = get_logger("sr_tpu_torch.mesh")


@dataclass
class Mesh:
    positions: np.ndarray          # (V, 3) float32
    normals: np.ndarray            # (V, 3) float32
    uvs: np.ndarray                # (V, 2) float32
    colors: np.ndarray             # (V, 3) float32
    tris: np.ndarray               # (T, 3) int32
    vertex_ids: np.ndarray = None  # (V,) int32
    tangents: np.ndarray = None    # (V, 3) float32
    bitangents: np.ndarray = None  # (V, 3) float32
    name: str = "mesh"
    # material id per triangle for multi-material OBJ/MTL meshes (reference
    # mesh.py materials list + per-material draw); -1 = default material.
    tri_material: np.ndarray = None  # (T,) int32

    def __post_init__(self) -> None:
        v = self.positions.shape[0]
        if self.vertex_ids is None:
            self.vertex_ids = np.arange(v, dtype=np.int32)
        if self.tri_material is None:
            self.tri_material = np.full((self.tris.shape[0],), -1, np.int32)
        if self.tangents is None or self.bitangents is None:
            self.tangents, self.bitangents = _tangent_space(
                self.positions, self.uvs, self.tris
            )

    @property
    def vertex_count(self) -> int:
        return self.positions.shape[0]

    @cached_property
    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """Object-space AABB (min, max) corners, computed once per mesh."""
        if self.positions.shape[0]:
            return self.positions.min(0), self.positions.max(0)
        return np.zeros(3, np.float32), np.zeros(3, np.float32)

    @property
    def triangle_count(self) -> int:
        return self.tris.shape[0]

    # --- procedural geometry (reference mesh.py:448-470 Plane/Sphere) ---

    @classmethod
    def Plane(cls, size: float = 1.0, segments: int = 1) -> "Mesh":
        """XZ plane centered at origin, +Y normal, uv spanning [0,1]^2."""
        s = segments
        xs = np.linspace(-size / 2, size / 2, s + 1, dtype=np.float32)
        zs = np.linspace(-size / 2, size / 2, s + 1, dtype=np.float32)
        gx, gz = np.meshgrid(xs, zs, indexing="xy")
        pos = np.stack([gx, np.zeros_like(gx), gz], axis=-1).reshape(-1, 3)
        nrm = np.tile(np.array([[0, 1, 0]], np.float32), (pos.shape[0], 1))
        u, v = np.meshgrid(
            np.linspace(0, 1, s + 1, dtype=np.float32),
            np.linspace(0, 1, s + 1, dtype=np.float32),
            indexing="xy",
        )
        uv = np.stack([u, v], axis=-1).reshape(-1, 2)
        tris = []
        for j in range(s):
            for i in range(s):
                a = j * (s + 1) + i
                b = a + 1
                c = a + (s + 1)
                d = c + 1
                tris += [[a, c, b], [b, c, d]]
        col = np.ones_like(pos)
        return cls(pos, nrm, uv, col, np.asarray(tris, np.int32), name="plane")

    @classmethod
    def Sphere(cls, radius: float = 1.0, segments: int = 32) -> "Mesh":
        """UV sphere (latitude/longitude), matching the reference's _SphereMesh."""
        lat = segments
        lon = segments
        phis = np.linspace(0, np.pi, lat + 1, dtype=np.float32)
        thetas = np.linspace(0, 2 * np.pi, lon + 1, dtype=np.float32)
        pos, nrm, uv = [], [], []
        for j, phi in enumerate(phis):
            for i, theta in enumerate(thetas):
                x = np.sin(phi) * np.cos(theta)
                y = np.cos(phi)
                z = np.sin(phi) * np.sin(theta)
                pos.append([radius * x, radius * y, radius * z])
                nrm.append([x, y, z])
                uv.append([i / lon, 1.0 - j / lat])
        tris = []
        for j in range(lat):
            for i in range(lon):
                a = j * (lon + 1) + i
                b = a + 1
                c = a + (lon + 1)
                d = c + 1
                if j > 0:
                    tris.append([a, b, c])
                if j < lat - 1:
                    tris.append([b, d, c])
        pos = np.asarray(pos, np.float32)
        return cls(
            pos,
            np.asarray(nrm, np.float32),
            np.asarray(uv, np.float32),
            np.ones_like(pos),
            np.asarray(tris, np.int32),
            name="sphere",
        )

    @classmethod
    def Cube(cls, size: float = 1.0) -> "Mesh":
        s = size / 2
        faces = [
            ([0, 0, 1], [[-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]]),
            ([0, 0, -1], [[s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]]),
            ([1, 0, 0], [[s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]]),
            ([-1, 0, 0], [[-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]]),
            ([0, 1, 0], [[-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]]),
            ([0, -1, 0], [[-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]]),
        ]
        pos, nrm, uv, tris = [], [], [], []
        for n, corners in faces:
            base = len(pos)
            pos.extend(corners)
            nrm.extend([n] * 4)
            uv.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
            tris += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        pos = np.asarray(pos, np.float32)
        return cls(
            pos,
            np.asarray(nrm, np.float32),
            np.asarray(uv, np.float32),
            np.ones_like(pos),
            np.asarray(tris, np.int32),
            name="cube",
        )

    # --- loading from files (the assimp replacement) ---

    @classmethod
    def Load(cls, path: str | Path, name: str | None = None) -> "Mesh":
        """A mesh from a file, by its suffix: ``.obj`` through the native
        parser (``load_obj`` where it cannot be built), else ``LOADERS``.
        Sets ``material_names``, the names ``tri_material`` indexes."""
        path = Path(path)
        suffix = path.suffix.lower()
        if suffix != ".obj":
            from benchmark.reference.plain.engine.mesh_formats import LOADERS

            if suffix not in LOADERS:
                raise ValueError(
                    f"Unsupported mesh format '{suffix}' "
                    f"(have .obj {' '.join(sorted(LOADERS))}; export FBX/DAE "
                    "assets to glTF)")
            pos, uv, nrm, colors, tris, tri_mat, names = LOADERS[suffix](path)
            mesh = cls(
                positions=pos,
                normals=nrm,
                uvs=uv,
                colors=colors,
                tris=tris,
                tri_material=tri_mat,
                name=name or path.stem,
            )
            mesh.material_names = names  # type: ignore[attr-defined]
            return mesh
        from benchmark.reference.plain import native

        try:
            parsed = native.load_obj_native(path)
        except FileNotFoundError:
            raise
        except Exception as e:  # noqa: BLE001 - any native issue falls back
            logger.warning(f"native OBJ parser failed on {path} ({e}); using load_obj")
            parsed = None
        if parsed is None:
            return load_obj(path, name=name or path.stem)
        pos, uv, nrm, tris, tri_mat, names = parsed
        if not np.any(nrm):
            nrm = _face_normals_to_vertices(pos, tris)
        mesh = cls(
            positions=pos,
            normals=nrm,
            uvs=uv,
            colors=np.ones_like(pos),
            tris=tris,
            tri_material=tri_mat,
            name=name or path.stem,
        )
        mesh.material_names = names  # type: ignore[attr-defined]
        return mesh


def _tangent_space(
    positions: np.ndarray, uvs: np.ndarray, tris: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex tangent/bitangent from uv gradients (assimp CalcTangentSpace
    equivalent, averaged over incident triangles)."""
    v = positions.shape[0]
    tan = np.zeros((v, 3), np.float64)
    bit = np.zeros((v, 3), np.float64)
    if tris.shape[0]:
        p0, p1, p2 = (positions[tris[:, k]] for k in range(3))
        t0, t1, t2 = (uvs[tris[:, k]] for k in range(3))
        e1, e2 = p1 - p0, p2 - p0
        d1, d2 = t1 - t0, t2 - t0
        det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
        r = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1, det))
        t = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
        b = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r[:, None]
        for k in range(3):
            np.add.at(tan, tris[:, k], t)
            np.add.at(bit, tris[:, k], b)
    norm = np.linalg.norm(tan, axis=-1, keepdims=True)
    tan = np.where(norm > 1e-12, tan / np.maximum(norm, 1e-12), [1.0, 0, 0])
    norm = np.linalg.norm(bit, axis=-1, keepdims=True)
    bit = np.where(norm > 1e-12, bit / np.maximum(norm, 1e-12), [0, 1.0, 0])
    return tan.astype(np.float32), bit.astype(np.float32)


def load_obj(path: str | Path, name: str | None = None) -> Mesh:
    """Minimal OBJ reader: v / vn / vt / f (polygon fan-triangulated), usemtl.

    Produces one unique vertex per distinct (v, vt, vn) triple, like assimp's
    JoinIdenticalVertices + Triangulate flags in the reference (mesh.py:155-180).
    """
    positions_in: list[list[float]] = []
    normals_in: list[list[float]] = []
    uvs_in: list[list[float]] = []
    vert_map: dict[tuple, int] = {}
    positions: list[list[float]] = []
    normals: list[list[float]] = []
    uvs: list[list[float]] = []
    tris: list[list[int]] = []
    tri_mat: list[int] = []
    materials: list[str] = []
    cur_mat = -1

    def vid(token: str) -> int:
        parts = token.split("/")
        pi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        pi = pi - 1 if pi > 0 else len(positions_in) + pi
        ti = ti - 1 if ti > 0 else (len(uvs_in) + ti if ti else -1)
        ni = ni - 1 if ni > 0 else (len(normals_in) + ni if ni else -1)
        key = (pi, ti, ni)
        if key not in vert_map:
            vert_map[key] = len(positions)
            positions.append(positions_in[pi])
            uvs.append(uvs_in[ti] if ti >= 0 and uvs_in else [0.0, 0.0])
            normals.append(normals_in[ni] if ni >= 0 and normals_in else [0.0, 0.0, 0.0])
        return vert_map[key]

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if tok[0] == "v":
                positions_in.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vn":
                normals_in.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                uvs_in.append([float(tok[1]), float(tok[2]) if len(tok) > 2 else 0.0])
            elif tok[0] == "usemtl":
                mat_name = tok[1] if len(tok) > 1 else ""
                if mat_name not in materials:
                    materials.append(mat_name)
                cur_mat = materials.index(mat_name)
            elif tok[0] == "f":
                idx = [vid(t) for t in tok[1:]]
                for k in range(1, len(idx) - 1):
                    tris.append([idx[0], idx[k], idx[k + 1]])
                    tri_mat.append(cur_mat)

    pos = np.asarray(positions, np.float32)
    nrm = np.asarray(normals, np.float32)
    if not normals_in or not np.any(nrm):
        nrm = _face_normals_to_vertices(pos, np.asarray(tris, np.int32))
    mesh = Mesh(
        positions=pos,
        normals=nrm,
        uvs=np.asarray(uvs, np.float32) if uvs else np.zeros((pos.shape[0], 2), np.float32),
        colors=np.ones_like(pos),
        tris=np.asarray(tris, np.int32),
        tri_material=np.asarray(tri_mat, np.int32),
        name=name or Path(path).stem,
    )
    mesh.material_names = materials  # type: ignore[attr-defined]
    return mesh


def _face_normals_to_vertices(pos: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Per-vertex normals: the sum of the incident triangles' area-weighted
    face normals, normalized."""
    nrm = np.zeros_like(pos, dtype=np.float64)
    fn = np.cross(pos[tris[:, 1]] - pos[tris[:, 0]], pos[tris[:, 2]] - pos[tris[:, 0]])
    for k in range(3):
        np.add.at(nrm, tris[:, k], fn)
    n = np.linalg.norm(nrm, axis=-1, keepdims=True)
    return (nrm / np.maximum(n, 1e-12)).astype(np.float32)
