"""The scenes the cells draw, worked out from the workload file alone.

A scene is data: a camera (position, target, field of view, near and far
planes), and objects, each a sphere of a radius and segment count with a
sprite id, a material id, a prompt and a turn of so many degrees a frame
about an axis. The quaternion arithmetic is the engine's (a float32 turn
multiplied on once a frame, the camera's look-at turned into a quaternion),
so the model-view matrix of frame ``f`` is the one the engine draws with:
an object is drawn before its turn of that frame, so frame 0 is unturned.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_matrix(q: np.ndarray) -> np.ndarray:
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y), 0],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x), 0],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y), 0],
        [0, 0, 0, 1],
    ], np.float32)


def axis_angle_quat(axis, angle_deg: float) -> np.ndarray:
    axis = np.asarray(np.asarray(axis, np.float32), np.float64)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    half = np.deg2rad(angle_deg) / 2
    return np.concatenate([[np.cos(half)], np.sin(half) * axis]).astype(np.float32)


def look_at_quat(pos, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """The quaternion that turns -Z toward ``target`` from ``pos``."""
    f = np.asarray(target, np.float64) - np.asarray(pos, np.float32)
    f = f / max(np.linalg.norm(f), 1e-12)
    s = np.cross(f, np.asarray(up, np.float64))
    s = s / max(np.linalg.norm(s), 1e-12)
    u = np.cross(s, f)
    m = np.stack([s, u, -f], axis=1)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s4 = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s4, (m[2, 1] - m[1, 2]) / s4, (m[0, 2] - m[2, 0]) / s4,
                      (m[1, 0] - m[0, 1]) / s4])
    else:
        i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s4 = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[0] = (m[k, j] - m[j, k]) / s4
        q[1 + i] = 0.25 * s4
        q[1 + j] = (m[j, i] + m[i, j]) / s4
        q[1 + k] = (m[k, i] + m[i, k]) / s4
    return (q / np.linalg.norm(q)).astype(np.float32)


def trs_matrix(pos, quat) -> np.ndarray:
    m = quat_matrix(quat)
    m[:3, 3] = np.asarray(pos, np.float32)
    return m


def view_matrix(camera: dict) -> np.ndarray:
    pos = np.asarray(camera["position"], np.float32)
    return np.linalg.inv(trs_matrix(pos, look_at_quat(pos, camera["target"]))).astype(np.float32)


def projection_matrix(camera: dict, aspect: float) -> np.ndarray:
    n, f = camera["near"], camera["far"]
    t = float(np.tan(np.radians(camera["fov"]) / 2.0))
    return np.array([
        [1.0 / (aspect * t), 0, 0, 0],
        [0, 1.0 / t, 0, 0],
        [0, 0, -(f + n) / (f - n), -2.0 * f * n / (f - n)],
        [0, 0, -1.0, 0],
    ], np.float32)


def object_quat(obj: dict, frame: int) -> np.ndarray:
    """The object's rotation when frame ``frame`` draws it: its turn applied
    ``frame`` times (every ``interval`` frames, when it has one)."""
    q = np.array([1.0, 0, 0, 0], np.float32)
    turn = axis_angle_quat(obj["axis"], obj["deg_per_turn"])
    interval = int(obj.get("interval", 1))
    for i in range(1, frame + 1):
        if i % interval == 0:
            q = quat_mul(q, turn)
    return q


@lru_cache(maxsize=8)
def sphere(radius: float, segments: int):
    from benchmark.reference.plain.engine.mesh import Mesh

    return Mesh.Sphere(radius, segments)


def draw_inputs(scene: dict, frame: int, height: int, width: int, device, render_mode: int,
                noise=None, corrmap=None):
    """(draws, sigs, proj) of frame ``frame``, as the engine hands them to the
    frame step: one draw an object, far objects none (every scene here is in
    front of its camera)."""
    from benchmark.reference.plain.engine.render_exec import mesh_device_buffers
    from benchmark.reference.plain.ops.gbuffer import DrawUniforms

    view = view_matrix(scene["camera"])
    draws, sigs = [], []
    for obj in scene["objects"]:
        mesh = sphere(float(obj["radius"]), int(obj["segments"]))
        model = trs_matrix(obj.get("position", (0.0, 0.0, 0.0)), object_quat(obj, frame))
        corr_vals, corr_size = None, (512, 512)
        if corrmap is not None:
            corr_vals, corr_size = corrmap.values, (corrmap.height, corrmap.width)
        draws.append(dict(buffers=mesh_device_buffers(mesh, device), mv=view @ model,
                          diffuse=None, noise=noise, corrmap=corr_vals))
        sigs.append((DrawUniforms(sprite_id=int(obj["sprite_id"]),
                                  material_id=int(obj["material_id"]), render_mode=render_mode,
                                  has_vertex_color=True), corr_size, None, None))
    return draws, sigs, projection_matrix(scene["camera"], width / height)


def prompt_text(scene: dict, default: str = "") -> str:
    """The engine's one conditioning text: the sprites' prompts, then the
    camera's environment prompt, joined by commas."""
    parts = [o["prompt"] for o in scene["objects"] if o.get("prompt")]
    env = scene["camera"].get("prompt") or default
    return ", ".join(parts + ([env] if env else [])) or default
