"""User shaders (engine/shader.py) of the port against the JAX package on the
CPU: the registry and ``ShaderStruct``, and a custom vertex and fragment
shader, each written once with jnp and once with torch, through both
packages' draw pass (vertex stage -> rasterize -> shade -> compose) on the
bench sphere at 64x64. Identity shaders give the fixed pipeline's G-buffer
bit for bit."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_renderer_tpu.engine import shader as jshader
from stable_renderer_tpu_torch.engine import shader as tshader

torch.set_num_threads(1)
SIZE = 64
TOL = dict(atol=2e-4, rtol=2e-4)


class Tint(tshader.ShaderStruct):
    tint = (0.9, 0.5, 0.2)
    gain = 1.5


class JTint(jshader.ShaderStruct):
    tint = (0.9, 0.5, 0.2)
    gain = 1.5


def test_registry_and_shader_struct_match_jax():
    for sh in (jshader, tshader):
        s = sh.Shader("test_registry_custom", fragment_fn=lambda f, u: f.color)
        assert sh.Shader.Find("test_registry_custom") is s
        assert sh.Shader.Find("no such shader") is None
        assert "test_registry_custom" in sh.Shader.AllShaders()
        default = sh.Shader.Default()
        assert default is sh.Shader.Default() and default.fragment_fn is None
        assert default.bound_fragment() is None and default.vertex_fn is None
        debug = sh.Shader.DefaultDebug()
        assert debug is sh.Shader.DefaultDebug() and debug.name == "debug_normals"
        assert s.bound_fragment() is s.bound_fragment()  # memoized: one hook a shader
        assert repr(s) == "<Shader test_registry_custom [frag]>"
        assert repr(default) == "<Shader default [fixed]>"
    tu, ju = Tint(gain=2.0).uniforms(), JTint(gain=2.0).uniforms()
    assert sorted(tu) == sorted(ju) == ["gain", "tint"]
    for k in tu:
        assert torch.is_tensor(tu[k])
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]))
    assert Tint().gain == 1.5 and Tint(gain=2.0).gain == 2.0


def _draw(pkg, vertex_fn=None, fragment_fn=None):
    """One draw of the bench sphere (vertex colors, NORMAL mode) at 64x64
    through package ``pkg``'s draw pass; returns the G-buffer as numpy."""
    from test_torch_frame import _bench_camera

    mv, proj = _bench_camera()
    if pkg == "jax":
        from stable_renderer_tpu.data.framebuffers import GBuffer
        from stable_renderer_tpu.engine.mesh import Mesh
        from stable_renderer_tpu.engine.render_exec import _draw_pass
        from stable_renderer_tpu.ops.gbuffer import DrawUniforms

        mesh = Mesh.Sphere(1.0, 12)
        bufs = {k: jnp.asarray(getattr(mesh, k)) for k in
                ("positions", "normals", "uvs", "colors", "vertex_ids", "tris")}
        gbuf, _ = _draw_pass(GBuffer.empty(SIZE, SIZE), jnp.ones((SIZE, SIZE)), bufs,
                             jnp.asarray(mv), jnp.asarray(proj), DrawUniforms(sprite_id=1),
                             SIZE, SIZE, fragment_fn=fragment_fn, vertex_fn=vertex_fn)
        return {k: np.asarray(v) for k, v in gbuf._asdict().items()}
    from stable_renderer_tpu_torch.data.framebuffers import GBuffer
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.render_exec import _draw_pass, mesh_device_buffers
    from stable_renderer_tpu_torch.ops.gbuffer import DrawUniforms

    bufs = mesh_device_buffers(Mesh.Sphere(1.0, 12), "cpu")
    gbuf, _ = _draw_pass(GBuffer.empty(SIZE, SIZE, device="cpu"), torch.ones((SIZE, SIZE)), bufs,
                         torch.from_numpy(mv), torch.from_numpy(proj), DrawUniforms(sprite_id=1),
                         SIZE, SIZE, fragment_fn=fragment_fn, vertex_fn=vertex_fn)
    return {k: v.numpy() for k, v in gbuf._asdict().items()}


def _wobble(xp, vertex_stage):
    """A user vertex stage: the sphere squashed in y and pushed out by a
    ripple along x, then the fixed transform."""
    def vertex_fn(positions, normals, mv, proj):
        p = positions * xp.stack([1.0 + 0.15 * xp.sin(3.0 * positions[:, 1]),
                                  0.8 + 0.0 * positions[:, 1],
                                  1.0 + 0.0 * positions[:, 1]], -1)
        return vertex_stage(p, normals, mv, proj)
    return vertex_fn


def _tinted(xp, cat):
    """A user fragment stage with uniforms: tint * gain * fixed color plus the
    uv as a red-green ramp, three channels (alpha 1)."""
    def frag(f, u):
        rgb = f.color[..., :3] * u["tint"] * u["gain"] + 0.25 * cat(
            [f.uv, f.vertex_color[..., :1] * 0.0], -1)
        return rgb * (0.5 + 0.5 * f.normal[..., 2:3]) + 0.01 * f.view_pos
    return frag


@pytest.mark.parametrize("stages", ["vertex", "fragment", "both"])
def test_custom_shaders_in_the_draw_match_jax(stages):
    from stable_renderer_tpu.ops.raster import vertex_stage as j_vertex_stage
    from stable_renderer_tpu_torch.ops.raster import vertex_stage

    jv = _wobble(jnp, j_vertex_stage) if stages != "fragment" else None
    tv = _wobble(torch, vertex_stage) if stages != "fragment" else None
    jf = tf = None
    if stages != "vertex":
        jf = jshader.Shader("test_tinted_jax", fragment_fn=_tinted(jnp, jnp.concatenate),
                            uniforms=JTint()).bound_fragment()
        tf = tshader.Shader("test_tinted", fragment_fn=_tinted(torch, torch.cat),
                            uniforms=Tint()).bound_fragment()
    ref, out = _draw("jax", jv, jf), _draw("torch", tv, tf)
    fixed = _draw("torch")
    np.testing.assert_array_equal(out["id"], ref["id"])
    for k in ("color", "pos", "normal_depth", "noise", "canny"):
        np.testing.assert_allclose(out[k], ref[k], err_msg=k, **TOL)
    moved = "id" if stages == "vertex" else "color"
    assert not np.array_equal(out[moved], fixed[moved])
    covered = out["id"][..., 0] > 0
    assert (out["color"][~covered] == 0).all()  # the user color lands on covered pixels only
    if stages != "vertex":
        assert (out["color"][covered][:, 3] == 1.0).all()


def test_identity_shaders_equal_the_fixed_pipeline_and_debug_differs():
    from stable_renderer_tpu_torch.ops.raster import vertex_stage

    ident = tshader.Shader("test_identity", fragment_fn=lambda f, u: f.color,
                           vertex_fn=lambda p, n, mv, proj: vertex_stage(p, n, mv, proj))
    fixed = _draw("torch")
    same = _draw("torch", ident.vertex_fn, ident.bound_fragment())
    for k in fixed:
        np.testing.assert_array_equal(same[k], fixed[k], err_msg=k)
    debug = _draw("torch", None, tshader.Shader.DefaultDebug().bound_fragment())
    jdebug = _draw("jax", None, jshader.Shader.DefaultDebug().bound_fragment())
    np.testing.assert_allclose(debug["color"], jdebug["color"], **TOL)
    assert not np.array_equal(debug["color"], fixed["color"])
    np.testing.assert_array_equal(debug["id"], fixed["id"])


def test_material_shader_reaches_the_draw_inputs():
    """``Material.shader`` rides the draw call into ``draw_call_inputs``: the
    signature carries the vertex stage and the memoized bound fragment."""
    from types import SimpleNamespace

    from stable_renderer_tpu_torch.engine.frame_program import draw_call_inputs
    from stable_renderer_tpu_torch.engine.material import Material
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.ops.gbuffer import DrawUniforms

    mat = Material("shaded")
    assert mat.shader is None
    mat.shader = tshader.Shader("test_material", fragment_fn=lambda f, u: f.color,
                                vertex_fn=lambda *a: None)
    call = SimpleNamespace(mesh=Mesh.Cube(1.0), model_matrix=np.eye(4, dtype=np.float32),
                           uniforms=DrawUniforms(), diffuse=None, noise=None, corrmap=None,
                           shader=mat.shader)
    _, sigs = draw_call_inputs([call], np.eye(4, dtype=np.float32), device="cpu")
    assert sigs[0][2] is mat.shader.vertex_fn and sigs[0][3] is mat.shader.bound_fragment()
