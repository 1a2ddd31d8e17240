"""Public names of ported modules that the port lacked until ROADMAP 1.15,
held against the JAX package on the CPU: ``Corresponder.prepare`` and
``Corresponder.step_callback``, ``ops.texture.noise_texture`` and
``engine.render_exec.execute_draws`` (``Tokenizer.encode_batch`` and
``SDTokenizer.untokenize`` are in tests/test_torch_model_families.py)."""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_executor import engine_maps, jax_engine_data, port_engine_data
from test_torch_frame import _look_at_np

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("ms", [True, False])
def test_corresponder_step_callback_matches_jax(ms):
    """OverlapCorresponder.step_callback over EngineData (its id and normal
    maps) and a ModelSampling's log sigmas: the same step on the same latents
    at a sigma above and one below the stop timestep; without the
    ModelSampling both packages average at every sigma. prepare does nothing
    in either; without engine data (no id maps) there is no callback."""
    from stable_renderer_tpu.models.sampling import ModelSampling as JMS
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap

    from stable_renderer_tpu_torch.models.sampling import ModelSampling
    from stable_renderer_tpu_torch.ops.correspondence import Corresponder, OverlapCorresponder

    maps = engine_maps(n=2, h=32, w=32, seed=4)
    corr, jcorr = OverlapCorresponder(step_finished_inject_ratio=0.5), JOverlap(
        step_finished_inject_ratio=0.5)
    ped, jed = port_engine_data(maps), jax_engine_data(maps)
    assert corr.prepare(ped) is None and jcorr.prepare(jed) is None
    assert Corresponder().step_callback(ped) is None
    cb = corr.step_callback(ped, ModelSampling() if ms else None)
    jcb = jcorr.step_callback(jed, JMS() if ms else None)
    rng = np.random.default_rng(5)
    for sigma in (14.0, 0.05):
        x, den = (rng.standard_normal((2, 32, 32, 4)).astype(np.float32) for _ in range(2))
        out = cb(torch.from_numpy(x), torch.from_numpy(den), torch.tensor(sigma), 1)
        ref = jcb(jnp.asarray(x), jnp.asarray(den), jnp.float32(sigma), 1)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert corr.step_callback(None, ModelSampling()) is jcorr.step_callback(None, JMS()) is None


def test_noise_texture_matches_jax():
    """noise_texture: an (H, W, C) f32 standard-normal texture in both
    packages (the draws differ: a torch generator here, a key there), the
    same for the same generator seed."""
    from stable_renderer_tpu.ops.texture import noise_texture as j_noise

    from stable_renderer_tpu_torch.ops.texture import noise_texture

    out = noise_texture(torch.Generator().manual_seed(3), 64, 48, 4)
    ref = j_noise(jax.random.PRNGKey(3), 64, 48, 4)
    assert tuple(out.shape) == tuple(ref.shape) == (64, 48, 4)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert torch.equal(out, noise_texture(torch.Generator().manual_seed(3), 64, 48, 4))
    for a in (out.numpy(), np.asarray(ref)):
        assert abs(float(a.mean())) < 0.05 and abs(float(a.std()) - 1.0) < 0.05
    assert noise_texture(None, 2, 3, channels=1).shape == (2, 3, 1)


def test_execute_draws_matches_jax():
    """execute_draws: a sphere and a turned cube with a noise texture, drawn
    through the camera's view and projection into a fresh G-buffer, field
    for field as JAX's; no camera or no draws give the empty G-buffer."""
    from stable_renderer_tpu.engine.mesh import Mesh as JMesh
    from stable_renderer_tpu.engine.render_exec import execute_draws as j_execute
    from stable_renderer_tpu.ops.gbuffer import DrawUniforms as JUniforms

    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.render_exec import execute_draws
    from stable_renderer_tpu_torch.ops.gbuffer import DrawUniforms

    h, w = 48, 64
    view = _look_at_np([0.0, 0.5, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])

    def projection(aspect):
        t, n, f = 1.0 / np.tan(np.radians(45.0) / 2.0), 0.1, 100.0
        return np.array([[t / aspect, 0, 0, 0], [0, t, 0, 0],
                         [0, 0, -(f + n) / (f - n), -2 * f * n / (f - n)], [0, 0, -1, 0]],
                        np.float32)

    camera = SimpleNamespace(viewMatrix=view, projectionMatrix=projection)
    a = np.radians(30.0)
    turned = np.array([[np.cos(a), 0, np.sin(a), 0.6], [0, 1, 0, 0], [-np.sin(a), 0, np.cos(a), 0],
                       [0, 0, 0, 1]], np.float32)
    tex = np.random.default_rng(6).standard_normal((16, 16, 4)).astype(np.float32)

    def calls(mesh_cls, uniforms_cls, wrap):
        eye = np.eye(4, dtype=np.float32)
        return [SimpleNamespace(mesh=mesh_cls.Sphere(0.8, 10), model_matrix=eye,
                                uniforms=uniforms_cls(sprite_id=1, material_id=1), diffuse=None,
                                noise=None, corrmap=None, shader=None),
                SimpleNamespace(mesh=mesh_cls.Cube(0.7), model_matrix=turned,
                                uniforms=uniforms_cls(sprite_id=2, material_id=1), diffuse=None,
                                noise=SimpleNamespace(array=wrap(tex)), corrmap=None, shader=None)]

    jcalls = calls(JMesh, JUniforms, jnp.asarray)
    out = execute_draws(calls(Mesh, DrawUniforms, torch.from_numpy), camera, h, w, device="cpu")
    ref = j_execute(jcalls, camera, h, w)
    for name in ("color", "id", "pos", "normal_depth", "noise", "canny"):
        mine, theirs = getattr(out, name), np.asarray(getattr(ref, name))
        assert tuple(mine.shape) == theirs.shape, name
        np.testing.assert_allclose(mine.float().numpy(), theirs.astype(np.float32), err_msg=name,
                                   **TOL)
    assert float(out.color[..., 3].sum()) > 0
    for args in ((calls(Mesh, DrawUniforms, torch.from_numpy), None), ([], camera)):
        empty = execute_draws(*args, h, w, device="cpu")
        jempty = j_execute(jcalls if args[1] is None else [], args[1], h, w)
        for name in ("color", "id", "normal_depth"):
            np.testing.assert_array_equal(getattr(empty, name).numpy(),
                                          np.asarray(getattr(jempty, name)))
