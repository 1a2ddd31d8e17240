"""The PyTorch port's whole frame against the JAX package's ``frame_step``.

Both packages run the sequential 64x64 frame on the CPU with the same tiny
random pipeline (the JAX params converted leaf by leaf), the same mesh,
camera, background noise and corresponder, and the sampler re-noise draws the
JAX program makes. The JAX side runs its XLA rasterizer and plain attention
(the CPU routes); the port its plain versions of both kernels.
"""

from __future__ import annotations

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_renderer_tpu_torch.convert import params_from_numpy

torch.set_num_threads(1)

SIZE = 64
SEED = 3


def _look_at_np(eye, center, up):
    eye, center, up = (np.asarray(a, np.float64) for a in (eye, center, up))
    f = center - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, f @ eye
    return m.astype(np.float32)


def _bench_camera():
    """The bench scene's camera (bench.py:229-236): eye (0, 0.5, 3) looking
    at the origin, fov 45, near 0.1, far 100; the ball turned 4 degrees."""
    view = _look_at_np([0.0, 0.5, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    t = 1.0 / np.tan(np.radians(45.0) / 2.0)
    n, f = 0.1, 100.0
    proj = np.array([[t, 0, 0, 0], [0, t, 0, 0],
                     [0, 0, -(f + n) / (f - n), -2 * f * n / (f - n)], [0, 0, -1, 0]], np.float32)
    a = np.radians(4.0)
    model = np.array([[np.cos(a), 0, np.sin(a), 0], [0, 1, 0, 0],
                      [-np.sin(a), 0, np.cos(a), 0], [0, 0, 0, 1]], np.float32)
    return (view @ model).astype(np.float32), proj


def _frames(int8: bool):
    """The 64x64 frame through both packages from the same tiny pipeline
    (quantized by the JAX package when ``int8``); returns both outputs, both
    pipelines and a function that runs the port's frame on the same inputs
    for another port pipeline."""
    from stable_renderer_tpu.data.sprite import EnvPrompt as JEnv, Sprite as JSprite
    from stable_renderer_tpu.engine.frame_program import frame_step as j_frame_step
    from stable_renderer_tpu.engine.mesh import Mesh as JMesh
    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.engine.render_exec import mesh_device_buffers as j_buffers
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap
    from stable_renderer_tpu.ops.gbuffer import RENDER_MODE_BAKING, DrawUniforms as JUniforms
    from stable_renderer_tpu.ops.postprocess import PostProcessParams as JPP
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.engine.frame_program import frame_step
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.ops.gbuffer import DrawUniforms
    from stable_renderer_tpu_torch.ops.postprocess import PostProcessParams
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform",
              int8_conv=int8)
    jpipe = JPipe.from_random(JConfig(**kw), tiny=True, seed=0)
    mv, proj = _bench_camera()
    bg = np.random.default_rng(7).standard_normal((1, SIZE, SIZE, 4)).astype(np.float32)
    key = np.array([0, SEED], np.uint32)

    # --- JAX ---
    jmesh = JMesh.Sphere(1.0, 12)
    jsigs = ((JUniforms(sprite_id=1, material_id=1, render_mode=RENDER_MODE_BAKING),
              (512, 512), None, None),)
    jdraws = (dict(buffers=j_buffers(jmesh), mv=mv, diffuse=None, noise=None, corrmap=None),)
    _, jctx, jnctx, _, _ = jpipe.prepare_conditioning(
        {1: JSprite(spriteID=1, prompt="a shiny ball")}, (JEnv("a ball"),), 1)
    jcorr = JOverlap(vertex_segments=SIZE * SIZE, update_corrmap=False)
    up, vp, cp = jpipe.compute_params()
    jdisp, jgbuf, jpack, jimages, _, _ = j_frame_step(
        jpipe, jcorr, (), jsigs, SIZE, SIZE, True, False, JPP(), (), True, jdraws,
        jnp.asarray(proj), jnp.asarray(bg), None, jctx, jnctx, jpipe.scheduler_sigmas(),
        key, up, vp, cp)
    # the sampler's re-noise draws inside the JAX program (samplers.py:251-255)
    lat_shape = (1, SIZE // 2, SIZE // 2, 4)  # tiny VAE downsamples by 2
    k = jax.random.fold_in(jnp.asarray(key), 1)
    step_noise = []
    for _ in range(4):
        k, sub = jax.random.split(k)
        step_noise.append(torch.from_numpy(np.array(jax.random.normal(sub, lat_shape))))

    # --- port, same params (the quantized trees when int8) ---
    mesh = Mesh.Sphere(1.0, 12)
    sigs = ((DrawUniforms(sprite_id=1, material_id=1, render_mode=2), (512, 512), None, None),)
    draws = (dict(buffers=mesh_device_buffers(mesh, "cpu"), mv=mv, diffuse=None, noise=None,
                  corrmap=None),)

    def run_port(pipe):
        _, ctx, nctx, _, _ = pipe.prepare_conditioning(
            {1: Sprite(spriteID=1, prompt="a shiny ball")}, (EnvPrompt("a ball"),), 1)
        np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=2e-4, rtol=2e-4)
        corr = OverlapCorresponder(vertex_segments=SIZE * SIZE, update_corrmap=False)
        return frame_step(
            pipe, corr, (), sigs, SIZE, SIZE, True, False, PostProcessParams(), (), True, draws,
            torch.from_numpy(proj), torch.from_numpy(bg), None, ctx, nctx,
            pipe.scheduler_sigmas(), torch.Generator().manual_seed(SEED),
            *pipe.compute_params(), step_noise=step_noise)[:4]

    pipe = _port_pipeline(jpipe, RenderConfig(**kw))
    return run_port(pipe), (jdisp, jgbuf, jpack, jimages), pipe, run_port


def test_frame_step_matches_jax():
    (disp, gbuf, pack, images), (jdisp, jgbuf, jpack, jimages), _, _ = _frames(int8=False)

    # the G-buffer id map is exact: same triangles, vertices and view bins
    np.testing.assert_array_equal(gbuf.id.numpy(), np.asarray(jgbuf.id))
    assert int((gbuf.id[..., 3] > 0).sum()) > 500  # the sphere covers the frame centre
    for name in ("color", "mask", "pos", "normal", "depth", "canny", "noise"):
        np.testing.assert_allclose(pack[name].numpy(), np.asarray(jpack[name]),
                                   atol=2e-4, rtol=2e-4, err_msg=name)
    # decoded frame after 4 LCM steps through the tiny UNet and VAE, f32
    np.testing.assert_allclose(images.numpy(), np.asarray(jimages), atol=2e-4, rtol=2e-4)
    assert disp.dtype == torch.uint8 and disp.shape == (SIZE, SIZE, 4)
    assert int((disp.int() - torch.from_numpy(np.array(jdisp)).int()).abs().max()) <= 1


def test_int8_frame_step_matches_jax():
    """The calibrated int8 frame: the JAX package quantizes the tiny pipeline
    (calibration at 512x512, as ``quantize_convs`` does by default) and the
    port runs the same quantized trees through ``conv2d_q`` (the tiny widths
    are below K3's 128-channel gate in both packages).

    The bar is not the f32 frame's 2e-4. Each conv's int8 result is exact
    given its input (tests/test_torch_quant.py), but the two packages compute
    each conv input only to within f32 rounding, and an input within an ulp
    of a .5 quantization boundary rounds to neighbouring int8 values in the
    two: that conv's output moves by a_scale * w_scale * |w_q| (up to ~1/127
    of the input's range) around the pixel, and later convs, attention and
    four sampler steps spread it. The JAX package is not even stable against
    itself: its calibrated scales differ in the last bits between processes
    (XLA's multithreaded CPU sums), so its own int8 frame changes from run to
    run. The frame is therefore held to what separates an int8 frame from a
    float one: the port's int8 frame must lie at most half as far from the
    JAX int8 frame, in mean absolute error on [0, 1] pixels, as the same
    pipeline's float frame does (runs of this test read 0.003 to 0.024
    against 0.14 to 0.16)."""
    (disp, gbuf, pack, images), (jdisp, jgbuf, jpack, jimages), pipe, run_port = _frames(
        int8=True)
    assert "weight_q" in pipe.unet_params["input_blocks"]["1"]["0"]["in_layers"]["2"]
    conv1 = pipe.vae_params["decoder"]["mid"]["block_1"]["conv1"]
    assert conv1["a_scale"].dtype == conv1["w_scale"].dtype == torch.float32
    np.testing.assert_array_equal(gbuf.id.numpy(), np.asarray(jgbuf.id))
    assert np.isfinite(images.numpy()).all() and images.shape == (1, SIZE, SIZE, 3)
    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform")
    float_pipe = _port_pipeline(JPipe.from_random(JConfig(**kw), tiny=True, seed=0),
                                RenderConfig(**kw))
    float_images = run_port(float_pipe)[3].numpy()
    err = np.abs(images.numpy() - np.asarray(jimages)).mean()
    quant_effect = np.abs(float_images - np.asarray(jimages)).mean()
    assert err <= 0.5 * quant_effect, (err, quant_effect)


def test_render_matches_jax():
    """``DiffusionPipeline.render`` over a two-frame EngineData: frame 1's K/V
    broadcast to both frames and vertex averaging across frames. Euler draws
    nothing and the noise maps give the initial noise, so both packages run
    on the same inputs without handing draws across."""
    from stable_renderer_tpu.data.engine_data import EngineData as JEngineData
    from stable_renderer_tpu.data.sprite import EnvPrompt as JEnv, Sprite as JSprite
    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(prompt="a ball", steps=2, cfg_scale=2.0, sampler="euler", scheduler="sgm_uniform")
    jpipe = JPipe.from_random(JConfig(**kw), tiny=True, seed=1)
    pipe = _port_pipeline(jpipe, RenderConfig(**kw))
    n, s = 2, 32
    rng = np.random.default_rng(11)
    arrays = dict(
        frame_indices=np.arange(n, dtype=np.int32),
        color_maps=rng.random((n, s, s, 3)).astype(np.float32),
        noise_maps=rng.standard_normal((n, s // 8, s // 8, 4)).astype(np.float32),
        normal_maps=rng.random((n, s, s, 3)).astype(np.float32),
    )
    ids = np.zeros((n, s, s, 4), np.int32)
    ids[..., :2] = 1
    ids[..., 2] = rng.integers(0, 9, (n, s, s))
    ids[..., 3] = rng.integers(0, 40, (n, s, s))  # few vertices: many pixels share one
    ids[:, :4] = 0  # background rows
    arrays["id_maps"] = ids
    jed = JEngineData(**{k: jnp.asarray(v) for k, v in arrays.items()},
                      sprite_infos={1: JSprite(spriteID=1, prompt="a shiny ball")},
                      env_prompts=(JEnv("a ball"),))
    ed = EngineData(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                    sprite_infos={1: Sprite(spriteID=1, prompt="a shiny ball")},
                    env_prompts=(EnvPrompt("a ball"),))
    corr_kw = dict(vertex_segments=64, update_corrmap=False)
    ref = jpipe.render(jed, corresponder=JOverlap(**corr_kw))
    out = pipe.render(ed, corresponder=OverlapCorresponder(**corr_kw))
    assert out.shape == (n, s, s, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)

    jc, jn = jpipe.encode_prompts(["a ball", "a red ball"], ["", "blurry"])
    tc, tn = pipe.encode_prompts(["a ball", "a red ball"], ["", "blurry"])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=2e-4, rtol=2e-4)


def test_draw_call_inputs_and_pack_frame_data_match_jax():
    from types import SimpleNamespace

    from stable_renderer_tpu.data.framebuffers import GBuffer as JGBuffer
    from stable_renderer_tpu.engine.frame_program import draw_call_inputs as j_inputs
    from stable_renderer_tpu.engine.mesh import Mesh as JMesh
    from stable_renderer_tpu.engine.render_exec import pack_frame_data as j_pack
    from stable_renderer_tpu.ops.gbuffer import DrawUniforms as JUniforms

    from stable_renderer_tpu_torch.data.framebuffers import GBuffer
    from stable_renderer_tpu_torch.engine.frame_program import draw_call_inputs
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.render_exec import pack_frame_data
    from stable_renderer_tpu_torch.ops.gbuffer import DrawUniforms

    rng = np.random.default_rng(2)
    view, model = (rng.standard_normal((4, 4)).astype(np.float32) for _ in range(2))
    tex = rng.random((8, 8, 4)).astype(np.float32)
    corrmap = SimpleNamespace(values=np.zeros((9, 3, 4), np.float32), height=256, width=128)

    def calls(mesh, uniforms, wrap):
        return [SimpleNamespace(mesh=mesh, model_matrix=model, uniforms=uniforms, diffuse=None,
                                noise=SimpleNamespace(array=wrap(tex)), corrmap=corrmap,
                                shader=None)]

    jdraws, jsigs = j_inputs(calls(JMesh.Cube(1.0), JUniforms(sprite_id=3), jnp.asarray), view)
    mesh = Mesh.Cube(1.0)
    draws, sigs = draw_call_inputs(calls(mesh, DrawUniforms(sprite_id=3), torch.from_numpy), view,
                                   device="cpu")
    assert [s[1:] for s in sigs] == [s[1:] for s in jsigs] == [((256, 128), None, None)]
    assert sigs[0][0].sprite_id == jsigs[0][0].sprite_id == 3
    np.testing.assert_allclose(draws[0]["mv"], jdraws[0]["mv"], rtol=1e-6)
    np.testing.assert_array_equal(draws[0]["noise"].numpy(), np.asarray(jdraws[0]["noise"]))
    assert draws[0]["corrmap"] is corrmap.values and draws[0]["diffuse"] is None
    # against the mesh itself: the JAX cache keys on id(mesh) alone, so a
    # mesh freed by an earlier test can hand its buffers to this one
    assert sorted(draws[0]["buffers"]) == sorted(jdraws[0]["buffers"])
    for name, buf in draws[0]["buffers"].items():
        np.testing.assert_array_equal(buf.numpy(), getattr(mesh, name))

    h = w = 16
    fields = dict(color=rng.random((h, w, 4)), id=rng.integers(0, 50, (h, w, 4)).astype(np.int32),
                  pos=rng.random((h, w, 3)), normal_depth=rng.random((h, w, 4)),
                  noise=rng.standard_normal((h, w, 4)), canny=rng.random((h, w, 3)))
    fields = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in fields.items()}
    bg = rng.standard_normal((1, h, w, 4)).astype(np.float32)
    ref = j_pack(JGBuffer(**{k: jnp.asarray(v) for k, v in fields.items()}), jnp.asarray(bg), 5)
    out = pack_frame_data(GBuffer(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                          torch.from_numpy(bg), 5)
    assert out.keys() == ref.keys() and out["frame_index"] == ref["frame_index"] == 5
    for k in out.keys() - {"frame_index"}:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=2e-4, rtol=2e-4,
                                   err_msg=k)


def _port_pipeline(jpipe, config):
    """The port's pipeline over the JAX pipeline's parameters, converted."""
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.models.clip import CLIPTextModel, Tokenizer
    from stable_renderer_tpu_torch.models.sampling import ModelSampling
    from stable_renderer_tpu_torch.models.unet import UNetModel
    from stable_renderer_tpu_torch.models.vae import VAE

    return DiffusionPipeline(
        unet=UNetModel(_unet_cfg(jpipe)),
        vae=VAE(_vae_cfg(jpipe)),
        clip=CLIPTextModel(_clip_cfg(jpipe)),
        tokenizer=Tokenizer(_clip_cfg(jpipe)),
        unet_params=params_from_numpy(jpipe.unet_params, "cpu"),
        vae_params=params_from_numpy(jpipe.vae_params, "cpu"),
        clip_params=params_from_numpy(jpipe.clip_params, "cpu"),
        config=config,
        model_sampling=ModelSampling(prediction=jpipe.model_sampling.prediction),
        device="cpu",
    )


def _unet_cfg(jpipe):
    from stable_renderer_tpu_torch.models.unet import UNetConfig

    c = jpipe.unet.config
    return UNetConfig(in_channels=c.in_channels, out_channels=c.out_channels,
                      model_channels=c.model_channels, num_res_blocks=c.num_res_blocks,
                      channel_mult=c.channel_mult, attention_levels=c.attention_levels,
                      transformer_depth=c.transformer_depth, num_heads=c.num_heads,
                      context_dim=c.context_dim)


def _vae_cfg(jpipe):
    from stable_renderer_tpu_torch.models.vae import VAEConfig

    c = jpipe.vae.config
    return VAEConfig(ch=c.ch, ch_mult=c.ch_mult, num_res_blocks=c.num_res_blocks,
                     z_channels=c.z_channels, embed_dim=c.embed_dim, scale_factor=c.scale_factor)


def _clip_cfg(jpipe):
    from stable_renderer_tpu_torch.models.clip import CLIPConfig

    c = jpipe.clip.config
    return CLIPConfig(vocab_size=c.vocab_size, max_length=c.max_length,
                      hidden_size=c.hidden_size, num_layers=c.num_layers,
                      num_heads=c.num_heads, intermediate_size=c.intermediate_size,
                      bos_token=c.bos_token, eos_token=c.eos_token)


def test_import_boundary():
    """Importing every module of the port pulls in neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import stable_renderer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'stable_renderer_tpu' or k.startswith('stable_renderer_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_params_from_numpy(dtype):
    tree = {"a": {"weight": np.ones((2, 3), np.float32)}, "ids": np.arange(4, dtype=np.int32)}
    out = params_from_numpy(tree, "cpu", dtype=dtype)
    assert out["a"]["weight"].dtype == (dtype or torch.float32)
    assert out["a"]["weight"].shape == (2, 3)
    assert out["ids"].dtype == torch.int32


def test_params_from_numpy_keeps_int8_scales_f32():
    leaf = {"weight_q": np.ones((3, 3, 2, 4), np.int8), "w_scale": np.full(4, 0.1, np.float32),
            "a_scale": np.float32(0.02), "bias": np.zeros(4, np.float32)}
    out = params_from_numpy({"conv": leaf}, "cpu", dtype=torch.bfloat16)["conv"]
    assert out["weight_q"].dtype == torch.int8
    assert out["w_scale"].dtype == out["a_scale"].dtype == torch.float32
    assert out["a_scale"].dim() == 0 and out["a_scale"].item() == np.float32(0.02)
    assert out["bias"].dtype == torch.bfloat16


def test_entry_points_default_to_the_card():
    """Without ``device=`` the entry points pick CUDA, and raise where there
    is no card; the CPU is asked for by name."""
    from stable_renderer_tpu_torch.engine.frame_program import draw_call_inputs
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers

    calls = {
        "from_random": lambda: DiffusionPipeline.from_random(tiny=True).device,
        "mesh_device_buffers": lambda: mesh_device_buffers(Mesh.Cube(1.0))["tris"].device,
        "draw_call_inputs": lambda: draw_call_inputs((), np.eye(4)) and torch.device("cuda"),
        "params_from_numpy": lambda: params_from_numpy({"w": np.ones(2, np.float32)})["w"].device,
    }
    for name, call in calls.items():
        if torch.cuda.is_available():
            assert call().type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert DiffusionPipeline.from_random(tiny=True, device="cpu").device.type == "cpu"
