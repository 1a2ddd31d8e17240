"""The port's TAESD (``models/taesd.py``) and the realtime TAESD frame against
the JAX package, on the CPU.

One parameter tree feeds both packages (the JAX ``TAESD.init`` tree, converted
leaf by leaf). The frames use the tiny pipeline: TAESD always downsamples by
8, so the 64x64 frame's latent is 8x8 (the tiny VAE's would be 32x32).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_renderer_tpu_torch.convert import params_from_numpy

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)  # the f32 frame's bar (tests/test_torch_frame.py)
SIZE = 64
LAT = SIZE // 8


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@functools.lru_cache(maxsize=None)
def _jax_params():
    from stable_renderer_tpu.models.taesd import TAESD as JTAESD

    return JTAESD().init(jax.random.PRNGKey(0))


def test_init_tree_matches_jax():
    """The same keys (the torch Sequential indices) and shapes as the JAX
    package's init, weights N(0, 0.05^2), zero biases, stride convs without
    bias; f32 by default."""
    from stable_renderer_tpu_torch.models.taesd import TAESD

    params = TAESD().init(torch.Generator().manual_seed(0))
    assert _flat(params) == _flat(_jax_params())
    assert "encoder.2.bias" not in _flat(params) and "decoder.3.conv.0.weight" in _flat(params)
    w = params["encoder"]["1"]["conv"]["0"]["weight"]
    assert w.dtype == torch.float32 and 0.04 < float(w.std()) < 0.06
    assert float(params["encoder"]["0"]["bias"].abs().max()) == 0.0
    again = TAESD().init(torch.Generator().manual_seed(0))
    assert torch.equal(again["decoder"]["1"]["weight"], params["decoder"]["1"]["weight"])


def test_encode_decode_match_jax():
    """64x64 f32 encode and decode within 1e-4 abs; decode clamps to [0, 1]."""
    from stable_renderer_tpu.models.taesd import TAESD as JTAESD

    from stable_renderer_tpu_torch.models.taesd import TAESD

    jp = _jax_params()
    tp = params_from_numpy(jp, "cpu")
    rng = np.random.default_rng(0)
    x = rng.random((2, SIZE, SIZE, 3)).astype(np.float32)
    z = rng.standard_normal((2, LAT, LAT, 4)).astype(np.float32)
    jt, t = JTAESD(), TAESD()
    lat = t.encode(tp, torch.from_numpy(x))
    assert lat.shape == (2, LAT, LAT, 4)
    np.testing.assert_allclose(lat.numpy(), np.asarray(jt.encode(jp, jnp.asarray(x))), atol=1e-4)
    img = t.decode(tp, torch.from_numpy(z))
    assert img.shape == (2, SIZE, SIZE, 3) and 0.0 <= float(img.min()) <= float(img.max()) <= 1.0
    np.testing.assert_allclose(img.numpy(), np.asarray(jt.decode(jp, jnp.asarray(z))), atol=1e-4)


def test_bf16_input_runs_in_bf16_like_jax():
    """The pipeline hands TAESD its colour in the VAE's compute type (bf16
    at full width) while the TAESD tree stays f32: both packages' conv2d
    cast the weight to the activation's type, so encode and decode run and
    return bf16. Each of the ~20 convs in a row rounds its output to bf16,
    in another order of sums in each package, so the two bf16 results are
    not held to each other but to the f32 result: the port's bf16 error
    must stay within twice the JAX package's (measured 0.8-1.5x)."""
    from stable_renderer_tpu.models.taesd import TAESD as JTAESD

    from stable_renderer_tpu_torch.models.taesd import TAESD

    jp = _jax_params()
    tp = params_from_numpy(jp, "cpu")
    assert tp["encoder"]["0"]["weight"].dtype == torch.float32
    rng = np.random.default_rng(1)
    x = rng.random((1, SIZE, SIZE, 3)).astype(np.float32)
    jt, t = JTAESD(), TAESD()
    j_lat = jt.encode(jp, jnp.asarray(x).astype(jnp.bfloat16))
    t_lat = t.encode(tp, torch.from_numpy(x).to(torch.bfloat16))
    f32_lat = np.asarray(jt.encode(jp, jnp.asarray(x)))
    j_img, t_img = jt.decode(jp, j_lat), t.decode(tp, t_lat)
    f32_img = np.asarray(jt.decode(jp, jnp.asarray(f32_lat)))
    for j_out, t_out, ref in ((j_lat, t_lat, f32_lat), (j_img, t_img, f32_img)):
        assert t_out.dtype == torch.bfloat16 and j_out.dtype == jnp.bfloat16
        j_err = np.abs(np.asarray(j_out.astype(jnp.float32)) - ref).max()
        t_err = np.abs(t_out.float().numpy() - ref).max()
        assert 0 < t_err <= 2.0 * j_err, (t_err, j_err)


@functools.lru_cache(maxsize=None)
def _pipelines(stream: bool):
    """A tiny JAX pipeline with ``realtime_taesd`` and ``with_taesd()``, and
    the port's over the same UNet, VAE, CLIP and TAESD params."""
    from test_torch_frame import _port_pipeline

    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.models.taesd import TAESD
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform",
              realtime_taesd=True)
    if stream:
        kw.update(stream_pipeline=True, stream_kv_layers=(2,))
    jpipe = JPipe.from_random(JConfig(**kw), tiny=True, seed=0).with_taesd()
    pipe = _port_pipeline(jpipe, RenderConfig(**kw))
    pipe.taesd, pipe.taesd_params = TAESD(), params_from_numpy(jpipe.taesd_params, "cpu")
    return jpipe, pipe


def test_taesd_frame_step_matches_jax():
    """The 64x64 bench frame through both packages' ``frame_step`` with
    TAESD encoding and decoding: the sampler's re-noise draws handed over,
    decoded frames at the f32 frame's bar, the display within one step."""
    from test_torch_frame import _bench_camera

    from stable_renderer_tpu.data.sprite import EnvPrompt as JEnv, Sprite as JSprite
    from stable_renderer_tpu.engine.frame_program import frame_step as j_frame_step
    from stable_renderer_tpu.engine.mesh import Mesh as JMesh
    from stable_renderer_tpu.engine.render_exec import mesh_device_buffers as j_buffers
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap
    from stable_renderer_tpu.ops.gbuffer import RENDER_MODE_BAKING, DrawUniforms as JUniforms
    from stable_renderer_tpu.ops.postprocess import PostProcessParams as JPP

    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.engine.frame_program import frame_step
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.ops.gbuffer import DrawUniforms
    from stable_renderer_tpu_torch.ops.postprocess import PostProcessParams

    jpipe, pipe = _pipelines(stream=False)
    mv, proj = _bench_camera()
    bg = np.random.default_rng(7).standard_normal((1, SIZE, SIZE, 4)).astype(np.float32)
    key = np.array([0, 3], np.uint32)
    jsigs = ((JUniforms(sprite_id=1, material_id=1, render_mode=RENDER_MODE_BAKING),
              (512, 512), None, None),)
    jdraws = (dict(buffers=j_buffers(JMesh.Sphere(1.0, 12)), mv=mv, diffuse=None, noise=None,
                   corrmap=None),)
    _, jctx, jnctx, _, _ = jpipe.prepare_conditioning(
        {1: JSprite(spriteID=1, prompt="a shiny ball")}, (JEnv("a ball"),), 1)
    jdisp, _, _, jimages, _, _ = j_frame_step(
        jpipe, JOverlap(vertex_segments=SIZE * SIZE, update_corrmap=False), (), jsigs, SIZE,
        SIZE, True, False, JPP(), (), True, jdraws, jnp.asarray(proj), jnp.asarray(bg), None,
        jctx, jnctx, jpipe.scheduler_sigmas(), key, *jpipe.compute_params())
    k = jax.random.fold_in(jnp.asarray(key), 1)
    step_noise = []
    for _ in range(4):
        k, sub = jax.random.split(k)
        step_noise.append(torch.from_numpy(np.array(jax.random.normal(sub, (1, LAT, LAT, 4)))))

    sigs = ((DrawUniforms(sprite_id=1, material_id=1, render_mode=2), (512, 512), None, None),)
    draws = (dict(buffers=mesh_device_buffers(Mesh.Sphere(1.0, 12), "cpu"), mv=mv, diffuse=None,
                  noise=None, corrmap=None),)
    _, ctx, nctx, _, _ = pipe.prepare_conditioning(
        {1: Sprite(spriteID=1, prompt="a shiny ball")}, (EnvPrompt("a ball"),), 1)
    disp, _, _, images, _, _ = frame_step(
        pipe, OverlapCorresponder(vertex_segments=SIZE * SIZE, update_corrmap=False), (), sigs,
        SIZE, SIZE, True, False, PostProcessParams(), (), True, draws, torch.from_numpy(proj),
        torch.from_numpy(bg), None, ctx, nctx, pipe.scheduler_sigmas(),
        torch.Generator().manual_seed(3), *pipe.compute_params(), step_noise=step_noise)
    assert images.shape == (1, SIZE, SIZE, 3)
    np.testing.assert_allclose(images.numpy(), np.asarray(jimages), **TOL)
    assert int((disp.int() - torch.from_numpy(np.array(jdisp)).int()).abs().max()) <= 1


def test_taesd_stream_matches_jax():
    """Three stream frames (lag-1 K/V, the ids riding for vertex averaging)
    with TAESD in both programs, the LCM draws handed over: images and
    latent state at the f32 bar."""
    from test_torch_stream import _jax_stream_draws

    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap

    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    jpipe, pipe = _pipelines(stream=True)
    kw = dict(vertex_segments=64, update_corrmap=False)
    jcorr, corr = JOverlap(**kw), OverlapCorresponder(**kw)
    _, jctx, jnctx, _, _ = jpipe.prepare_conditioning({}, (), 1)
    _, ctx, nctx, _, _ = pipe.prepare_conditioning({}, (), 1)
    ju, jv, _ = jpipe.compute_params()
    jstate = jkv = state = kv = None
    for f in range(3):
        rng = np.random.default_rng(100 + f)
        ids = np.zeros((1, SIZE, SIZE, 4), np.int32)
        ids[..., :2] = 1
        ids[..., 2] = rng.integers(0, 9, (1, SIZE, SIZE))
        ids[..., 3] = rng.integers(0, 40, (1, SIZE, SIZE))
        ids[:, :8 + f] = 0
        color = rng.random((1, SIZE, SIZE, 3)).astype(np.float32)
        noise = rng.standard_normal((1, LAT, LAT, 4)).astype(np.float32)
        key = np.array([0, 7 + f], np.uint32)
        jimg, jstate, jkv = jpipe._jit_render_stream(
            ju, jv, jnp.asarray(color), jnp.asarray(noise), jnp.asarray(ids), jstate,
            jpipe.scheduler_sigmas(), jnp.asarray(key), jctx, jnctx, stream_init=f == 0,
            kv_state=jkv, corresponder=jcorr)
        img, state, kv = pipe._render_stream(
            *pipe.compute_params()[:2], torch.from_numpy(color), torch.from_numpy(noise),
            torch.from_numpy(ids), state, pipe.scheduler_sigmas(), None, ctx, nctx,
            stream_init=f == 0, kv_state=kv, corresponder=corr,
            step_noise=_jax_stream_draws(key, (4, LAT, LAT, 4)))
        assert img.shape == (1, SIZE, SIZE, 3) and state["x"].shape == (4, LAT, LAT, 4)
        np.testing.assert_allclose(img.numpy(), np.asarray(jimg), err_msg=f"frame {f}", **TOL)
        np.testing.assert_allclose(state["x"].numpy(), np.asarray(jstate["x"]),
                                   err_msg=f"frame {f}", **TOL)


def test_realtime_taesd_without_with_taesd_runs_the_vae():
    """``realtime_taesd`` asks for TAESD, but until ``with_taesd`` attaches
    one both programs run the full VAE, as the JAX package's do: the frame
    equals the VAE frame exactly. With TAESD attached it moves."""
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.ops.correspondence import default_corresponder
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(prompt="a ball", steps=2, cfg_scale=2.0, sampler="euler", scheduler="sgm_uniform")
    vae_pipe = DiffusionPipeline.from_random(RenderConfig(**kw), tiny=True, device="cpu")
    asks = DiffusionPipeline.from_random(RenderConfig(realtime_taesd=True, **kw), tiny=True,
                                         device="cpu")
    rng = np.random.default_rng(2)
    color = torch.from_numpy(rng.random((1, SIZE, SIZE, 3)).astype(np.float32))

    def frame(p, noise):
        _, ctx, nctx, _, _ = p.prepare_conditioning({}, (), 1)
        return p._render(default_corresponder(), (), *p.compute_params(), color, noise, None,
                         (), ctx, nctx, p.scheduler_sigmas(), None)

    assert asks.taesd is None
    vae_noise = torch.from_numpy(rng.standard_normal((1, 32, 32, 4)).astype(np.float32))
    np.testing.assert_array_equal(frame(asks, vae_noise).numpy(), frame(vae_pipe, vae_noise).numpy())
    asks.with_taesd()
    taesd_noise = torch.from_numpy(rng.standard_normal((1, LAT, LAT, 4)).astype(np.float32))
    out = frame(asks, taesd_noise)
    assert out.shape == (1, SIZE, SIZE, 3) and torch.isfinite(out).all()
    assert asks.taesd_params["encoder"]["0"]["weight"].dtype == torch.float32
    # quantize_convs leaves the TAESD tree alone, as in the JAX package
    before = asks.taesd_params["decoder"]["3"]["conv"]["0"]["weight"].clone()
    asks.quantize_convs(render_size=(SIZE, SIZE))
    assert "weight_q" not in asks.taesd_params["decoder"]["3"]["conv"]["0"]
    assert torch.equal(asks.taesd_params["decoder"]["3"]["conv"]["0"]["weight"], before)


def test_with_taesd_paths_wait_for_checkpoints(tmp_path):
    """With paths, ``with_taesd`` loads the official files (here written from
    an init seeded with 5: an encoder .safetensors, a decoder .pth) onto the
    pipeline's device; without, it draws random weights from ``seed``."""
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.models.taesd import TAESD
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    pipe = DiffusionPipeline.from_random(tiny=True, device="cpu")
    assert pipe.taesd is None
    files = TAESD().init(torch.Generator().manual_seed(5))
    write_safetensors(flatten(files["encoder"]), tmp_path / "taesd_encoder.safetensors")
    torch.save(flatten(files["decoder"]), tmp_path / "taesd_decoder.pth")
    pipe.with_taesd(encoder_path=str(tmp_path / "taesd_encoder.safetensors"),
                    decoder_path=str(tmp_path / "taesd_decoder.pth"))
    for part in ("encoder", "decoder"):
        got, want = flatten(pipe.taesd_params[part]), flatten(files[part])
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want), part
    pipe.with_taesd(seed=4)
    same = TAESD().init(torch.Generator().manual_seed(4))
    assert torch.equal(pipe.taesd_params["encoder"]["14"]["weight"], same["encoder"]["14"]["weight"])
