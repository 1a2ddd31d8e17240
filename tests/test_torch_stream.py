"""The port's stream program (``DiffusionPipeline._render_stream``) against
the JAX package's ``_jit_render_stream``, on the CPU at tiny widths
(tests/test_torch_stream_engine.py runs it through ``Engine.Run`` and in
int8).

Randomness is handed across: the LCM re-noise draws the JAX program makes
(``jax.random.split(key, 3)[2]``) go to the port as ``step_noise``, and the
engine test gives the port the JAX engine's background noise. ControlNets are
perturbed (tests/test_torch_controlnet.py), so their hints change the frames.
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

TOL = dict(atol=2e-4, rtol=2e-4)  # f32: summation order only
KV_LAYERS = (2,)  # the tiny UNet's middle transformer, as 6 is SD1.5's
SIZE = 32
FRAMES = 3


def _jax_stream_draws(key, shape) -> torch.Tensor:
    """The stream program's LCM re-noise draw for frame key ``key``."""
    skey = jax.random.split(jnp.asarray(key), 3)[2]
    return torch.from_numpy(np.array(jax.random.normal(skey, shape)))


@functools.lru_cache(maxsize=None)
def _pipelines(sampler: str, controlnet: bool, int8: bool = False):
    """A tiny JAX pipeline in bench.py's default stream mode and the port's
    over the same params; with ``controlnet``, one perturbed ControlNet on
    the normal map (strength 0.6) in both. ``int8`` quantizes the JAX
    pipeline's convs calibrated at 256x256 (``quantize_convs``), which takes
    the UNet's level-0 convs and the VAE's to int8 in a third of the time
    512x512 takes; the port runs the same quantized trees."""
    from test_torch_controlnet import _jnp_tree, perturbed_controlnet
    from test_torch_frame import _port_pipeline

    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.workflow.config import ControlNetSpec as JSpec, RenderConfig as JConfig

    from stable_renderer_tpu_torch.workflow.config import ControlNetSpec, RenderConfig

    kw = dict(prompt="a ball", steps=4, cfg_scale=2.0, sampler=sampler, scheduler="sgm_uniform",
              stream_pipeline=True, stream_kv_layers=KV_LAYERS)
    jpipe = JPipe.from_random(JConfig(**kw), tiny=True, seed=0)
    if int8:
        jpipe.quantize_convs(render_size=(256, 256))
    pipe = _port_pipeline(jpipe, RenderConfig(**kw, int8_conv=int8))
    if controlnet:
        p = perturbed_controlnet(5)
        jpipe.add_controlnet(_jnp_tree(p), JSpec(source="normal", strength=0.6))
        pipe.add_controlnet(params_from_numpy(p, "cpu"), ControlNetSpec(source="normal",
                                                                         strength=0.6))
    return jpipe, pipe


def _frame_inputs(f: int) -> dict:
    """Frame ``f``'s color, pooled noise, id map and normal map."""
    rng = np.random.default_rng(100 + f)
    ids = np.zeros((1, SIZE, SIZE, 4), np.int32)
    ids[..., :2] = 1
    ids[..., 2] = rng.integers(0, 9, (1, SIZE, SIZE))
    ids[..., 3] = rng.integers(0, 40, (1, SIZE, SIZE))  # few vertices: many pixels share one
    ids[:, : 4 + f] = 0  # background rows, a different count each frame
    return dict(color=rng.random((1, SIZE, SIZE, 3)).astype(np.float32),
                noise=rng.standard_normal((1, SIZE // 8, SIZE // 8, 4)).astype(np.float32),
                id=ids, normal=rng.random((1, SIZE, SIZE, 3)).astype(np.float32))


def _corresponders(carry_ids: bool):
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap

    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    if not carry_ids:
        return None, None
    kw = dict(vertex_segments=64, update_corrmap=False)
    return JOverlap(**kw), OverlapCorresponder(**kw)


def _run_streams(jpipe, pipe, carry_ids: bool, frames: int = FRAMES):
    """``frames`` stream frames through both programs, each fed its own
    state and captured contexts; yields (frame, port outputs, JAX outputs)."""
    jcorr, corr = _corresponders(carry_ids)
    _, jctx, jnctx, _, _ = jpipe.prepare_conditioning({}, (), 1)
    _, ctx, nctx, _, _ = pipe.prepare_conditioning({}, (), 1)
    ju, jv, jc = jpipe.compute_params()
    s = pipe.config.steps
    jstate = jkv = state = kv = None
    for f in range(frames):
        inp = _frame_inputs(f)
        key = np.array([0, 7 + f], np.uint32)
        jhints = tuple(jnp.asarray(inp["normal"]) for _ in jpipe.controlnets) or None
        jimg, jstate, jkv = jpipe._jit_render_stream(
            ju, jv, jnp.asarray(inp["color"]), jnp.asarray(inp["noise"]), jnp.asarray(inp["id"]),
            jstate, jpipe.scheduler_sigmas(), jnp.asarray(key), jctx, jnctx, stream_init=f == 0,
            kv_state=jkv, cn_params=jc, hints=jhints, corresponder=jcorr)
        hints = tuple(torch.from_numpy(inp["normal"]) for _ in pipe.controlnets) or None
        img, state, kv = pipe._render_stream(
            *pipe.compute_params()[:2], torch.from_numpy(inp["color"]),
            torch.from_numpy(inp["noise"]), torch.from_numpy(inp["id"]), state,
            pipe.scheduler_sigmas(), None, ctx, nctx, stream_init=f == 0, kv_state=kv,
            cn_params=pipe.compute_params()[2], hints=hints, corresponder=corr,
            step_noise=_jax_stream_draws(key, (s, SIZE // 2, SIZE // 2, 4)))
        yield f, (img, state, kv), (jimg, jstate, jkv)


@pytest.mark.parametrize("sampler,riding", [("lcm", True), ("euler", False)],
                         ids=["lcm-hints-and-ids", "euler-plain-state"])
def test_render_stream_matches_jax(sampler, riding):
    """Three consecutive stream frames: decoded images and latent state at
    the f32 bar, the shifted hints and id maps exactly, and the lag-1 K/V
    contexts captured at the positive rows, (S, L, C)."""
    jpipe, pipe = _pipelines(sampler, riding)
    for f, (img, state, kv), (jimg, jstate, jkv) in _run_streams(jpipe, pipe, riding):
        assert img.shape == (1, SIZE, SIZE, 3)
        np.testing.assert_allclose(img.numpy(), np.asarray(jimg), err_msg=f"frame {f}", **TOL)
        assert isinstance(state, dict) == isinstance(jstate, dict) == riding
        x, jx = (state["x"], jstate["x"]) if riding else (state, jstate)
        assert x.shape == (4, SIZE // 2, SIZE // 2, 4)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), err_msg=f"frame {f}", **TOL)
        if riding:
            assert len(state["hints"]) == len(jstate["hints"]) == 1
            np.testing.assert_array_equal(state["hints"][0].numpy(),
                                          np.asarray(jstate["hints"][0]))
            np.testing.assert_array_equal(state["ids"].numpy(), np.asarray(jstate["ids"]))
            # row r holds frame f - r's conditioning (the first frame fills every row)
            for r in range(4):
                src = _frame_inputs(max(f - r, 0))
                np.testing.assert_array_equal(state["ids"][r].numpy(), src["id"][0])
        assert sorted(kv) == sorted(jkv) == [str(layer) for layer in KV_LAYERS]
        for layer in kv:
            assert kv[layer].shape == (4, 64, 64)  # 8x8 tokens at the middle block, C = 64
            np.testing.assert_allclose(kv[layer].numpy(), np.asarray(jkv[layer]),
                                       err_msg=f"frame {f} layer {layer}", **TOL)


def test_per_sample_sigma_denoiser_matches_jax():
    """``make_denoiser`` with one sigma a row (the stream's batch) against
    the JAX package's, cfg and LCM prediction."""
    from stable_renderer_tpu.models.sampling.cfg import make_denoiser as j_make

    from stable_renderer_tpu_torch.models.sampling.cfg import make_denoiser

    jpipe, pipe = _pipelines("lcm", False)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32) * 3.0
    sig = np.array([14.6, 3.1, 0.7], np.float32)
    ctx = rng.standard_normal((3, 77, 64)).astype(np.float32)
    nctx = rng.standard_normal((3, 77, 64)).astype(np.float32)
    ls = np.asarray(pipe.model_sampling.log_sigmas, np.float32)
    ref = jax.jit(lambda *a: j_make(jpipe.unet, jpipe.unet_params, a[2], a[3], jnp.asarray(ls),
                                    cfg_scale=2.0, prediction="lcm")(a[0], a[1]))(
        jnp.asarray(x), jnp.asarray(sig), jnp.asarray(ctx), jnp.asarray(nctx))
    den = make_denoiser(pipe.unet, pipe.unet_params, torch.from_numpy(ctx),
                        torch.from_numpy(nctx), torch.from_numpy(ls), cfg_scale=2.0,
                        prediction="lcm")
    np.testing.assert_allclose(den(torch.from_numpy(x), torch.from_numpy(sig)).numpy(),
                               np.asarray(ref), **TOL)


def test_stream_errors_and_unported_paths():
    """A kv_state for other layers than ``stream_kv_layers`` is a stale
    stream (ValueError); a TAESD weight file that is not there raises
    (no random weights in its place); the stream mesh raises by name."""
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    _, pipe = _pipelines("euler", False)
    inp = _frame_inputs(0)
    _, ctx, nctx, _, _ = pipe.prepare_conditioning({}, (), 1)
    with pytest.raises(ValueError, match="stale stream kv_state"):
        pipe._render_stream(*pipe.compute_params()[:2], torch.from_numpy(inp["color"]),
                            torch.from_numpy(inp["noise"]), torch.from_numpy(inp["id"]), None,
                            pipe.scheduler_sigmas(), None, ctx, nctx, stream_init=True,
                            kv_state={"5": torch.zeros(4, 64, 64)})
    taesd_pipe = DiffusionPipeline.from_random(RenderConfig(realtime_taesd=True), device="cpu")
    with pytest.raises(FileNotFoundError):
        taesd_pipe.with_taesd(encoder_path="no_such_dir/taesd_encoder.pth")
    assert taesd_pipe.taesd is None
    with pytest.raises(NotImplementedError, match="stream mesh"):
        pipe.enable_stream_mesh(None)
