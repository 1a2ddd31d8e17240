"""SVD's temporal UNet (models/video_unet.py), its config detection and the
EDM schedule against the JAX package's, on the CPU at the tiny config.

One numpy param tree feeds both packages: JAX's init of
TINY_VIDEO_UNET_CONFIG with every leaf perturbed by a seeded draw (so the
zero mix factors, zero biases and unit norms of the init do not hide a
term), handed to the port by ``convert.params_from_numpy``. The JAX side is
jitted, as its own tests run it. Tolerances: PURE (1e-6) for tensor work in
f32, TOL (2e-5) for one module, UNET_TOL (2e-4) for a UNet evaluation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_renderer_tpu.models import layers as jlayers
from stable_renderer_tpu.models import video_unet as jv
from stable_renderer_tpu.models.sampling import schedules as jsched
from stable_renderer_tpu.models.unet import AttnHooks as JHooks
from stable_renderer_tpu_torch.convert import params_from_numpy
from stable_renderer_tpu_torch.models import layers as players
from stable_renderer_tpu_torch.models import video_unet as pv
from stable_renderer_tpu_torch.models.sampling import schedules as psched
from stable_renderer_tpu_torch.models.unet import AttnHooks as PHooks

torch.set_num_threads(1)

PURE = dict(atol=1e-6, rtol=1e-6)      # tensor work in f32: rounding of the same ops
TOL = dict(atol=2e-5, rtol=2e-5)       # one module
UNET_TOL = dict(atol=2e-4, rtol=2e-4)  # a UNet evaluation
CFG = pv.TINY_VIDEO_UNET_CONFIG
RNG = np.random.default_rng(18)


def draw(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def port(tree):
    return params_from_numpy(tree, device="cpu")


def close(out, ref, tol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)


@pytest.fixture(scope="module")
def tree():
    """The port's init of the tiny video UNet (the JAX package's tree:
    ``test_port_init_has_jax_tree``), each leaf moved by 0.1 of a normal
    draw, as numpy f32."""
    from stable_renderer_tpu_torch.models.weights import flatten, nest

    rng = np.random.default_rng(19)
    flat = flatten(pv.VideoUNetModel(CFG).init(torch.Generator().manual_seed(0)))
    return nest({k: (v.numpy() + 0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
                 for k, v in flat.items()})


def test_conv3d_video_matches_jax():
    p = {"weight": draw(6, 4, 3, 3, 3, scale=0.2), "bias": draw(6)}
    x = draw(2, 3, 5, 6, 4)
    out = pv.conv3d_video(port(p), torch.from_numpy(x), 3)
    close(out, jv.conv3d_video(p, jnp.asarray(x), 3), TOL)


def test_temporal_res_block_and_its_5d_group_norm_match_jax(tree):
    """The time_stack ResBlock of the tiny UNet's first res block, on a
    (nb, T, H, W, C) input; the port's group_norm on the 5-D tensor takes
    each group's statistics over all T frames (and H, W) of a row, as JAX's."""
    p = tree["input_blocks"]["1"]["0"]["time_stack"]
    x, emb = draw(2, 3, 4, 5, 32), draw(2, 3, CFG.time_embed_dim)
    out = pv.temporal_res_block(port(p), torch.from_numpy(x), torch.from_numpy(emb), 3)
    close(out, jv.temporal_res_block(p, jnp.asarray(x), jnp.asarray(emb), 3), TOL)
    gn = p["in_layers"]["0"]
    x64 = draw(2, 3, 4, 5, 64)
    mine = players.group_norm(port(gn | {"weight": np.ones(64, np.float32),
                                         "bias": np.zeros(64, np.float32)}),
                              torch.from_numpy(x64))
    g = x64.reshape(2, 3 * 4 * 5, 32, 2).astype(np.float64)  # 32 groups of 2 channels
    want = (g - g.mean((1, 3), keepdims=True)) / np.sqrt(g.var((1, 3), keepdims=True) + 1e-6)
    np.testing.assert_allclose(mine.numpy(), want.reshape(x64.shape), atol=1e-5, rtol=1e-5)
    ones = {"weight": jnp.ones(64), "bias": jnp.zeros(64)}
    close(mine, jlayers.group_norm(ones, jnp.asarray(x64)), TOL)


def test_published_3x1x1_temporal_convs_do_not_fit_in_either_package(tree):
    """SVD_UNET_CONFIG's temporal convs are 3x3x3 (video_kernel_size 3), as
    the JAX package's: a time_stack ResBlock with the published SVD
    layout's (O, I, 3, 1, 1) weights (comfy model_detection's video kernel
    [3, 1, 1]) is padded by 1 on H and W as well, and its output no longer
    adds to the block's input, in both packages (ROADMAP queue 3)."""
    p = {k: dict(v) for k, v in tree["input_blocks"]["1"]["0"]["time_stack"].items()}
    for layer, i in (("in_layers", "2"), ("out_layers", "3")):
        p[layer] = {**p[layer], i: {"weight": draw(32, 32, 3, 1, 1, scale=0.1),
                                    "bias": draw(32)}}
    x, emb = draw(2, 3, 4, 5, 32), draw(2, 3, CFG.time_embed_dim)
    with pytest.raises(RuntimeError):
        pv.temporal_res_block(port(p), torch.from_numpy(x), torch.from_numpy(emb), 3)
    with pytest.raises((TypeError, ValueError)):
        jv.temporal_res_block(p, jnp.asarray(x), jnp.asarray(emb), 3)


def test_alpha_blend_matches_jax():
    p, a, b = {"mix_factor": draw(1)}, draw(2, 4, 8), draw(2, 4, 8)
    out = pv.alpha_blend(port(p), torch.from_numpy(a), torch.from_numpy(b))
    close(out, jv.alpha_blend(p, jnp.asarray(a), jnp.asarray(b)), PURE)


def test_spatial_video_transformer_matches_jax(tree):
    """The level-0 SpatialVideoTransformer (32 channels, 2 heads) over two
    groups of 3 frames: the frame-index embedding, each group's first-frame
    context, the transposes to (nb * S, T, C) and back."""
    p = tree["input_blocks"]["1"]["1"]
    x, ctx = draw(6, 4, 5, 32), draw(6, 1, CFG.context_dim)
    out, nxt = pv.spatial_video_transformer(port(p), torch.from_numpy(x), torch.from_numpy(ctx),
                                            2, 1, 3, PHooks(), 10000, 3)
    ref, jnxt = jv.spatial_video_transformer(p, jnp.asarray(x), jnp.asarray(ctx), 2, 1, 3,
                                             JHooks(), 10000, 3)
    assert nxt == jnxt == 4
    close(out, ref, TOL)


@pytest.mark.parametrize("groups", [1, 2], ids=["T", "cfg_2T"])
def test_video_unet_apply_matches_jax(tree, groups):
    """VideoUNetModel.apply on 3 frames (num_frames unset: the batch is one
    sequence) and on a CFG batch of 6 rows with num_frames 3 (two groups),
    with SVD's ADM vector; a post hook sees the same transformer indices in
    both. At 2T the uncond group equals a run of its 3 frames alone."""
    t_frames = 3
    b = groups * t_frames
    x, ctx = draw(b, 8, 8, 8), draw(b, 1, CFG.context_dim)
    ts = np.linspace(-1.0, 1.5, b).astype(np.float32)
    y = np.array(jv.svd_adm_vector(5.0, 127.0, 0.02, n=b))
    seen = {"jax": [], "port": []}

    def hook(who):
        def post(vals, layer):
            seen[who].append(layer)
            return vals
        return post

    nf = t_frames if groups > 1 else None
    junet = jv.VideoUNetModel(jv.TINY_VIDEO_UNET_CONFIG, num_frames=nf)
    ref = jax.jit(lambda p, *a: junet.apply(p, *a[:3], y=a[3], hooks=JHooks(post=hook("jax"))))(
        tree, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jnp.asarray(y))
    punet = pv.VideoUNetModel(CFG, num_frames=nf)
    pp = port(tree)
    out = punet.apply(pp, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                      y=torch.from_numpy(y), hooks=PHooks(post=hook("port")))
    assert tuple(out.shape) == (b, 8, 8, 4)
    close(out, ref, UNET_TOL)
    assert seen["port"] == seen["jax"] == list(range(7))
    if groups > 1:
        solo = punet.apply(pp, torch.from_numpy(x[t_frames:]), torch.from_numpy(ts[t_frames:]),
                           torch.from_numpy(ctx[t_frames:]), y=torch.from_numpy(y[t_frames:]))
        np.testing.assert_allclose(out[t_frames:].numpy(), solo.numpy(), **TOL)


def test_port_init_has_jax_tree():
    """The port's init draws the JAX package's tree: the same keys and
    shapes (JAX's by ``eval_shape``)."""
    from stable_renderer_tpu.models.weights import flatten as jflatten

    from stable_renderer_tpu_torch.models.weights import flatten

    mine = flatten(pv.VideoUNetModel(CFG).init(torch.Generator().manual_seed(0)))
    theirs = jflatten(jax.eval_shape(
        lambda: jv.VideoUNetModel(jv.TINY_VIDEO_UNET_CONFIG).init(jax.random.PRNGKey(0))))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in theirs.items()}


def test_svd_adm_vector_matches_jax():
    out = pv.svd_adm_vector(5.0, 127.0, 0.3, n=4)
    assert tuple(out.shape) == (4, 768)
    # TOL, not PURE: sin and cos of arguments up to 127 rad, whose f32
    # rounding (127 x 2^-24 = 7.6e-6) the two libraries' exp and sin round
    # apart; measured 2.8e-6 (the UNet's own timestep embedding does the same)
    close(out, jv.svd_adm_vector(5.0, 127.0, 0.3, n=4), TOL)


def test_detect_unet_config_on_svd_keys(tree):
    """An SVD key set detects as SVD_UNET_CONFIG with the file's input,
    model and ADM widths in both packages (the preset's other fields, as
    the JAX package takes them)."""
    from stable_renderer_tpu.models.weights import detect_unet_config as jdetect, flatten

    from stable_renderer_tpu_torch.models.weights import detect_unet_config

    flat = {f"model.diffusion_model.{k}": v for k, v in flatten(tree).items()}
    mine, theirs = detect_unet_config(flat), jdetect(flat)
    assert isinstance(mine, pv.VideoUNetConfig) and isinstance(theirs, jv.VideoUNetConfig)
    # field for field (JAX's config has one more, its dtype)
    assert dataclasses.asdict(mine) == {f.name: getattr(theirs, f.name)
                                        for f in dataclasses.fields(mine)}
    assert (mine.in_channels, mine.model_channels, mine.adm_in_channels) == (8, 32, 768)
    assert mine.channel_mult == pv.SVD_UNET_CONFIG.channel_mult


@pytest.mark.parametrize("bounds", [(0.002, 700.0), (0.002, 120.0)])
def test_edm_schedule_matches_jax_bit_for_bit(bounds):
    """ModelSamplingEDM's float64-built tables, its bounds, percent_to_sigma
    and a karras schedule over it: bit for bit."""
    lo, hi = bounds
    mine = psched.ModelSamplingEDM(prediction="v", edm_sigma_min=lo, edm_sigma_max=hi)
    theirs = jsched.ModelSamplingEDM(prediction="v", edm_sigma_min=lo, edm_sigma_max=hi)
    np.testing.assert_array_equal(mine.sigmas, theirs.sigmas)
    np.testing.assert_array_equal(mine.log_sigmas, theirs.log_sigmas)
    assert (mine.sigma_min, mine.sigma_max) == (theirs.sigma_min, theirs.sigma_max)
    assert mine.timestep_mode == theirs.timestep_mode == "edm"
    assert mine.sigma_data == theirs.sigma_data == 1.0
    for pct in (0.0, 0.1, 0.5, 0.93, 1.0):
        assert mine.percent_to_sigma(pct) == theirs.percent_to_sigma(pct)
    for sched in ("karras", "normal", "simple"):
        np.testing.assert_array_equal(psched.calculate_sigmas(mine, sched, 6),
                                      jsched.calculate_sigmas(theirs, sched, 6))
