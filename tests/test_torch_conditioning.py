"""Conditioning beyond the plain prompt, the port against the JAX package on
the CPU at the tiny size: per-sprite scene conditioning (``sprite_masks``,
``make_scene_denoiser``, the pipeline's scene branch and a scene frame through
both engines), comfy cond lists (``make_cond_denoiser``), ``build_denoiser``'s
dispatch, the UNet's ``y`` (a class table and an ADM MLP) and a 9-channel
inpaint UNet. Inputs are made by numpy from a seed; the sampler's draws are
JAX's, handed to the port."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_renderer_tpu.models import unet as junet
from stable_renderer_tpu.models.sampling import assemble as jassemble
from stable_renderer_tpu.models.sampling import cfg as jcfg
from stable_renderer_tpu.models.sampling import conds as jconds
from stable_renderer_tpu.models.sampling import scene_cond as jscene
from stable_renderer_tpu.models.sampling import schedules as jsched
from stable_renderer_tpu.ops import correspondence as jcorr
from stable_renderer_tpu_torch.models import unet as tunet
from stable_renderer_tpu_torch.models.sampling import assemble as tassemble
from stable_renderer_tpu_torch.models.sampling import cfg as tcfg
from stable_renderer_tpu_torch.models.sampling import conds as tconds
from stable_renderer_tpu_torch.models.sampling import scene_cond as tscene
from stable_renderer_tpu_torch.ops import correspondence as tcorr

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)  # f32: summation order only
MS = jsched.ModelSampling(prediction="eps")
LOG_SIGMAS = MS.log_sigmas


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(**kw):
    """The tiny UNet in both packages (``kw`` onto its config), with the
    port's init (generator seeded with 4) as the one param tree."""
    jc = junet.UNetConfig(**{**junet.TINY_UNET_CONFIG.__dict__, **kw})
    tc = tunet.UNetConfig(model_channels=jc.model_channels, num_res_blocks=jc.num_res_blocks,
                          channel_mult=jc.channel_mult, attention_levels=jc.attention_levels,
                          num_heads=jc.num_heads, context_dim=jc.context_dim, **kw)
    tm = tunet.UNetModel(tc)
    tp = tm.init(torch.Generator().manual_seed(4))
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    return junet.UNetModel(jc), jp, tm, tp


def _id_maps(rng, b=2, h=16, w=16):
    """(B, H, W, 4) id maps: sprites 3 and 5 in two bands, a background band
    (sprite 0) and a stray sprite 9 that has no prompt."""
    ids = np.zeros((b, h, w, 4), np.int32)
    ids[..., 0] = rng.choice([0, 3, 5, 9], (b, h, w), p=[0.2, 0.35, 0.35, 0.1])
    ids[..., 1:] = rng.integers(1, 40, (b, h, w, 3))
    return ids


def test_sprite_masks_match_jax(rng):
    ids = _id_maps(rng)
    for lat in ((8, 8), (5, 7)):
        ref = jscene.sprite_masks(jnp.asarray(ids), (3, 5), *lat)
        out = tscene.sprite_masks(_t(ids), (3, 5), *lat)
        assert out.shape == (3, 2) + lat and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert float(out[-1].sum()) > 0 and float(out[0].sum()) > 0


def _hooks(kind):
    if kind == "overlap":
        return (jcorr.OverlapCorresponder(update_corrmap=False, layer_range=None).attn_hooks(None),
                tcorr.OverlapCorresponder(update_corrmap=False, layer_range=None).attn_hooks(None))
    return junet.AttnHooks(), tunet.AttnHooks()


@pytest.mark.parametrize("case", ["cfg", "no_cfg", "cfg_overlap_hooks"])
def test_scene_denoiser_matches_jax(rng, case):
    """Two sprites and the environment over two frames: the [cond_0 x B,
    cond_1 x B, env x B, uncond x B] batch, blended by normalized masks;
    the overlap corresponder's K/V injection per conditioning group."""
    jm, jp, tm, tp = _models()
    ctx = rng.standard_normal((3, 2, 77, 64)).astype(np.float32)
    unc = rng.standard_normal((2, 77, 64)).astype(np.float32)
    masks = np.asarray(jscene.sprite_masks(jnp.asarray(_id_maps(rng)), (3, 5), 8, 8))
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jh, th = _hooks("overlap" if case == "cfg_overlap_hooks" else "none")
    use_unc = case != "no_cfg"
    jden = jscene.make_scene_denoiser(jm, jp, jnp.asarray(ctx), jnp.asarray(masks),
                                      jnp.asarray(unc) if use_unc else None,
                                      jnp.asarray(LOG_SIGMAS), cfg_scale=3.0, hooks=jh)
    tden = tscene.make_scene_denoiser(tm, tp, _t(ctx), _t(masks), _t(unc) if use_unc else None,
                                      torch.from_numpy(LOG_SIGMAS), cfg_scale=3.0, hooks=th)
    sigma = np.float32(MS.sigmas[600])
    ref = jax.jit(jden)(jnp.asarray(x), jnp.asarray(sigma))
    out = tden(_t(x), torch.tensor(sigma))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _cond_list(rng):
    """A full-frame cond, a masked one (154 tokens: padded by repetition), an
    area cond with strength 0.7 and a cond active only for sigma in [1, 5]."""
    contexts = [rng.standard_normal((2, n, 64)).astype(np.float32) for n in (77, 154, 77, 77)]
    mask = (rng.random((2, 8, 8)) > 0.4).astype(np.float32)
    specs = [dict(), dict(has_mask=True, mask_strength=0.8), dict(area=(4, 6, 2, 1), strength=0.7),
             dict(sigma_start=5.0, sigma_end=1.0)]
    masks = [None, mask, None, None]
    return contexts, specs, masks


@pytest.mark.parametrize("sigma_index", [300, 999])
def test_cond_denoiser_matches_jax(rng, sigma_index):
    """comfy's cond-list semantics: at timestep 300 (sigma ~1.5) the ranged
    cond is active, at 999 (sigma ~14.6) it adds nothing; hooks per
    full-frame group."""
    jm, jp, tm, tp = _models()
    contexts, specs, masks = _cond_list(rng)
    unc = rng.standard_normal((2, 77, 64)).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jh, th = _hooks("overlap")
    jden = jconds.make_cond_denoiser(
        jm, jp, [jnp.asarray(c) for c in contexts], [jconds.CondSpec(**s) for s in specs],
        [None if m is None else jnp.asarray(m) for m in masks], jnp.asarray(unc),
        jnp.asarray(LOG_SIGMAS), cfg_scale=2.5, hooks=jh)
    tden = tconds.make_cond_denoiser(
        tm, tp, [_t(c) for c in contexts], [tconds.CondSpec(**s) for s in specs],
        [None if m is None else _t(m) for m in masks], _t(unc), torch.from_numpy(LOG_SIGMAS),
        cfg_scale=2.5, hooks=th)
    sigma = np.float32(MS.sigmas[sigma_index])
    ref = jax.jit(jden)(jnp.asarray(x), jnp.asarray(sigma))
    out = tden(_t(x), torch.tensor(sigma))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_feather_and_needs_cond_list_match_jax():
    for area, hw in (((4, 6, 2, 1), (8, 8)), ((12, 20, 0, 0), (12, 30)), ((3, 3, 1, 1), (5, 5))):
        np.testing.assert_array_equal(tconds._feather_mult(area, *hw),
                                      jconds._feather_mult(area, *hw))
    for specs, n in (([dict()], 1), ([dict()], 2), ([dict(strength=0.5)], 1),
                     ([dict(sigma_end=0.1)], 1), ([dict(has_mask=True)], 1)):
        assert tassemble.needs_cond_list([tconds.CondSpec(**s) for s in specs], n) == \
            jassemble.needs_cond_list([jconds.CondSpec(**s) for s in specs], n)


@pytest.mark.parametrize("case", ["scene_keep_mask", "cond_list", "one_plain_cond"])
def test_build_denoiser_dispatch_matches_jax(rng, case):
    """Scene contexts take the scene denoiser, wrapped by the inpaint keep
    mask; several cond entries the cond-list denoiser; one plain cond entry
    the fused CFG path."""
    jm, jp, tm, tp = _models()
    unc = rng.standard_normal((2, 77, 64)).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jkw = dict(uncond_context=jnp.asarray(unc), log_sigmas=jnp.asarray(LOG_SIGMAS), cfg_scale=2.0)
    tkw = dict(uncond_context=_t(unc), log_sigmas=torch.from_numpy(LOG_SIGMAS), cfg_scale=2.0)
    if case == "scene_keep_mask":
        ctx = rng.standard_normal((3, 2, 77, 64)).astype(np.float32)
        masks = np.asarray(jscene.sprite_masks(jnp.asarray(_id_maps(rng)), (3, 5), 8, 8))
        keep = (rng.random((2, 8, 8, 1)) > 0.5).astype(np.float32)
        lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        jkw.update(scene_contexts=jnp.asarray(ctx), scene_masks=jnp.asarray(masks),
                   inpaint_mask=jnp.asarray(keep), inpaint_latent=jnp.asarray(lat))
        tkw.update(scene_contexts=_t(ctx), scene_masks=_t(masks), inpaint_mask=_t(keep),
                   inpaint_latent=_t(lat))
    else:
        contexts, specs, masks = _cond_list(rng)
        if case == "one_plain_cond":
            contexts, specs, masks = contexts[:1], specs[:1], masks[:1]
        jkw.update(cond_contexts=[jnp.asarray(c) for c in contexts],
                   cond_specs=[jconds.CondSpec(**s) for s in specs],
                   cond_masks=[None if m is None else jnp.asarray(m) for m in masks])
        tkw.update(cond_contexts=[_t(c) for c in contexts],
                   cond_specs=[tconds.CondSpec(**s) for s in specs],
                   cond_masks=[None if m is None else _t(m) for m in masks])
    sigma = np.float32(MS.sigmas[500])
    ref = jax.jit(jassemble.build_denoiser(jm, jp, **jkw))(jnp.asarray(x), jnp.asarray(sigma))
    out = tassemble.build_denoiser(tm, tp, **tkw)(_t(x), torch.tensor(sigma))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if case == "scene_keep_mask":  # the kept pixels are the latent's, exactly
        kept = tkw["inpaint_mask"][..., 0] == 0
        assert torch.equal(out[kept], tkw["inpaint_latent"][kept])


@pytest.mark.parametrize("case", ["classes", "adm", "inpaint_9ch"])
def test_unet_y_and_inpaint_channels_match_jax(rng, case):
    """``y`` through ``label_emb``: a class table indexed by integer labels,
    the ADM MLP over a 16-wide vector; and a 9-channel inpaint UNet fed the
    [mask, masked latent] channels through the CFG denoiser."""
    kw = {"classes": dict(num_classes=10), "adm": dict(adm_in_channels=16),
          "inpaint_9ch": dict(in_channels=9)}[case]
    jm, jp, tm, tp = _models(**kw)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    t = np.asarray([700.0, 40.0], np.float32)
    if case == "inpaint_9ch":
        lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        mask = (rng.random((2, 8, 8, 1)) > 0.5).astype(np.float32)
        jcc = jassemble.inpaint_concat_channels(jnp.asarray(lat), jnp.asarray(mask))
        tcc = tassemble.inpaint_concat_channels(_t(lat), _t(mask))
        np.testing.assert_array_equal(tcc.numpy(), np.asarray(jcc))
        blank = tassemble.inpaint_concat_channels(_t(lat), None)
        np.testing.assert_array_equal(blank.numpy(), np.asarray(
            jassemble.inpaint_concat_channels(jnp.asarray(lat), None)))
        unc = rng.standard_normal((2, 77, 64)).astype(np.float32)
        jden = jcfg.make_denoiser(jm, jp, jnp.asarray(ctx), jnp.asarray(unc),
                                  jnp.asarray(LOG_SIGMAS), cfg_scale=2.0, concat_latent=jcc)
        tden = tcfg.make_denoiser(tm, tp, _t(ctx), _t(unc), torch.from_numpy(LOG_SIGMAS),
                                  cfg_scale=2.0, concat_latent=tcc)
        sigma = np.float32(MS.sigmas[400])
        ref = jax.jit(jden)(jnp.asarray(x), jnp.asarray(sigma))
        out = tden(_t(x), torch.tensor(sigma))
    else:
        y = (np.asarray([3, 7], np.int32) if case == "classes"
             else rng.standard_normal((2, 16)).astype(np.float32))
        ref = jax.jit(jm.apply)(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                y=jnp.asarray(y))
        out = tm.apply(tp, _t(x), _t(t), _t(ctx), y=_t(y))
        without = tm.apply(tp, _t(x), _t(t), _t(ctx))
        assert float((out - without).abs().max()) > 1e-3  # y moved the output
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# --- the pipeline and the engine ------------------------------------------------


def _pipelines(**kw):
    from test_torch_frame import _port_pipeline

    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(dict(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm",
                   scheduler="sgm_uniform"), **kw)
    jpipe = JPipe.from_random(JConfig(**kw), tiny=True, seed=0)
    return jpipe, _port_pipeline(jpipe, RenderConfig(**kw))


def test_prepare_conditioning_scene_branch_matches_jax():
    """Two prompted sprites and id maps: sprite ids in order, (S+1, n, L, D)
    contexts (each sprite's prompt, the environment prompt last) and one
    uncond a frame; one prompted sprite joins the prompts (S = 0)."""
    from stable_renderer_tpu.data.sprite import EnvPrompt as JEnv, Sprite as JSprite
    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite

    jpipe, pipe = _pipelines()
    for sprites in (((1, "a red ball"), (2, "a blue box")), ((1, "a red ball"), (2, ""))):
        jinf = {sid: JSprite(spriteID=sid, prompt=p) for sid, p in sprites}
        tinf = {sid: Sprite(spriteID=sid, prompt=p) for sid, p in sprites}
        jout = jpipe.prepare_conditioning(jinf, (JEnv("a garden"),), 2, image_size=(64, 64))
        tout = pipe.prepare_conditioning(tinf, (EnvPrompt("a garden"),), 2, image_size=(64, 64))
        assert tout[0] == jout[0] == (tuple(s for s, p in sprites if p) if sprites[1][1] else ())
        for a, b in zip(tout[1:3], jout[1:3]):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        assert tout[3] is tout[4] is None
    assert tout[1].dim() == 3 and pipe.prepare_conditioning(
        {1: Sprite(spriteID=1, prompt="a"), 2: Sprite(spriteID=2, prompt="b")}, (), 1)[1].dim() == 4


def _scene(E):
    """The bench scene (tests/test_torch_engine.py) with a second prompted
    sprite: a cube beside the ball, ids fixed."""
    from test_torch_engine import _bench_scene

    from stable_renderer_tpu.data.sprite import Sprite as JSprite
    from stable_renderer_tpu_torch.data.sprite import Sprite as PSprite
    import stable_renderer_tpu_torch.engine as P

    ball = _bench_scene(E)
    ball.transform.position = [-0.6, 0.0, 0.0]
    mat = E.Material("box")
    mat.materialID = 2
    box = E.GameObject("box")
    box.addComponent(E.SpriteInfo, sprite=(PSprite if E is P else JSprite)(
        spriteID=2, prompt="a wooden box"))
    box.addComponent(E.MeshRenderer, mesh=E.Mesh.Cube(0.9), materials=[mat])
    box.transform.position = [0.8, 0.0, 0.0]
    return box


def test_scene_engine_frame_matches_jax(monkeypatch):
    """One 64x64 frame of a scene with two prompted sprites through both
    packages' ``Engine.Run`` with the default ``scene_conditioning=True``
    (JAX's background noise and sampler draws handed to the port): the id
    maps exactly, the decoded frame at the f32 bar, and the frame differs
    from the same scene with the box unprompted."""
    import stable_renderer_tpu.engine as J
    import stable_renderer_tpu_torch.engine as P
    from test_torch_engine import SIZE, _jax_step_noise, _np, _run

    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap
    from stable_renderer_tpu_torch.engine import frame_program
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    jpipe, pipe = _pipelines()
    seen = {}
    orig_render = type(pipe)._render

    def spy(self, corresponder, sprite_ids, *a, **k):
        seen["sprite_ids"] = sprite_ids
        return orig_render(self, corresponder, sprite_ids, *a, **k)

    monkeypatch.setattr(type(pipe), "_render", spy)
    port_step = frame_program.frame_step

    def with_jax_draws(*args, **kwargs):
        kwargs["step_noise"] = _jax_step_noise(pipe.config.seed, (1, SIZE // 2, SIZE // 2, 4))
        return port_step(*args, **kwargs)

    monkeypatch.setattr(frame_program, "frame_step", with_jax_draws)

    def run(E, p, box_prompt, bg=None):
        E.Engine._reset()

        def scene(E_):
            _scene(E_).getComponent(E_.SpriteInfo).sprite.prompt = box_prompt

        corr = (OverlapCorresponder if E is P else JOverlap)(vertex_segments=SIZE * SIZE,
                                                            update_corrmap=False)
        before = None if bg is None else (
            lambda eng: setattr(eng.RenderManager, "_bg_noise", torch.from_numpy(bg.copy())))
        eng, rec = _run(E, frames=1, scene=scene, pipeline=p, corresponder=corr,
                        before_run=before)
        E.Engine._reset()
        return eng, rec

    jeng, jrec = run(J, jpipe, "a wooden box")
    bg = _np(jeng.RenderManager.GlobalBGNoise)
    _, rec = run(P, pipe, "a wooden box", bg)
    assert seen["sprite_ids"] == (1, 2)
    np.testing.assert_array_equal(rec["ids"][0], jrec["ids"][0])
    assert {1, 2} <= set(np.unique(rec["ids"][0][..., 0]).tolist())
    img = rec["images"][0]
    assert img.shape == (1, SIZE, SIZE, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, jrec["images"][0], **TOL)
    _, one = run(P, pipe, "", bg)
    assert seen["sprite_ids"] == ()
    assert float(np.abs(one["images"][0] - img).mean()) > 1e-3


def test_stream_with_two_prompted_sprites_raises_in_both():
    """The stream program takes one conditioning a frame. The JAX package's
    stream fails on a scene's (S+1, B, L, D) contexts (its cond and uncond
    batches do not concatenate); the port raises a ValueError that says so."""
    from stable_renderer_tpu.data.sprite import EnvPrompt as JEnv, Sprite as JSprite
    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite

    jpipe, pipe = _pipelines(stream_pipeline=True)
    sprites = ((1, "a red ball"), (2, "a blue box"))
    _, jctx, jnctx, _, _ = jpipe.prepare_conditioning(
        {s: JSprite(spriteID=s, prompt=p) for s, p in sprites}, (JEnv("a garden"),), 1)
    _, ctx, nctx, _, _ = pipe.prepare_conditioning(
        {s: Sprite(spriteID=s, prompt=p) for s, p in sprites}, (EnvPrompt("a garden"),), 1)
    color = np.random.default_rng(2).random((1, 64, 64, 3)).astype(np.float32)
    sig = pipe.scheduler_sigmas()
    up, vp, _ = jpipe.compute_params()
    with pytest.raises(TypeError):
        jpipe._jit_render_stream(up, vp, jnp.asarray(color), None, None, None,
                                 jnp.asarray(sig.numpy()), jax.random.PRNGKey(0), jctx, jnctx,
                                 stream_init=True)
    with pytest.raises(ValueError, match="scene contexts"):
        pipe._render_stream(pipe.unet_params, pipe.vae_params, _t(color), None, None, None, sig,
                            torch.Generator().manual_seed(0), ctx, nctx, stream_init=True)


@pytest.mark.parametrize("sampler", ["euler_ancestral", "dpmpp_2m"])
def test_stream_runs_other_samplers_as_euler_like_jax(sampler):
    """Every sampler but lcm takes an Euler step in the stream, as in the
    JAX package (pipeline.py:1093-1099): two stream frames with the JAX
    noise passed in, the second against JAX's at the f32 bar."""
    jpipe, pipe = _pipelines(stream_pipeline=True, sampler=sampler, steps=2)
    rng = np.random.default_rng(3)
    colors = rng.random((2, 1, 64, 64, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 1, 32, 32, 4)).astype(np.float32)
    ctx, nctx = pipe.encode_prompts(["a ball"], [""])
    jctx, jnctx = jpipe.encode_prompts(["a ball"], [""])
    sig = pipe.scheduler_sigmas()
    up, vp, _ = jpipe.compute_params()
    jstate = state = None
    for f in range(2):
        jimg, jstate, _ = jpipe._jit_render_stream(
            up, vp, jnp.asarray(colors[f]), jnp.asarray(noise[f]), None, jstate,
            jnp.asarray(sig.numpy()), jax.random.PRNGKey(f), jctx, jnctx, stream_init=f == 0)
        img, state, _ = pipe._render_stream(
            pipe.unet_params, pipe.vae_params, _t(colors[f]), _t(noise[f]), None, state, sig,
            torch.Generator().manual_seed(f), ctx, nctx, stream_init=f == 0)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)
