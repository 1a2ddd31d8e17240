"""What the workflow's model patches reach, the port against the JAX package on
the CPU at the tiny size: the UNet's six model-patch hook points, the CFG
extras through ``build_denoiser`` (PerpNeg, SAG, RescaleCFG,
``denoise_mask_fn`` on the plain path and inside the inpaint keep, ``t_fn``,
``model_extra_cond``), the extras the scene and cond-list paths drop, SAG
under a corresponder's ``attn`` hook, ``ModelSampling.percent_to_sigma`` /
``set_sigmas``, ``rescale_zero_terminal_snr_sigmas`` and the tiled VAE.
Inputs are made by numpy from a seed; f32 throughout: TOL."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_conditioning import _cond_list, _id_maps, _models

from stable_renderer_tpu.models import layers as jlayers, unet as junet, vae as jvae
from stable_renderer_tpu.models.sampling import assemble as jassemble, conds as jconds
from stable_renderer_tpu.models.sampling import scene_cond as jscene, schedules as jsched
from stable_renderer_tpu.ops import correspondence as jcorr
from stable_renderer_tpu_torch.models import layers as tlayers, unet as tunet, vae as tvae
from stable_renderer_tpu_torch.models.sampling import assemble as tassemble, conds as tconds
from stable_renderer_tpu_torch.models.sampling import schedules as tsched
from stable_renderer_tpu_torch.ops import correspondence as tcorr

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)  # f32: summation order only
MS = jsched.ModelSampling(prediction="eps")
LOG_SIGMAS = MS.log_sigmas


def _t(a):
    return torch.from_numpy(np.array(a))


# --- the UNet's model-patch hook points ----------------------------------------------


def _patch_hooks(point: str, pkg):
    """One hook point's patch, written once over the package's ops (``pkg``
    is jnp-like for JAX, torch for the port)."""
    attention = jlayers.attention if pkg is jnp else tlayers.attention
    fns = {
        "pre_all": lambda q, k, v, layer: (q, k * 1.1, v * (0.9 - 0.01 * layer)),
        "pre_cross": lambda n, ck, cv, layer: (n * 1.05, ck, cv * 0.8),
        "attn_all": lambda q, k, v, heads, layer: attention(q, k * 0.5, v, heads),
        "out_block": lambda h, hsp, i: (h * 1.1, hsp * 0.9) if i % 2 == 0 else (h, hsp),
        "in_block": lambda h, i, t: h * (1.0 + 0.02 * i),
        "in_block_after": lambda h, i, t: h * (1.0 - 0.03 * i),
    }
    hooks = junet.AttnHooks if pkg is jnp else tunet.AttnHooks
    if point == "attn_wins":  # a corresponder's attn takes precedence over attn_all
        return hooks(attn=lambda q, k, v, heads, layer: attention(q, k, v * 2.0, heads),
                     attn_all=fns["attn_all"])
    return hooks(**{point: fns[point]})


@pytest.mark.parametrize("point", ["pre_all", "pre_cross", "attn_all", "out_block",
                                   "in_block", "in_block_after", "attn_wins"])
def test_unet_patch_points_match_jax(rng, point):
    jm, jp, tm, tp = _models()
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    t = np.asarray([500.0, 20.0], np.float32)
    ref = jm.apply(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                   hooks=_patch_hooks(point, jnp))
    out = tm.apply(tp, _t(x), _t(t), _t(ctx), hooks=_patch_hooks(point, torch))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    plain = tm.apply(tp, _t(x), _t(t), _t(ctx))
    assert float((out - plain).abs().max()) > 1e-3  # the patch acted


# --- the CFG extras through build_denoiser --------------------------------------------


class _ExtraInput:
    """A UNet taking one named extra input (``effnet``), added to its latent:
    stands in for a model with ``model_extra_cond`` inputs."""

    def __init__(self, model):
        self.model, self.config = model, model.config

    def block_plan(self):
        return self.model.block_plan()

    def apply(self, params, x, t, ctx, effnet=None, **kw):
        return self.model.apply(params, x + effnet.astype(x.dtype) if hasattr(effnet, "astype")
                                else x + effnet.to(x.dtype), t, ctx, **kw)


def _extras(case: str, rng, pkg):
    """build_denoiser keywords of one extra, for the package ``pkg``."""
    arr = jnp.asarray if pkg is jnp else _t
    if case == "perp_neg":
        return dict(nocond_context=arr(rng.standard_normal((1, 77, 64)).astype(np.float32)),
                    perp_neg_scale=0.7)
    if case == "sag":
        return dict(sag=(0.8, 2.0, 2))  # the tiny UNet's middle transformer is layer 2
    if case == "rescale_cfg":
        return dict(rescale_cfg_multiplier=0.6)
    if case == "t_fn":
        return dict(t_fn=(lambda s: 0.25 * jnp.log(jnp.maximum(s, 1e-10))) if pkg is jnp
                    else (lambda s: 0.25 * torch.log(torch.clamp(s, min=1e-10))))
    if case == "model_extra_cond":
        cond = rng.standard_normal((2, 8, 8, 4)).astype(np.float32) * 0.3
        unc = rng.standard_normal((2, 8, 8, 4)).astype(np.float32) * 0.3
        return dict(model_extra_cond={"effnet": arr(cond)},
                    model_extra_uncond={"effnet": arr(unc)})
    if case == "denoise_mask_fn":
        # threshold the soft inpaint mask by sigma, as DifferentialDiffusion does
        return dict(denoise_mask_fn=(lambda s, m: (m >= s / 20.0).astype(m.dtype)) if pkg is jnp
                    else (lambda s, m: (m >= s / 20.0).to(m.dtype)))
    return {}


SIGMA = np.float32(MS.sigmas[500])


def _port_denoise(tkw, x, wrap=False):
    _, _, tm, tp = _models()
    tm = _ExtraInput(tm) if wrap else tm
    return tassemble.build_denoiser(tm, tp, **tkw)(_t(x), torch.tensor(SIGMA))


def _denoise_both(rng, jkw, tkw, wrap=False):
    """Both packages' build_denoiser at one sigma on the same x: (port, JAX)."""
    jm, jp, _, _ = _models()
    jm = _ExtraInput(jm) if wrap else jm
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ref = jax.jit(jassemble.build_denoiser(jm, jp, **jkw))(jnp.asarray(x), jnp.asarray(SIGMA))
    return _port_denoise(tkw, x, wrap), np.asarray(ref)


def _plain_kw(rng, pkg, mask=False):
    arr = jnp.asarray if pkg is jnp else _t
    r = np.random.default_rng(11)
    kw = dict(cond_context=arr(r.standard_normal((2, 77, 64)).astype(np.float32)),
              uncond_context=arr(r.standard_normal((2, 77, 64)).astype(np.float32)),
              log_sigmas=arr(LOG_SIGMAS), cfg_scale=2.5)
    if mask:
        kw.update(inpaint_mask=arr(r.uniform(size=(2, 8, 8, 1)).astype(np.float32)),
                  inpaint_latent=arr(r.standard_normal((2, 8, 8, 4)).astype(np.float32)))
    return kw


@pytest.mark.parametrize("case", ["perp_neg", "sag", "rescale_cfg", "t_fn", "model_extra_cond",
                                  "denoise_mask_fn"])
def test_cfg_extras_match_jax(rng, case):
    mask = case == "denoise_mask_fn"
    seed = int(rng.integers(1 << 30))
    jkw = {**_plain_kw(rng, jnp, mask), **_extras(case, np.random.default_rng(seed), jnp)}
    tkw = {**_plain_kw(rng, torch, mask), **_extras(case, np.random.default_rng(seed), torch)}
    out, ref = _denoise_both(np.random.default_rng(1), jkw, tkw, wrap=case == "model_extra_cond")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    if case != "model_extra_cond":  # the extra moved the plain denoise
        x = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(np.float32)
        base = _port_denoise(_plain_kw(rng, torch, mask), x)
        assert float((out - base).abs().max()) > 1e-4


def test_denoise_mask_fn_inside_inpaint_keep_matches_jax(rng):
    """The scene path's keep-wrap takes the mask through denoise_mask_fn."""
    ctx = rng.standard_normal((3, 2, 77, 64)).astype(np.float32)
    masks = np.asarray(jscene.sprite_masks(jnp.asarray(_id_maps(rng)), (3, 5), 8, 8))
    keep = rng.uniform(size=(2, 8, 8, 1)).astype(np.float32)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    unc = rng.standard_normal((2, 77, 64)).astype(np.float32)
    common = dict(cfg_scale=2.0)
    jkw = dict(scene_contexts=jnp.asarray(ctx), scene_masks=jnp.asarray(masks),
               uncond_context=jnp.asarray(unc), log_sigmas=jnp.asarray(LOG_SIGMAS),
               inpaint_mask=jnp.asarray(keep), inpaint_latent=jnp.asarray(lat),
               **_extras("denoise_mask_fn", rng, jnp), **common)
    tkw = dict(scene_contexts=_t(ctx), scene_masks=_t(masks), uncond_context=_t(unc),
               log_sigmas=_t(LOG_SIGMAS), inpaint_mask=_t(keep), inpaint_latent=_t(lat),
               **_extras("denoise_mask_fn", rng, torch), **common)
    out, ref = _denoise_both(rng, jkw, tkw)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    thresholded = (_t(keep) >= float(SIGMA) / 20.0).float()
    kept = thresholded[..., 0] == 0
    assert torch.equal(out[kept], _t(lat)[kept])


@pytest.mark.parametrize("path", ["scene", "cond_list"])
def test_scene_and_cond_list_paths_drop_the_extras_like_jax(rng, path):
    """PerpNeg, SAG, RescaleCFG and t_fn ride the plain path only: the scene
    and cond-list denoisers give what they give without them."""
    unc = rng.standard_normal((2, 77, 64)).astype(np.float32)
    if path == "scene":
        ctx = rng.standard_normal((3, 2, 77, 64)).astype(np.float32)
        masks = np.asarray(jscene.sprite_masks(jnp.asarray(_id_maps(rng)), (3, 5), 8, 8))
        jbase = dict(scene_contexts=jnp.asarray(ctx), scene_masks=jnp.asarray(masks))
        tbase = dict(scene_contexts=_t(ctx), scene_masks=_t(masks))
    else:
        contexts, specs, cmasks = _cond_list(rng)
        jbase = dict(cond_contexts=[jnp.asarray(c) for c in contexts],
                     cond_specs=[jconds.CondSpec(**s) for s in specs],
                     cond_masks=[None if m is None else jnp.asarray(m) for m in cmasks])
        tbase = dict(cond_contexts=[_t(c) for c in contexts],
                     cond_specs=[tconds.CondSpec(**s) for s in specs],
                     cond_masks=[None if m is None else _t(m) for m in cmasks])
    for kw, pkg in ((jbase, jnp), (tbase, torch)):
        arr = jnp.asarray if pkg is jnp else _t
        kw.update(uncond_context=arr(unc), log_sigmas=arr(LOG_SIGMAS), cfg_scale=2.0)
    seed = int(rng.integers(1 << 30))
    extras = ("perp_neg", "sag", "rescale_cfg", "t_fn")
    jkw = dict(jbase)
    tkw = dict(tbase)
    for case in extras:
        jkw.update(_extras(case, np.random.default_rng(seed), jnp))
        tkw.update(_extras(case, np.random.default_rng(seed), torch))
    out, ref = _denoise_both(np.random.default_rng(3), jkw, tkw)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 4)).astype(np.float32)
    assert torch.equal(out, _port_denoise(tbase, x))


def test_sag_under_a_corresponder_is_skipped_like_jax(rng):
    """A corresponder's attn hook takes precedence over SAG's recording
    attn_all, so SAG records nothing and is not applied, in both packages."""
    jh = jcorr.OverlapCorresponder(update_corrmap=False, all_frames=True,
                                   layer_range=None).attn_hooks(None)
    th = tcorr.OverlapCorresponder(update_corrmap=False, all_frames=True,
                                   layer_range=None).attn_hooks(None)
    jkw = {**_plain_kw(rng, jnp), "hooks": jh, **_extras("sag", rng, jnp)}
    tkw = {**_plain_kw(rng, torch), "hooks": th}
    x = np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(np.float32)
    without = _port_denoise(tkw, x)
    tkw.update(_extras("sag", rng, torch))
    out, ref = _denoise_both(np.random.default_rng(5), jkw, tkw)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert torch.equal(out, without)


# --- schedules ----------------------------------------------------------------------


def test_percent_to_sigma_and_set_sigmas_match_jax():
    jms, tms = jsched.ModelSampling(), tsched.ModelSampling()
    for p in (-0.5, 0.0, 1e-4, 0.1, 0.37, 0.5, 0.999, 1.0, 2.0):
        assert tms.percent_to_sigma(p) == jms.percent_to_sigma(p)
    assert tms.percent_to_sigma(0.0) == 999999999.9
    z_ref = jsched.rescale_zero_terminal_snr_sigmas(jms.sigmas)
    z = tsched.rescale_zero_terminal_snr_sigmas(tms.sigmas)
    assert z.dtype == np.float32
    np.testing.assert_array_equal(z, z_ref)
    jms.set_sigmas(z_ref[::2])
    tms.set_sigmas(z[::2])
    assert tms.num_timesteps == jms.num_timesteps == 500
    np.testing.assert_array_equal(tms.log_sigmas, jms.log_sigmas)
    for p in (0.2, 0.8):
        assert tms.percent_to_sigma(p) == jms.percent_to_sigma(p)
    s = np.asarray([0.5, 3.0, 9.0], np.float32)
    np.testing.assert_array_equal(tms.timestep(s), jms.timestep(s))


# --- the tiled VAE ----------------------------------------------------------------------


def _vaes():
    tm = tvae.VAE(tvae.TINY_VAE_CONFIG)
    tp = tm.init(torch.Generator().manual_seed(2))
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    return jvae.VAE(jvae.TINY_VAE_CONFIG), jp, tm, tp


@pytest.mark.parametrize("case", [("decode", (1, 16, 16, 4), 16, 4),   # one tile
                                  ("decode", (2, 24, 20, 4), 8, 2),    # 4 x 4 tiles
                                  ("encode", (1, 32, 32, 3), 32, 8),   # one tile
                                  ("encode", (1, 48, 40, 3), 16, 4)])  # 4 x 3 tiles
def test_tiled_vae_matches_jax(rng, case):
    kind, shape, tile, overlap = case
    jm, jp, tm, tp = _vaes()
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "decode":
        ref = jm.decode_tiled(jp, jnp.asarray(x), tile=tile, overlap=overlap)
        out = tm.decode_tiled(tp, _t(x), tile=tile, overlap=overlap)
        whole = tm.decode(tp, _t(x))
    else:
        x = np.tanh(x)
        ref = jm.encode_tiled(jp, jnp.asarray(x), tile=tile, overlap=overlap)
        out = tm.encode_tiled(tp, _t(x), tile=tile, overlap=overlap)
        whole = tm.encode(tp, _t(x))
    assert out.dtype == torch.float32 and out.shape == whole.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if tile >= max(shape[1:3]):  # one tile: the whole decode / encode
        np.testing.assert_allclose(out.numpy(), whole.numpy(), atol=1e-5, rtol=1e-5)
