"""Stable Cascade (models/cascade.py) and its schedule against the JAX
package's, on the CPU at the tiny configs.

The stages' trees are the port's inits (the JAX package's trees:
``test_port_init_has_jax_tree``) with every leaf moved by a seeded draw, so
the zero GRN gamma and beta and the zero biases of the init do not hide a
term; one numpy tree feeds both packages. The JAX side runs op by op, as
its own tests call it: jitted whole, XLA's CPU program for a tiny stage
lands 3e-4 from the port and from JAX's own op-by-op result, which agree
within 3.5e-6 (measured).
Tolerances: PURE (1e-6) for tensor work in f32, TOL (2e-5) for one module,
UNET_TOL (2e-4) for a stage's evaluation.

Found and held here (ROADMAP queue 3): the JAX package's ``conv_transpose2x``
takes a ConvTranspose2d file's 2x2 taps flipped against torch's
``conv_transpose2d`` with the same weight; the port reproduces JAX's. A
stage's tree as its file's keys nest it lacks the repeat mappers' subtrees
where every repeat is 1, and JAX's walkers raise KeyError on it; the port
reads them as empty (``jax_tree`` adds them for JAX).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stable_renderer_tpu.models import cascade as jc
from stable_renderer_tpu.models.sampling import schedules as jsched
from stable_renderer_tpu_torch.convert import params_from_numpy
from stable_renderer_tpu_torch.models import cascade as pc
from stable_renderer_tpu_torch.models.sampling import schedules as psched

torch.set_num_threads(1)

PURE = dict(atol=1e-6, rtol=1e-6)      # tensor work in f32: rounding of the same ops
TOL = dict(atol=2e-5, rtol=2e-5)       # one module
UNET_TOL = dict(atol=2e-4, rtol=2e-4)  # a stage's evaluation
RNG = np.random.default_rng(27)


def draw(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def port(tree):
    return params_from_numpy(tree, device="cpu")


def close(out, ref, tol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)


def perturbed_tree(model, seed: int) -> dict:
    """``model``'s port init with each leaf moved by 0.1 of a normal draw,
    as numpy f32, re-nested as a file's keys nest (no empty subtree)."""
    from stable_renderer_tpu_torch.models.weights import flatten, nest

    rng = np.random.default_rng(seed)
    flat = flatten(model.init(torch.Generator().manual_seed(seed)))
    return nest({k: (v.numpy() + 0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
                 for k, v in flat.items()})


def jax_tree(tree: dict) -> dict:
    """A loaded stage tree as the JAX package's walkers can take it: the
    repeat mappers' subtrees, which a file's keys do not make where every
    repeat is 1, added empty; JAX arrays."""
    return jax.tree_util.tree_map(jnp.asarray, {"down_repeat_mappers": {},
                                                "up_repeat_mappers": {}, **tree})


# the tiny Stage B with repeats on both sides: the repeat mappers, and the
# level's skip joined again at every repeat of the up side
REPEATS = dict(block_repeat_down=(2, 1), block_repeat_up=(2, 3))


@pytest.fixture(scope="module")
def trees():
    from dataclasses import replace

    return {"c": perturbed_tree(pc.CascadeStageC(pc.TINY_CASCADE_C_CONFIG), 1),
            "b": perturbed_tree(pc.CascadeStageB(pc.TINY_CASCADE_B_CONFIG), 2),
            "b_repeats": perturbed_tree(pc.CascadeStageB(replace(pc.TINY_CASCADE_B_CONFIG,
                                                                 **REPEATS)), 3)}


# --- the primitives ------------------------------------------------------------------------

X = draw(2, 6, 10, 8)
LIN = {"weight": draw(12, 8, 1, 1, scale=0.3), "bias": draw(12)}
DEPTHWISE = {"weight": draw(8, 1, 3, 3, scale=0.3), "bias": draw(8)}
STRIDED = {"weight": draw(12, 8, 2, 2, scale=0.2), "bias": draw(12)}
GRN = {"gamma": draw(1, 1, 1, 8), "beta": draw(1, 1, 1, 8)}
CHANNELWISE = {"0": {"weight": draw(32, 8, scale=0.3), "bias": draw(32)},
               "2": {"gamma": draw(1, 1, 1, 32), "beta": draw(1, 1, 1, 32)},
               "4": {"weight": draw(8, 32, scale=0.2), "bias": draw(8)}}
CHANNELWISE_SKIP = {**CHANNELWISE, "0": {"weight": draw(32, 16, scale=0.3), "bias": draw(32)}}
TSB = {"mapper": {"weight": draw(16, 6, scale=0.3), "bias": draw(16)},
       "mapper_sca": {"weight": draw(16, 6, scale=0.3), "bias": draw(16)}}
ATTN = {"kv_mapper": {"1": {"weight": draw(8, 5, scale=0.3), "bias": draw(8)}},
        "attention": {"attn": {n: {"weight": draw(8, 8, scale=0.3), "bias": draw(8)}
                               for n in ("to_q", "to_k", "to_v", "out_proj")}}}
CLIP = draw(2, 3, 5)
R_EMBED = draw(2, 12)

# (name, port call, JAX call, tolerance): each takes the module's numpy draws
PRIMITIVES = [
    ("conv1x1", lambda m, t: m.conv1x1(t(LIN), t(X)), PURE),
    ("conv2d_generic_depthwise",
     lambda m, t: m.conv2d_generic(t(DEPTHWISE), t(X), padding=1, groups=8), TOL),
    ("conv2d_generic_strided", lambda m, t: m.conv2d_generic(t(STRIDED), t(X), stride=2), TOL),
    ("resize_bilinear_ac_up", lambda m, t: m.resize_bilinear_ac(t(X), 13, 7), PURE),
    ("resize_bilinear_ac_down", lambda m, t: m.resize_bilinear_ac(t(X), 3, 4), PURE),
    ("resize_bilinear_ac_to_one", lambda m, t: m.resize_bilinear_ac(t(X), 1, 5), PURE),
    ("pixel_unshuffle", lambda m, t: m.pixel_unshuffle(t(X), 2), PURE),
    ("pixel_shuffle", lambda m, t: m.pixel_shuffle(t(X), 2), PURE),
    ("ln2d", lambda m, t: m._ln2d(t(X)), PURE),
    ("global_response_norm", lambda m, t: m.global_response_norm(t(GRN), t(X)), PURE),
    ("channelwise", lambda m, t: m._channelwise(t(CHANNELWISE), t(X)), TOL),
    ("r_embedding", lambda m, t: m.r_embedding(t(np.asarray([0.0, 0.37, 1.0], np.float32)), 33),
     PURE),
    ("timestep_block", lambda m, t: m.cascade_timestep_block(t(TSB), t(X), t(R_EMBED), ("sca",)),
     PURE),
    ("res_block_with_skip", lambda m, t: m.cascade_res_block(
        {"depthwise": t(DEPTHWISE), "channelwise": t(CHANNELWISE_SKIP)}, t(X), t(X)), TOL),
    ("ffn_block", lambda m, t: m.cascade_ffn_block({"channelwise": t(CHANNELWISE)}, t(X)), TOL),
    ("attn_block_self", lambda m, t: m.cascade_attn_block(t(ATTN), t(X), t(CLIP), 2, True), TOL),
    ("attn_block_cross", lambda m, t: m.cascade_attn_block(t(ATTN), t(X), t(CLIP), 2, False),
     TOL),
]


@pytest.mark.parametrize("name, call, tol", PRIMITIVES, ids=[p[0] for p in PRIMITIVES])
def test_primitive_matches_jax(name, call, tol):
    out = call(pc, lambda a: port(a) if isinstance(a, dict) else torch.from_numpy(a))
    ref = call(jc, lambda a: jax.tree_util.tree_map(jnp.asarray, a))
    assert tuple(out.shape) == tuple(ref.shape)
    close(out, ref, tol)


def test_conv_transpose2x_reproduces_jax_tap_flip():
    """conv_transpose2x as the JAX package computes it: torch's
    conv_transpose2d with the file's (I, O, 2, 2) weight differs (ROADMAP
    queue 3: a loaded Stage B's upscalers run with flipped taps in JAX), and
    with the weight flipped on both spatial axes it agrees."""
    p = {"weight": draw(8, 5, 2, 2), "bias": draw(5)}
    ref = np.asarray(jc.conv_transpose2x(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(X)))
    out = pc.conv_transpose2x(port(p), torch.from_numpy(X))
    assert tuple(out.shape) == ref.shape == (2, 12, 20, 5)
    close(out, ref, PURE)
    w, b, xc = torch.from_numpy(p["weight"]), torch.from_numpy(p["bias"]), torch.from_numpy(
        X).permute(0, 3, 1, 2)
    torch_same = F.conv_transpose2d(xc, w, b, stride=2).permute(0, 2, 3, 1).numpy()
    torch_flipped = F.conv_transpose2d(xc, w.flip(2, 3), b, stride=2).permute(0, 2, 3, 1).numpy()
    assert np.abs(torch_same - ref).max() > 0.1
    np.testing.assert_allclose(torch_flipped, ref, **PURE)


def test_channelwise_gelu_is_the_tanh_form():
    """The channelwise MLP's GELU is jax.nn.gelu's default tanh form: the
    erf form misses JAX's by more than TOL on the same draws."""
    ref = np.asarray(jc._channelwise(jax.tree_util.tree_map(jnp.asarray, CHANNELWISE),
                                     jnp.asarray(X * 3)))
    p, x = port(CHANNELWISE), torch.from_numpy(X * 3)
    close(pc._channelwise(p, x), ref, TOL)
    h = F.gelu(F.linear(x, p["0"]["weight"], p["0"]["bias"]))  # the erf form
    erf = F.linear(pc.global_response_norm(p["2"], h), p["4"]["weight"], p["4"]["bias"])
    assert np.abs(erf.numpy() - ref).max() > 10 * TOL["atol"]


@pytest.mark.parametrize("extras", [True, False], ids=["pooled_and_image", "zeros"])
def test_stage_c_apply_matches_jax(trees, extras):
    """CascadeStageC.apply on a (2, 6, 6, 16) latent at two t's, with the
    pooled text and image embeds, and without (zeros in both)."""
    cfg = pc.TINY_CASCADE_C_CONFIG
    x, t = draw(2, 6, 6, 16), np.asarray([0.2, 0.85], np.float32)
    ctx = draw(2, 5, cfg.c_clip_text)
    y = draw(2, cfg.c_clip_text_pooled) if extras else None
    img = draw(2, 1, cfg.c_clip_img) if extras else None
    jm = jc.CascadeStageC(jc.TINY_CASCADE_C_CONFIG)
    ref = jm.apply(jax_tree(trees["c"]), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                   None if y is None else jnp.asarray(y),
                   clip_img=None if img is None else jnp.asarray(img))
    opt = (lambda a: None if a is None else torch.from_numpy(a))
    out = pc.CascadeStageC(cfg).apply(port(trees["c"]), torch.from_numpy(x), torch.from_numpy(t),
                                      torch.from_numpy(ctx), opt(y), clip_img=opt(img))
    assert tuple(out.shape) == (2, 6, 6, 16)
    close(out, ref, UNET_TOL)


@pytest.mark.parametrize("effnet, tree", [(True, "b"), (False, "b"), (True, "b_repeats")],
                         ids=["effnet", "no_effnet", "repeats"])
def test_stage_b_apply_matches_jax(trees, effnet, tree):
    """CascadeStageB.apply on a (2, 16, 16, 4) latent with the pooled CLIP
    context, and Stage C's latent as the effnet prior (resized to the
    level-0 grid) or none (zeros in both); and with repeats (REPEATS): the
    repeat mappers, and the up side's skip joined again at every repeat, as
    the JAX package's ``_up`` does (ROADMAP queue 3)."""
    from dataclasses import replace

    extra = REPEATS if tree == "b_repeats" else {}
    cfg = replace(pc.TINY_CASCADE_B_CONFIG, **extra)
    x, t = draw(2, 16, 16, 4), np.asarray([0.6, 0.1], np.float32)
    ctx, eff = draw(2, 1, cfg.c_clip), draw(2, 3, 3, 16) if effnet else None
    jm = jc.CascadeStageB(replace(jc.TINY_CASCADE_B_CONFIG, **extra))
    ref = jm.apply(jax_tree(trees[tree]), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                   effnet=None if eff is None else jnp.asarray(eff))
    out = pc.CascadeStageB(cfg).apply(port(trees[tree]), torch.from_numpy(x),
                                      torch.from_numpy(t), torch.from_numpy(ctx),
                                      effnet=None if eff is None else torch.from_numpy(eff))
    assert tuple(out.shape) == (2, 16, 16, 4)
    close(out, ref, UNET_TOL)


@pytest.mark.parametrize("stage", ["c", "b"])
def test_loaded_tree_without_repeat_mappers_runs_in_the_port(trees, stage):
    """A stage's tree as its file's keys nest it has no repeat mapper
    subtree where every repeat is 1 (the tiny stages', as Stage C's and
    Stage B's down side at full width): the JAX package's walkers raise
    KeyError on it (ROADMAP queue 3), the port reads the missing subtree as
    empty (the stage tests above hold its result on that tree to JAX's on
    the tree with the subtrees added)."""
    assert "down_repeat_mappers" not in trees[stage]
    cfg = pc.TINY_CASCADE_C_CONFIG if stage == "c" else pc.TINY_CASCADE_B_CONFIG
    x = draw(1, 4, 4, 16) if stage == "c" else draw(1, 8, 8, 4)
    t, ctx = np.asarray([0.5], np.float32), draw(1, 3, 48)
    jm = (jc.CascadeStageC if stage == "c" else jc.CascadeStageB)(
        jc.TINY_CASCADE_C_CONFIG if stage == "c" else jc.TINY_CASCADE_B_CONFIG)
    with pytest.raises(KeyError, match="repeat_mappers"):
        jm.apply(jax.tree_util.tree_map(jnp.asarray, trees[stage]), jnp.asarray(x),
                 jnp.asarray(t), jnp.asarray(ctx))
    pm = (pc.CascadeStageC if stage == "c" else pc.CascadeStageB)(cfg)
    out = pm.apply(port(trees[stage]), torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ctx))
    assert tuple(out.shape) == x.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("stage", ["c", "b"])
def test_port_init_has_jax_tree(stage):
    """The port's init draws the JAX package's tree: the same keys and
    shapes (JAX's by ``eval_shape``)."""
    from stable_renderer_tpu.models.weights import flatten as jflatten

    from stable_renderer_tpu_torch.models.weights import flatten

    name = f"TINY_CASCADE_{stage.upper()}_CONFIG"
    pcls, jcls = ((pc.CascadeStageC, jc.CascadeStageC) if stage == "c"
                  else (pc.CascadeStageB, jc.CascadeStageB))
    mine = flatten(pcls(getattr(pc, name)).init(torch.Generator().manual_seed(0)))
    theirs = jflatten(jax.eval_shape(lambda: jcls(getattr(jc, name)).init(jax.random.PRNGKey(0))))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in theirs.items()}


@pytest.mark.parametrize("shift", [1.0, 2.0])
def test_cascade_schedule_matches_jax_bit_for_bit(shift):
    """ModelSamplingCascade's 1000-entry float64-built tables, sigma_of_t,
    t_of_sigma, percent_to_sigma and schedules over it: bit for bit."""
    mine, theirs = psched.ModelSamplingCascade(shift=shift), jsched.ModelSamplingCascade(
        shift=shift)
    assert mine.num_timesteps == theirs.num_timesteps == 1000
    assert mine.timestep_mode == theirs.timestep_mode == "cascade"
    assert mine._init_alpha == theirs._init_alpha
    np.testing.assert_array_equal(mine.sigmas, theirs.sigmas)
    np.testing.assert_array_equal(mine.log_sigmas, theirs.log_sigmas)
    t = np.linspace(0.001, 1.0, 37)
    np.testing.assert_array_equal(mine.sigma_of_t(t), theirs.sigma_of_t(t))
    sig = np.concatenate([mine.sigmas[::97], [0.0, 1e3]])
    np.testing.assert_array_equal(mine.t_of_sigma(sig), theirs.t_of_sigma(sig))
    for pct in (0.0, 0.25, 0.6, 1.0):
        assert mine.percent_to_sigma(pct) == theirs.percent_to_sigma(pct)
    for sched in ("karras", "simple", "normal"):
        np.testing.assert_array_equal(psched.calculate_sigmas(mine, sched, 5),
                                      jsched.calculate_sigmas(theirs, sched, 5))


def test_chip_smoke_schedule_digests_are_the_jax_tables():
    """chip_smoke.SCHEDULE_DIGESTS, which phase 27d holds the port's tables
    to on the card's machine, are the digests of the JAX package's EDM and
    Cascade sigma tables, and the port's tables here have them."""
    import chip_smoke

    for sched in (jsched, psched):
        assert {k: chip_smoke.table_digest(v) for k, v in chip_smoke.schedule_tables(
            sched).items()} == chip_smoke.SCHEDULE_DIGESTS
