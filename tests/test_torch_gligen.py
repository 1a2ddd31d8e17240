"""The port's models/gligen.py against the JAX package's, on the CPU at tiny
widths.

The same parameters (JAX's ``init_random_gligen`` handed across by
``convert.gligen_from_numpy``, or a state dict both packages load) and the
same numpy-seeded inputs go through both packages; f32 throughout: TOL. The
fuser's feed-forward GELU is the tanh form in both (``jax.nn.gelu``'s
default), which the exact-erf GELU misses by more than TOL.

Through the tiny UNet, as the JAX package applies the mid hook: the plain
CFG denoiser runs the fusers on the positive rows only; the scene denoiser
runs them per conditioning group; the cond-list denoiser drops the hook
(its group wrapper passes only the pre / post hooks on), so grounding there
changes nothing in either package.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_conditioning import LOG_SIGMAS, MS, _cond_list, _id_maps, _models, _t

import stable_renderer_tpu.models.gligen as jgl
import stable_renderer_tpu_torch.models.gligen as pgl
from stable_renderer_tpu.models import unet as junet
from stable_renderer_tpu.models.sampling import assemble as jassemble
from stable_renderer_tpu.models.sampling import conds as jconds
from stable_renderer_tpu.models.sampling import scene_cond as jscene
from stable_renderer_tpu_torch.convert import gligen_from_numpy
from stable_renderer_tpu_torch.models import unet as tunet
from stable_renderer_tpu_torch.models.sampling import assemble as tassemble
from stable_renderer_tpu_torch.models.sampling import conds as tconds

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)       # one module in f32: summation order only
UNET_TOL = dict(atol=2e-4, rtol=2e-4)  # a UNet evaluation, as test_torch_conditioning's
RNG = np.random.default_rng(31)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def gligen_pair(seed=1, **kw):
    """(JAX Gligen, the port's): JAX's random init handed across, the
    alphas 0.5."""
    jg = jgl.init_random_gligen(jax.random.PRNGKey(seed), **kw)
    pg = gligen_from_numpy([np_tree(f) for f in jg.fusers], jg.fuser_heads,
                           np_tree(jg.position_net), jg.key_dim, device="cpu")
    return jg, pg


def test_fourier_embed_matches_jax():
    x = RNG.uniform(size=(2, 5, 4)).astype(np.float32)
    want = np.asarray(jgl.fourier_embed(jnp.asarray(x)))
    got = pgl.fourier_embed(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 5, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_position_net_matches_jax():
    """Two boxes of five slots filled, the rest the learned null features
    (set non-zero here, so that the padding shows)."""
    jg, pg = gligen_pair(n_fusers=1)
    pn = jax.tree_util.tree_map(np.array, jg.position_net)
    pn["null_positive_feature"] = RNG.standard_normal(64).astype(np.float32)
    pn["null_position_feature"] = RNG.standard_normal(64).astype(np.float32)
    boxes = RNG.uniform(size=(2, 5, 4)).astype(np.float32)
    masks = np.zeros((2, 5), np.float32)
    masks[:, :2] = 1.0
    emb = RNG.standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(jgl.position_net_apply(jax.tree_util.tree_map(jnp.asarray, pn),
                                             jnp.asarray(boxes), jnp.asarray(masks),
                                             jnp.asarray(emb)))
    got = pgl.position_net_apply(jax.tree_util.tree_map(torch.from_numpy, pn),
                                 torch.from_numpy(boxes), torch.from_numpy(masks),
                                 torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_gated_self_attention_matches_jax_and_zero_alpha_is_identity():
    jg, pg = gligen_pair(n_fusers=1)
    x = RNG.standard_normal((2, 16, 64)).astype(np.float32)
    objs = RNG.standard_normal((2, pgl.MAX_OBJS, 64)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a, b: jgl.gated_self_attention(p, a, b, 2))(
        jg.fusers[0], jnp.asarray(x), jnp.asarray(objs)))
    got = pgl.gated_self_attention(pg.fusers[0], torch.from_numpy(x), torch.from_numpy(objs), 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not np.allclose(got.numpy(), x, atol=1e-4)
    zero = {**pg.fusers[0], "alpha_attn": torch.tensor(0.0), "alpha_dense": torch.tensor(0.0)}
    out0 = pgl.gated_self_attention(zero, torch.from_numpy(x), torch.from_numpy(objs), 2)
    assert torch.equal(out0, torch.from_numpy(x))


def test_geglu_is_the_tanh_form():
    """The fuser's feed-forward against JAX's within TOL, and the erf GELU
    outside it: the port keeps jax.nn.gelu's default."""
    jg, pg = gligen_pair(n_fusers=1)
    x = (RNG.standard_normal((1, 8, 64)) * 40).astype(np.float32)
    want = np.asarray(jgl._geglu_ff(jg.fusers[0]["ff"], jnp.asarray(x)))
    got = pgl._geglu_ff(pg.fusers[0]["ff"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ff = pg.fusers[0]["ff"]
    a, gate = F.linear(torch.from_numpy(x), ff["net"]["0"]["proj"]["weight"],
                       ff["net"]["0"]["proj"]["bias"]).chunk(2, -1)
    erf = F.linear(a * F.gelu(gate), ff["net"]["2"]["weight"], ff["net"]["2"]["bias"])
    assert float((erf - got).abs().max()) > 10 * TOL["atol"]


def _state_dict(specs):
    """A GLIGEN state dict: one fuser a (block key, query_dim, key_dim), and
    the position net (key_dim 768 -> 768)."""
    from stable_renderer_tpu_torch.models.weights import flatten

    g = torch.Generator().manual_seed(9)
    sd = {}
    for block, q, k in specs:
        f = pgl.init_random_gligen(g, n_fusers=1, query_dim=q, key_dim=k).fusers[0]
        sd.update({f"{block}.fuser.{n}": v for n, v in flatten(f).items()})
    pn = pgl.init_random_gligen(g, n_fusers=0, key_dim=768).position_net
    sd.update({f"position_net.{n}": v for n, v in flatten(pn).items()})
    return sd


def test_load_gligen_head_rule_and_order_match_jax():
    """Fusers in scan order (input, middle, output blocks); 8 heads at key
    width 768 (SD1.x), query_dim // 64 otherwise; every leaf as loaded."""
    from stable_renderer_tpu.models.weights import flatten as jflatten

    from stable_renderer_tpu_torch.models.weights import flatten

    specs = [("output_blocks.3.1", 128, 768), ("input_blocks.1.1", 64, 768),
             ("middle_block.1", 128, 768), ("input_blocks.10.1", 192, 96)]
    sd = _state_dict(specs)
    pg = pgl.load_gligen(sd, device="cpu")
    jg = jgl.load_gligen({k: v.numpy() for k, v in sd.items()})
    assert pg.fuser_heads == jg.fuser_heads == [8, 3, 8, 8]
    assert pg.key_dim == jg.key_dim == 768
    assert [f["linear"]["weight"].shape[0] for f in pg.fusers] == [64, 192, 128, 128]
    for mine, theirs in zip(pg.fusers + [pg.position_net], jg.fusers + [jg.position_net]):
        fm, ft = flatten(mine), jflatten(theirs)
        assert sorted(fm) == sorted(ft)
        for k, v in fm.items():
            assert v.numpy().tobytes() == np.asarray(ft[k]).tobytes(), k


def test_grounding_tokens_match_jax():
    jg, pg = gligen_pair(n_fusers=1)
    pooled = [RNG.standard_normal(64).astype(np.float32) for _ in range(2)]
    pos = [(pooled[0], 4, 3, 1, 2), (pooled[1], 2, 6, 5, 0)]
    want = np.asarray(jg.grounding_tokens(2, [(jnp.asarray(e), *r) for e, *r in pos], (8, 8)))
    got = pg.grounding_tokens(2, [(torch.from_numpy(e), *r) for e, *r in pos], (8, 8))
    assert tuple(got.shape) == want.shape == (2, pgl.MAX_OBJS, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    empty = np.asarray(jg.grounding_tokens(1, None, (8, 8)))
    np.testing.assert_allclose(pg.grounding_tokens(1, None, (8, 8)).numpy(), empty, **TOL)


def _hook_pair(jg, pg, batch):
    pooled = RNG.standard_normal(64).astype(np.float32)
    jo = jg.grounding_tokens(batch, [(jnp.asarray(pooled), 4, 4, 0, 0)], (8, 8))
    po = pg.grounding_tokens(batch, [(torch.from_numpy(pooled), 4, 4, 0, 0)], (8, 8))
    return (junet.AttnHooks(mid=jg.make_mid_hook(jo)), tunet.AttnHooks(mid=pg.make_mid_hook(po)))


@pytest.mark.parametrize("path", ["cfg", "scene", "cond_list"])
def test_mid_hook_through_the_denoisers_matches_jax(path):
    """16 fusers at the tiny UNet's level-0 width (32), so the level-1
    blocks (64 wide) skip by the width guard. On the plain CFG path the
    hook moves the positive rows; on the scene path each conditioning
    group; on the cond-list path nothing, in both packages."""
    rng = np.random.default_rng(5)
    jm, jp, tm, tp = _models()
    width = tm.config.model_channels
    jg, pg = gligen_pair(n_fusers=16, query_dim=width, key_dim=64, n_heads=2)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    unc = rng.standard_normal((2, 77, 64)).astype(np.float32)
    jkw = dict(uncond_context=jnp.asarray(unc), log_sigmas=jnp.asarray(LOG_SIGMAS), cfg_scale=2.0)
    tkw = dict(uncond_context=_t(unc), log_sigmas=torch.from_numpy(LOG_SIGMAS), cfg_scale=2.0)
    if path == "cfg":
        ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
        jkw.update(cond_context=jnp.asarray(ctx))
        tkw.update(cond_context=_t(ctx))
    elif path == "scene":
        ctx = rng.standard_normal((3, 2, 77, 64)).astype(np.float32)
        masks = np.asarray(jscene.sprite_masks(jnp.asarray(_id_maps(rng)), (3, 5), 8, 8))
        jkw.update(scene_contexts=jnp.asarray(ctx), scene_masks=jnp.asarray(masks))
        tkw.update(scene_contexts=_t(ctx), scene_masks=_t(masks))
    else:
        contexts, specs, masks = _cond_list(rng)
        jkw.update(cond_contexts=[jnp.asarray(c) for c in contexts],
                   cond_specs=[jconds.CondSpec(**s) for s in specs],
                   cond_masks=[None if m is None else jnp.asarray(m) for m in masks])
        tkw.update(cond_contexts=[_t(c) for c in contexts],
                   cond_specs=[tconds.CondSpec(**s) for s in specs],
                   cond_masks=[None if m is None else _t(m) for m in masks])
    jh, th = _hook_pair(jg, pg, 2)
    sigma = np.float32(MS.sigmas[500])
    ref = jax.jit(jassemble.build_denoiser(jm, jp, hooks=jh, **jkw))(jnp.asarray(x),
                                                                      jnp.asarray(sigma))
    out = tassemble.build_denoiser(tm, tp, hooks=th, **tkw)(_t(x), torch.tensor(sigma))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **UNET_TOL)
    plain = tassemble.build_denoiser(tm, tp, **tkw)(_t(x), torch.tensor(sigma))
    moved = float((out - plain).abs().max())
    if path == "cond_list":
        assert moved == 0.0  # the cond-list wrapper drops the mid hook
    else:
        assert moved > 1e-4


def test_bf16_activations_under_f32_gates_widen_like_jax():
    """A loaded file's f32 alphas under bf16 activations: JAX's array
    promotion widens the block's output to f32 (a loaded leaf is strongly
    typed), and the port promotes alike; bf16 alphas keep bf16."""
    sd = _state_dict([("input_blocks.1.1", 64, 768)])
    x = RNG.standard_normal((1, 8, 64)).astype(np.float32)
    for dt, jdt, want in ((torch.float32, np.float32, torch.float32),
                          (torch.bfloat16, jnp.bfloat16, torch.bfloat16)):
        pg = pgl.load_gligen({k: v.to(dt) for k, v in sd.items()}, device="cpu")
        jg = jgl.load_gligen({k: v.float().numpy().astype(jdt) for k, v in sd.items()})
        out = pgl.gated_self_attention(pg.fusers[0], torch.from_numpy(x).to(torch.bfloat16),
                                       torch.zeros(1, pgl.MAX_OBJS, 768, dtype=torch.bfloat16), 8)
        ref = jgl.gated_self_attention(jg.fusers[0], jnp.asarray(x, jnp.bfloat16),
                                       jnp.zeros((1, pgl.MAX_OBJS, 768), jnp.bfloat16), 8)
        assert out.dtype == want and str(ref.dtype) == str(want).replace("torch.", "")
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   atol=3e-2, rtol=3e-2)  # bf16 activations: 2^-8 steps
