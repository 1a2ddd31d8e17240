"""The port's models (tokenizer, CLIP, VAE, UNet) against the JAX package's, at
the tiny configs, with the same parameters on both sides (f32, CPU). The JAX
models run under jit: one compile costs less than op-by-op dispatch."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_renderer_tpu.models import clip as jclip
from stable_renderer_tpu.models import unet as junet
from stable_renderer_tpu.models import vae as jvae
from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap
from stable_renderer_tpu_torch.models import clip as tclip
from stable_renderer_tpu_torch.models import unet as tunet
from stable_renderer_tpu_torch.models import vae as tvae
from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)

PROMPTS = [
    "a shiny ball, a ball",
    "(masterpiece:1.2), a ((red)) ball!! 3D render of a café, über-bright 123",
    "A  prompt\twith\nnewlines, 'quotes' and it's \\(escaped\\) parens",
    " ".join(["word"] * 70 + ["supercalifragilisticexpialidocious"] * 4),
    "",
]


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


def _init_both(model, seed):
    """Params from the port's own init, as (jax tree, torch tree): drawing
    them with torch keeps the test free of JAX's per-shape random compiles."""
    tp = model.init(torch.Generator().manual_seed(seed))
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp), tp


def _unet_cfg():
    c = junet.TINY_UNET_CONFIG
    return tunet.UNetConfig(model_channels=c.model_channels, num_res_blocks=c.num_res_blocks,
                            channel_mult=c.channel_mult, attention_levels=c.attention_levels,
                            num_heads=c.num_heads, context_dim=c.context_dim)


def test_tokenizer_ids_match_jax():
    """The port's own BPE gives the ids transformers' CLIPTokenizer gives,
    chunking and weights included."""
    jt, tt = jclip.Tokenizer(jclip.SD15_CLIP_CONFIG), tclip.Tokenizer(tclip.SD15_CLIP_CONFIG)
    for text in PROMPTS:
        ji, jw, _ = jt.tokenize_weighted(text)
        ti, tw, _ = tt.tokenize_weighted(text)
        np.testing.assert_array_equal(ti, ji, err_msg=text)
        np.testing.assert_allclose(tw, jw, err_msg=text)
    ji, jw, _ = jt.tokenize_weighted_batch(PROMPTS)
    ti, tw, _ = tt.tokenize_weighted_batch(PROMPTS)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw)


def test_tiny_tokenizer_matches_jax():
    jt, tt = jclip.Tokenizer(jclip.TINY_CLIP_CONFIG), tclip.Tokenizer(tclip.TINY_CLIP_CONFIG)
    np.testing.assert_array_equal(tt.tokenize_weighted_batch(PROMPTS[:2])[0],
                                  jt.tokenize_weighted_batch(PROMPTS[:2])[0])


@pytest.mark.parametrize("clip_skip", [-1, -2])
def test_clip_matches_jax(clip_skip):
    jm = jclip.CLIPTextModel(jclip.TINY_CLIP_CONFIG)
    tm = tclip.CLIPTextModel(tclip.TINY_CLIP_CONFIG)
    jp, tp = _init_both(tm, 0)
    ids, w, _ = tclip.Tokenizer(tclip.TINY_CLIP_CONFIG).tokenize_weighted_batch(PROMPTS[:2])
    w[0, 0, 2] = 1.3  # a weighted token
    jctx, jpool = jclip.encode_token_weights_batch(jm, jp, jnp.asarray(ids), jnp.asarray(w),
                                                   clip_skip=clip_skip)
    tctx, tpool = tclip.encode_token_weights_batch(tm, tp, torch.from_numpy(ids),
                                                   torch.from_numpy(w), clip_skip=clip_skip)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), **TOL)


def test_vae_encode_decode_match_jax(rng):
    jm = jvae.VAE(jvae.TINY_VAE_CONFIG)
    tm = tvae.VAE(tvae.TINY_VAE_CONFIG)
    jp, tp = _init_both(tm, 1)
    x = np.tanh(rng.standard_normal((1, 32, 32, 3))).astype(np.float32)
    np.testing.assert_allclose(tm.encode(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jax.jit(jm.encode)(jp, jnp.asarray(x))), **TOL)
    z = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    np.testing.assert_allclose(tm.decode(tp, torch.from_numpy(z)).numpy(),
                               np.asarray(jax.jit(jm.decode)(jp, jnp.asarray(z))), **TOL)


@pytest.mark.parametrize("hooks", ["plain", "overlap", "overlap_all_layers"])
def test_unet_matches_jax(rng, hooks):
    jm = junet.UNetModel(junet.TINY_UNET_CONFIG)
    tm = tunet.UNetModel(_unet_cfg())
    jp, tp = _init_both(tm, 2)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.asarray([999.0, 261.0], np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    jh, th = junet.AttnHooks(), tunet.AttnHooks()
    if hooks != "plain":
        layers = None if hooks == "overlap_all_layers" else (6,)
        jh = JOverlap(layer_range=layers, update_corrmap=False).attn_hooks(None)
        th = OverlapCorresponder(layer_range=layers, update_corrmap=False).attn_hooks(None)
    ref = jax.jit(jm.apply, static_argnames="hooks")(
        jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), hooks=jh)
    out = tm.apply(tp, torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ctx), hooks=th)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert tm.num_transformer_layers() == jm.num_transformer_layers()


@pytest.mark.parametrize("which", ["unet", "vae", "clip"])
def test_random_init_trees_match_jax(which):
    """The port's own random init has the JAX init's keys and shapes (the JAX
    tree's shapes come from eval_shape, without drawing it)."""
    models = {
        "unet": (junet.UNetModel(junet.TINY_UNET_CONFIG), tunet.UNetModel(_unet_cfg())),
        "vae": (jvae.VAE(jvae.TINY_VAE_CONFIG), tvae.VAE(tvae.TINY_VAE_CONFIG)),
        "clip": (jclip.CLIPTextModel(jclip.TINY_CLIP_CONFIG),
                 tclip.CLIPTextModel(tclip.TINY_CLIP_CONFIG)),
    }
    jm, tm = models[which]
    j = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    t = tm.init(torch.Generator().manual_seed(0))
    assert _shapes(t) == _shapes(j)
    assert all(v.dtype == torch.float32 for v in jax.tree_util.tree_leaves(t))


def test_sd15_block_plan_matches_jax():
    jp_in, jp_out, jchs = junet.UNetModel(junet.SD15_UNET_CONFIG).block_plan()
    tp_in, tp_out, tchs = tunet.UNetModel(tunet.SD15_UNET_CONFIG).block_plan()
    assert [e[:3] for e in jp_in] == [e[:3] for e in tp_in]
    assert [e[:4] for e in jp_out] == [e[:4] for e in tp_out]
    assert jchs == tchs
    assert tunet.UNetModel(tunet.SD15_UNET_CONFIG).num_transformer_layers() == 16
