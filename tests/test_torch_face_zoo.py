"""The zoo's face restorers (models/gfpgan.py, codeformer.py,
restoreformer.py) against the JAX package's, on the CPU at tiny widths.

GFPGAN: the modulated conv (one grouped conv in the port, a vmap in JAX),
the antialiased bilinear resamples, the SFT-half and full-SFT decoders, the
stored noises and JAX's own keyed draws handed in as ``noises``.
CodeFormer and RestoreFormer end in an argmax / argmin over the codebook,
which can flip between two f32 programs on a near tie: the tests compare
the logits (distances) within TOL, the indices exactly at every token whose
best code leads the next by more than ``MARGIN`` (over 90% of them), and
then the images, the port's decoder fed JAX's indices.

Trees as tests/test_torch_upscale.py makes them. Tolerances: PURE (1e-6),
TOL (2e-4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_upscale import PURE, TOL, both, image, model_tree, port_model

from stable_renderer_tpu.models import codeformer as jcf
from stable_renderer_tpu.models import gfpgan as jg
from stable_renderer_tpu.models import restoreformer as jrf
from stable_renderer_tpu.models.layers import conv2d as jconv2d
from stable_renderer_tpu.models.layers import layer_norm as jlayer_norm
from stable_renderer_tpu.models.layers import linear as jlinear
from stable_renderer_tpu_torch.convert import params_from_numpy
from stable_renderer_tpu_torch.models import gfpgan as pg

torch.set_num_threads(1)
RNG = np.random.default_rng(193)
MARGIN = 1e-3  # a token's best code over its second, logits or squared distances


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# --- GFPGAN -----------------------------------------------------------------------


@pytest.mark.parametrize("demodulate, mode", [(True, None), (True, "upsample"),
                                              (True, "downsample"), (False, None)])
def test_modulated_conv_matches_jax(demodulate, mode):
    p = {"modulation": {"weight": RNG.standard_normal((6, 5)).astype(np.float32) * 0.3,
                        "bias": np.ones(6, np.float32)},
         "weight": RNG.standard_normal((1, 4, 6, 3, 3)).astype(np.float32) * 0.2}
    x = RNG.standard_normal((3, 8, 8, 6)).astype(np.float32)
    style = RNG.standard_normal((3, 5)).astype(np.float32)
    ref = jg._modulated_conv(jtree(p), jnp.asarray(x), jnp.asarray(style), demodulate, mode)
    out = pg._modulated_conv(params_from_numpy(p, device="cpu"), torch.from_numpy(x),
                             torch.from_numpy(style), demodulate, mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PURE)


@pytest.mark.parametrize("cfg", [
    jg.TINY_GFPGAN_CONFIG,
    jg.GFPGANConfig(out_size=32, num_style_feat=16, channel_multiplier=1, base_channels=32,
                    sft_half=False, different_w=False),
], ids=["sft-half", "full-sft-one-w"])
def test_gfpgan_with_stored_noises_matches_jax(cfg):
    out = both(jg.GFPGAN(cfg), port_model(jg.GFPGAN(cfg)), model_tree(jg.GFPGAN(cfg), seed=1),
               image(2, 32, 32, 3, lo=-1.0))
    np.testing.assert_allclose(*out, **TOL)


def test_gfpgan_keyed_noise_matches_jax_draws_handed_in():
    """Without stored noises JAX draws normal(fold_in(key, layer)); the port
    takes those draws as ``noises``."""
    jm = jg.GFPGAN(jg.TINY_GFPGAN_CONFIG)
    tree = model_tree(jm, seed=2)
    del tree["stylegan_decoder"]["noises"]
    x = image(1, 32, 32, 3, lo=-1.0)
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda p, a: jm.apply(p, a, key=key))(jtree(tree), jnp.asarray(x))
    noises = {}
    for layer in range(2 * (jm.config.log_size - 2) + 1):
        res = 2 ** ((layer + 5) // 2)
        noises[layer] = torch.from_numpy(np.array(
            jax.random.normal(jax.random.fold_in(key, layer), (1, res, res, 1))))
    out = port_model(jm).apply(params_from_numpy(tree, device="cpu"), torch.from_numpy(x),
                               noises=noises)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    zeros = port_model(jm).apply(params_from_numpy(tree, device="cpu"), torch.from_numpy(x))
    assert np.abs(zeros.numpy() - out.numpy()).max() > 1e-3  # the noise term acts


# --- CodeFormer -------------------------------------------------------------------


def jax_codeformer_logits(jm, p, x):
    """JAX CodeFormer.apply up to the codebook logits, with the JAX package's
    own functions."""
    cfg = jm.config
    b, lr = x.shape[0], cfg.latent_res
    lq, _ = jcf._run_plan(jm.enc_plan, p["encoder"]["blocks"], x,
                          collect={int(s): jm.enc_fuse[int(s)] for s in cfg.connect_list})
    tokens = lq.transpose(0, 3, 1, 2).reshape(b, cfg.emb_dim, lr * lr).transpose(0, 2, 1)
    feat = jlinear(p["feat_emb"], tokens)
    for i in range(cfg.n_layers):
        feat = jcf._transformer_layer(p["ft_layers"][str(i)], feat, p["position_emb"], cfg.n_head)
    return jlayer_norm(p["idx_pred_layer"]["0"], feat) @ p["idx_pred_layer"]["1"]["weight"].T


def same_where_led(idx: np.ndarray, ref_scores: np.ndarray, largest: bool) -> None:
    """The port's code indices equal JAX's best code at every token whose
    best leads its second by more than MARGIN, and those are most tokens."""
    s = np.sort(ref_scores, axis=-1)
    lead = s[..., -1] - s[..., -2] if largest else s[..., 1] - s[..., 0]
    want = ref_scores.argmax(-1) if largest else ref_scores.argmin(-1)
    led = lead > MARGIN
    assert led.mean() > 0.9
    np.testing.assert_array_equal(idx[led], want[led])


@pytest.mark.parametrize("weight", [0.0, 0.5, 1.0])
def test_codeformer_matches_jax(weight):
    jm = jcf.CodeFormer(jcf.TINY_CODEFORMER_CONFIG)
    pm = port_model(jm)
    tree = model_tree(jm, seed=3, scale=0.05)
    x = image(2, 16, 16, 3, lo=-1.0)
    ref_logits = np.asarray(jax.jit(lambda p, a: jax_codeformer_logits(jm, p, a))(
        jtree(tree), jnp.asarray(x)))
    params = params_from_numpy(tree, device="cpu")
    idx, feats, logits = pm.code_indices(params, torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), ref_logits, **TOL)
    same_where_led(idx.numpy(), ref_logits, largest=True)
    ref = jax.jit(lambda p, a: jm.apply(p, a, weight=weight))(jtree(tree), jnp.asarray(x))
    jidx = torch.from_numpy(ref_logits.argmax(-1))
    out = pm.decode(params, jidx, feats, weight, torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_codeformer_plans_match_jax():
    from stable_renderer_tpu_torch.models import codeformer as pcf

    for cfg in (jcf.CodeFormerConfig(), jcf.TINY_CODEFORMER_CONFIG):
        pcfg = pcf.CodeFormerConfig(**vars(cfg))
        assert pcf._encoder_plan(pcfg) == jcf._encoder_plan(cfg)
        assert pcf._generator_plan(pcfg) == jcf._generator_plan(cfg)


# --- RestoreFormer ----------------------------------------------------------------


def jax_restoreformer_distances(jm, p, x):
    """JAX RestoreFormer.apply's encoder and codebook distances, with the
    JAX package's own functions."""
    cfg = jm.config
    heads, nres = cfg.head_size, len(cfg.ch_mult)
    enc = p["encoder"]
    h = jconv2d(enc["conv_in"], x, padding=1)
    curr = cfg.resolution
    for i in range(nres):
        dp = enc["down"][str(i)]
        for j in range(cfg.num_res_blocks):
            h = jrf._res_block(dp["block"][str(j)], h)
            if curr in cfg.attn_resolutions:
                h = jrf._mh_attn(dp["attn"][str(j)], h, heads)
        if i != nres - 1:
            h = jconv2d(dp["downsample"]["conv"], jnp.pad(h, ((0, 0), (0, 1), (0, 1), (0, 0))),
                        stride=2)
            curr //= 2
    h = jrf._res_block(enc["mid"]["block_2"],
                       jrf._mh_attn(enc["mid"]["attn_1"], jrf._res_block(enc["mid"]["block_1"], h),
                                    heads))
    h = jconv2d(enc["conv_out"], jrf._swish(jrf._norm(enc["norm_out"], h)), padding=1)
    z = jconv2d(p["quant_conv"], h).reshape(-1, cfg.embed_dim)
    cb = p["quantize"]["embedding"]["weight"]
    return jnp.sum(z ** 2, -1, keepdims=True) + jnp.sum(cb ** 2, -1) - 2.0 * z @ cb.T


def test_restoreformer_matches_jax():
    jm = jrf.RestoreFormer(jrf.TINY_RESTOREFORMER_CONFIG)
    pm = port_model(jm)
    tree = model_tree(jm, seed=4, scale=0.05)
    x = image(2, 16, 16, 3, lo=-1.0)
    ref_d2 = np.asarray(jax.jit(lambda p, a: jax_restoreformer_distances(jm, p, a))(
        jtree(tree), jnp.asarray(x)))
    params = params_from_numpy(tree, device="cpu")
    z, d2, hs = pm.encode(params, torch.from_numpy(x))
    np.testing.assert_allclose(d2.numpy(), ref_d2, **TOL)
    same_where_led(d2.argmin(-1).numpy(), ref_d2, largest=False)
    ref = jax.jit(jm.apply)(jtree(tree), jnp.asarray(x))
    out = pm.decode(params, z.shape, torch.from_numpy(ref_d2.argmin(-1)), hs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
