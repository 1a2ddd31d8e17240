"""The zoo's window-attention transformers (models/swinir.py, swin2sr.py,
hat.py, dat.py) and the JAX-matching resamplers against the JAX package's,
on the CPU at tiny widths: every upsampler and variant branch (SwinIR's four
upsamplers, its 3conv residual, its pixel-unshuffled input and the
one-window rule; Swin2SR's four, pixelshuffle_aux's cubic skip included;
HAT's OCAB; DAT's two upsamplers, its shift cadence and 3conv), on inputs
that need the reflect pad to a window multiple.

Trees as tests/test_torch_upscale.py makes them (the port's init held to
JAX's tree, perturbed). Tolerances: PURE (1e-6) for tensor work in f32
(resizes, shuffles), TOL (2e-4) for a model; host tables exact.

Held here: the JAX package's ``pixel_shuffle`` / ``pixel_unshuffle`` on
NHWC equal torch's ``F.pixel_shuffle`` / ``F.pixel_unshuffle`` on the NCHW
view exactly, and the port's equal both. ``jax.image.resize``'s "bilinear"
and "cubic" are half-pixel, antialiased when shrinking, cubic with Keys
a = -0.5 (``clip_vision.resize_linear`` / ``resize_cubic``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_upscale import PURE, TOL, both, image, model_tree, port_model

from stable_renderer_tpu.models import dat as jd
from stable_renderer_tpu.models import hat as jh
from stable_renderer_tpu.models import swin2sr as js2
from stable_renderer_tpu.models import swinir as jsw
from stable_renderer_tpu_torch.models import clip_vision as pcv
from stable_renderer_tpu_torch.models import dat as pd
from stable_renderer_tpu_torch.models import hat as ph
from stable_renderer_tpu_torch.models import swinir as psw

torch.set_num_threads(1)
RNG = np.random.default_rng(191)


def check(jmodel, x, tree=None, seed=0):
    """The port's output against JAX's on one tree; returns the port's."""
    tree = model_tree(jmodel, seed) if tree is None else tree
    out, ref = both(jmodel, port_model(jmodel), tree, x)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
    return out


def three_conv(tree, e, seed):
    """Replace each residual group's 1x1 conv by the 3conv stack (conv 3x3 e
    -> e/4, 1x1, 3x3 e/4 -> e), drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def conv(i, o, k):
        return {"weight": (rng.standard_normal((o, i, k, k)) * 0.05).astype(np.float32),
                "bias": (rng.standard_normal(o) * 0.02).astype(np.float32)}

    for lp in tree["layers"].values():
        lp["conv"] = {"0": conv(e, e // 4, 3), "2": conv(e // 4, e // 4, 1),
                      "4": conv(e // 4, e, 3)}
    return tree


# --- the resamplers and host tables ---------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 8, 4, 4), (8, 10, 16, 20), (6, 5, 32, 40), (9, 7, 5, 3),
                                   (4, 4, 16, 16)])
@pytest.mark.parametrize("method", ["bilinear", "cubic"])
def test_resizes_match_jax(method, shape):
    h, w, oh, ow = shape
    x = RNG.standard_normal((2, h, w, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, oh, ow, 3), method)
    fn = pcv.resize_linear if method == "bilinear" else pcv.resize_cubic
    np.testing.assert_allclose(fn(torch.from_numpy(x), oh, ow).numpy(), np.asarray(ref), **PURE)


def test_halving_resize_is_antialiased_unlike_plain_interpolate():
    """GFPGAN's downsample: JAX's bilinear at 0.5 averages a 4-tap tent;
    ``F.interpolate(antialias=False)`` reads two taps and differs."""
    x = RNG.standard_normal((1, 16, 16, 2)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 8, 8, 2), "bilinear"))
    plain = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(8, 8), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(plain - ref).max() > 0.1
    np.testing.assert_allclose(pcv.resize_linear(torch.from_numpy(x), 8, 8).numpy(), ref, **PURE)


@pytest.mark.parametrize("r", [2, 3, 4])
def test_pixel_shuffles_match_jax_and_torch(r):
    x = RNG.standard_normal((2, 3, 5, 2 * r * r)).astype(np.float32)
    out = psw.pixel_shuffle(torch.from_numpy(x), r)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jsw.pixel_shuffle(jnp.asarray(x), r)))
    torch_ps = F.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(out.numpy(), torch_ps.numpy())
    y = RNG.standard_normal((2, 2 * r, 3 * r, 5)).astype(np.float32)
    back = psw.pixel_unshuffle(torch.from_numpy(y), r)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jsw.pixel_unshuffle(jnp.asarray(y), r)))
    np.testing.assert_array_equal(psw.pixel_shuffle(back, r).numpy(), y)


@pytest.mark.parametrize("n, pad", [(5, 3), (16, 16), (3, 9), (1, 4)])
def test_reflect_pad_matches_jnp_pad(n, pad):
    """jnp.pad's reflect repeats the reflection where the pad passes the
    axis (SCUNet pads a 16-pixel image by 16); torch's reflect cannot."""
    x = RNG.standard_normal((1, n, n, 2)).astype(np.float32)
    ref = jnp.pad(jnp.asarray(x), ((0, 0), (0, pad), (0, pad), (0, 0)), mode="reflect")
    np.testing.assert_array_equal(psw.pad_reflect(torch.from_numpy(x), pad, pad).numpy(),
                                  np.asarray(ref))


def test_host_tables_equal_jax():
    for ws in (4, 7, 8):
        np.testing.assert_array_equal(psw._rel_pos_index(ws), jsw._rel_pos_index(ws))
        np.testing.assert_array_equal(psw._shift_attn_mask(4 * ws, 2 * ws, ws, ws // 2),
                                      jsw._shift_attn_mask(4 * ws, 2 * ws, ws, ws // 2))
    np.testing.assert_array_equal(ph._rpi_oca(16, 24), jh._rpi_oca(16, 24))
    np.testing.assert_array_equal(pd._rect_mask(8, 8, 2, 4, 1, 2), jd._rect_mask(8, 8, 2, 4, 1, 2))
    from stable_renderer_tpu_torch.models import swin2sr as ps2

    np.testing.assert_array_equal(ps2._coords_table(8), js2._coords_table(8))
    for rg in range(4):
        for bi in range(8):
            assert pd._do_shift(rg, bi) == jd._do_shift(rg, bi)


def test_overlap_windows_match_jax():
    x = RNG.standard_normal((2, 8, 12, 3)).astype(np.float32)
    out = ph._extract_overlap_windows(torch.from_numpy(x), 4, 6)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jh._extract_overlap_windows(jnp.asarray(x), 4, 6)))


# --- SwinIR -----------------------------------------------------------------------


SWINIR_CASES = {
    "pixelshuffledirect-x2-padded": (jsw.TINY_SWINIR_CONFIG, (1, 10, 14, 3), False),
    "one-window": (jsw.TINY_SWINIR_CONFIG, (1, 4, 4, 3), False),
    "pixelshuffle-x4-3conv": (jsw.SwinIRConfig(embed_dim=16, depths=(2,), num_heads=(2,),
                                               window_size=4, mlp_ratio=2.0,
                                               upsampler="pixelshuffle", upscale=4, num_feat=8,
                                               resi_connection="3conv"), (1, 8, 6, 3), True),
    "nearest+conv-x4": (jsw.SwinIRConfig(embed_dim=16, depths=(2,), num_heads=(4,),
                                         window_size=4, mlp_ratio=2.0, upsampler="nearest+conv",
                                         upscale=4, num_feat=8), (1, 8, 8, 3), False),
    "denoise": (jsw.SwinIRConfig(embed_dim=16, depths=(2,), num_heads=(2,), window_size=4,
                                 mlp_ratio=2.0, upsampler="", upscale=1, patch_norm=False),
                (2, 8, 8, 3), False),
    "unshuffled-input": (jsw.SwinIRConfig(embed_dim=16, depths=(2,), num_heads=(2,),
                                          window_size=4, mlp_ratio=2.0,
                                          upsampler="pixelshuffledirect", upscale=4,
                                          in_chans=12, start_unshuffle=2), (1, 12, 8, 3), False),
}


@pytest.mark.parametrize("case", list(SWINIR_CASES))
def test_swinir_matches_jax(case):
    cfg, shape, resi3 = SWINIR_CASES[case]
    jm = jsw.SwinIR(cfg)
    tree = model_tree(jm)
    if resi3:
        tree = three_conv(tree, cfg.embed_dim, 7)
    out = check(jm, image(*shape), tree)
    if cfg.start_unshuffle == 1:
        assert out.shape == (shape[0], shape[1] * jm.scale, shape[2] * jm.scale, 3)
    else:  # both packages upsample the unshuffled map by ``scale`` (ROADMAP queue 3):
        # 12x8 -> 6x4, padded to 8x4, x2 -> 16x8, cropped to at most 24x16
        assert out.shape == (1, 16, 8, 3)


def test_swinir_m_config_is_the_published_layout():
    cfg = psw.SWINIR_M_X4_CONFIG
    tree = psw.SwinIR(cfg).init(torch.Generator().manual_seed(0), device="meta")
    flat = {k: v for k, v in __import__("stable_renderer_tpu_torch.models.weights",
                                        fromlist=["flatten"]).flatten(tree).items()}
    assert psw.detect_swinir_config(flat) == cfg
    assert jsw.detect_swinir_config(flat) == jsw.SwinIRConfig(**vars(cfg))


# --- Swin2SR ----------------------------------------------------------------------


@pytest.mark.parametrize("upsampler, scale", [("pixelshuffledirect", 2), ("pixelshuffle", 2),
                                              ("pixelshuffle_aux", 2), ("nearest+conv", 4)])
def test_swin2sr_matches_jax(upsampler, scale):
    cfg = js2.Swin2SRConfig(embed_dim=16, depths=(2,), num_heads=(2,), window_size=4,
                            mlp_ratio=2.0, upsampler=upsampler, upscale=scale, num_feat=8)
    jm = js2.Swin2SR(cfg)
    out = check(jm, image(1, 10, 12, 3))
    assert out.shape == (1, 10 * scale, 12 * scale, 3)


# --- HAT --------------------------------------------------------------------------


@pytest.mark.parametrize("cfg, shape", [
    (jh.TINY_HAT_CONFIG, (1, 10, 10, 3)),
    (jh.HATConfig(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4,
                  overlap_ratio=0.5, compress_ratio=2, squeeze_factor=4, mlp_ratio=2.0,
                  upscale=4, num_feat=8), (1, 8, 12, 3)),
], ids=["tiny-x2-padded", "two-groups-x4"])
def test_hat_matches_jax(cfg, shape):
    jm = jh.HAT(cfg)
    out = check(jm, image(*shape))
    assert out.shape == (1, shape[1] * cfg.upscale, shape[2] * cfg.upscale, 3)


# --- DAT --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["tiny", "two-groups-pixelshuffle-3conv"])
def test_dat_matches_jax(case):
    if case == "tiny":
        cfg, shape, resi3 = jd.TINY_DAT_CONFIG, (1, 12, 16, 3), False
    else:  # group 1 shifts at block 0 (_do_shift), group 0 does not
        cfg = jd.DATConfig(embed_dim=16, depths=(2, 2), num_heads=(2, 2), split_size=(2, 4),
                           expansion_factor=2.0, upsampler="pixelshuffle", upscale=2,
                           num_feat=8, resi_connection="3conv")
        shape, resi3 = (1, 10, 12, 3), True
    jm = jd.DAT(cfg)
    tree = model_tree(jm)
    if resi3:
        tree = three_conv(tree, cfg.embed_dim, 8)
    out = check(jm, image(*shape), tree)
    assert out.shape == (1, shape[1] * cfg.upscale, shape[2] * cfg.upscale, 3)
