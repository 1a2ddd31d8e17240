"""The zoo's convolutional restorers (models/omnisr.py, spsr.py, scunet.py)
against the JAX package's, on the CPU at tiny widths: OmniSR's block and
grid attentions and its ESA (the 7x7 stride-3 max pool and JAX's bilinear
upsample), SPSR's gradient map and both RRDB branches, SCUNet's W-MSA and
SW-MSA, its stride-2 down convs and transposed up convs; inputs that need
the pads (OmniSR's zero pad to the window, SCUNet's reflect pad to 8
windows, past the image's own size).

Trees as tests/test_torch_upscale.py makes them. Tolerances: PURE (1e-6) for
tensor work in f32, TOL (2e-4) for a model.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_upscale import PURE, TOL, both, image, model_tree, port_model

from stable_renderer_tpu.models import omnisr as jo
from stable_renderer_tpu.models import scunet as jsc
from stable_renderer_tpu.models import spsr as jsp
from stable_renderer_tpu_torch.convert import params_from_numpy
from stable_renderer_tpu_torch.models import omnisr as po
from stable_renderer_tpu_torch.models import scunet as psc
from stable_renderer_tpu_torch.models import spsr as psp

torch.set_num_threads(1)
RNG = np.random.default_rng(192)


def check(jmodel, x, seed=0):
    out, ref = both(jmodel, port_model(jmodel), model_tree(jmodel, seed), x)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
    return out


# --- OmniSR -----------------------------------------------------------------------


@pytest.mark.parametrize("cfg, shape", [
    (jo.TINY_OMNISR_CONFIG, (1, 16, 16, 3)),
    (jo.OmniSRConfig(num_feat=16, res_num=2, block_num=1, window_size=4, up_scale=3),
     (1, 18, 22, 3)),  # padded to 20x24; the ESA's pool needs >= 15 pixels
], ids=["tiny-x2", "two-groups-x3-padded"])
def test_omnisr_matches_jax(cfg, shape):
    out = check(jo.OmniSR(cfg), image(*shape))
    assert out.shape == (1, shape[1] * cfg.up_scale, shape[2] * cfg.up_scale, 3)


@pytest.mark.parametrize("grid", [False, True])
def test_omnisr_partitions_match_jax(grid):
    x = RNG.standard_normal((2, 8, 12, 3)).astype(np.float32)
    out = po._block_partition(torch.from_numpy(x), 4, grid)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo._block_partition(jnp.asarray(x), 4,
                                                                              grid)))
    np.testing.assert_array_equal(po._block_reverse(out, 4, 8, 12, grid).numpy(), x)


def test_esa_matches_jax():
    """The ESA at a size whose pooled map does not divide the image (24 ->
    11 -> 2, resized back to 24)."""
    from stable_renderer_tpu_torch.models.swinir import Draws

    d = Draws(torch.Generator().manual_seed(3))
    p = {"conv1": d.conv(16, 16, 1), "conv_f": d.conv(16, 16, 1), "conv2": d.conv(16, 16),
         "conv3": d.conv(16, 16), "conv4": d.conv(16, 16, 1)}
    p = {k: {n: t.numpy() + 0.02 for n, t in v.items()} for k, v in p.items()}
    x = RNG.standard_normal((1, 24, 26, 16)).astype(np.float32)
    import jax

    ref = jo._esa(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    out = po._esa(params_from_numpy(p, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PURE)


# --- SPSR -------------------------------------------------------------------------


def test_gradient_map_matches_jax():
    x = RNG.uniform(size=(2, 9, 11, 3)).astype(np.float32)
    np.testing.assert_allclose(psp.gradient_map(torch.from_numpy(x)).numpy(),
                               np.asarray(jsp.gradient_map(jnp.asarray(x))), **PURE)


@pytest.mark.parametrize("cfg", [jsp.TINY_SPSR_CONFIG,
                                 jsp.SPSRConfig(num_filters=8, num_blocks=5, scale=4)],
                         ids=["tiny-x2", "x4-five-blocks"])
def test_spsr_matches_jax(cfg):
    out = check(jsp.SPSRNet(cfg), image(1, 8, 10, 3))
    assert out.shape == (1, 8 * cfg.scale, 10 * cfg.scale, 3)


# --- SCUNet -----------------------------------------------------------------------


def test_conv_transpose_up_matches_jax():
    x = RNG.standard_normal((2, 5, 6, 8)).astype(np.float32)
    w = RNG.standard_normal((8, 4, 2, 2)).astype(np.float32)
    ref = jsc._conv_transpose_up({"weight": jnp.asarray(w)}, jnp.asarray(x))
    out = psc._conv_transpose_up({"weight": torch.from_numpy(w)}, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PURE)


@pytest.mark.parametrize("cfg, shape", [
    (jsc.TINY_SCUNET_CONFIG, (1, 16, 16, 3)),
    (jsc.SCUNetConfig(dim=16, config=(2, 1, 1, 2, 1, 1, 2), head_dim=8, window_size=2),
     (1, 20, 14, 3)),
], ids=["tiny-reflect-past-the-image", "shifted-blocks"])
def test_scunet_matches_jax(cfg, shape):
    out = check(jsc.SCUNet(cfg), image(*shape))
    assert out.shape == shape
