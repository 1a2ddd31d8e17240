"""LaMa (models/lama.py) against the JAX package's, on the CPU at tiny widths:
the reflect convs, the stride-2 transposed convs (torch's ConvTranspose2d
taps: the JAX package flips and transposes the kernel into a fractionally
strided conv, which is the same operation; no flip is reproduced here, unlike
Cascade's 2x2 ``conv_transpose2x``), the Fourier unit's rfft2 -> 1x1 conv ->
irfft2 with ortho norm, inference BatchNorm, the mask composite, and inputs
that need the pad to 2 ** n_downsampling.

Trees as tests/test_torch_upscale.py makes them. Tolerances: PURE (1e-6) for
tensor work in f32, TOL (2e-4) for the model.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_upscale import PURE, TOL, both, image, model_tree, port_model, write_pth

from stable_renderer_tpu.models import lama as jl
from stable_renderer_tpu_torch.convert import params_from_numpy
from stable_renderer_tpu_torch.models import lama as pl

torch.set_num_threads(1)
RNG = np.random.default_rng(194)


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_conv_transpose_matches_jax_and_torch():
    p = {"weight": RNG.standard_normal((6, 4, 3, 3)).astype(np.float32) * 0.2,  # outputs ~1
         "bias": RNG.standard_normal(4).astype(np.float32)}
    x = RNG.standard_normal((2, 5, 7, 6)).astype(np.float32)
    ref = jl._conv_transpose_s2(jtree(p), jnp.asarray(x))
    out = pl._conv_transpose_s2(params_from_numpy(p, device="cpu"), torch.from_numpy(x))
    assert out.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PURE)
    layer = torch.nn.ConvTranspose2d(6, 4, 3, stride=2, padding=1, output_padding=1)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(p["weight"]))
        layer.bias.copy_(torch.from_numpy(p["bias"]))
        mod = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), mod.numpy(), **PURE)


def test_fourier_unit_matches_jax():
    c = 6
    p = {"conv_layer": {"weight": RNG.standard_normal((2 * c, 2 * c, 1, 1)).astype(np.float32)
                        * 0.3},
         "bn": {"weight": RNG.uniform(0.5, 1.5, 2 * c).astype(np.float32),
                "bias": RNG.standard_normal(2 * c).astype(np.float32) * 0.1,
                "running_mean": RNG.standard_normal(2 * c).astype(np.float32) * 0.1,
                "running_var": RNG.uniform(0.5, 1.5, 2 * c).astype(np.float32)}}
    x = RNG.standard_normal((2, 8, 10, c)).astype(np.float32)
    ref = jl._fourier_unit(jtree(p), jnp.asarray(x))
    out = pl._fourier_unit(params_from_numpy(p, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PURE)


@pytest.mark.parametrize("cfg, shape", [
    (jl.TINY_LAMA_CONFIG, (1, 16, 16)),
    (jl.LaMaConfig(ngf=8, n_downsampling=3, n_blocks=2, max_features=32), (2, 18, 21)),
], ids=["tiny", "three-downs-padded"])
def test_lama_matches_jax(cfg, shape):
    jm = jl.LaMa(cfg)
    b, h, w = shape
    img = image(b, h, w, 3)
    mask = (RNG.uniform(size=(b, h, w, 1)) > 0.6).astype(np.float32)
    out, ref = both(jm, port_model(jm), model_tree(jm, seed=6, scale=0.05), img, mask)
    assert out.shape == (b, h, w, 3)
    np.testing.assert_allclose(out, ref, **TOL)
    keep = mask[..., 0] == 0
    np.testing.assert_array_equal(out[keep], img[keep])  # the composite keeps known pixels


def test_load_lama_reads_generator_keys_as_jax(tmp_path):
    """The official files' ``generator.model.*`` keys load as ``model.model.*``
    in both packages, with the same detected config."""
    jm = jl.LaMa(jl.TINY_LAMA_CONFIG)
    tree = model_tree(jm, seed=7)
    path = write_pth({"generator": tree["model"]}, tmp_path / "big-lama.pth")
    jmodel, jparams = jl.load_lama(str(path))
    pmodel, pparams = pl.load_lama(path, device="cpu")
    assert jmodel.config == jl.LaMaConfig(ngf=8, in_nc=4)
    assert pmodel.config == pl.LaMaConfig(ngf=8, in_nc=4)
    from stable_renderer_tpu_torch.models.weights import flatten

    jflat, pflat = flatten(jparams), flatten(pparams)
    assert sorted(jflat) == sorted(pflat) and all(k.startswith("model.model.") for k in pflat)
