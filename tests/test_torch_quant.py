"""The port's int8 conv quantization (models/quant.py) against the JAX package.

Weights, scales, tree structure and calibration come out equal to the JAX
package's from the same numpy inputs; ``conv2d_q`` agrees on f32 inputs.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_renderer_tpu.models import layers as jlayers
from stable_renderer_tpu.models import quant as jquant
from stable_renderer_tpu_torch.convert import params_from_numpy
from stable_renderer_tpu_torch.models import layers as tlayers
from stable_renderer_tpu_torch.models import quant as tquant

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape,a_scale", [((16, 8, 3, 3), 2.54), ((24, 32, 1, 1), 0.37),
                                           ((8, 4, 3, 3), None)])
def test_quantize_conv_params_matches_jax(shape, a_scale):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    b = rng.standard_normal(shape[0]).astype(np.float32)
    ref = jquant.quantize_conv_params({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                      a_scale=a_scale)
    out = tquant.quantize_conv_params({"weight": _t(w), "bias": _t(b)}, a_scale=a_scale)
    assert sorted(out) == sorted(ref)
    assert out["weight_q"].dtype == torch.int8 and out["weight_q"].is_contiguous()
    np.testing.assert_array_equal(out["weight_q"].numpy(), np.asarray(ref["weight_q"]))
    assert out["w_scale"].dtype == torch.float32
    np.testing.assert_array_equal(out["w_scale"].numpy(), np.asarray(ref["w_scale"]))
    if a_scale is not None:
        # f32(max(a, 1e-8) / 127) with the division in Python double
        assert out["a_scale"].dtype == torch.float32 and out["a_scale"].dim() == 0
        assert out["a_scale"].item() == float(np.asarray(ref["a_scale"]))
        assert out["a_scale"].item() == float(np.float32(a_scale / 127.0))


def _tree(np_rng):
    def conv(o, i, k=3):
        return {"weight": (np_rng.standard_normal((o, i, k, k)) * 0.1).astype(np.float32),
                "bias": np.zeros(o, np.float32)}

    return {
        "conv_in": conv(4, 3),                       # skipped by DEFAULT_SKIP_RE
        "mid": conv(8, 4),                           # calibrated, big enough
        "small": conv(8, 8),                         # calibrated below min_pixels
        "missed": conv(8, 8),                        # absent from the scales
        "nested": {"inner": conv(8, 8, 1), "lin": {"weight": np.ones((4, 4), np.float32)}},
        "norm": {"weight": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)},
    }


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}.{k}" if path else k))
        return out
    return {path: tree}


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.mark.parametrize("scales", ["calibrated", "dynamic"])
def test_quantize_tree_matches_jax(scales):
    tree = _tree(np.random.default_rng(1))
    act = None
    if scales == "calibrated":
        act = {"mid": (2.0, 64 * 64), "small": (3.0, 16 * 16), "nested.inner": (1.5, 4096)}
    ref = {k: np.asarray(v) for k, v in
           _flat(jquant.quantize_tree(jax_tree(tree), act, min_pixels=32 * 32)).items()}
    out = tquant.quantize_tree(params_from_numpy(tree, "cpu"), act, min_pixels=32 * 32)
    flat = {k: v.numpy() for k, v in _flat(out).items()}
    assert sorted(flat) == sorted(ref)
    for k, v in flat.items():
        assert v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    assert "weight" in out["conv_in"]
    if scales == "calibrated":
        assert "weight_q" in out["mid"] and "a_scale" in out["mid"]
        assert "weight" in out["small"] and "weight" in out["missed"]
    else:
        assert all("weight_q" in out[k] for k in ("mid", "small", "missed"))


def test_calibrate_act_scales_small_tree_matches_jax():
    rng = np.random.default_rng(2)
    tree = {
        "a": {"weight": (rng.standard_normal((4, 3, 3, 3)) * 0.3).astype(np.float32),
              "bias": rng.standard_normal(4).astype(np.float32)},
        "b": {"inner": {"weight": (rng.standard_normal((4, 4, 1, 1)) * 0.2).astype(np.float32)}},
        "lin": {"weight": np.ones((4, 4), np.float32)},
    }
    x = (rng.standard_normal((1, 8, 8, 3)) * 3.0).astype(np.float32)

    def japply(p, x):
        return jlayers.conv2d(p["b"]["inner"], jlayers.conv2d(p["a"], x, padding=1))

    def tapply(p, x):
        return tlayers.conv2d(p["b"]["inner"], tlayers.conv2d(p["a"], x, padding=1))

    ref = jquant.calibrate_act_scales(japply, jax_tree(tree), jnp.asarray(x))
    out = tquant.calibrate_act_scales(tapply, params_from_numpy(tree, "cpu"), _t(x))
    assert set(out) == set(ref) == {"a", "b.inner"}
    for k in ref:
        np.testing.assert_allclose(out[k][0], ref[k][0], rtol=1e-6)
        assert out[k][1] == ref[k][1] == 64
    assert not tquant._CAL.active and not tquant._CAL.paths


def test_calibrate_act_scales_tiny_unet_matches_jax():
    """The tiny UNet in f32 on the same numpy inputs: every conv is reached,
    the spatial sizes are equal, and the maxima agree to rtol 1e-6 (f32
    evaluation order only)."""
    from stable_renderer_tpu.models.unet import TINY_UNET_CONFIG as JCFG, UNetModel as JUNet

    from stable_renderer_tpu_torch.models.unet import UNetConfig, UNetModel

    import jax

    junet = JUNet(JCFG)
    jparams = junet.init(jax.random.PRNGKey(0))
    unet = UNetModel(UNetConfig(in_channels=JCFG.in_channels, out_channels=JCFG.out_channels,
                                model_channels=JCFG.model_channels,
                                num_res_blocks=JCFG.num_res_blocks,
                                channel_mult=JCFG.channel_mult,
                                attention_levels=JCFG.attention_levels,
                                transformer_depth=JCFG.transformer_depth,
                                num_heads=JCFG.num_heads, context_dim=JCFG.context_dim))
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 16, JCFG.in_channels)).astype(np.float32)
    t = np.array([999.0, 759.0, 999.0, 759.0], np.float32)
    ctx = (rng.standard_normal((4, 77, JCFG.context_dim)) * 0.35).astype(np.float32)
    ref = jquant.calibrate_act_scales(lambda p, *a: junet.apply(p, *a), jparams,
                                      jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    out = tquant.calibrate_act_scales(lambda p, *a: unet.apply(p, *a), params,
                                      _t(x), _t(t), _t(ctx))
    n_convs = len(_conv_paths(params))
    assert set(out) == set(ref) and len(out) == n_convs
    for k in ref:
        np.testing.assert_allclose(out[k][0], ref[k][0], rtol=1e-6, err_msg=k)
        assert out[k][1] == ref[k][1], k


def _conv_paths(tree, path=""):
    if isinstance(tree, dict):
        if tquant._is_conv_leaf(tree):
            return [path]
        return [p for k, v in tree.items() for p in _conv_paths(v, f"{path}.{k}" if path else k)]
    return []


@pytest.mark.parametrize("kind", ["static", "dynamic"])
@pytest.mark.parametrize("k,stride,padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0), (3, 2, 0)])
def test_conv2d_q_matches_jax(kind, k, stride, padding):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 9, 16)).astype(np.float32)
    p = {"weight": (rng.standard_normal((24, 16, k, k)) * 0.1).astype(np.float32),
         "bias": rng.standard_normal(24).astype(np.float32)}
    a = float(np.abs(x).max()) * 0.8 if kind == "static" else None  # clips the largest values
    jq = jquant.quantize_conv_params(jax_tree(p), a_scale=a)
    tq = params_from_numpy({k_: np.asarray(v) for k_, v in jq.items()}, "cpu")
    ref = np.asarray(jquant.conv2d_q(jq, jnp.asarray(x), stride=stride, padding=padding))
    out = tquant.conv2d_q(tq, _t(x), stride=stride, padding=padding)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    # quantized values and int32 sums are equal; the f32 dequantization differs
    # at most by one rounding
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    via_layers = tlayers.conv2d(tq, _t(x), stride=stride, padding=padding)
    np.testing.assert_array_equal(via_layers.numpy(), out.numpy())


def test_int_conv_is_exact():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.integers(-127, 128, (1, 6, 6, 64)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 64, 16)).astype(np.int8))
    out = tquant.int_conv(q, w, stride=1, padding=1)
    ref = torch.nn.functional.conv2d(q.long().permute(0, 3, 1, 2).double(),
                                     w.long().permute(3, 2, 0, 1).double(), padding=1)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref.permute(0, 2, 3, 1).long().numpy())
    # brute force at one interior and one corner pixel
    qi, wi = q.long(), w.long()
    for y, x_ in ((3, 2), (0, 0)):
        s = sum(int((qi[0, y + dy - 1, x_ + dx - 1] * wi[dy, dx, :, 5]).sum())
                for dy in range(3) for dx in range(3)
                if 0 <= y + dy - 1 < 6 and 0 <= x_ + dx - 1 < 6)
        assert int(out[0, y, x_, 5]) == s


def test_from_random_int8_quantizes_and_renders(monkeypatch):
    """``RenderConfig(int8_conv=True)`` in the port alone: ``from_random``
    calibrates and quantizes both trees (first and last convs stay float) and
    the pipeline renders a finite frame. Calibration runs at 256x256 here
    (the smallest render whose 32x32 latent passes min_pixels; the default
    512x512 is slow for bf16 convs on the CPU)."""
    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    calls = []
    orig = DiffusionPipeline.quantize_convs

    def quantize_convs(self, **kw):
        calls.append(kw)
        return orig(self, render_size=(256, 256))

    monkeypatch.setattr(DiffusionPipeline, "quantize_convs", quantize_convs)
    cfg = RenderConfig(prompt="q", steps=2, sampler="lcm", scheduler="sgm_uniform",
                       int8_conv=True)
    pipe = DiffusionPipeline.from_random(cfg, tiny=True, device="cpu")
    assert calls == [{}]
    up, vp = pipe.unet_params, pipe.vae_params
    assert "weight_q" in up["input_blocks"]["1"]["0"]["in_layers"]["2"]
    assert "a_scale" in up["input_blocks"]["1"]["0"]["in_layers"]["2"]
    assert "weight" in up["input_blocks"]["0"]["0"] and "weight" in up["out"]["2"]
    assert "weight" in vp["encoder"]["conv_in"] and "weight_q" in vp["decoder"]["mid"]["block_1"]["conv1"]
    size = 32
    rng = np.random.default_rng(0)
    ed = EngineData(frame_indices=torch.arange(1), color_maps=torch.zeros((1, size, size, 3)),
                    id_maps=torch.zeros((1, size, size, 4), dtype=torch.int32),
                    noise_maps=torch.from_numpy(rng.standard_normal((1, 4, 4, 4)).astype(np.float32)))
    out = pipe.render(ed, key=torch.Generator().manual_seed(0))
    assert out.shape == (1, size, size, 3) and torch.isfinite(out).all()
