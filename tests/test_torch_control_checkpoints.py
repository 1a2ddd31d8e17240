"""The port's control checkpoints against the JAX package, on the CPU at tiny
widths: ``ControlNet.init_control_lora``, the T2I-Adapter
(models/t2i_adapter.py: ``pixel_unshuffle``, ``features``, ``apply``,
``load_t2i_adapter``'s three layouts) and
``DiffusionPipeline.add_control_from_state_dict``'s routing, then a frame
with a ControlNet and an adapter chained.

Composed parameters are compared bit for bit (the merges are numpy
arithmetic in both packages); outputs within TOL, f32 throughout.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from stable_renderer_tpu_torch.convert import params_from_numpy

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)  # f32: summation order only
RANK = 8


def _np(tree):
    """A tree of tensors or arrays as numpy arrays (f32 tensors stay f32)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (ml_dtypes bf16 included) as a CPU tensor of its dtype."""
    a = np.array(a)  # a writable copy
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _assert_bits_equal(mine: dict, ref: dict):
    mine, ref = _flat(mine), _flat(ref)
    assert sorted(mine) == sorted(ref)
    for k, v in mine.items():
        r = _torch(np.asarray(ref[k]))
        assert v.dtype == r.dtype and v.shape == r.shape, k
        assert torch.equal(v.reshape(-1).view(torch.uint8), r.reshape(-1).view(torch.uint8)), k


def _assert_controls_close(out: dict, ref: dict):
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert len(out[k]) == len(ref[k]), k
        for i, (a, b) in enumerate(zip(out[k], ref[k])):
            assert (a is None) == (b is None), f"{k}[{i}]"
            if a is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"{k}[{i}]", **TOL)


# --- control-LoRA ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _unet_np():
    """The tiny UNet's params (the port's init, seed 0) as numpy f32."""
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG, UNetModel

    return _np(UNetModel(TINY_UNET_CONFIG).init(torch.Generator().manual_seed(0)))


def _control_lora_file(file_dtype) -> dict:
    """A control-LoRA state dict for the tiny UNet: the marker, full tensors
    for the control-only parts (a perturbed ControlNet's hint block, zero
    convs and middle_block_out) and one norm of the trunk, and rank-8
    ``.up`` / ``.down`` pairs for every 2-D and 4-D trunk weight, in
    ``file_dtype``."""
    from test_torch_controlnet import perturbed_controlnet

    rng = np.random.default_rng(3)
    cn = perturbed_controlnet(4)
    flat = {"lora_controlnet": np.zeros((0,), file_dtype)}
    for part in ("input_hint_block", "zero_convs", "middle_block_out"):
        flat.update({f"{part}.{k}": v.astype(file_dtype) for k, v in _flat(cn[part]).items()})
    flat["input_blocks.1.0.in_layers.0.weight"] = (
        1.0 + rng.standard_normal(32) * 0.1).astype(file_dtype)
    for k, w in _flat(_unet_np()).items():
        if (k.startswith(("time_embed.", "input_blocks.", "middle_block."))
                and k.endswith(".weight") and w.ndim in (2, 4)):
            base = k[: -len(".weight")]
            flat[base + ".up"] = (rng.standard_normal((w.shape[0], RANK)) * 0.05).astype(
                file_dtype)
            flat[base + ".down"] = (rng.standard_normal((RANK,) + w.shape[1:]) * 0.05).astype(
                file_dtype)
    return flat


@pytest.mark.parametrize("file_dtype", [np.float32, np.float16, ml_dtypes.bfloat16])
def test_init_control_lora_matches_jax(file_dtype):
    """The composed ControlNet params equal JAX's bit for bit (each delta
    in numpy at the factors' dtype, bf16 promoted to f32, cast to the
    weight's, added; full tensors in the file's dtype), and the composed
    net's residuals match JAX's."""
    from test_torch_controlnet import _inputs, _nets

    jcn, cn = _nets()
    flat = _control_lora_file(file_dtype)
    ref = jcn.init_control_lora(_unet_np(), flat)
    out = cn.init_control_lora(params_from_numpy(_unet_np(), "cpu"),
                               {k: _torch(v) for k, v in flat.items()})
    _assert_bits_equal(out, jax.tree_util.tree_map(np.asarray, ref))
    w = "input_blocks.1.1.proj_in.weight"
    assert not np.array_equal(_flat(out)[w].numpy(), _flat(_unet_np())[w])  # the delta landed
    x, hint, ctx = _inputs(2, 8)
    t = np.array([500.0, 500.0], np.float32)
    args = (x, hint, t, ctx)
    got = cn.apply(out, *(torch.from_numpy(a) for a in args), strength=0.7)
    want = jcn.apply(jax.tree_util.tree_map(jnp.asarray, ref), *(jnp.asarray(a) for a in args),
                     strength=0.7)
    _assert_controls_close(got, want)


# --- the T2I-Adapter ------------------------------------------------------------------


def test_pixel_unshuffle_matches_torch_and_jax():
    """NHWC PixelUnshuffle: torch.nn.functional.pixel_unshuffle on NCHW and
    the JAX package's, exactly."""
    from stable_renderer_tpu.models.t2i_adapter import pixel_unshuffle as j_unshuffle

    from stable_renderer_tpu_torch.models.t2i_adapter import pixel_unshuffle

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 24, 3)).astype(
        np.float32))
    for r in (2, 8):
        out = pixel_unshuffle(x, r)
        ref = torch.nn.functional.pixel_unshuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
        assert torch.equal(out, ref)
        np.testing.assert_array_equal(out.numpy(), np.asarray(j_unshuffle(jnp.asarray(x.numpy()),
                                                                          r)))


_ADAPTERS = {
    "full": dict(channels=(32, 64, 128, 128)),
    "full_conv_ksize3": dict(channels=(32, 64, 128, 128), use_conv=True, ksize=3),
    "light": dict(channels=(32, 64, 128, 128), light=True, nums_rb=2),
    "xl": dict(channels=(32, 64, 128, 128), cin=768, xl=True),
}


def _adapters(name):
    from stable_renderer_tpu.models.t2i_adapter import (
        T2IAdapter as JAdapter,
        T2IAdapterConfig as JConfig,
    )

    from stable_renderer_tpu_torch.models.t2i_adapter import T2IAdapter, T2IAdapterConfig

    kw = _ADAPTERS[name]
    return JAdapter(JConfig(**kw)), T2IAdapter(T2IAdapterConfig(**kw))


@pytest.mark.parametrize("name", sorted(_ADAPTERS))
def test_adapter_features_and_apply_match_jax(name):
    """``features`` (a residual or None per input block) and ``apply`` (the
    strength and the denoise-percent gate) against the JAX package's, on
    the port's init (seed 2) and a hint made from a seed."""
    jad, ad = _adapters(name)
    params = ad.init(torch.Generator().manual_seed(2))
    jparams = jax.tree_util.tree_map(jnp.asarray, _np(params))
    rng = np.random.default_rng(6)
    size = 128 if name == "xl" else 64
    hint = rng.random((2, size, size, 3)).astype(np.float32)
    feats = ad.features(params, torch.from_numpy(hint))
    jfeats = jad.features(jparams, jnp.asarray(hint))
    _assert_controls_close({"input": feats}, {"input": jfeats})
    assert sum(f is not None for f in feats) == 4
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    for t0, pr in ((400.0, (0.0, 1.0)), (900.0, (0.5, 1.0))):
        t = np.array([t0, t0], np.float32)
        got = ad.apply(params, torch.from_numpy(x), torch.from_numpy(hint), torch.from_numpy(t),
                       None, strength=0.8, percent_range=pr)
        want = jad.apply(jparams, jnp.asarray(x), jnp.asarray(hint), jnp.asarray(t), None,
                         strength=0.8, percent_range=pr)
        _assert_controls_close(got, want)
    off = ad.apply(params, torch.from_numpy(x), torch.from_numpy(hint), torch.from_numpy(t),
                   None, percent_range=(0.5, 1.0))
    assert all(f is None or not f.any() for f in off["input"])  # t 900 is before 50%


def _diffusers_names(flat: dict) -> dict:
    """The full adapter's keys in diffusers' layout: body.{2i+j}.X ->
    adapter.body.i.resnets.j.X (a stage's in_conv and down_opt at
    adapter.body.i.X), conv_in -> adapter.conv_in."""
    out = {}
    for k, v in flat.items():
        if k.startswith("body."):
            _, idx, rest = k.split(".", 2)
            i, j = divmod(int(idx), 2)
            if rest.startswith(("in_conv", "down_opt")):
                out[f"adapter.body.{i}.{rest}"] = v
            else:
                out[f"adapter.body.{i}.resnets.{j}.{rest}"] = v
        else:
            out["adapter." + k] = v
    return out


@pytest.mark.parametrize("layout", ["full", "diffusers", "light"])
def test_load_t2i_adapter_layouts_match_jax(layout):
    """``load_t2i_adapter`` on the three layouts detects JAX's config and
    nests the same params."""
    from stable_renderer_tpu.models.t2i_adapter import load_t2i_adapter as j_load

    from stable_renderer_tpu_torch.models.t2i_adapter import load_t2i_adapter

    _, ad = _adapters("light" if layout == "light" else "full_conv_ksize3")
    flat = _flat(ad.init(torch.Generator().manual_seed(1)))
    if layout == "diffusers":
        flat = _diffusers_names(flat)
    mine, params = load_t2i_adapter(flat)
    jad, jparams = j_load(_np(flat))
    assert mine.config.__dict__ == jad.config.__dict__
    _assert_bits_equal(params, jparams)
    if layout == "light":
        assert mine.config.light and mine.config.nums_rb == 4
    else:
        assert (mine.config.ksize, mine.config.use_conv, mine.config.channels) == (
            3, True, (32, 64, 128, 128))
    with pytest.raises(ValueError, match="not a t2i adapter"):
        load_t2i_adapter({"body.0.block1.weight": torch.zeros(1)})


# --- the pipeline -----------------------------------------------------------------------


def _ucfg2(jax_pkg: bool):
    """The tiny UNet with 2 res blocks a level, so input blocks 2 and 5 are
    res blocks at the adapter's first two stage resolutions."""
    if jax_pkg:
        from stable_renderer_tpu.models.unet import TINY_UNET_CONFIG
    else:
        from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG
    return replace(TINY_UNET_CONFIG, num_res_blocks=2)


@functools.lru_cache(maxsize=None)
def _pipelines():
    """A tiny JAX pipeline with the 2-res-block UNet and the port's over the
    same params; no controls. Shared: callers copy before adding controls."""
    from test_torch_frame import _port_pipeline

    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.models.unet import UNetModel as JUNet
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform")
    jpipe = JPipe.from_random(JConfig(**kw), tiny=True, seed=0)
    jpipe.unet = JUNet(_ucfg2(True))
    jpipe.unet_params = jpipe.unet.init(jax.random.PRNGKey(4))
    return jpipe, _port_pipeline(jpipe, RenderConfig(**kw))


def _controlnet_flat(seed: int) -> dict:
    """A perturbed ControlNet for the 2-res-block UNet, flat, under
    ``control_model.`` as in a ControlNet checkpoint, as numpy f32."""
    from stable_renderer_tpu_torch.models.controlnet import ControlNet, ControlNetConfig

    p = _np(ControlNet(ControlNetConfig(unet=_ucfg2(False))).init(
        torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    leaves = [p["middle_block_out"]["0"], p["input_hint_block"]["14"]]
    leaves += [z["0"] for z in p["zero_convs"].values()]
    for leaf in leaves:
        for name in ("weight", "bias"):
            leaf[name] = (rng.standard_normal(leaf[name].shape) * 0.1).astype(np.float32)
    return {"control_model." + k: v for k, v in _flat(p).items()}


def _both(jpipe, pipe, flats):
    """Copies of both pipelines with ``flats`` = ((state dict, source), ...)
    chained by ``add_control_from_state_dict`` (the JAX one given numpy
    arrays, the port's CPU tensors)."""
    from stable_renderer_tpu.workflow.config import ControlNetSpec as JSpec

    from stable_renderer_tpu_torch.workflow.config import ControlNetSpec

    jpipe, pipe = replace(jpipe, controlnets=[]), replace(pipe, controlnets=[])
    for flat, source in flats:
        jpipe.add_control_from_state_dict(dict(flat), JSpec(source=source, strength=0.6))
        pipe.add_control_from_state_dict(
            {k: torch.from_numpy(np.array(v)) for k, v in flat.items()},
            ControlNetSpec(source=source, strength=0.6))
    return jpipe, pipe


def _adapter_flat() -> dict:
    _, ad = _adapters("full")
    return _np(_flat(ad.init(torch.Generator().manual_seed(9))))


def test_add_control_from_state_dict_routes_like_jax():
    """A control-LoRA file (``lora_controlnet``), an adapter file (``body.``
    keys) and a ``control_model.`` ControlNet file each land as the same kind
    of control with the same params as in the JAX package."""
    jpipe, pipe = _pipelines()
    rng = np.random.default_rng(0)
    lora = {"lora_controlnet": np.zeros((0,), np.float32)}
    unet = _flat(_np(pipe.unet_params))
    for k in ("input_blocks.1.1.proj_in.weight", "middle_block.0.in_layers.2.weight"):
        w = unet[k]
        lora[k[: -len(".weight")] + ".up"] = rng.standard_normal((w.shape[0], RANK)).astype(
            np.float32) * 0.05
        lora[k[: -len(".weight")] + ".down"] = rng.standard_normal(
            (RANK,) + w.shape[1:]).astype(np.float32) * 0.05
    cn_flat = _controlnet_flat(5)
    lora.update({k[len("control_model."):]: v for k, v in cn_flat.items()
                 if k.startswith(("control_model.zero_convs", "control_model.input_hint_block",
                                  "control_model.middle_block_out"))})
    jpipe, pipe = _both(jpipe, pipe, ((lora, "depth"), (_adapter_flat(), "normal"),
                                      (cn_flat, "depth")))
    kinds = [type(c).__name__ for c, _, _ in pipe.controlnets]
    assert kinds == [type(c).__name__ for c, _, _ in jpipe.controlnets] == [
        "ControlNet", "T2IAdapter", "ControlNet"]
    assert pipe.controlnets[1][0].config.__dict__ == jpipe.controlnets[1][0].config.__dict__
    for (_, params, spec), (_, jparams, jspec) in zip(pipe.controlnets, jpipe.controlnets):
        assert (spec.source, spec.strength) == (jspec.source, jspec.strength)
        _assert_bits_equal(params, jax.tree_util.tree_map(np.asarray, jparams))


def test_adapter_chained_after_controlnet_matches_jax():
    """A ControlNet (depth hint) and a T2I-Adapter (normal hint) chained:
    ``_make_control_fn`` sums their entries by key (the adapter's ``input``,
    the ControlNet's ``middle`` and ``output``) as JAX's does, on two
    evaluations; then the sequential frame with JAX's sampler draws handed
    in matches JAX's ``_jit_render``, and the adapter moves it."""
    from test_torch_controlnet import _frame_inputs, _inputs, _jax_render, _port_render

    jpipe, pipe = _both(*_pipelines(), ((_controlnet_flat(6), "depth"),
                                        (_adapter_flat(), "normal")))
    rng = np.random.default_rng(8)
    hints = tuple(rng.random((1, 48, 48, 3)).astype(np.float32) for _ in range(2))
    control_fn = pipe._make_control_fn(tuple(torch.from_numpy(h) for h in hints))
    for seed, t0 in ((9, 600.0), (10, 200.0)):
        x, _, ctx = _inputs(2, 8, seed=seed)
        t = np.array([t0, t0], np.float32)
        ref = jax.jit(lambda h, *a: jpipe._make_control_fn(h)(*a))(
            tuple(jnp.asarray(h) for h in hints), jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(ctx))
        out = control_fn(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
        _assert_controls_close(out, ref)
    assert sorted(out) == ["input", "middle", "output"]
    inp = _frame_inputs()
    key = np.array([0, 3], np.uint32)
    frame, jframe = _port_render(pipe, inp, key), _jax_render(jpipe, inp, key)
    np.testing.assert_allclose(frame.numpy(), np.asarray(jframe), **TOL)
    without = _port_render(replace(pipe, controlnets=pipe.controlnets[:1]), inp, key)
    assert float((frame - without).abs().mean()) > 1e-3
