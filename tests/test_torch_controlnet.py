"""The port's ControlNet path (models/controlnet.py, the UNet's control
residuals, ``DiffusionPipeline._make_control_fn`` and the control frame)
against the JAX package, on the CPU at tiny widths.

A fresh ControlNet's zero convs, ``middle_block_out`` and last hint conv are
zeros, so its residuals are exact zeros and a comparison would prove nothing:
every parity case perturbs those leaves with a seeded draw
(``perturbed_controlnet``), and the zero-init case is checked on its own.
Both packages get the same numpy parameters and inputs; f32 throughout.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_renderer_tpu_torch.convert import params_from_numpy

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)  # f32: summation order only
PERTURB = 0.1  # scale of the seeded draw put into the zero-initialised leaves


def _np_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: a.numpy() if torch.is_tensor(a) else np.array(a, np.float32), tree)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def _perturbed(seed: int):
    _, cn = _nets()
    p = _np_tree(cn.init(torch.Generator().manual_seed(seed), device="cpu"))
    rng = np.random.default_rng(seed)
    leaves = [p["middle_block_out"]["0"], p["input_hint_block"]["14"]]
    leaves += [z["0"] for z in p["zero_convs"].values()]
    for leaf in leaves:
        for name in ("weight", "bias"):
            leaf[name] = (rng.standard_normal(leaf[name].shape) * PERTURB).astype(np.float32)
    return p


def perturbed_controlnet(seed: int):
    """A tiny ControlNet's random init (the port's ``init``, generator seeded
    with ``seed``) as a numpy tree, with its zero convs, middle_block_out and
    last hint conv drawn from a numpy generator seeded with ``seed``."""
    return jax.tree_util.tree_map(np.copy, _perturbed(seed))


def port_unet_config(jcfg):
    from stable_renderer_tpu_torch.models.unet import UNetConfig

    return UNetConfig(in_channels=jcfg.in_channels, out_channels=jcfg.out_channels,
                      model_channels=jcfg.model_channels, num_res_blocks=jcfg.num_res_blocks,
                      channel_mult=jcfg.channel_mult, attention_levels=jcfg.attention_levels,
                      transformer_depth=jcfg.transformer_depth, num_heads=jcfg.num_heads,
                      context_dim=jcfg.context_dim)


def _nets():
    from stable_renderer_tpu.models.controlnet import ControlNet as JCN, ControlNetConfig as JCfg
    from stable_renderer_tpu.models.unet import TINY_UNET_CONFIG as JTINY

    from stable_renderer_tpu_torch.models.controlnet import ControlNet, ControlNetConfig

    return JCN(JCfg(unet=JTINY)), ControlNet(ControlNetConfig(unet=port_unet_config(JTINY)))


def _inputs(b: int, lat: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, lat, lat, 4)).astype(np.float32)
    hint = rng.random((b, 8 * lat, 8 * lat, 3)).astype(np.float32)
    ctx = (rng.standard_normal((b, 77, 64)) * 0.5).astype(np.float32)
    return x, hint, ctx


def _assert_controls_close(out: dict, ref: dict):
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert len(out[k]) == len(ref[k]), k
        for i, (a, b) in enumerate(zip(out[k], ref[k])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"{k}[{i}]", **TOL)


# --- the ControlNet module ------------------------------------------------------


def test_controlnet_init_tree_matches_jax_and_converts():
    """``ControlNet.init`` draws the JAX package's tree (keys and shapes, by
    ``jax.eval_shape`` of its ``init``), its zero-initialised leaves are
    zeros, and ``params_from_numpy`` carries a ControlNet tree over leaf by
    leaf."""
    jcn, cn = _nets()
    shapes = jax.eval_shape(jcn.init, jax.random.PRNGKey(0))
    tp = cn.init(torch.Generator().manual_seed(0), device="cpu")
    flat_t = {k: tuple(v.shape) for k, v in _flatten(tp).items()}
    assert flat_t == {k: tuple(v.shape) for k, v in _flatten(shapes).items()}
    for name in ("weight", "bias"):
        assert not tp["middle_block_out"]["0"][name].any()
        assert not tp["input_hint_block"]["14"][name].any()
        assert not any(z["0"][name].any() for z in tp["zero_convs"].values())
        assert tp["input_hint_block"]["12"]["weight"].any()
    p = perturbed_controlnet(3)
    conv = params_from_numpy(p, "cpu")
    for k, v in _flatten(conv).items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), _flatten(p)[k], err_msg=k)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("t0,percent_range,on", [
    (999.0, (0.0, 1.0), True),
    (999.0, (0.5, 1.0), False),   # denoise progress 0 is before the range
    (100.0, (0.5, 1.0), True),
    (100.0, (0.0, 0.5), False),   # progress 0.9 is past it
])
def test_controlnet_apply_matches_jax(t0, percent_range, on):
    """``apply_hint`` and ``apply`` with perturbed zero convs, the percent
    gate on and off. The gate reads row 0's timestep for the whole batch:
    row 1 sits at another timestep and is gated with row 0."""
    jcn, cn = _nets()
    p = perturbed_controlnet(3)
    jp, tp = _jnp_tree(p), params_from_numpy(p, "cpu")
    x, hint, ctx = _inputs(2, 8)
    t = np.array([t0, 999.0 - t0 + 1.0], np.float32)

    ref_hint = jax.jit(jcn.apply_hint)(jp, jnp.asarray(hint))
    out_hint = cn.apply_hint(tp, torch.from_numpy(hint))
    np.testing.assert_allclose(out_hint.numpy(), np.asarray(ref_hint), **TOL)
    assert float(np.abs(np.asarray(ref_hint)).mean()) > 1e-3  # the perturbed last conv

    kw = dict(strength=0.6, percent_range=percent_range)
    ref = jax.jit(lambda *a: jcn.apply(*a, **kw))(
        jp, jnp.asarray(x), jnp.asarray(hint), jnp.asarray(t), jnp.asarray(ctx))
    out = cn.apply(tp, *(torch.from_numpy(a) for a in (x, hint, t, ctx)), **kw)
    _assert_controls_close(out, ref)
    # the hint tower's output handed in, as the pipeline hands it in
    given = cn.apply(tp, torch.from_numpy(x), None, torch.from_numpy(t), torch.from_numpy(ctx),
                     guided_hint=out_hint, **kw)
    for k in out:
        assert all(torch.equal(a, b) for a, b in zip(out[k], given[k]))
    assert len(out["output"]) == 4 and len(out["middle"]) == 1  # tiny plan: 4 input blocks
    mags = [float(o.abs().mean()) for o in out["output"] + out["middle"]]
    assert all(m > 1e-3 for m in mags) if on else not any(mags)


def test_unet_apply_with_control_matches_jax():
    """``UNetModel.apply`` with a control dict: ``output`` residuals popped
    onto the skip connections, ``middle`` after the middle block and
    ``input`` (None where absent) after the input blocks."""
    from stable_renderer_tpu.models.unet import TINY_UNET_CONFIG as JTINY, UNetModel as JUNet

    from stable_renderer_tpu_torch.models.unet import UNetModel

    junet = JUNet(JTINY)
    unet = UNetModel(port_unet_config(JTINY))
    p = _np_tree(unet.init(torch.Generator().manual_seed(2), device="cpu"))
    x, _, ctx = _inputs(2, 8, seed=4)
    t = np.array([700.0, 300.0], np.float32)
    jcn, cn = _nets()
    ctl = jax.jit(jcn.apply)(_jnp_tree(perturbed_controlnet(5)), jnp.asarray(x),
                             jnp.asarray(np.random.default_rng(6).random((2, 64, 64, 3),
                                                                         np.float32)),
                             jnp.asarray(t), jnp.asarray(ctx))
    ctl = {k: [np.array(a) for a in v] for k, v in ctl.items()}
    ctl["input"] = [None, ctl["output"][1] * 0.5, None, ctl["output"][3]]
    ref = jax.jit(lambda p_, x_, t_, c_, k_: junet.apply(p_, x_, t_, c_, control=k_))(
        _jnp_tree(p), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        {k: [None if a is None else jnp.asarray(a) for a in v] for k, v in ctl.items()})
    out = unet.apply(params_from_numpy(p, "cpu"), torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(ctx),
                     control={k: [None if a is None else torch.from_numpy(a) for a in v]
                              for k, v in ctl.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    plain = unet.apply(params_from_numpy(p, "cpu"), torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(ctx))
    assert float((out - plain).abs().mean()) > 1e-2  # the residuals moved the output


@functools.lru_cache(maxsize=None)
def _pipelines():
    """A tiny JAX pipeline and the port's over the same params, each with two
    perturbed ControlNets (normal, strength 0.6, and depth, 0.6, as
    bench.py's control mode chains them). Shared: callers do not change
    them."""
    from test_torch_frame import _port_pipeline

    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.workflow.config import ControlNetSpec as JSpec, RenderConfig as JConfig

    from stable_renderer_tpu_torch.workflow.config import ControlNetSpec, RenderConfig

    kw = dict(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform")
    jpipe = JPipe.from_random(JConfig(**kw), tiny=True, seed=0)
    pipe = _port_pipeline(jpipe, RenderConfig(**kw))
    for source, seed in (("normal", 5), ("depth", 6)):
        p = perturbed_controlnet(seed)
        jpipe.add_controlnet(_jnp_tree(p), JSpec(source=source, strength=0.6))
        pipe.add_controlnet(params_from_numpy(p, "cpu"), ControlNetSpec(source=source,
                                                                         strength=0.6))
    return jpipe, pipe


def test_make_control_fn_sums_two_nets_like_jax():
    """Two chained ControlNets: each hint resized to 8x the latent and tiled
    to the cfg batch, the residuals summed entry by entry. A second
    evaluation of the same callable (another latent and timestep, the hint
    towers' outputs kept from the first) still matches."""
    jpipe, pipe = _pipelines()
    assert [s.source for _, _, s in pipe.controlnets] == ["normal", "depth"]
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
    # the normal net alone: the depth net's share is not zero
    alone = replace(pipe, controlnets=pipe.controlnets[:1])._make_control_fn(
        tuple(torch.from_numpy(h) for h in hints[:1]))(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert float((out["middle"][0] - alone["middle"][0]).abs().mean()) > 1e-3


def _frame_inputs(size: int = 32, seed: int = 12):
    rng = np.random.default_rng(seed)
    ids = np.zeros((1, size, size, 4), np.int32)
    ids[..., :2] = 1
    ids[..., 2] = rng.integers(0, 9, (1, size, size))
    ids[..., 3] = rng.integers(0, 40, (1, size, size))
    ids[:, :4] = 0
    return dict(color=rng.random((1, size, size, 3)).astype(np.float32),
                noise=rng.standard_normal((1, size // 8, size // 8, 4)).astype(np.float32),
                id=ids,
                normal=rng.random((1, size, size, 3)).astype(np.float32),
                depth=np.repeat(rng.random((1, size, size, 1)), 3, -1).astype(np.float32))


def _jax_lcm_draws(key, lat_shape, steps: int = 4) -> list:
    """The sequential LCM sampler's re-noise draws inside ``_jit_render``
    (samplers.py:251-255), as tests/test_torch_frame.py takes them."""
    k = jax.random.fold_in(jnp.asarray(key), 1)
    out = []
    for _ in range(steps):
        k, sub = jax.random.split(k)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, lat_shape))))
    return out


def _jax_render(jpipe, inp, key):
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap

    _, jctx, jnctx, _, _ = jpipe.prepare_conditioning({}, (), 1)
    jhints = tuple(jnp.asarray(inp[spec.source]) for _, _, spec in jpipe.controlnets)
    return jpipe._jit_render(
        JOverlap(vertex_segments=64, update_corrmap=False), (), *jpipe.compute_params(),
        jnp.asarray(inp["color"]), jnp.asarray(inp["noise"]), jnp.asarray(inp["id"]), jhints,
        jctx, jnctx, jpipe.scheduler_sigmas(), jnp.asarray(key),
        normal_maps=jnp.asarray(inp["normal"]))


def _port_render(pipe, inp, key=None):
    """The port's ``_render`` on ``inp``; with ``key``, the LCM draws JAX's
    ``_jit_render`` makes for it are handed in."""
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    _, ctx, nctx, _, _ = pipe.prepare_conditioning({}, (), 1)
    size = inp["color"].shape[1]
    hints = tuple(torch.from_numpy(inp[spec.source]) for _, _, spec in pipe.controlnets)
    return pipe._render(
        OverlapCorresponder(vertex_segments=64, update_corrmap=False), (),
        *pipe.compute_params(), torch.from_numpy(inp["color"]), torch.from_numpy(inp["noise"]),
        torch.from_numpy(inp["id"]), hints, ctx, nctx, pipe.scheduler_sigmas(), None,
        normal_maps=torch.from_numpy(inp["normal"]),
        step_noise=None if key is None else _jax_lcm_draws(key, (1, size // 2, size // 2, 4)))


def test_control_frame_matches_jax():
    """The sequential frame with two perturbed ControlNets (normal + depth
    hints), the port's ``_render`` against JAX's ``_jit_render``, with JAX's
    sampler draws handed in; the ControlNets move the frame."""
    jpipe, pipe = _pipelines()
    inp = _frame_inputs()
    key = np.array([0, 3], np.uint32)
    out, ref = _port_render(pipe, inp, key), _jax_render(jpipe, inp, key)
    assert out.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    bare = _port_render(replace(pipe, controlnets=[]), inp, key)
    assert float((out - bare).abs().mean()) > 1e-3


def test_zero_init_controlnet_leaves_frame_unchanged():
    """``add_random_controlnet`` (zero-initialised zero convs): the frame
    equals the plain frame bit for bit, as a zero residual adds nothing."""
    from test_torch_frame import _port_pipeline

    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.workflow.config import ControlNetSpec, RenderConfig

    kw = dict(prompt="a ball", steps=2, cfg_scale=2.0, sampler="euler", scheduler="sgm_uniform")
    pipe = _port_pipeline(JPipe.from_random(JConfig(**kw), tiny=True, seed=0), RenderConfig(**kw))
    inp = _frame_inputs(seed=14)
    plain = _port_render(pipe, inp)
    pipe.add_random_controlnet(ControlNetSpec(source="normal", strength=0.6), seed=5)
    pipe.add_random_controlnet(ControlNetSpec(source="depth", strength=0.6), seed=6)
    assert len(pipe.compute_params()[2]) == 2
    np.testing.assert_array_equal(_port_render(pipe, inp).numpy(), plain.numpy())


def test_unported_control_paths_raise():
    """The control checkpoints that raised before their slice now build
    controls (tests/test_torch_control_checkpoints.py holds them to JAX).
    ``y`` on a UNet with neither class labels nor an ADM width is ignored,
    as the JAX package's UNet ignores it: the output with ``y`` equals the
    output without, and JAX's with the same params."""
    from stable_renderer_tpu.models.unet import TINY_UNET_CONFIG as JTINY, UNetModel as JUNet

    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow.config import ControlNetSpec

    pipe = DiffusionPipeline.from_random(tiny=True, device="cpu")
    spec = ControlNetSpec()
    _, cn = _nets()
    composed = cn.init_control_lora(pipe.unet_params, {"lora_controlnet": torch.zeros(0)})
    assert composed["input_blocks"].keys() == pipe.unet_params["input_blocks"].keys()
    pipe.add_control_lora({"lora_controlnet": torch.zeros(0)}, spec)
    pipe.add_control_from_state_dict({"conv_in.weight": torch.zeros(32, 192, 3, 3),
                                      "body.0.block2.weight": torch.zeros(32, 32, 1, 1)}, spec)
    assert [type(c).__name__ for c, _, _ in pipe.controlnets] == ["ControlNet", "T2IAdapter"]
    x, _, ctx = _inputs(1, 8, seed=3)
    args = (torch.from_numpy(x), torch.full((1,), 500.0), torch.from_numpy(ctx))
    with_y = pipe.unet.apply(pipe.unet_params, *args, y=torch.ones(1, 16))
    torch.testing.assert_close(with_y, pipe.unet.apply(pipe.unet_params, *args), rtol=0, atol=0)
    jp = _jnp_tree(_np_tree(pipe.unet_params))
    ref = JUNet(JTINY).apply(jp, jnp.asarray(x), jnp.full((1,), 500.0), jnp.asarray(ctx),
                             y=jnp.ones((1, 16)))
    np.testing.assert_allclose(with_y.numpy(), np.asarray(ref), **TOL)
