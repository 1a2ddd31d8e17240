"""Multi-device serving (stable_renderer_tpu_torch/parallel/): the specs
and shards, tensor parallelism, the mesh render and ``bench_torch.py --dp``,
against the JAX package's on its 8-device virtual CPU mesh
(tests/test_torch_mesh_stream_ring.py holds the stream mesh, the ring and
the sharded CorrespondMap update).

The port runs one process a rank: the multi-rank cases spawn 2 or 4 gloo
ranks (tests/torch_mesh_ranks.py, which imports no JAX), each with one CPU
thread, on a file store under the test's temporary directory; this process
computes the JAX side and the port's one-process reference and compares.
Inputs come from numpy seeds, or are handed across (the tiny tokenizer's
encodings, the LCM draws).

Tolerances: the port's mesh run against its one-process run 3e-4 (the JAX
package's own bar for its sharded render, tests/test_parallel.py), against
the JAX package 2e-4 (the frame bar of tests/test_torch_frame.py), the TP
UNet forward 5e-4 (tests/test_parallel.py's).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP
from torch_mesh_ranks import launch, pipeline_payload, rank_render, rank_tp

from stable_renderer_tpu_torch.convert import params_from_numpy

torch.set_num_threads(1)

MESH_TOL = dict(atol=3e-4, rtol=0)
JAX_TOL = dict(atol=2e-4, rtol=2e-4)
N, SIZE = 8, 32


def _jax_mesh(shape):
    from stable_renderer_tpu.parallel import create_mesh

    return create_mesh(shape, devices=jax.devices()[:int(np.prod(list(shape.values())))])


def _pipes(**kw):
    """The JAX package's tiny pipeline and the port's over its params."""
    from test_torch_frame import _port_pipeline

    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(dict(prompt="a ball", steps=2, cfg_scale=2.0, sampler="euler"), **kw)
    jpipe = JPipe.from_random(JConfig(**kw), tiny=True)
    return jpipe, _port_pipeline(jpipe, RenderConfig(**kw))


def _batch(with_ids: bool = True) -> dict:
    """tests/test_parallel.py's sharded-render batch, from numpy: 8 frames of
    32x32, a 16x16 block of vertex ids, pooled noise maps."""
    rng = np.random.default_rng(0)
    arrays = dict(frame_indices=np.arange(N, dtype=np.int32),
                  color_maps=rng.random((N, SIZE, SIZE, 3)).astype(np.float32),
                  noise_maps=rng.standard_normal((N, SIZE // 2, SIZE // 2, 4)).astype(np.float32))
    if with_ids:
        ids = np.zeros((N, SIZE, SIZE, 4), np.int32)
        ids[:, 8:24, 8:24, 3] = np.arange(256, dtype=np.int32).reshape(16, 16) + 1
        ids[:, 8:24, 8:24, 0] = 1
        arrays["id_maps"] = ids
    return arrays


def _engine_data(arrays: dict):
    from stable_renderer_tpu.data.engine_data import EngineData as JEngineData
    from stable_renderer_tpu_torch.data.engine_data import EngineData

    return (JEngineData(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            EngineData(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _same_on_every_rank(outs, key):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key].numpy(), outs[0][key].numpy())


# --- in one process ------------------------------------------------------------------


def test_mesh_shapes_and_specs_match_jax():
    """``default_mesh_shape`` as JAX's; ``unet_param_specs`` equal to JAX's
    leaf for leaf on the tiny UNet and a tiny ControlNet."""
    from test_torch_controlnet import perturbed_controlnet

    from stable_renderer_tpu.models.weights import flatten as jflatten
    from stable_renderer_tpu.parallel import default_mesh_shape as jshape
    from stable_renderer_tpu.parallel import unet_param_specs as jspecs
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG, UNetModel
    from stable_renderer_tpu_torch.models.weights import flatten
    from stable_renderer_tpu_torch.parallel import P, default_mesh_shape, unet_param_specs

    for n, tp in ((8, 1), (8, 2), (6, 4), (1, 1), (4, 4)):
        assert default_mesh_shape(n, tp) == jshape(n, tp)
    unet = UNetModel(TINY_UNET_CONFIG).init(torch.Generator().manual_seed(0), device="cpu")
    for tree in (jax.tree_util.tree_map(lambda t: t.numpy(), unet), perturbed_controlnet(5)):
        ref = jflatten(jspecs(tree))
        got = flatten(unet_param_specs(params_from_numpy(tree, "cpu")))
        assert sorted(got) == sorted(ref)
        assert all(tuple(got[k]) == tuple(ref[k]) for k in ref), [
            k for k in ref if tuple(got[k]) != tuple(ref[k])][:5]
        assert sum(s == P("tp", None) for s in got.values()) > 10
    blk = "input_blocks.1.1.transformer_blocks.0."
    assert got[blk + "ff.net.0.proj.bias"] == P("tp") and got[blk + "ff.net.2.weight"] == P(
        None, "tp") and got["input_blocks.0.0.weight"] == P()


def test_geglu_split_lines_up_and_naive_chunk_does_not():
    """Two tensor-parallel ranks' MLPs summed: with the port's shards (each
    GEGLU half split on its own) they give the whole MLP; with a contiguous
    chunk of the [x; gate] projection (rank 0 all x columns, rank 1 all gate
    columns) they do not."""
    import torch.nn.functional as F

    from stable_renderer_tpu_torch.models.layers import geglu, linear
    from stable_renderer_tpu_torch.models.unet import UNetModel, TINY_UNET_CONFIG
    from stable_renderer_tpu_torch.parallel.mesh import FrameShard
    from stable_renderer_tpu_torch.parallel.sharding import shard_params

    params = UNetModel(TINY_UNET_CONFIG).init(torch.Generator().manual_seed(0), device="cpu")
    ff = params["input_blocks"]["1"]["1"]["transformer_blocks"]["0"]["ff"]["net"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 32)).astype(
        np.float32))
    whole = linear(ff["2"], geglu(ff["0"], x))

    def summed(shards):
        parts = [F.linear(geglu(s["0"], x), s["2"]["weight"]) for s in shards]
        return sum(parts) + ff["2"]["bias"]

    port = summed([shard_params({"ff": {"net": ff}}, FrameShard(None, r, 2))["ff"]["net"]
                   for r in range(2)])
    np.testing.assert_allclose(port.numpy(), whole.numpy(), atol=1e-5, rtol=1e-5)
    naive = [{"0": {"proj": {"weight": ff["0"]["proj"]["weight"].chunk(2, 0)[r],
                             "bias": ff["0"]["proj"]["bias"].chunk(2, 0)[r]}},
              "2": {"weight": ff["2"]["weight"].chunk(2, 1)[r]}} for r in range(2)]
    assert (summed(naive) - whole).abs().max() > 1e-2
    with pytest.raises(ValueError, match="do not divide"):
        shard_params({"ff": {"net": ff}}, FrameShard(None, 0, 3))


# --- tensor parallelism, 2 ranks --------------------------------------------------


def test_tp_unet_controlnet_render_and_cache(tmp_path):
    """{"dp": 1, "tp": 2}: the UNet forward on each rank's Megatron shards
    against JAX's apply on its dp 4 x tp 2 mesh; a tiny ControlNet's
    residuals against the port's unsharded ones; the tp-only render (no
    corresponder hooks) against JAX's render(mesh=mesh8) and the port's
    one-process render; compute_params' cache kept for one mesh and dropped
    by a new UNet tree; hooks that need every head (gathered over tp): the
    UNet with a post hook that mixes the heads, and a CFG denoiser with SAG
    over a model patch's attn_all, against JAX's unsharded ones; a mesh
    shape that does not cover the world raises."""
    from test_torch_controlnet import perturbed_controlnet

    from stable_renderer_tpu.models import TINY_UNET_CONFIG, UNetModel
    from stable_renderer_tpu.models.layers import attention as jattention
    from stable_renderer_tpu.models.sampling import ModelSampling
    from stable_renderer_tpu.models.sampling.cfg import make_denoiser as make_jdenoiser
    from stable_renderer_tpu.models.unet import AttnHooks as JHooks
    from stable_renderer_tpu.parallel import apply_param_sharding as japply
    from stable_renderer_tpu_torch.models.controlnet import ControlNet, ControlNetConfig

    jpipe, pipe = _pipes()
    arrays = _batch(with_ids=False)
    jed, ed = _engine_data(arrays)
    mesh8 = _jax_mesh({"dp": 4, "tp": 2})
    jref = np.asarray(jpipe.render(jed, key=jax.random.PRNGKey(3), mesh=mesh8))
    ref = pipe.render(ed, key=torch.Generator().manual_seed(3)).numpy()

    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16, 16, 4)).astype(np.float32)
    t = np.full((4,), 500.0, np.float32)
    ctx = rng.standard_normal((4, 7, TINY_UNET_CONFIG.context_dim)).astype(np.float32)
    hint = rng.random((4, 128, 128, 3)).astype(np.float32)
    junet = UNetModel(TINY_UNET_CONFIG)
    dp = NamedSharding(mesh8, JP("dp"))
    unet_out = np.asarray(jax.jit(lambda p, a, b, c: junet.apply(p, a, b, c))(
        japply(jax.tree_util.tree_map(jnp.asarray, jpipe.unet_params), mesh8),
        jax.device_put(x, dp), jnp.asarray(t), jax.device_put(ctx, dp)))
    cn_params = params_from_numpy(perturbed_controlnet(5), "cpu")
    with torch.no_grad():
        ctl = ControlNet(ControlNetConfig(unet=pipe.unet.config)).apply(
            cn_params, *(torch.from_numpy(a) for a in (x, hint, t, ctx)))
    control = [r for k in sorted(ctl) for r in ctl[k] if r is not None]
    jp = jax.tree_util.tree_map(jnp.asarray, jpipe.unet_params)
    post_out = np.asarray(jax.jit(lambda p, a, b, c: junet.apply(p, a, b, c, hooks=JHooks(
        post=lambda vals, layer: vals + (0.1 + 0.05 * layer) * jnp.flip(vals, -1))))(
        jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    sag = (0.8, 2.0, 2)  # the tiny UNet's middle transformer is layer 2
    cond, uncond = ctx[:2], rng.standard_normal((2, 7, TINY_UNET_CONFIG.context_dim)).astype(
        np.float32)
    ms = ModelSampling()
    sigma = np.float32(ms.sigmas[500])
    sag_out = np.asarray(jax.jit(make_jdenoiser(
        junet, jp, jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(ms.log_sigmas),
        cfg_scale=2.0, sag=sag, hooks=JHooks(attn_all=lambda q, k, v, heads, layer: jattention(
            q, k * 0.5, v, heads))))(jnp.asarray(x[:2]), jnp.asarray(sigma)))

    outs = launch(rank_tp, 2, tmp_path, dict(
        pipe=pipeline_payload(pipe), ed={k: torch.from_numpy(v) for k, v in arrays.items()},
        x=torch.from_numpy(x), t=torch.from_numpy(t), ctx=torch.from_numpy(ctx),
        hint=torch.from_numpy(hint), cn_params=cn_params, cond=torch.from_numpy(cond),
        uncond=torch.from_numpy(uncond), log_sigmas=torch.from_numpy(ms.log_sigmas), sag=sag,
        x_sag=torch.from_numpy(x[:2]), sigma=torch.tensor(sigma)))
    for o in outs:
        assert "does not cover 2 ranks" in o["cover_error"]
        assert o["q_rows"] == TINY_UNET_CONFIG.model_channels // 2
        np.testing.assert_allclose(o["unet"].numpy(), unet_out, atol=5e-4, rtol=0)
        assert len(o["control"]) == len(control)
        for a, b in zip(o["control"], control):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
        assert o["render"].shape == (N, SIZE, SIZE, 3)
        np.testing.assert_allclose(o["render"].numpy(), ref, **MESH_TOL)
        np.testing.assert_allclose(o["render"].numpy(), jref, **JAX_TOL)
        assert o["cache"] == (True, True)
        np.testing.assert_allclose(o["post"].numpy(), post_out, atol=5e-4, rtol=0)
        assert np.abs(post_out - unet_out).max() > 1e-2  # the hook acted
        np.testing.assert_allclose(o["sag_attn_all"].numpy(), sag_out, atol=5e-4, rtol=0)
    _same_on_every_rank(outs, "render")


# --- the mesh render, 4 ranks ---------------------------------------------------------


def test_mesh_render_matches_jax_and_one_process(tmp_path):
    """tests/test_parallel.py's sharded render (8 frames of 32x32, euler, 2
    steps, an OverlapCorresponder with frame 1's K/V broadcast at layer 6 and
    vertex averaging, noise maps given) on dp 2 x tp 2 and dp 4: every rank
    returns the whole batch, within JAX's bar of the port's one-process
    render and of JAX's render(mesh=mesh8). A random pick of the injected
    frame (the same bits on every rank, mapped over the whole batch) and the
    frame-distance weighting (frames counted in the whole batch) against the
    one-process render; ``shard_engine_data`` gives each rank its frames."""
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    jpipe, pipe = _pipes()
    arrays = _batch()
    jed, ed = _engine_data(arrays)
    kw = dict(vertex_segments=512, update_corrmap=False)
    jref = np.asarray(jpipe.render(jed, corresponder=JOverlap(**kw), key=jax.random.PRNGKey(3),
                                   mesh=_jax_mesh({"dp": 4, "tp": 2})))
    cases = [("dp2tp2", {"dp": 2, "tp": 2}, kw, False), ("dp4", {"dp": 4, "tp": 1}, kw, False),
             ("random_pick", {"dp": 2, "tp": 2},
              dict(kw, pre_attn_frames=None, layer_range=None), False),
             ("frame_distance", {"dp": 4, "tp": 1}, dict(kw, weighting="frame_distance"), False)]
    refs = {name: pipe.render(ed, corresponder=OverlapCorresponder(**ckw),
                              key=torch.Generator().manual_seed(3)).numpy()
            for name, _, ckw, _ in cases}
    np.testing.assert_allclose(refs["dp4"], jref, **JAX_TOL)
    outs = launch(rank_render, 4, tmp_path, dict(
        pipe=pipeline_payload(pipe), ed={k: torch.from_numpy(v) for k, v in arrays.items()},
        cases=cases))
    for name, _, _, _ in cases:
        _same_on_every_rank(outs, name)
        np.testing.assert_allclose(outs[0][name].numpy(), refs[name], err_msg=name, **MESH_TOL)
    for name in ("dp2tp2", "dp4"):
        np.testing.assert_allclose(outs[0][name].numpy(), jref, err_msg=name, **JAX_TOL)
    assert np.abs(refs["random_pick"] - refs["dp4"]).max() > 1e-4  # another injected frame
    for r, o in enumerate(outs):
        frames, color, pos, env = o["local_frames"]
        assert frames.tolist() == [2 * r, 2 * r + 1] and pos is None and env == ()
        np.testing.assert_array_equal(color.numpy(), arrays["color_maps"][2 * r:2 * r + 2])


# --- one rank in this process ----------------------------------------------------------


def test_engine_stream_mesh_on_one_rank():
    """``Engine.Run`` of a stream pipeline whose stream mesh is a one-rank
    gloo mesh (the managers hand the frame ``stream_params``): the frames
    equal the run without a mesh bit for bit. ``init_distributed`` keeps a
    group that is up; a mesh shape must cover the world."""
    import torch.distributed as dist

    import stable_renderer_tpu_torch.engine as P
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.parallel import create_mesh, init_distributed
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    def run(mesh, frames=3):
        pipe = DiffusionPipeline.from_random(
            RenderConfig(stream_pipeline=True, stream_kv_layers=(2,)), tiny=True, device="cpu")
        if mesh is not None:
            pipe.enable_stream_mesh(mesh)
        out = []
        P.Engine.Run(winSize=(16, 16), pipeline=pipe, max_frames=frames,
                     frame_callback=lambda f, i: out.append(np.array(f)))
        return out

    plain = run(None)
    assert init_distributed("cpu") == torch.device("cpu")
    try:
        assert init_distributed("cpu") == torch.device("cpu")  # kept
        mesh = create_mesh({"dp": 1, "tp": 1})
        meshed = run(mesh)
        assert len(meshed) == len(plain) == 3
        for a, b in zip(meshed, plain):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="does not cover 1 ranks"):
            create_mesh({"dp": 2, "tp": 1})
    finally:
        dist.destroy_process_group()


# --- bench_torch.py --dp, one rank ------------------------------------------------------


def test_bench_dp_on_the_cpu(monkeypatch, capsys):
    """``bench_torch.py --dp --device cpu`` on the tiny pipeline: one gloo
    rank on a file store, bench.py's --dp line (batch 8, dp 1), the TF32
    note first on stderr; the group it started is gone after."""
    import torch.distributed as dist

    import bench_torch

    for k in list(os.environ):
        if k.startswith("SR_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("SR_BENCH_QUICK", "1")
    monkeypatch.setenv("SR_BENCH_FRAMES", "2")
    line = bench_torch.main(["--dp", "--device", "cpu"])
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == line
    assert line["metric"] == ("bake-batched img2img frames/s @ 64x64, 4-step LCM cfg2, "
                              "batch=8, dp=1 (cpu)")
    assert line["unit"] == "frames/s" and line["value"] > 0
    assert err.splitlines()[0].startswith("# matmul.allow_tf32=") and "# compile" in err
    assert not dist.is_initialized()
