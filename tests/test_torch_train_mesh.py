"""The training step over a mesh (stable_renderer_tpu_torch/parallel/train.py
with Megatron tensor parallelism in models/unet.py) on spawned gloo ranks
(tests/torch_mesh_ranks.py), against the JAX package's unsharded
diffusion_train_step and the port's one-process step; and the step and
the pipelines on a one-rank mesh in this process, against no mesh.

Inputs and bars are tests/test_torch_train.py's (TINY_UNET_CONFIG, batch 4,
JAX's draws, lr 1e-3, 3 steps; params within TRAIN_PARAM_TOL, losses within
LOSS_RTOL). The level-0 self-attention takes FlashAttentionFn in every port
run (its threshold lowered to the tiny UNet's 256 keys), so the runs see the
gradient through K1's route: with its plain backward swapped for a no-op,
the params leave the bar.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_train import (
    LEVEL0_ATTENTIONS,
    LOSS_RTOL,
    LR,
    STEPS,
    TRAIN_PARAM_TOL,
    assert_params,
    flat_numpy,
    jax_steps,
    port_steps,
)
from torch_mesh_ranks import launch, rank_train

torch.set_num_threads(1)

MIN_KV = 256  # the tiny UNet's level-0 keys: FlashAttentionFn's route


@pytest.fixture(scope="module")
def runs():
    """JAX's 3 steps and the port's one-process steps through K1's route."""
    from stable_renderer_tpu_torch.ops import flash_attention as fa

    states, losses, draws, data = jax_steps(STEPS)
    mp = pytest.MonkeyPatch()
    mp.setattr(fa, "FLASH_MIN_KV_LEN", MIN_KV)
    try:
        port = port_steps(states[0].params, draws, data)
    finally:
        mp.undo()
    return states, losses, draws, data, port


def _payload(runs, shape, cases):
    from stable_renderer_tpu_torch.convert import params_from_numpy
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG

    states, _, draws, (lat, ctx, sig), _ = runs
    return dict(params=params_from_numpy(states[0].params, "cpu"), config=TINY_UNET_CONFIG,
                sigmas=torch.from_numpy(sig), latents=torch.from_numpy(lat),
                context=torch.from_numpy(ctx), lr=LR, min_kv=MIN_KV, shape=shape, cases=cases,
                draws=[(torch.from_numpy(t), torch.from_numpy(e)) for t, e in draws])


def _unshard(locals_: list, tp: int) -> dict:
    """The whole tree (flat numpy) from the tp ranks' shards, by the specs
    of ``unet_param_specs``; every replicated leaf equal on the tp ranks."""
    from stable_renderer_tpu_torch.models.weights import flatten
    from stable_renderer_tpu_torch.parallel.sharding import _GEGLU, unet_param_specs

    flats = [flatten(t) for t in locals_]
    specs = flatten(unet_param_specs(locals_[0]))
    out = {}
    for path, spec in specs.items():
        parts = [f[path] for f in flats]
        if spec and spec[0] == "tp":
            if path.rsplit(".", 1)[0].endswith(_GEGLU):
                halves = [p.chunk(2, 0) for p in parts]
                whole = torch.cat([h[0] for h in halves] + [h[1] for h in halves])
            else:
                whole = torch.cat(parts, 0)
        elif len(spec) == 2 and spec[1] == "tp":
            whole = torch.cat(parts, 1)
        else:
            for p in parts[1:]:
                assert torch.equal(p, parts[0]), f"replicated {path} differs across tp ranks"
            whole = parts[0]
        out[path] = whole.double().numpy()
    assert len(parts) == tp
    return out


@pytest.mark.parametrize("world,shape,cases", [
    (2, {"dp": 1, "tp": 2}, [("tp2", False, "plain"), ("noop", False, "noop")]),
    (4, {"dp": 2, "tp": 2}, [("dp2tp2_remat", True, "plain")]),
])
def test_mesh_train_steps_match_jax(tmp_path, runs, world, shape, cases):
    """3 steps on the mesh (with remat on the 4-rank run): losses and the
    gathered params against JAX's unsharded step and the port's
    one-process step; every replicated leaf equal across the tp ranks and
    the dp replicas equal; K1's plain backward called once a level-0
    self-attention a step. With it swapped for a tracked no-op the params
    fail the comparison."""
    states, losses, _, _, port = runs
    outs = launch(rank_train, world, tmp_path, _payload(runs, shape, cases), timeout=240.0)
    tp = shape["tp"]
    want_jax = flat_numpy(states[-1].params)
    for name, _, backward in cases:
        for r in range(tp, world):  # the dp replicas of tp rank r % tp
            replica = flat_numpy(outs[r % tp][name]["params"])
            for k, v in flat_numpy(outs[r][name]["params"]).items():
                np.testing.assert_array_equal(v, replica[k], err_msg=f"rank {r} {k}")
        got = _unshard([outs[r][name]["params"] for r in range(tp)], tp)
        for o in outs:
            assert o[name]["step"] == STEPS
            assert o[name]["grad_calls"] == LEVEL0_ATTENTIONS * STEPS
            assert o[name]["losses"] == outs[0][name]["losses"]
        if backward == "noop":
            err = max(np.abs(got[k] - want_jax[k]).max() for k in want_jax)
            assert err > TRAIN_PARAM_TOL, f"no attention gradient, yet params within {err:.3e}"
            continue
        np.testing.assert_allclose(outs[0][name]["losses"], losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(outs[0][name]["losses"], port["losses"], rtol=LOSS_RTOL)
        assert_params(got, want_jax, TRAIN_PARAM_TOL, f"{name} against JAX")
        assert_params(got, port["params"][-1], TRAIN_PARAM_TOL, f"{name} against one process")


def test_one_rank_mesh_equals_no_mesh():
    """On a one-process gloo group: the step on {"dp": 1, "tp": 1}, with
    and without remat, and pipeline_apply, clip_pipeline_encode and
    unet_middle_pipeline on {"pp": 1} equal the mesh-less step and the
    sequential forms bit for bit."""
    import torch.distributed as dist

    from stable_renderer_tpu_torch.models.clip import TINY_CLIP_CONFIG, CLIPTextModel
    from stable_renderer_tpu_torch.models.unet import (
        AttnHooks,
        TINY_UNET_CONFIG,
        UNetConfig,
        UNetModel,
        res_block,
        spatial_transformer,
    )
    from stable_renderer_tpu_torch.models.weights import flatten
    from stable_renderer_tpu_torch.parallel import create_mesh, init_distributed
    from stable_renderer_tpu_torch.parallel.pipeline import (
        clip_pipeline_encode,
        pipeline_apply,
        stack_stage_params,
        unet_middle_pipeline,
    )
    from stable_renderer_tpu_torch.parallel.train import (
        diffusion_draws,
        diffusion_train_step,
        make_train_state,
    )
    from torch_mesh_ranks import mlp_stage

    gen = torch.Generator().manual_seed(0)
    unet = UNetModel(TINY_UNET_CONFIG)
    params = unet.init(gen)
    lat, ctx = torch.randn((2, 16, 16, 4), generator=gen), torch.randn((2, 77, 64), generator=gen)
    sig = torch.linspace(0.03, 14.6, 1000)
    t, eps = diffusion_draws(torch.Generator().manual_seed(1), 2, (16, 16, 4), 1000)
    assert t.shape == (2,) and eps.shape == (2, 16, 16, 4) and int(t.max()) < 1000
    init_distributed("cpu")
    try:
        meshes = {"dptp": create_mesh({"dp": 1, "tp": 1}), "pp": create_mesh({"pp": 1})}
        for remat in (False, True):
            got = []
            for mesh in (meshes["dptp"], None):
                st, opt = make_train_state(unet, params, learning_rate=LR)
                st, loss = diffusion_train_step(unet, opt, st, sig, lat, ctx, t, eps,
                                                remat=remat, mesh=mesh)
                got.append((loss, flatten(st.params)))
            assert torch.equal(got[0][0], got[1][0])
            assert all(torch.equal(v, got[1][1][k]) for k, v in got[0][1].items())

        stages = [{"w": torch.randn((8, 8), generator=gen) * 0.2,
                   "b": torch.randn(8, generator=gen) * 0.1}]
        x = torch.randn((6, 8), generator=gen)
        assert torch.equal(pipeline_apply(mlp_stage, stack_stage_params(stages), x,
                                          meshes["pp"]), mlp_stage(stages[0], x))

        clip = CLIPTextModel(TINY_CLIP_CONFIG)
        cparams = clip.init(gen)
        tokens = torch.randint(0, TINY_CLIP_CONFIG.vocab_size, (3, 77), generator=gen)
        assert torch.equal(clip_pipeline_encode(clip, cparams, tokens, meshes["pp"]),
                           clip.apply(cparams, tokens))

        cfg = UNetConfig(model_channels=8, num_res_blocks=1, channel_mult=(1, 2),
                         attention_levels=(0, 1), num_heads=2, context_dim=16,
                         transformer_depth_middle=4)
        mid = UNetModel(cfg)
        mparams = mid.init(gen)
        h, emb = torch.randn((2, 4, 4, 16), generator=gen), torch.randn((2, 32), generator=gen)
        mctx = torch.randn((2, 7, 16), generator=gen)
        mp = mparams["middle_block"]
        want, _ = spatial_transformer(mp["1"], res_block(mp["0"], h, emb), mctx, 2, 4, 0,
                                      AttnHooks())
        want = res_block(mp["2"], want, emb)
        assert torch.equal(unet_middle_pipeline(mid, mparams, h, emb, mctx, meshes["pp"]), want)
    finally:
        dist.destroy_process_group()
