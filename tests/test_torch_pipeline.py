"""GPipe (stable_renderer_tpu_torch/parallel/pipeline.py) over 2 and 4
spawned gloo ranks (tests/torch_mesh_ranks.py), against the JAX package's
pipeline_apply / clip_pipeline_encode / unet_middle_pipeline on a mesh of
its virtual CPU devices and against the sequential forms: the eight cases
of tests/test_pipeline_parallel.py, each world size's cases in one launch.

Bars are tests/test_pipeline_parallel.py's: the stage chains rtol 1e-6
(plus atol 1e-6 across the two packages, whose tanh rounds differently
near 0), CLIP 2e-5, the UNet middle atol 2e-5 rtol 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_ranks import launch, rank_pipeline

torch.set_num_threads(1)

CHAIN_TOL = dict(rtol=1e-6, atol=1e-6)
CLIP_TOL = dict(rtol=2e-5, atol=2e-5)
MIDDLE_TOL = dict(rtol=1e-5, atol=2e-5)


def _jax_mesh(shape):
    from stable_renderer_tpu.parallel import create_mesh

    return create_mesh(shape, devices=jax.devices()[:int(np.prod(list(shape.values())))])


def _stages(n, dim, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((dim, dim)) * 0.2).astype(np.float32),
             "b": (rng.standard_normal(dim) * 0.1).astype(np.float32)} for _ in range(n)]


def _jax_mlp(p, x):
    return jnp.tanh(x @ p["w"] + p["b"]) + x


def _jax_pytree(p, act):
    x, skip = act
    return jnp.tanh(x @ p["w"] + p["b"]) + skip, skip + 1.0


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _chain_case(name, kind, shape, n_stages, dim, batch, seed, **kw):
    """(port case, JAX's pipeline_apply result, the sequential fold)."""
    from stable_renderer_tpu.parallel.pipeline import pipeline_apply, stack_stage_params

    stages = _stages(n_stages, dim, seed)
    x = np.random.default_rng(seed + 100).standard_normal((batch, dim)).astype(np.float32)
    act = x if kind == "mlp" else (x, np.zeros_like(x))
    fn = _jax_mlp if kind == "mlp" else _jax_pytree
    got = pipeline_apply(fn, stack_stage_params(jax.tree_util.tree_map(jnp.asarray, stages)),
                         jax.tree_util.tree_map(jnp.asarray, act), _jax_mesh(shape), **kw)
    seq = jax.tree_util.tree_map(jnp.asarray, act)
    for p in stages:
        seq = fn(p, seq)
    case = (name, kind, shape, {"stages": _torch(stages), "x": _torch(act)}, kw)
    return case, jax.tree_util.tree_map(np.asarray, got), jax.tree_util.tree_map(np.asarray, seq)


def _clip(num_layers, vocab=101):
    from stable_renderer_tpu.models.clip import CLIPConfig, CLIPTextModel

    from stable_renderer_tpu_torch.models.clip import CLIPConfig as PConfig

    kw = dict(vocab_size=vocab, hidden_size=32, num_layers=num_layers, num_heads=2,
              intermediate_size=64)
    model = CLIPTextModel(CLIPConfig(**kw))
    return model, model.init(jax.random.PRNGKey(0)), PConfig(**kw)


def _middle():
    from stable_renderer_tpu.models.unet import UNetConfig, UNetModel

    from stable_renderer_tpu_torch.models.unet import UNetConfig as PConfig

    kw = dict(model_channels=8, num_res_blocks=1, channel_mult=(1, 2), attention_levels=(0, 1),
              num_heads=2, context_dim=16, transformer_depth_middle=4)
    unet = UNetModel(UNetConfig(**kw))
    return unet, unet.init(jax.random.PRNGKey(0)), PConfig(**kw)


def _compare(got, want, tol, what):
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what, **tol)


@pytest.mark.parametrize("world", [2, 4])
def test_pipelines_match_jax(tmp_path, world):
    """On ``world`` ranks: a stage chain on pp=world exact against the
    sequential fold and JAX's pipeline_apply; at 4 ranks also M = 12 > S
    microbatches, (x, skip) pytree activations and a pp 2 x dp 2 grid
    (batch_axis="dp"); an uneven batch raises; the CLIP tower with its 4
    layers on pp=world against JAX's clip_pipeline_encode and the replicated
    tower, 3 layers raise; the UNet middle of depth 4 on pp 2 x dp 2 (4
    ranks) against JAX's unet_middle_pipeline and the sequential middle.
    Every rank returns the whole batch."""
    from stable_renderer_tpu.parallel.pipeline import clip_pipeline_encode as jclip
    from stable_renderer_tpu.parallel.pipeline import unet_middle_pipeline as jmiddle

    pp = {"pp": world}
    grid = {"pp": 2, "dp": 2}
    chains = [_chain_case("exact", "mlp", pp, world, 16, 16, 0)]
    if world == 4:
        chains += [_chain_case("more_microbatches", "mlp", pp, 4, 8, 24, 2, num_microbatches=12),
                   _chain_case("pytree", "pytree", pp, 4, 8, 8, 4),
                   _chain_case("pp_dp", "mlp", grid, 2, 8, 16, 6, batch_axis="dp")]
    cases = [c for c, _, _ in chains]
    uneven = _stages(world, 8, 8)
    cases.append(("uneven", "mlp", pp, {"stages": _torch(uneven), "x": torch.zeros(10, 8)},
                  {"num_microbatches": 8}))

    jmodel, jparams, pcfg = _clip(4)
    tokens = np.random.default_rng(1).integers(0, 101, (8, 77)).astype(np.int32)
    want_clip = np.asarray(jclip(jmodel, jparams, jnp.asarray(tokens), _jax_mesh(pp)))
    want_tower = np.asarray(jmodel.apply(jparams, jnp.asarray(tokens)))
    cases.append(("clip", "clip", pp, {"config": pcfg, "params": _torch(jparams),
                                       "tokens": torch.from_numpy(tokens)}, {}))
    _, jparams3, pcfg3 = _clip(3, vocab=11)
    cases.append(("clip_indivisible", "clip", pp, {"config": pcfg3, "params": _torch(jparams3),
                                                   "tokens": torch.zeros(4, 77, dtype=torch.int32)},
                  {}))
    if world == 4:
        from stable_renderer_tpu.models.unet import AttnHooks, res_block, spatial_transformer

        unet, mparams, mcfg = _middle()
        rng = np.random.default_rng(3)
        h = rng.standard_normal((8, 4, 4, 16)).astype(np.float32)
        emb = rng.standard_normal((8, 32)).astype(np.float32)
        ctx = rng.standard_normal((8, 7, 16)).astype(np.float32)
        want_mid = np.asarray(jmiddle(unet, mparams, *(jnp.asarray(a) for a in (h, emb, ctx)),
                                      _jax_mesh(grid), batch_axis="dp"))
        mp = mparams["middle_block"]
        seq_mid, _ = spatial_transformer(mp["1"], res_block(mp["0"], jnp.asarray(h),
                                                            jnp.asarray(emb)),
                                         jnp.asarray(ctx), 2, 4, 0, AttnHooks())
        seq_mid = np.asarray(res_block(mp["2"], seq_mid, jnp.asarray(emb)))
        cases.append(("middle", "middle", grid, {"config": mcfg, "params": _torch(mparams),
                                                 **_torch({"h": h, "emb": emb, "ctx": ctx})},
                      {"batch_axis": "dp"}))

    outs = launch(rank_pipeline, world, tmp_path, {"cases": cases}, timeout=180.0)
    for o in outs:
        for (name, *_), jgot, seq in chains:
            _compare(o[name], seq, CHAIN_TOL, f"{name} against the sequential fold")
            _compare(o[name], jgot, CHAIN_TOL, f"{name} against JAX")
        assert "not divisible into 8 microbatches" in o["uneven"]
        _compare(o["clip"], want_clip, CLIP_TOL, "clip against JAX")
        _compare(o["clip"], want_tower, CLIP_TOL, "clip against the tower")
        assert "3 layers not divisible" in o["clip_indivisible"]
        if world == 4:
            _compare(o["middle"], want_mid, MIDDLE_TOL, "middle against JAX")
            _compare(o["middle"], seq_mid, MIDDLE_TOL, "middle against the sequential middle")
    for name in [c[0] for c in cases if not isinstance(outs[0][c[0]], str)]:
        for o in outs[1:]:
            for a, b in zip(jax.tree_util.tree_leaves(o[name]),
                            jax.tree_util.tree_leaves(outs[0][name])):
                assert torch.equal(a, b), f"{name}: ranks differ"


def test_pipeline_apply_rejects_an_empty_pytree():
    """An activation tree with no leaves raises, as JAX's does, before any
    collective."""
    from stable_renderer_tpu_torch.parallel.pipeline import pipeline_apply

    with pytest.raises(ValueError, match="empty activation pytree"):
        pipeline_apply(lambda p, a: a, {"w": torch.zeros(1, 2)}, (), None)
