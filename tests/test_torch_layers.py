"""The port's shared layers (stable_renderer_tpu_torch/models/layers.py) against
the JAX package's, on the same numpy inputs and parameters (f32, CPU)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_renderer_tpu.models import layers as jl
from stable_renderer_tpu_torch.models import layers as tl

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_torch_parity.py:36


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """numpy tree -> (jax tree, torch tree)."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def _close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(kw or TOL))


def test_linear(rng):
    p = {"weight": _rand(rng, 24, 16, scale=0.25), "bias": _rand(rng, 24)}
    x = _rand(rng, 2, 5, 16)
    (jp, tp), (jx, tx) = _both(p), _both(x)
    _close(tl.linear(tp, tx), jl.linear(jp, jx))


@pytest.mark.parametrize("k,stride,padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0), (3, 2, 0)])
def test_conv2d(rng, k, stride, padding):
    p = {"weight": _rand(rng, 12, 8, k, k, scale=0.2), "bias": _rand(rng, 12)}
    x = _rand(rng, 2, 9, 10, 8)
    (jp, tp), (jx, tx) = _both(p), _both(x)
    _close(tl.conv2d(tp, tx, stride=stride, padding=padding),
           jl.conv2d(jp, jx, stride=stride, padding=padding))


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("channels,eps", [(64, 1e-6), (24, 1e-5)])
def test_group_norm(rng, act, channels, eps):
    p = {"weight": _rand(rng, channels), "bias": _rand(rng, channels)}
    x = _rand(rng, 2, 6, 5, channels, scale=3.0) + 1.5
    (jp, tp), (jx, tx) = _both(p), _both(x)
    _close(tl.group_norm(tp, tx, eps=eps, act=act), jl.group_norm(jp, jx, eps=eps, act=act))


def test_norm_act_conv(rng):
    pn = {"weight": _rand(rng, 32), "bias": _rand(rng, 32)}
    pc = {"weight": _rand(rng, 16, 32, 3, 3, scale=0.1), "bias": _rand(rng, 16)}
    x = _rand(rng, 1, 8, 8, 32)
    (jn, tn), (jc, tc), (jx, tx) = _both(pn), _both(pc), _both(x)
    _close(tl.norm_act_conv(tn, tc, tx, eps=1e-5), jl.norm_act_conv(jn, jc, jx, eps=1e-5))


@pytest.mark.parametrize("with_params", [True, False])
def test_layer_norm(rng, with_params):
    p = {"weight": _rand(rng, 48), "bias": _rand(rng, 48)} if with_params else None
    x = _rand(rng, 2, 7, 48, scale=2.0)
    jx, tx = _both(x)
    jp, tp = _both(p) if p is not None else (None, None)
    _close(tl.layer_norm(tp, tx), jl.layer_norm(jp, jx))


def test_activations_and_geglu(rng):
    x = _rand(rng, 3, 40, scale=3.0)
    jx, tx = _both(x)
    _close(tl.silu(tx), jl.silu(jx))
    _close(tl.gelu_quick(tx), jl.gelu_quick(jx))
    p = {"proj": {"weight": _rand(rng, 64, 40, scale=0.2), "bias": _rand(rng, 64)}}
    jp, tp = _both(p)
    _close(tl.geglu(tp, tx), jl.geglu(jp, jx))


@pytest.mark.parametrize("dim", [320, 33])
def test_timestep_embedding(dim):
    t = np.asarray([0.0, 1.0, 499.0, 999.0], np.float32)
    jt, tt = _both(t)
    _close(tl.timestep_embedding(tt, dim), jl.timestep_embedding(jt, dim))


def test_upsample_and_pool(rng):
    x = _rand(rng, 2, 4, 6, 3)
    jx, tx = _both(x)
    _close(tl.upsample_nearest_2x(tx), jl.upsample_nearest_2x(jx), atol=0, rtol=0)
    _close(tl.avg_pool_2x(tx), jl.avg_pool_2x(jx))


def test_attention_masked(rng):
    b, l, heads, d = 2, 9, 3, 8
    q, k, v = (_rand(rng, b, l, heads * d) for _ in range(3))
    mask = np.where(np.arange(l)[None, :] <= np.arange(l)[:, None], 0.0, -np.inf)
    mask = mask.astype(np.float32)[None, None]
    (jq, tq), (jk, tk), (jv, tv), (jm, tm) = _both(q), _both(k), _both(v), _both(mask)
    _close(tl.attention(tq, tk, tv, heads, mask=tm), jl.attention(jq, jk, jv, heads, mask=jm))


@pytest.mark.parametrize("lk", [77, 2048])
def test_attention_routes_match_plain(rng, lk):
    """Unmasked attention on both sides of the K1 routing threshold equals the
    JAX package's plain attention (on the CPU the kernel route is the plain
    version)."""
    b, lq, heads, d = 1, 16, 2, 8
    q = _rand(rng, b, lq, heads * d)
    k, v = _rand(rng, b, lk, heads * d), _rand(rng, b, lk, heads * d)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    _close(tl.attention(tq, tk, tv, heads), jl.attention(jq, jk, jv, heads))
