"""K4, the fused GroupNorm: the port's plain version against the JAX package's
Pallas kernel (interpret mode, which it takes by itself on the CPU), and its
routing in ``models.layers.group_norm``.

The CUDA kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stable_renderer_tpu.ops.group_norm_pallas as jgn
from stable_renderer_tpu.models import layers as jlayers
from stable_renderer_tpu_torch.models import layers as tlayers
from stable_renderer_tpu_torch.ops import group_norm_kernel as tgn

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)  # f32 summation order (tests/test_group_norm_pallas.py)


def _data(n, s, c, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, s, c)).astype(np.float32) * 1.5 + 0.3,
            rng.normal(size=(c,)).astype(np.float32), rng.normal(size=(c,)).astype(np.float32))


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("n,s,c,g", [(2, 64, 128, 32), (1, 17, 256, 32), (3, 8, 128, 4)])
def test_reference_matches_pallas(n, s, c, g, act):
    x, w, b = _data(n, s, c)
    ref = np.asarray(jgn.group_norm_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                           groups=g, act=act))
    out = tgn.group_norm_kernel(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                groups=g, act=act)
    assert out.dtype == torch.float32 and out.shape == (n, s, c)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_reference_is_not_layers_group_norm_in_bf16():
    """The kernel squares and normalizes in f32; layers.group_norm squares and
    applies the multiply-add in bf16. In bf16 the two differ, and the plain
    version follows the kernel."""
    x, w, b = _data(2, 64, 128, seed=1)
    xb = torch.from_numpy(x).bfloat16()
    ref = np.asarray(jgn.group_norm_pallas(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                                           jnp.asarray(w), jnp.asarray(b))).astype(np.float32)
    out = tgn.group_norm_kernel(xb, torch.from_numpy(w), torch.from_numpy(b)).float().numpy()
    plain = tlayers.group_norm({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)},
                               xb.reshape(2, 8, 8, 128)).reshape(2, 64, 128).float().numpy()
    # both round once to bf16 from nearly the same f32 value: at most one bf16 step
    np.testing.assert_allclose(out, ref, rtol=2 ** -7, atol=1e-2)
    assert np.abs(out - plain).max() > 0


def test_wrapper_rejects_non_cuda_devices():
    x = torch.empty((1, 8, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tgn.group_norm_kernel(x, torch.empty(128, device="meta"), torch.empty(128, device="meta"))


@pytest.mark.parametrize("shape,routed", [((2, 8, 8, 128), True), ((2, 4, 4, 48), False),
                                          ((1, 2, 2, 128), False), ((1, 64, 64, 640), False)])
def test_routing_matches_jax(monkeypatch, shape, routed):
    """``_group_norm_pallas_on`` sends the same norms to K4 in both packages:
    C % 128 == 0, S >= 8 and S * C <= 2 * 2^20; outputs agree."""
    monkeypatch.setattr(jlayers, "_group_norm_pallas_on", True)
    monkeypatch.setattr(tlayers, "_group_norm_pallas_on", True)
    jcalls, tcalls = [], []
    jorig, torig = jgn.group_norm_pallas, tlayers.group_norm_kernel

    def jspy(x, *a, **kw):
        jcalls.append(tuple(x.shape))
        return jorig(x, *a, **kw)

    def tspy(x, *a, **kw):
        tcalls.append(tuple(x.shape))
        return torig(x, *a, **kw)

    monkeypatch.setattr(jgn, "group_norm_pallas", jspy)
    monkeypatch.setattr(tlayers, "group_norm_kernel", tspy)
    rng = np.random.default_rng(2)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    p = {"weight": rng.normal(size=(c,)).astype(np.float32),
         "bias": rng.normal(size=(c,)).astype(np.float32)}
    ref = np.asarray(jlayers.group_norm({k: jnp.asarray(v) for k, v in p.items()},
                                        jnp.asarray(x), act="silu"))
    out = tlayers.group_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), act="silu")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    s = shape[1] * shape[2]
    assert jcalls == tcalls == ([(shape[0], s, c)] if routed else [])
