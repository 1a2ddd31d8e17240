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


# --- K4's launch geometry (the card tests run it: tests/test_torch_cuda.py) -----


def _k4_cases():
    import chip_smoke

    shapes = sorted({k[:3] for k in chip_smoke.K4_SWITCHED_FRAME_SHAPES})
    cases = [(s, 32, 2) for s in shapes] + [(s, 32, 4) for s in shapes]
    # the tests' small shapes, the gate's extremes, the widest slice, and
    # 65536 rows of one slice, where x leaves the registers and is read twice
    cases += [((1, 17, 256), 32, 4), ((3, 8, 128), 4, 4), ((2, 64, 128), 32, 4),
              ((1, 16384, 128), 32, 2), ((1, 16384, 128), 32, 4), ((1, 8, 32768), 32, 2),
              ((1, 65536, 32), 32, 2)]
    return cases


@pytest.mark.parametrize("shape,groups,elem_bytes", _k4_cases())
def test_gn_geometry(shape, groups, elem_bytes):
    """Every switched-frame shape class (bf16 and f32) and the gate's
    extremes: whole groups and whole vectors a slice, clusters the card
    allows, in one wave, every row covered, the kernel's thread, register and
    shared memory limits; at the frame's classes the largest cluster that
    keeps one wave, and whole 32-byte sectors of at least 64 bytes a row."""
    n, s, c = shape
    g = tgn.gn_geometry(n, s, c, groups, elem_bytes)
    cpg = c // groups
    assert g.slice_channels % cpg == 0 and g.slice_channels % tgn.VEC == 0
    assert c % g.slice_channels == 0 and g.slice_channels <= tgn.MAX_SLICE
    assert 1 <= g.cluster <= min(tgn.MAX_CLUSTER, s)
    assert g.cluster * g.rows_per_cta >= s > (g.cluster - 1) * g.rows_per_cta  # every CTA has rows
    assert g.passes * g.rows_per_pass >= g.rows_per_cta
    assert (g.passes - 1) * g.rows_per_pass < g.rows_per_cta  # no empty pass
    assert 1 <= g.threads <= tgn.MAX_THREADS
    assert g.resident == (g.passes <= tgn.MAX_PASSES)
    assert g.resident or shape in ((1, 65536, 32), (2, 1024, 1920), (2, 1024, 1280))
    assert tgn.STATIC_SMEM <= tgn.SMEM_LIMIT
    assert 2 * (g.slice_channels // cpg) * (g.cluster + 1) <= tgn.RED_FLOATS
    assert g.threads % 32 == 0 and g.threads - 32 < g.slice_channels // tgn.VEC * g.rows_per_pass
    clusters = n * (c // g.slice_channels)
    assert g.cluster & (g.cluster - 1) == 0
    assert clusters * g.cluster <= tgn.WAVE_CTAS[g.cluster] or g.cluster == 1  # one wave
    if s * c <= tgn.MAX_ELEMENTS and c >= 512 and groups == 32:  # the frame's classes
        assert clusters * g.cluster * 2 > tgn.WAVE_CTAS[min(16, 2 * g.cluster)]  # the largest
        row_bytes = g.slice_channels * elem_bytes  # whole 32-byte sectors, at least 64 bytes
        assert row_bytes % 32 == 0 and row_bytes >= tgn.SEGMENT_BYTES


def test_gn_geometry_rejects_a_slice_the_kernel_cannot_hold():
    with pytest.raises(ValueError, match="slice"):
        tgn.gn_geometry(1, 8, 4096, 2, 2)  # one group of 2048 channels


def test_gn_limits_match_the_kernel():
    """The limits gn_geometry plans with are csrc/group_norm.cu's."""
    import re

    text = open(tgn.__file__.rsplit("/ops/", 1)[0] + "/csrc/group_norm.cu").read()
    for name, value in (("kVec", tgn.VEC), ("kMaxThreads", tgn.MAX_THREADS),
                        ("kMaxPasses", tgn.MAX_PASSES), ("kMaxCluster", tgn.MAX_CLUSTER),
                        ("kMaxSlice", tgn.MAX_SLICE)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) == value, name
