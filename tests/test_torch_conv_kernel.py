"""K3, the fused 3x3 conv: the port's plain version against the JAX package's
Pallas kernel (interpret mode), its routing in ``models.layers``, and the
number of K3 and K4 launches of the SD1.5 frame.

The CUDA kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 7).
"""

from __future__ import annotations

import collections
import functools
from typing import Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import stable_renderer_tpu.ops.conv_pallas as jcp
from stable_renderer_tpu.models import layers as jlayers
from stable_renderer_tpu_torch.models import layers as tlayers
from stable_renderer_tpu_torch.ops import conv_kernel as tck

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=1e-4)  # f32 summation order (tests/test_conv_pallas.py)
# int8: the quantized values and int32 sums are equal; what is left is the f32
# dequantization and bias add (one rounding each) and the SiLU's exp
INT8_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(jcp.pl, "pallas_call", functools.partial(orig, interpret=True))


def _data(n, h, w_img, ci, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w_img, ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, ci, co)) * 0.05).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    return x, w, b


def _int8(w, x):
    ws = (np.abs(w).max(axis=(0, 1, 2)) / 127.0).astype(np.float32)
    wq = np.round(w / ws).clip(-127, 127).astype(np.int8)
    a_s = np.float32(np.abs(x).max() / 127.0)
    return wq, ws, a_s


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("mode", ["plain", "epilogue_silu", "prologue_silu", "int8",
                                  "int8_prologue", "int8_silu"])
def test_reference_matches_pallas(mode):
    n = 2 if "prologue" in mode else 1
    x, w, b = _data(n, 8, 8, 128, 128)
    kw, tkw = {}, {}
    if "prologue" in mode:
        rng = np.random.default_rng(1)
        ps = rng.normal(size=(n, 128)).astype(np.float32)
        pb = rng.normal(size=(n, 128)).astype(np.float32)
        kw.update(pre_scale=jnp.asarray(ps), pre_shift=jnp.asarray(pb), pre_act="silu")
        tkw.update(pre_scale=_t(ps), pre_shift=_t(pb), pre_act="silu")
    if "silu" in mode and "prologue" not in mode:
        kw["act"] = tkw["act"] = "silu"
    tol = F32_TOL
    wj, wt = jnp.asarray(w), _t(w)
    if mode.startswith("int8"):
        wq, ws, a_s = _int8(w, x)
        wj, wt = jnp.asarray(wq), _t(wq)
        kw.update(a_scale=float(a_s), w_scale=jnp.asarray(ws))
        tkw.update(a_scale=torch.tensor(a_s), w_scale=_t(ws))
        tol = INT8_TOL
    ref = np.asarray(jcp.conv3x3_pallas(jnp.asarray(x), wj, jnp.asarray(b), block_h=4, **kw))
    out = tck.conv3x3_kernel(_t(x), wt, _t(b), **tkw)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **tol)
    if mode == "int8":  # a conv of the dequantized weights agrees to the quant error only
        fl = np.asarray(jcp.conv3x3_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
        assert np.linalg.norm(out.numpy() - fl) / np.linalg.norm(fl) < 0.03


def test_reference_matches_pallas_multi_block():
    x, w, b = _data(2, 16, 8, 256, 128)
    ref = np.asarray(jcp.conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                        block_h=4, block_co=128))
    out = tck.conv3x3_kernel(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("prologue", [False, True])
def test_zero_edge_rows(prologue):
    """tests/test_conv_pallas.py:92-103: all-ones input and weights give 9, 6
    and 4 x Cin at interior, edge and corner pixels. With the prologue
    (scale 1, shift 0.5, SiLU) the halo must still be zero: silu(0.5) != 0."""
    ci = 128
    x = np.ones((1, 4, 8, ci), np.float32)
    w = np.ones((3, 3, ci, 128), np.float32)
    kw, tkw = {}, {}
    v = 1.0
    if prologue:
        ps, pb = np.ones((1, ci), np.float32), np.full((1, ci), 0.5, np.float32)
        kw = dict(pre_scale=jnp.asarray(ps), pre_shift=jnp.asarray(pb), pre_act="silu")
        tkw = dict(pre_scale=_t(ps), pre_shift=_t(pb), pre_act="silu")
        v = 1.5 / (1.0 + np.exp(-1.5))
    ref = np.asarray(jcp.conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), block_h=2, **kw))
    out = tck.conv3x3_kernel(_t(x), _t(w), **tkw).numpy()
    np.testing.assert_allclose(out, ref, **F32_TOL)
    for (yy, xx), taps in (((1, 4), 9), ((0, 4), 6), ((3, 4), 6), ((0, 0), 4)):
        assert out[0, yy, xx, 0] == pytest.approx(taps * ci * v, rel=1e-5)


def test_int8_quantizes_by_reciprocal():
    """The kernel quantizes x * (1 / a_scale); conv2d_q divides. At a value
    where the two round differently the plain version follows the kernel."""
    a_s = torch.tensor(np.float32(0.3))
    x = torch.zeros((1, 1, 1, 8))
    x[0, 0, 0, 0] = float(np.nextafter(np.float32(0.75), np.float32(1)))  # just above 2.5 steps
    assert torch.round(x[0, 0, 0, 0] * torch.reciprocal(a_s)) == 3  # the kernel's rule
    assert torch.round(x[0, 0, 0, 0] / a_s) == 2  # conv2d_q's rule
    w = torch.zeros((3, 3, 8, 8), dtype=torch.int8)
    w[1, 1, 0, 0] = 1
    out = tck.conv3x3_kernel(x, w, a_scale=a_s, w_scale=torch.ones(8))
    assert out[0, 0, 0, 0].item() == pytest.approx(3 * a_s.item(), rel=1e-6)


def test_wrapper_rejects_non_cuda_devices():
    x = torch.empty((1, 8, 8, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tck.conv3x3_kernel(x, torch.empty((3, 3, 128, 128), device="meta"))


# --- routing ------------------------------------------------------------------


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(x, *a, **kw):
        calls.append((tuple(x.shape), "pre_scale" in kw and kw["pre_scale"] is not None))
        return orig(x, *a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_int8_routing_matches_jax(monkeypatch):
    """1x32x32x128 with the JAX switch on: the int8 3x3 conv (>= 32^2) goes
    to K3 in both packages, the stride-2 and 1x1 int8 convs and the float conv
    below 64^2 do not; outputs agree."""
    from stable_renderer_tpu.models import quant as jquant

    from stable_renderer_tpu_torch.convert import params_from_numpy

    monkeypatch.setattr(jlayers, "_conv_pallas_on", True)
    monkeypatch.setattr(tlayers, "_conv_pallas_on", False)  # restored at teardown
    tck.use_pallas_conv(True)
    assert tlayers._conv_pallas_on
    jcalls = _spy(monkeypatch, jcp, "conv3x3_pallas")
    tcalls = _spy(monkeypatch, tlayers, "conv3x3_kernel")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 32, 32, 128)).astype(np.float32)
    conv = {"weight": (rng.normal(size=(128, 128, 3, 3)) * 0.03).astype(np.float32),
            "bias": rng.normal(size=(128,)).astype(np.float32)}
    one = {"weight": (rng.normal(size=(128, 128, 1, 1)) * 0.1).astype(np.float32)}
    a = float(np.abs(x).max())
    jq = {k: jquant.quantize_conv_params({kk: jnp.asarray(v) for kk, v in p.items()}, a_scale=a)
          for k, p in (("conv", conv), ("one", one))}
    tq = {k: params_from_numpy({kk: np.asarray(v) for kk, v in p.items()}, "cpu")
          for k, p in jq.items()}
    cases = [("conv", dict(padding=1)), ("conv", dict(stride=2, padding=1)), ("one", {})]
    for name, kw in cases:
        ref = np.asarray(jlayers.conv2d(jq[name], jnp.asarray(x), **kw))
        out = tlayers.conv2d(tq[name], _t(x), **kw)
        np.testing.assert_allclose(out.numpy(), ref, **INT8_TOL)
    jw = {"w_hwio": jnp.transpose(jnp.asarray(conv["weight"]), (2, 3, 1, 0)),
          "bias": jnp.asarray(conv["bias"])}
    ref = np.asarray(jlayers.conv2d(jw, jnp.asarray(x), padding=1))
    out = tlayers.conv2d({k: _t(v) for k, v in conv.items()}, _t(x), padding=1)
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)
    assert jcalls == tcalls == [((1, 32, 32, 128), False)]


def test_float_routing_matches_jax(monkeypatch):
    """1x64x64x128 with the switch on: conv2d and norm_act_conv (prologue)
    take K3 in both packages and agree."""
    monkeypatch.setattr(jlayers, "_conv_pallas_on", True)
    monkeypatch.setattr(tlayers, "_conv_pallas_on", True)
    jcalls = _spy(monkeypatch, jcp, "conv3x3_pallas")
    tcalls = _spy(monkeypatch, tlayers, "conv3x3_kernel")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 64, 64, 128)).astype(np.float32)
    w = (rng.normal(size=(128, 128, 3, 3)) * 0.03).astype(np.float32)
    b = rng.normal(size=(128,)).astype(np.float32)
    norm = {"weight": rng.normal(size=(128,)).astype(np.float32),
            "bias": rng.normal(size=(128,)).astype(np.float32)}
    jconv = {"w_hwio": jnp.transpose(jnp.asarray(w), (2, 3, 1, 0)), "bias": jnp.asarray(b)}
    tconv = {"weight": _t(w), "bias": _t(b)}
    jnorm, tnorm = {k: jnp.asarray(v) for k, v in norm.items()}, {k: _t(v) for k, v in norm.items()}
    ref = np.asarray(jlayers.conv2d(jconv, jnp.asarray(x), padding=1))
    out = tlayers.conv2d(tconv, _t(x), padding=1)
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)
    ref = np.asarray(jlayers.norm_act_conv(jnorm, jconv, jnp.asarray(x), eps=1e-5))
    out = tlayers.norm_act_conv(tnorm, tconv, _t(x), eps=1e-5)
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)
    assert jcalls == tcalls == [((1, 64, 64, 128), False), ((1, 64, 64, 128), True)]
    # the HWIO view is made once per weight tensor
    assert tlayers._hwio(tconv["weight"], torch.float32) is tlayers._hwio(tconv["weight"],
                                                                          torch.float32)


@pytest.mark.parametrize("cin, cout, routed", [(180, 180, False), (128, 180, False),
                                               (180, 128, False), (184, 176, True),
                                               (128, 128, True)])
def test_float_gate_admits_only_channel_multiples_of_8(monkeypatch, cin, cout, routed):
    """Under the float switch a 3x3 conv at 64^2 takes K3 only with Cin and
    Cout multiples of 8, which K3 needs: the zoo's 180-wide SwinIR, HAT and
    DAT convs take F.conv2d, with its result. The frames' K3 classes are
    unchanged (test_switched_frame_k3_shape_classes and the int8 tallies
    below: every frame width is a multiple of 8)."""
    monkeypatch.setattr(tlayers, "_conv_pallas_on", True)
    tcalls = _spy(monkeypatch, tlayers, "conv3x3_kernel")
    assert tlayers._pallas_conv_gate(64, 64, cin, cout) is routed
    rng = np.random.default_rng(8)
    x = _t(rng.normal(size=(1, 64, 64, cin)).astype(np.float32))
    conv = {"weight": _t((rng.normal(size=(cout, cin, 3, 3)) * 0.03).astype(np.float32)),
            "bias": _t(rng.normal(size=(cout,)).astype(np.float32))}
    out = tlayers.conv2d(conv, x, padding=1)
    assert tcalls == ([((1, 64, 64, cin), False)] if routed else [])
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv["weight"], conv["bias"],
                                     padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)


# --- launches of the SD1.5 frame, counted on the meta device ------------------


def _count_frame_launches(monkeypatch, int8: bool, shapes: Optional[dict] = None,
                          k4_shapes: Optional[dict] = None, batch: int = 2):
    """Run the full-width SD1.5 UNet (batch ``batch`` at 64x64: 2 in the
    sequential frame, 2S = 8 in the stream frame) and VAE (encode and decode
    at 512x512) on the meta device, with K1, K3 and K4 stubbed to shape-only
    functions, and count the K3 and K4 calls. The counts depend on shapes
    alone, so this is what one 512x512 frame launches per UNet evaluation
    and per VAE pass. ``shapes``, if given, gets each pass's K3 calls by (N,
    H, W, Cin, Cout, prologue); ``k4_shapes``, if given, each pass's K4 calls
    by (N, S, C, groups, act). int8 calibration records spatial sizes, which
    the batch does not change."""
    from stable_renderer_tpu_torch.models import quant as tquant
    from stable_renderer_tpu_torch.models.unet import SD15_UNET_CONFIG, UNetModel
    from stable_renderer_tpu_torch.models.vae import SD15_VAE_CONFIG, VAE
    from stable_renderer_tpu_torch.ops import flash_attention as tfa

    counts = {"k3": 0, "k4": 0}
    calls = collections.Counter()
    k4_calls = collections.Counter()

    def k3(x, w, bias=None, **kw):
        counts["k3"] += 1
        calls[tuple(x.shape) + (w.shape[-1], kw.get("pre_scale") is not None)] += 1
        return torch.empty(x.shape[:3] + (w.shape[-1],), dtype=x.dtype, device=x.device)

    def k4(x, *a, **kw):
        counts["k4"] += 1
        k4_calls[tuple(x.shape) + (kw.get("groups"), kw.get("act"))] += 1
        return torch.empty_like(x)

    def int_conv(q, w_q, stride=1, padding=0):
        n, h, w, _ = q.shape
        kh = w_q.shape[0]
        ho, wo = (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kh) // stride + 1
        return torch.empty((n, ho, wo, w_q.shape[-1]), dtype=torch.int32, device=q.device)

    monkeypatch.setattr(tlayers, "conv3x3_kernel", k3)
    monkeypatch.setattr(tlayers, "group_norm_kernel", k4)
    monkeypatch.setattr(tquant, "int_conv", int_conv)
    monkeypatch.setattr(tfa, "flash_attention", lambda q, k, v: torch.empty_like(q))
    meta, dt = torch.device("meta"), torch.bfloat16
    unet, vae = UNetModel(SD15_UNET_CONFIG), VAE(SD15_VAE_CONFIG)
    up, vp = unet.init(dtype=dt, device=meta), vae.init(dtype=dt, device=meta)
    x = torch.empty((batch, 64, 64, 4), dtype=dt, device=meta)
    t = torch.empty((batch,), device=meta)
    ctx = torch.empty((batch, 77, 768), dtype=dt, device=meta)
    z = torch.empty((1, 64, 64, 4), dtype=dt, device=meta)
    px = torch.empty((1, 512, 512, 3), dtype=dt, device=meta)
    if int8:  # quantize_convs' policy, with the spatial sizes a calibration records
        def pixels(apply_fn, params, *args):
            tquant._CAL.__init__()
            tquant._register_paths(params, "", tquant._CAL.paths)
            tquant._CAL.active = True
            try:
                apply_fn(params, *args)
            finally:
                tquant._CAL.active = False
            return {path: (1.0, tquant._CAL.pixels[i]) for i, path in tquant._CAL.paths.items()
                    if i in tquant._CAL.pixels}

        su = pixels(lambda p, *a: unet.apply(p, *a), up, x, t, ctx)
        sv = pixels(lambda p, z_, px_: (vae.decode(p, z_), vae.encode_moments(p, px_)), vp, z, px)
        up = tquant.quantize_tree(up, su, min_pixels=32 * 32)
        vp = tquant.quantize_tree(vp, sv, min_pixels=32 * 32)
    out = {}
    for name, fn in (("unet", lambda: unet.apply(up, x, t, ctx)),
                     ("encode", lambda: vae.encode(vp, px)), ("decode", lambda: vae.decode(vp, z))):
        counts.update(k3=0, k4=0)
        calls.clear()
        k4_calls.clear()
        fn()
        out[name] = dict(counts)
        if shapes is not None:
            shapes[name] = collections.Counter(calls)
        if k4_shapes is not None:
            k4_shapes[name] = collections.Counter(k4_calls)
    return out


def test_int8_frame_k3_launches(monkeypatch):
    """The int8 frame: 22 K3 calls per UNet evaluation (the 3x3 convs at 64^2
    and 32^2; 16^2 and 8^2 stay in the float type under min_pixels), 20 in
    the VAE encode and 31 in the decode: 4 x 22 + 20 + 31 = 139 a frame
    (chip_smoke.py K3_INT8_CALLS_PER_FRAME). K4 is off. On the meta device
    the switch stands in for the card, where int8 routing needs no switch; no
    float conv of this frame passes the float gate."""
    monkeypatch.setattr(tlayers, "_conv_pallas_on", True)
    c = _count_frame_launches(monkeypatch, int8=True)
    assert c == {"unet": {"k3": 22, "k4": 0}, "encode": {"k3": 20, "k4": 0},
                 "decode": {"k3": 31, "k4": 0}}


def test_switched_frame_k3_k4_launches(monkeypatch):
    """The bf16 frame with both switches on: K3 under the float gate (>= 64^2,
    >= 128 channels, not 256^2 with cin >= 512), K4 where C % 128 == 0 and
    S * C <= 2^21 and the norm is not fused into K3's prologue.
    K3 4 x 11 + 20 + 29 = 93 and K4 4 x 43 + 2 + 1 = 175 a frame
    (chip_smoke.py K3_SWITCHED_CALLS_PER_FRAME, K4_SWITCHED_CALLS_PER_FRAME)."""
    monkeypatch.setattr(tlayers, "_conv_pallas_on", True)
    monkeypatch.setattr(tlayers, "_group_norm_pallas_on", True)
    c = _count_frame_launches(monkeypatch, int8=False)
    assert c == {"unet": {"k3": 11, "k4": 43}, "encode": {"k3": 20, "k4": 2},
                 "decode": {"k3": 29, "k4": 1}}


def test_bf16_frame_launches_no_kernel_by_default(monkeypatch):
    c = _count_frame_launches(monkeypatch, int8=False)
    assert all(v == {"k3": 0, "k4": 0} for v in c.values())


# --- K3's shape classes and its tile picker -------------------------------------


def _frame_tally(shapes: dict) -> collections.Counter:
    """Launches a frame by shape class: 4 UNet evaluations, one encode, one
    decode."""
    tally = collections.Counter()
    for name, times in (("unet", 4), ("encode", 1), ("decode", 1)):
        for key, count in shapes[name].items():
            tally[key] += times * count
    return tally


def test_int8_frame_k3_shape_classes(monkeypatch):
    """The int8 frame's 139 K3 launches fall in 20 shape classes, none with
    the prologue: chip_smoke.K3_INT8_FRAME_SHAPES, which phase 7 and the card
    tests check one by one."""
    import chip_smoke

    monkeypatch.setattr(tlayers, "_conv_pallas_on", True)
    shapes = {}
    _count_frame_launches(monkeypatch, int8=True, shapes=shapes)
    tally = _frame_tally(shapes)
    assert {k[:5]: v for k, v in tally.items()} == chip_smoke.K3_INT8_FRAME_SHAPES
    assert not any(k[5] for k in tally)
    assert len(tally) == 20 and sum(tally.values()) == chip_smoke.K3_INT8_CALLS_PER_FRAME == 139


def test_int8_stream_frame_k3_shape_classes(monkeypatch):
    """The int8 stream frame (bench.py's default mode) runs one UNet
    evaluation at batch 2S = 8 and the VAE once each way: u + v = 22 + 51 =
    73 K3 launches, where the sequential frame's 139 = 4u + v; its classes
    are chip_smoke.K3_STREAM_FRAME_SHAPES, the UNet's at batch 8."""
    import chip_smoke

    monkeypatch.setattr(tlayers, "_conv_pallas_on", True)
    shapes = {}
    c = _count_frame_launches(monkeypatch, int8=True, shapes=shapes, batch=8)
    u, v = c["unet"]["k3"], c["encode"]["k3"] + c["decode"]["k3"]
    assert (u, v) == (chip_smoke.K3_UNET_CALLS_PER_EVAL, chip_smoke.K3_VAE_CALLS_PER_FRAME)
    assert 4 * u + v == chip_smoke.K3_INT8_CALLS_PER_FRAME
    tally = collections.Counter()
    for name in ("unet", "encode", "decode"):
        tally.update({k[:5]: n for k, n in shapes[name].items()})
    assert dict(tally) == chip_smoke.K3_STREAM_FRAME_SHAPES
    assert sum(tally.values()) == chip_smoke.K3_STREAM_CALLS_PER_FRAME == 73
    assert {k[0] for k in shapes["unet"]} == {8}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hint_tower_k3_routing(monkeypatch, dtype):
    """Under the float switch, the ControlNet hint tower's last conv (256 ->
    320 at 64x64, stride 1, batch 1: the tower runs once a frame on the
    frame's hint) passes the float gate: K3 takes it for bf16 activations.
    The G-buffer's hints are f32, as in the JAX package, so on the card the
    tower runs in f32 and stays off K3, whose float mode takes bf16."""
    from stable_renderer_tpu_torch.models.controlnet import ControlNet, ControlNetConfig

    monkeypatch.setattr(tlayers, "_conv_pallas_on", True)
    calls = []

    def k3(x, w, bias=None, **kw):
        calls.append(tuple(x.shape) + (w.shape[-1],))
        return torch.empty(x.shape[:3] + (w.shape[-1],), dtype=x.dtype, device=x.device)

    monkeypatch.setattr(tlayers, "conv3x3_kernel", k3)
    meta = torch.device("meta")
    cn = ControlNet(ControlNetConfig())
    params = cn.init(dtype=torch.bfloat16, device=meta)
    out = cn.apply_hint(params, torch.empty((1, 512, 512, 3), dtype=dtype, device=meta))
    assert tuple(out.shape) == (1, 64, 64, 320)
    assert calls == ([(1, 64, 64, 256, 320)] if dtype == torch.bfloat16 else [])


def test_switched_frame_k3_shape_classes(monkeypatch):
    """The switched bf16 frame's 93 K3 launches: 12 shape classes, most of
    them with the GroupNorm+SiLU prologue."""
    import chip_smoke

    monkeypatch.setattr(tlayers, "_conv_pallas_on", True)
    monkeypatch.setattr(tlayers, "_group_norm_pallas_on", True)
    shapes = {}
    _count_frame_launches(monkeypatch, int8=False, shapes=shapes)
    tally = _frame_tally(shapes)
    assert dict(tally) == chip_smoke.K3_SWITCHED_FRAME_SHAPES
    assert len({k[:5] for k in tally}) == 12
    assert sum(tally.values()) == chip_smoke.K3_SWITCHED_CALLS_PER_FRAME == 93


def test_switched_frame_k4_shape_classes(monkeypatch):
    """The switched bf16 frame's 175 K4 launches: 13 classes of (N, S, C,
    act), all with 32 groups: chip_smoke.K4_SWITCHED_FRAME_SHAPES, which
    phase 8 and the card tests check one by one."""
    import chip_smoke

    monkeypatch.setattr(tlayers, "_conv_pallas_on", True)
    monkeypatch.setattr(tlayers, "_group_norm_pallas_on", True)
    k4 = {}
    _count_frame_launches(monkeypatch, int8=False, k4_shapes=k4)
    tally = _frame_tally(k4)
    assert {k[4] for k in tally} <= {None, "silu"} and {k[3] for k in tally} == {32}
    assert {k[:3] + (k[4],): v for k, v in tally.items()} == chip_smoke.K4_SWITCHED_FRAME_SHAPES
    assert sum(tally.values()) == chip_smoke.K4_SWITCHED_CALLS_PER_FRAME == 175


def _picker_cases():
    import chip_smoke

    cases = [(s, True) for s in chip_smoke.K3_INT8_FRAME_SHAPES]
    cases += [(s, False) for s in sorted({k[:5] for k in chip_smoke.K3_SWITCHED_FRAME_SHAPES})]
    # ragged edges: H and W not multiples of the tile, Cout not a multiple of BN
    cases += [((1, 16, 24, 136, 72), True), ((1, 16, 24, 136, 72), False),
              ((1, 33, 47, 8, 8), True), ((1, 10, 13, 128, 136), True),
              ((1, 10, 13, 128, 136), False), ((1, 9, 11, 200, 56), True)]
    return cases


@pytest.mark.parametrize("shape,int8", _picker_cases())
def test_tile_picker(shape, int8):
    """What conv_tiles picks fits the card and the instructions: shared memory
    within a block's 232,448 bytes, an N tile that wgmma takes in the mode
    (a multiple of 8 up to 256; of 16 above 32 for s8) and that the kernel
    was compiled for, 16-byte TMA strides, and a grid whose blocks cover
    every output, with no block past the last output channel."""
    n, h, w, cin, cout = shape
    t = tck.conv_tiles(n, h, w, cin, cout, int8)
    assert (t.bn, t.nwg, t.mb, t.smem) in tck.TILE_CONFIGS
    assert t.smem <= 232_448
    assert t.bn % 8 == 0 and t.bn <= 256 and not (int8 and t.bn > 32 and t.bn % 16)
    eb = 1 if int8 else 2
    assert t.cs >= cin and (t.cs * eb) % 16 == 0 and (9 * t.cs * eb) % 16 == 0
    assert t.cs == (-(-cin // 16) * 16 if int8 else cin)
    assert t.rows == 4 * t.nwg * t.mb and t.threads == 128 * (t.nwg + 1)
    tiles_y, tiles_x = -(-h // t.rows), -(-w // tck.TILE_W)
    assert t.grid[0] == n * tiles_y * tiles_x
    assert tiles_y * t.rows >= h and tiles_x * tck.TILE_W >= w
    assert t.grid[1] * t.bn >= cout > (t.grid[1] - 1) * t.bn
    # the patch box, (rows + 2) x 18 pixels of 128 bytes, and the weight box,
    # 128 bytes x BN rows: every TMA box dimension at most 256
    assert t.rows + 2 <= 256 and tck.TILE_W + 2 <= 256 and t.bn <= 256


def test_tile_configs_match_the_kernel_table():
    """TILE_CONFIGS is csrc/conv3x3.cu's kConfigs (shared memory included,
    which the .cu asserts at compile time), in order, and run_gemm launches
    every entry."""
    import re

    src = (tck.__file__.rsplit("/ops/", 1)[0] + "/csrc/conv3x3.cu")
    text = open(src).read()
    table = text[text.index("kConfigs[] = {"):text.index("};", text.index("kConfigs[] = {"))]
    assert tuple(tuple(map(int, m)) for m in
                 re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\}", table)) == \
        tuple((bn, nwg, mb, smem) for bn, nwg, mb, smem in tck.TILE_CONFIGS)
    cases = re.findall(r"case (\d+): return launch_gemm<INT8, (\d+)>", text)
    assert [(int(i), int(c)) for i, c in cases] == [(i, i) for i in range(len(tck.TILE_CONFIGS))]


@pytest.mark.parametrize("shape,int8", [((2, 64, 64, 320, 320), False),
                                        ((1, 512, 512, 128, 128), True),
                                        ((1, 512, 512, 128, 128), False)])
def test_tile_candidates_fill_the_shared_memory_budget(shape, int8):
    """Every compiled tile shape is a candidate, each within a block's
    232,448 bytes of shared memory, and the picker takes one of them."""
    cands = tck.tile_candidates(*shape, int8)
    assert [(t.bn, t.nwg, t.mb, t.smem) for t in cands] == list(tck.TILE_CONFIGS)
    for t in cands:
        assert t.smem <= 232_448
    assert tck.conv_tiles(*shape, int8) in cands


@pytest.mark.parametrize("shape,int8,want", [
    ((2, 64, 64, 320, 320), False, (160, 2, 1)),   # Cout 320 in two 160-wide tiles
    ((2, 32, 32, 640, 640), True, (128, 2, 1)),    # 80 tiles: the smaller tile fills more SMs
    ((1, 512, 512, 128, 128), True, (128, 2, 2)),  # 1024 tiles: 256 pixels a tile halve B's traffic
])
def test_tile_picker_choices(shape, int8, want):
    """The picks that the sweep on the card found fastest at three frame
    shapes (PERF.md)."""
    t = tck.conv_tiles(*shape, int8)
    assert (t.bn, t.nwg, t.mb) == want
