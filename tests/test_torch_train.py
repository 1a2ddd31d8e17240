"""The training step (stable_renderer_tpu_torch/parallel/train.py) and K1's
gradient (``ops.flash_attention.FlashAttentionFn``), held against the JAX
package on the CPU at TINY_UNET_CONFIG (batch 4, 16x16 latents, a 77-token
context, f32), with JAX's own timestep and noise draws
(``jax.random.split(key)`` as stable_renderer_tpu/parallel/train.py:53-56
splits it) handed to the port.

Bars:
  * losses rtol LOSS_RTOL (1e-5), gradients atol GRAD_ATOL (1e-5) of the
    largest |gradient|: f32 summation order only;
  * params after AdamW steps TRAIN_PARAM_TOL: AdamW divides each gradient
    by the root of its second moment, so gradients that are f32 rounding
    noise (~1e-9 against a largest |gradient| of ~0.15, the biases of layers
    a GroupNorm follows) move their params by up to the learning rate a
    step in a direction the rounding picks. Both packages drift that far
    from the f64 graph: ``python tests/train_drift.py`` measures it, and the
    bar is the two drifts' sum, rounded up;
  * K1's gradient on small shapes GRAD_ATOL of the largest |gradient|;
    the AdamW update against optax's ADAMW_ATOL (1e-6 of unit-scale params:
    order of f32 operations).

The level-0 self-attention of the tiny UNet has 256 keys, under K1's
routing threshold; ``k1_route`` lowers the threshold so that it takes
``FlashAttentionFn`` (the plain forward on the CPU), as SD1.5's 4096 keys
do on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

LR = 1e-3
BATCH, LAT, CTX_LEN = 4, 16, 77
STEPS = 3
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5  # x the largest |gradient|
ADAMW_ATOL = 1e-6
# the two packages' f32 drift from the f64 graph after 3 steps (tests/train_drift.py:
# the port 4.86e-4, JAX 6.32e-4; the gap between them 1.03e-3), summed and rounded up
TRAIN_PARAM_TOL = 1.5e-3
LEVEL0_ATTENTIONS = 3  # the tiny UNet's level-0 self-attentions: input block 1, output blocks 3, 4


def flat_numpy(tree) -> dict:
    from stable_renderer_tpu_torch.models.weights import flatten

    return {k: np.array(v, np.float64) for k, v in flatten(tree).items()}


def inputs():
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((BATCH, LAT, LAT, 4)).astype(np.float32)
    ctx = rng.standard_normal((BATCH, CTX_LEN, 64)).astype(np.float32)
    return lat, ctx


def jax_draws(key, num_sigmas: int):
    """JAX's draws inside diffusion_loss: (t, eps) as numpy."""
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (BATCH,), 0, num_sigmas)
    eps = jax.random.normal(k_n, (BATCH, LAT, LAT, 4), jnp.float32)
    return np.array(t), np.array(eps)


def _numpy_copy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def jax_steps(n: int):
    """JAX's unsharded diffusion_train_step, ``n`` steps at lr LR from
    init(PRNGKey(0)) with keys PRNGKey(10 + i): (states as numpy, the
    state before the first step included; losses; draws; (latents,
    context, sigmas))."""
    from stable_renderer_tpu.models import TINY_UNET_CONFIG, UNetModel
    from stable_renderer_tpu.models.sampling import ModelSampling
    from stable_renderer_tpu.parallel import diffusion_train_step, make_train_state

    unet = UNetModel(TINY_UNET_CONFIG)
    lat, ctx = inputs()
    sig = jnp.asarray(ModelSampling().sigmas)
    state, tx = make_train_state(unet, unet.init(jax.random.PRNGKey(0)), learning_rate=LR)
    states, losses, draws = [_numpy_copy(state)], [], []
    for i in range(n):
        key = jax.random.PRNGKey(10 + i)
        draws.append(jax_draws(key, sig.shape[0]))
        state, loss = diffusion_train_step(unet, tx, state, sig, jnp.asarray(lat),
                                           jnp.asarray(ctx), key)
        states.append(_numpy_copy(state))
        losses.append(float(loss))
    return states, losses, draws, (lat, ctx, np.array(sig))


def port_steps(params0, draws, data, dtype=torch.float32, remat=False, state=None):
    """The port's diffusion_train_step over ``draws`` from ``params0`` (a
    numpy tree) or from ``state``: {"params": flat numpy after each step,
    "losses", "state"}."""
    from stable_renderer_tpu_torch.convert import params_from_numpy
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG, UNetModel
    from stable_renderer_tpu_torch.parallel.train import diffusion_train_step, make_train_state

    unet = UNetModel(TINY_UNET_CONFIG)
    lat, ctx, sig = (torch.from_numpy(a).to(dtype) for a in data)
    st, opt = make_train_state(unet, params_from_numpy(params0, "cpu", dtype), learning_rate=LR)
    if state is not None:
        st = state
    out = {"params": [], "losses": []}
    for t, eps in draws:
        st, loss = diffusion_train_step(unet, opt, st, sig, lat, ctx, torch.from_numpy(t),
                                        torch.from_numpy(eps).to(dtype), remat=remat)
        out["params"].append(flat_numpy(st.params))
        out["losses"].append(float(loss))
    out["state"] = st
    return out


@pytest.fixture(scope="module")
def jax_run():
    return jax_steps(STEPS)


@pytest.fixture
def k1_route(monkeypatch):
    """Attention with 256 or more keys through K1's route (FlashAttentionFn
    under grad); yields the count of plain-backward calls."""
    from stable_renderer_tpu_torch.ops import flash_attention as fa

    calls = []
    grad = fa.attention_grad_reference

    def counted(*a):
        calls.append(a[0].shape)
        return grad(*a)

    monkeypatch.setattr(fa, "FLASH_MIN_KV_LEN", 256)
    monkeypatch.setattr(fa, "attention_grad_reference", counted)
    return calls


def through_k1(t: torch.Tensor) -> bool:
    """Whether FlashAttentionFn is in ``t``'s autograd graph."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if "FlashAttentionFn" in type(fn).__name__:
            return True
        todo += [f for f, _ in fn.next_functions]
    return False


def assert_params(got: dict, want: dict, tol: float, what: str) -> None:
    err = max(np.abs(got[k] - want[k]).max() for k in want)
    assert sorted(got) == sorted(want)
    assert err <= tol, f"{what}: params max abs err {err:.3e} > {tol}"


# --- (a) K1's autograd Function --------------------------------------------------------


def _jax_attention_grads(q, k, v, dout, heads):
    """jax.grad of JAX's models.layers.attention (packed (B, L, H*D))."""
    from stable_renderer_tpu.models.layers import attention

    def f(q, k, v):
        return jnp.sum(attention(q, k, v, heads) * dout)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("lq,lk", [(64, 64), (70, 2100)])
def test_k1_function_gradient_matches_plain_and_jax(lq, lk):
    """FlashAttentionFn over (BH, L, D) and over the fused-QKV chunk views
    (B, L, H, D): its q/k/v gradients against torch autograd through
    flash_attention_reference and against jax.grad of JAX's attention, at a
    small shape and a ragged K/V length (split into blocks of the batch-head
    axis by GRAD_LOGIT_BYTES, lowered here)."""
    from stable_renderer_tpu_torch.ops import flash_attention as fa

    b, heads, d = 2, 3, 16
    rng = np.random.default_rng(lq)
    q = rng.standard_normal((b, lq, heads * d)).astype(np.float32)
    k, v = (rng.standard_normal((b, lk, heads * d)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((b, lq, heads * d)).astype(np.float32)
    want = _jax_attention_grads(*(jnp.asarray(a) for a in (q, k, v, dout)), heads)
    top = max(np.abs(g).max() for g in want)

    def split(t, n):
        return t.reshape(b, n, heads, d).transpose(1, 2).reshape(b * heads, n, d)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    ref = fa.flash_attention_reference(split(tq, lq), split(tk, lk), split(tv, lk))
    plain = torch.autograd.grad(ref, (tq, tk, tv), split(torch.from_numpy(dout), lq))
    mp = pytest.MonkeyPatch()
    mp.setattr(fa, "GRAD_LOGIT_BYTES", lq * lk * 4 * 2)  # blocks of 2 of the 6 heads
    try:
        out = fa.FlashAttentionFn.apply(split(tq, lq), split(tk, lk), split(tv, lk), "bhld")
        assert "FlashAttentionFn" in type(out.grad_fn).__name__
        got = torch.autograd.grad(out, (tq, tk, tv), split(torch.from_numpy(dout), lq))
    finally:
        mp.undo()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-6, rtol=0)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=GRAD_ATOL * top, rtol=0)
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL * top, rtol=0)

    # the fused-QKV chunk views of one (B, L, 3 H D) product (self-attention)
    qkv = torch.from_numpy(np.concatenate([q, q[:, :, ::-1].copy(), -q], -1)).requires_grad_(True)
    views = [c.unflatten(-1, (heads, d)) for c in qkv.chunk(3, dim=-1)]
    assert not views[0].is_contiguous()
    out = fa.FlashAttentionFn.apply(*views, "blhd")
    (g_fn,) = torch.autograd.grad(out, qkv, torch.from_numpy(dout))
    q2, k2, v2 = qkv.chunk(3, dim=-1)
    ref = fa.flash_attention_reference(split(q2, lq), split(k2, lq), split(v2, lq))
    ref = ref.reshape(b, heads, lq, d).transpose(1, 2).reshape(b, lq, heads * d)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-6, rtol=0)
    (g_ref,) = torch.autograd.grad(ref, qkv, torch.from_numpy(dout))
    top = g_ref.abs().max().item()
    np.testing.assert_allclose(g_fn.numpy(), g_ref.numpy(), atol=GRAD_ATOL * top, rtol=0)
    # attention_pallas takes the Function under grad past the threshold, on the CPU too
    mp.setattr(fa, "FLASH_MIN_KV_LEN", lq)
    try:
        via = fa.attention_pallas(*qkv.chunk(3, dim=-1), heads)
    finally:
        mp.undo()
    assert through_k1(via)
    np.testing.assert_allclose(via.detach().numpy(), ref.detach().numpy(), atol=1e-6, rtol=0)


def test_raw_k1_launch_raises_under_grad():
    """A raw launch (bf16 and f32 routes) under grad mode with an input
    that requires grad raises before it reaches the kernel; under no_grad
    the Function is not taken."""
    from stable_renderer_tpu_torch.ops import flash_attention as fa

    q = torch.randn(1, 8, 2, 8, requires_grad=True)
    for launch, args in ((fa._launch_bf16, (q, q, q)), (fa._launch_f32, (q[:, :, 0],) * 3)):
        with pytest.raises(RuntimeError, match="drop the gradient"):
            launch(*args)
    with torch.no_grad():
        out = fa.flash_attention(q[:, :, 0], q[:, :, 0], q[:, :, 0])
    assert out.grad_fn is None
    assert "FlashAttentionFn" in type(fa.flash_attention(*(q[:, :, 0],) * 3).grad_fn).__name__


# --- (b) the loss and its gradients -------------------------------------------------------


@pytest.fixture(scope="module")
def jax_grads(jax_run):
    """jax.value_and_grad of JAX's diffusion_loss at the initial params,
    key PRNGKey(7): (loss, flat numpy gradients, t, eps)."""
    from stable_renderer_tpu.models import TINY_UNET_CONFIG, UNetModel
    from stable_renderer_tpu.parallel.train import diffusion_loss

    states, _, _, (lat, ctx, sig) = jax_run
    unet, key = UNetModel(TINY_UNET_CONFIG), jax.random.PRNGKey(7)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: diffusion_loss(
        unet, p, jnp.asarray(sig), jnp.asarray(lat), jnp.asarray(ctx), key)))(
        jax.tree_util.tree_map(jnp.asarray, states[0].params))
    return float(jl), flat_numpy(jg), *jax_draws(key, sig.shape[0])


@pytest.mark.parametrize("route", ["plain", "k1"])
def test_diffusion_loss_and_gradients_match_jax(route, request, jax_run, jax_grads):
    """diffusion_loss at TINY_UNET_CONFIG against jax.value_and_grad of
    JAX's, with JAX's draws: the level-0 self-attention by the plain
    autograd ("plain") and through FlashAttentionFn ("k1")."""
    from stable_renderer_tpu_torch.convert import params_from_numpy
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG, UNetModel
    from stable_renderer_tpu_torch.models.weights import flatten, nest
    from stable_renderer_tpu_torch.parallel.train import diffusion_loss

    calls = request.getfixturevalue("k1_route") if route == "k1" else None
    states, _, _, (lat, ctx, sig) = jax_run
    jl, want, t, eps = jax_grads
    params = params_from_numpy(states[0].params, "cpu")
    live = {k: v.requires_grad_(True) for k, v in flatten(params).items()}
    loss = diffusion_loss(UNetModel(TINY_UNET_CONFIG), nest(live, ""),
                          *(torch.from_numpy(a) for a in (sig, lat, ctx, t, eps)))
    grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    np.testing.assert_allclose(loss.item(), jl, rtol=LOSS_RTOL)
    top = max(np.abs(g).max() for g in want.values())
    err = max(np.abs(grads[k].numpy() - want[k]).max() for k in want)
    assert err <= GRAD_ATOL * top, f"gradient max abs err {err:.3e} > {GRAD_ATOL} x {top:.3e}"
    if calls is not None:
        assert len(calls) == LEVEL0_ATTENTIONS
    attn_q = "input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"
    assert np.abs(want[attn_q]).max() > 1e-2 * top  # level 0's attention gradient is not small


# --- (c) AdamW against optax ----------------------------------------------------------


def test_adamw_matches_optax():
    """Three AdamW updates (lr 1e-3, weight decay 1e-2) on the same gradient
    trees against optax.adamw: params and both moments, and the count."""
    import optax

    from stable_renderer_tpu_torch.parallel.train import AdamW

    rng = np.random.default_rng(3)
    params = {"a": {"w": rng.standard_normal((5, 7)).astype(np.float32)},
              "b": rng.standard_normal(11).astype(np.float32)}
    grads = [jax.tree_util.tree_map(lambda p: (rng.standard_normal(p.shape) * s).astype(
        np.float32), params) for s in (1.0, 1e-3, 1e-9)]
    tx = optax.adamw(LR, weight_decay=1e-2)
    jp, js = jax.tree_util.tree_map(jnp.asarray, params), None
    js = tx.init(jp)
    opt = AdamW(LR, weight_decay=1e-2)
    tp = jax.tree_util.tree_map(torch.from_numpy, params)
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = opt.update(jax.tree_util.tree_map(torch.from_numpy, g), ts, tp)
    assert ts.count == int(js[0].count) == 3
    for got, want in ((tp, jp), (ts.mu, js[0].mu), (ts.nu, js[0].nu)):
        w = flat_numpy(want)
        for k, a in flat_numpy(got).items():
            np.testing.assert_allclose(a, w[k], atol=ADAMW_ATOL * max(1.0, np.abs(w[k]).max()),
                                       rtol=1e-6, err_msg=k)


# --- (d) three steps, with and without remat ----------------------------------------------


def test_train_steps_match_jax(jax_run, k1_route):
    """Three steps at lr 1e-3 against JAX's diffusion_train_step: losses,
    step and params after each step; with remat the same losses and
    params as without, bit for bit (the recompute runs the same graph), and
    the level-0 attention's plain backward runs in both."""
    states, losses, draws, data = jax_run
    plain = port_steps(states[0].params, draws, data)
    n_plain = len(k1_route)
    remat = port_steps(states[0].params, draws, data, remat=True)
    assert n_plain == len(k1_route) - n_plain == LEVEL0_ATTENTIONS * STEPS
    for run in (plain, remat):
        np.testing.assert_allclose(run["losses"], losses, rtol=LOSS_RTOL)
        assert run["state"].step == STEPS and run["state"].opt_state.count == STEPS
        for i in range(STEPS):
            assert_params(run["params"][i], flat_numpy(states[i + 1].params), TRAIN_PARAM_TOL,
                          f"step {i + 1}")
    assert remat["losses"] == plain["losses"]
    for k, a in plain["params"][-1].items():
        np.testing.assert_array_equal(remat["params"][-1][k], a, err_msg=k)


# --- (e) a JAX state carried across ---------------------------------------------------------


def test_state_from_jax_continues(jax_run):
    """JAX's state after one step, carried across by train_state_from_numpy
    and stepped twice in the port, against JAX's three steps: params and
    both moments, the count and step 3."""
    from stable_renderer_tpu_torch.convert import train_state_from_numpy

    states, losses, draws, data = jax_run
    carried = train_state_from_numpy(states[1], "cpu")
    assert carried.step == 1 and carried.opt_state.count == 1
    run = port_steps(states[0].params, draws[1:], data, state=carried)
    np.testing.assert_allclose(run["losses"], losses[1:], rtol=LOSS_RTOL)
    st = run["state"]
    assert st.step == 3 and st.opt_state.count == int(states[3].opt_state[0].count) == 3
    assert_params(run["params"][-1], flat_numpy(states[3].params), TRAIN_PARAM_TOL, "step 3")
    mu, want_mu = flat_numpy(st.opt_state.mu), flat_numpy(states[3].opt_state[0].mu)
    top = max(np.abs(v).max() for v in want_mu.values())
    assert max(np.abs(mu[k] - want_mu[k]).max() for k in want_mu) <= GRAD_ATOL * top
    with pytest.raises(ValueError, match="optax.adamw"):
        train_state_from_numpy((states[1].params, (states[1].opt_state[0],
                                                   states[1].opt_state[0]), 1), "cpu")
