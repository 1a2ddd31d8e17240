"""The diffusion training step (fine-tuning / LoRA-style adaptation).

Counterpart of stable_renderer_tpu/parallel/train.py. One step:

    loss = || eps - UNet(z_t, t, ctx) ||^2   (noise prediction, eps-param)

over the mesh of ``parallel.mesh``: the batch split over 'dp' (each rank
its rows, the gradients averaged over the dp ranks), the attention heads
and the MLP over 'tp' (each rank its Megatron shards from
``apply_param_sharding``; the transformer blocks sum the row-parallel
products and the column-parallel inputs' gradients over tp, models/unet.py).
The optimizer is optax's AdamW, written out in optax's order of operations
on each rank's local shards, which is exact under tp.

Randomness is passed in: the JAX package draws the timesteps and the noise
from a key inside the loss; here the caller hands the whole batch's ``t``
and ``eps`` (``diffusion_draws`` draws them from a torch generator), and
each dp rank takes its rows.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from stable_renderer_tpu_torch.parallel.mesh import (
    active_dp,
    active_tp,
    dp_context,
    frame_sharding,
    tp_context,
)


class AdamWState(NamedTuple):
    """optax's ``ScaleByAdamState``: the update count and the two moments,
    trees like the params (the two empty states of optax's chain hold
    nothing)."""

    count: int
    mu: dict
    nu: dict


class TrainState(NamedTuple):
    params: dict
    opt_state: AdamWState
    step: int


def _flat(tree: dict) -> dict:
    from stable_renderer_tpu_torch.models.weights import flatten

    return flatten(tree)


def _nest(flat: dict) -> dict:
    from stable_renderer_tpu_torch.models.weights import nest

    return nest(flat, "")


class AdamW:
    """``optax.adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0,
    weight_decay)``: scale_by_adam, add_decayed_weights, then the learning
    rate, with optax's operations in optax's order on each leaf."""

    def __init__(self, learning_rate: float = 1e-5, weight_decay: float = 1e-2,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0):
        self.learning_rate, self.weight_decay = learning_rate, weight_decay
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, params: dict) -> AdamWState:
        flat = _flat(params)
        return AdamWState(0, _nest({p: torch.zeros_like(t) for p, t in flat.items()}),
                          _nest({p: torch.zeros_like(t) for p, t in flat.items()}))

    def update(self, grads: dict, state: AdamWState, params: dict) -> Tuple[dict, AdamWState]:
        """(new params, new state) from the gradient tree ``grads``."""
        count = state.count + 1
        # 1 - decay**count in f32, as optax's bias_correction computes it
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.int32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.int32(count))
        g, mu, nu = _flat(grads), _flat(state.mu), _flat(state.nu)
        new_p, new_mu, new_nu = {}, {}, {}
        for path, p in _flat(params).items():
            m = (1 - self.b1) * g[path] + self.b1 * mu[path]
            v = (1 - self.b2) * g[path] ** 2 + self.b2 * nu[path]
            u = (m / bc1) / (torch.sqrt(v / bc2 + self.eps_root) + self.eps)
            u = (u + self.weight_decay * p) * -self.learning_rate
            new_p[path] = (p + u).to(p.dtype)
            new_mu[path], new_nu[path] = m, v
        return _nest(new_p), AdamWState(count, _nest(new_mu), _nest(new_nu))


def make_train_state(unet, params: dict, learning_rate: float = 1e-5,
                     weight_decay: float = 1e-2) -> Tuple[TrainState, AdamW]:
    """(the state at step 0, the optimizer); ``params`` are this rank's
    (under tp, ``apply_param_sharding``'s shards)."""
    opt = AdamW(learning_rate, weight_decay=weight_decay)
    return TrainState(params, opt.init(params), 0), opt


def diffusion_draws(generator: torch.Generator, batch: int, latent_shape, num_sigmas: int,
                    device=None, dtype=torch.float32):
    """The step's draws for the whole batch: timesteps ``t`` (batch,) in
    [0, num_sigmas) and noise ``eps`` (batch, *latent_shape). Every rank
    draws the whole batch from its copy of the generator (as
    ``FrameShard.randn`` does) and the loss takes its rows."""
    t = torch.randint(0, num_sigmas, (batch,), generator=generator, device=device)
    eps = torch.randn((batch, *latent_shape), generator=generator, device=device, dtype=dtype)
    return t, eps


def diffusion_loss(unet, params: dict, ms_sigmas: torch.Tensor, latents: torch.Tensor,
                   context: torch.Tensor, t: torch.Tensor, eps: torch.Tensor,
                   remat: bool = False) -> torch.Tensor:
    """The JAX package's ``diffusion_loss`` with its draws passed in: ``t``
    (B,) integer timesteps and ``eps`` (B, h, w, 4), for the whole batch.
    Under ``dp_context`` the rank takes its rows of the batch and returns
    the mean over them. ``remat`` recomputes the UNet forward in the
    backward (``torch.utils.checkpoint`` over the whole apply, as
    ``jax.checkpoint`` wraps it); the recompute re-enters the tp and dp
    groups that were active here, since the backward may run outside
    them."""
    dp = active_dp()
    if dp is not None:
        latents, context, t, eps = (dp.take(a) for a in (latents, context, t, eps))
    sigma = ms_sigmas[t.long()][:, None, None, None]
    noised = latents + sigma * eps
    c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
    x, tf = noised * c_in, t.float()
    if remat:
        from torch.utils.checkpoint import checkpoint

        tp = active_tp()

        def fwd(x, tf, context):
            with tp_context(tp), dp_context(dp):
                return unet.apply(params, x, tf, context)

        pred = checkpoint(fwd, x, tf, context, use_reentrant=False)
    else:
        pred = unet.apply(params, x, tf, context)
    return torch.mean((pred - eps) ** 2)


def diffusion_train_step(unet, opt: AdamW, state: TrainState, ms_sigmas: torch.Tensor,
                         latents: torch.Tensor, context: torch.Tensor, t: torch.Tensor,
                         eps: torch.Tensor, remat: bool = False,
                         mesh=None) -> Tuple[TrainState, torch.Tensor]:
    """One AdamW step on the whole batch (``latents``, ``context``, draws
    ``t`` and ``eps``, identical on every rank): the loss and gradients of
    ``diffusion_loss`` under the mesh's tp and dp groups, the gradients
    averaged over dp (equal rows a rank: JAX's mean over the global batch),
    then the update of this rank's shards. Returns (the new state, the
    loss: the dp mean). With ``mesh=None``, the one-device step."""
    tp, dp = frame_sharding(mesh, "tp"), frame_sharding(mesh, "dp")
    live = {p: x.detach().requires_grad_(True) for p, x in _flat(state.params).items()}
    params = _nest(live)
    with tp_context(tp), dp_context(dp):
        loss = diffusion_loss(unet, params, ms_sigmas, latents, context, t, eps, remat=remat)
        grads = torch.autograd.grad(loss, list(live.values()))
    loss = loss.detach()
    if dp.size > 1:
        for g in (*grads, loss):
            dp.all_reduce_(g).div_(dp.size)
    params, opt_state = opt.update(_nest(dict(zip(live, grads))), state.opt_state, state.params)
    return TrainState(params, opt_state, state.step + 1), loss
