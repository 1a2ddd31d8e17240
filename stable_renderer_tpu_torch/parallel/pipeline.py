"""GPipe pipeline parallelism over the ``pp`` mesh axis.

Counterpart of stable_renderer_tpu/parallel/pipeline.py. A chain of
UNIFORM stages (the same activation structure and shapes in and out) is
split over the ranks of the ``pp`` axis, one stage a rank, and microbatches
stream through it. The JAX package runs one ``shard_map`` program whose
``lax.scan`` ppermutes each tick's activation to the next stage; here each
rank is its own process and runs the same ticks:

  * ``T = M + S - 1`` ticks for M microbatches over S stages. At tick t
    stage 0 takes microbatch ``min(t, M - 1)``, every other stage what the
    stage before it sent at tick t - 1, and the last stage keeps microbatch
    ``t - (S - 1)`` once that is a valid one. The GPipe bubble is
    ``(S - 1) / (M + S - 1)``.
  * The hand-off is ``FrameShard.shift`` over the pp group (``isend`` /
    ``irecv``): stage s sends to s + 1, and the last stage sends nothing
    (the JAX package's last-to-first wrap of the ring carries nothing
    used).
  * The last stage holds the result; it is broadcast over pp (the JAX
    package's masked psum), so every rank returns the whole batch.
  * With ``batch_axis``, each rank of that axis runs its rows of every
    microbatch, and the last stage gathers them back.

Stage params are stacked on a leading axis of size S
(``stack_stage_params``); each rank uses its own stage's slice.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from stable_renderer_tpu_torch.parallel.mesh import frame_sharding


def _flatten(tree) -> tuple:
    """(leaves, rebuild) of a pytree of dicts, lists and tuples whose
    leaves are tensors; ``rebuild(leaves)`` gives the same structure."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out) if not hasattr(tree, "_fields") else type(tree)(*out)

    return [leaf for p in parts for leaf in p[0]], rebuild


def _tree_map(fn, *trees):
    leaves, rebuild = _flatten(trees[0])
    others = [_flatten(t)[0] for t in trees[1:]]
    return rebuild([fn(*xs) for xs in zip(leaves, *others)])


def stack_stage_params(per_stage: list) -> Any:
    """Stack S structurally identical per-stage param trees along a new
    leading axis (the axis ``pipeline_apply`` splits over ``pp``)."""
    return _tree_map(lambda *xs: torch.stack(xs), *per_stage)


def pipeline_apply(
    stage_fn: Callable[[Any, Any], Any],
    stacked_params: Any,
    x: Any,
    mesh,
    *,
    axis: str = "pp",
    num_microbatches: Optional[int] = None,
    batch_axis: Optional[str] = None,
) -> Any:
    """Apply ``S = mesh[axis].size()`` stages to ``x`` as a GPipe pipeline.

    ``stage_fn(params_for_one_stage, activation) -> activation`` keeps the
    activation's structure and shapes (uniform stages). ``stacked_params``
    is a tree whose leaves carry a leading stage axis of size S (every rank
    holds it and takes its stage's slice). ``x`` is an activation tree whose
    leaves have a leading batch axis B, the same on every rank; B must
    divide into ``num_microbatches`` (default S), and with ``batch_axis``
    each microbatch into that axis's ranks. Returns the whole batch's
    result on every rank. Forward only: the hand-offs carry no gradient,
    and no caller differentiates it, so it runs without grad."""
    pp = frame_sharding(mesh, axis)
    dp = frame_sharding(mesh, batch_axis) if batch_axis is not None else frame_sharding(None)
    S = pp.size
    leaves, rebuild = _flatten(x)
    if not leaves:
        raise ValueError("pipeline_apply: empty activation pytree")
    B = leaves[0].shape[0]
    M = num_microbatches or S
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    b = B // M
    local = dp.rows(b)
    # (M, b, ...) microbatches, this rank's rows of each
    mbs = [[a[m * b:(m + 1) * b][local] for a in leaves] for m in range(M)]
    stage = pp.rank
    p = _tree_map(lambda a: a[stage], stacked_params)
    last = stage == S - 1
    outs = [None] * M
    recv = [torch.zeros_like(a) for a in mbs[0]]  # what a stage > 0 runs before its first input
    with torch.no_grad():
        for t in range(M + S - 1):
            cur = mbs[min(t, M - 1)] if stage == 0 else recv
            out, _ = _flatten(stage_fn(p, rebuild(cur)))
            m = t - (S - 1)
            if last and m >= 0:
                outs[m] = out
            if t + 1 < M + S - 1:
                recv = pp.shift(out)
        if last:
            result = [torch.cat([dp.gather(o[i]) for o in outs]) for i in range(len(leaves))]
        else:
            result = [torch.empty_like(a) for a in leaves]
        result = [pp.broadcast_from_last(r) for r in result]
    return rebuild(result)


# ---------------------------------------------------------------------------
# the CLIP text tower on the pipeline (the JAX package's demonstration model)


def clip_pipeline_encode(
    model,
    params: dict,
    tokens: torch.Tensor,
    mesh,
    *,
    axis: str = "pp",
    num_microbatches: Optional[int] = None,
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """``CLIPTextModel.apply(params, tokens)`` (``clip_skip=-1``) with the
    ``num_layers`` encoder layers in S = ``mesh[axis].size()`` stages of
    ``num_layers / S`` layers each; the embeddings and the final layer norm
    run on every rank. Raises ValueError when S does not divide the
    layers."""
    from stable_renderer_tpu_torch.models.clip import _causal_mask, encoder_layer
    from stable_renderer_tpu_torch.models.layers import layer_norm

    cfg = model.config
    S = frame_sharding(mesh, axis).size
    if cfg.num_layers % S:
        raise ValueError(f"{cfg.num_layers} layers not divisible into {S} stages")
    k = cfg.num_layers // S
    tm = params["text_model"]
    layers = [tm["encoder"]["layers"][str(i)] for i in range(cfg.num_layers)]
    stacked = stack_stage_params([stack_stage_params(layers[s * k:(s + 1) * k])
                                  for s in range(S)])
    tokens = tokens.long()
    x = tm["embeddings"]["token_embedding"]["weight"][torch.clamp(tokens, min=0)]
    x = x + tm["embeddings"]["position_embedding"]["weight"][: tokens.shape[1]][None]
    causal = _causal_mask(tokens.shape[1], tokens.device)

    def stage_fn(stage_params, h):
        for j in range(k):
            h = encoder_layer(_tree_map(lambda a: a[j], stage_params), h, cfg.num_heads, causal)
        return h

    hidden = pipeline_apply(stage_fn, stacked, x, mesh, axis=axis,
                            num_microbatches=num_microbatches, batch_axis=batch_axis)
    return layer_norm(tm["final_layer_norm"], hidden)


# ---------------------------------------------------------------------------
# the UNet middle block on the pipeline: res_block -> SpatialTransformer of
# depth D (SDXL: 10) -> res_block; its D BasicTransformerBlocks are uniform
# (tokens, context) -> tokens stages


def unet_middle_pipeline(
    unet,
    params: dict,
    h: torch.Tensor,        # (B, H, W, C) activation entering the middle block
    emb: torch.Tensor,      # (B, emb_dim) timestep embedding
    context: torch.Tensor,  # (B, L, D) text conditioning
    mesh,
    *,
    axis: str = "pp",
    num_microbatches: Optional[int] = None,
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """``params["middle_block"]`` with its transformer depth in S stages:
    the sequential middle block's result (res_block -> spatial_transformer
    -> res_block), with the context carried through the stages as the
    activation's second leaf. Raises ValueError when S does not divide the
    depth."""
    from stable_renderer_tpu_torch.models.layers import conv2d, group_norm, linear
    from stable_renderer_tpu_torch.models.unet import AttnHooks, basic_transformer_block, res_block

    cfg = unet.config
    md = cfg.middle_depth()
    S = frame_sharding(mesh, axis).size
    if md < 1 or md % S:
        raise ValueError(f"middle depth {md} not divisible into {S} stages")
    k = md // S
    mp = params["middle_block"]
    h = res_block(mp["0"], h, emb)
    p = mp["1"]
    b, hh, ww, c = h.shape
    x_in = h
    n = group_norm(p["norm"], h)
    use_conv_proj = p["proj_in"]["weight"].dim() == 4
    if use_conv_proj:
        n = conv2d(p["proj_in"], n).reshape(b, hh * ww, c)
    else:
        n = linear(p["proj_in"], n.reshape(b, hh * ww, c))
    blocks = [p["transformer_blocks"][str(i)] for i in range(md)]
    stacked = stack_stage_params([stack_stage_params(blocks[s * k:(s + 1) * k])
                                  for s in range(S)])
    heads = cfg.heads_for(c)

    def stage_fn(stage_params, act):
        tokens, ctx = act
        for j in range(k):
            tokens = basic_transformer_block(_tree_map(lambda a: a[j], stage_params), tokens,
                                             ctx, heads, 0, AttnHooks())
        return tokens, ctx

    n, _ = pipeline_apply(stage_fn, stacked, (n, context), mesh, axis=axis,
                          num_microbatches=num_microbatches, batch_axis=batch_axis)
    if use_conv_proj:
        n = conv2d(p["proj_out"], n.reshape(b, hh, ww, c))
    else:
        n = linear(p["proj_out"], n).reshape(b, hh, ww, c)
    return res_block(mp["2"], n + x_in, emb)
