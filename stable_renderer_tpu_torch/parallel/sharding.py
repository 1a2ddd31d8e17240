"""Sharding rules: frame-DP over EngineData, head-TP over UNet params.

Counterpart of stable_renderer_tpu/parallel/sharding.py, with the same
rules, applied by hand where the JAX package annotates and lets GSPMD
partition:

  * The frame batch (EngineData's leading axis) splits over 'dp': each rank
    renders its frames (``shard_engine_data``, ``mesh.FrameShard``).
  * UNet and ControlNet attention and MLP weights split over 'tp',
    Megatron-style: q/k/v and the GEGLU input column-parallel (output dim),
    to_out and the MLP output row-parallel (input dim).
    ``apply_param_sharding`` returns this rank's local shards; under
    ``tp_context`` the transformer block runs its share of the heads and
    all-reduces the row-parallel products over tp before adding their bias
    once (models/unet.py).
  * Everything else (norms, convs, embeddings) is held whole by every rank.

The GEGLU projection ``ff.net.0.proj`` computes ``[x; gate]`` in one product
and splits it in two: its weight and bias split by halves, so that rank r
holds rows r of the x half and rows r of the gate half, which line up with
each other and with its rows of ``ff.net.2``. (A contiguous chunk of the
whole weight would give rank 0 x rows only.)
"""

from __future__ import annotations

import dataclasses

import torch

from stable_renderer_tpu_torch.parallel.mesh import FrameShard, frame_sharding

_TP_COL_SUFFIXES = (  # weight (out, in): shard out
    "attn1.to_q", "attn1.to_k", "attn1.to_v",
    "attn2.to_q", "attn2.to_k", "attn2.to_v",
    "ff.net.0.proj",
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
    "mlp.fc1",
)
_TP_ROW_SUFFIXES = (  # weight (out, in): shard in
    "attn1.to_out.0", "attn2.to_out.0",
    "ff.net.2",
    "self_attn.out_proj",
    "mlp.fc2",
)
_GEGLU = "ff.net.0.proj"


class P(tuple):
    """A partition spec: one entry a dim, the mesh axis it splits over or
    None (``jax.sharding.PartitionSpec``'s tuple, so the two compare)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def unet_param_specs(params: dict, tp_axis: str = "tp") -> dict:
    """The spec tree of a UNet / ControlNet / CLIP param tree (Megatron-style
    head TP): column-parallel weights P(tp, None) and their biases P(tp),
    row-parallel weights P(None, tp), everything else P()."""
    from stable_renderer_tpu_torch.models.weights import flatten, nest

    specs = {}
    for path, value in flatten(params).items():
        spec = P()
        if path.endswith(".weight") and getattr(value, "ndim", 0) == 2:
            base = path[: -len(".weight")]
            if base.endswith(_TP_COL_SUFFIXES):
                spec = P(tp_axis, None)
            elif base.endswith(_TP_ROW_SUFFIXES):
                spec = P(None, tp_axis)
        elif path.endswith(".bias"):
            base = path[: -len(".bias")]
            if base.endswith(_TP_COL_SUFFIXES):
                spec = P(tp_axis)
        specs[path] = spec
    return nest(specs, "")


def _split(x: torch.Tensor, dim: int, shard: FrameShard, path: str) -> torch.Tensor:
    if x.shape[dim] % shard.size:
        raise ValueError(f"{shard.size} tensor-parallel ranks do not divide dim {dim} of {path} "
                         f"{tuple(x.shape)}")
    return x.chunk(shard.size, dim)[shard.rank]


def apply_param_sharding(params: dict, mesh, tp_axis: str = "tp") -> dict:
    """This rank's local shards of a param tree over ``tp_axis`` of ``mesh``
    (``unet_param_specs``): column-parallel weights and biases split on dim 0
    (the GEGLU projection by halves), row-parallel weights on dim 1, the rest
    whole. Raises ValueError where the ranks do not divide a width. With one
    tp rank, the tree itself."""
    return shard_params(params, frame_sharding(mesh, tp_axis), tp_axis)


def shard_params(params: dict, shard: FrameShard, tp_axis: str = "tp") -> dict:
    """``apply_param_sharding`` for rank ``shard.rank`` of ``shard.size``."""
    from stable_renderer_tpu_torch.models.weights import flatten, nest

    if shard.size == 1:
        return params
    specs = flatten(unet_param_specs(params, tp_axis))
    out = {}
    for path, x in flatten(params).items():
        spec = specs[path]
        if spec and spec[0] == tp_axis:
            if path.rsplit(".", 1)[0].endswith(_GEGLU):
                halves = x.chunk(2, 0)
                x = torch.cat([_split(h, 0, shard, path) for h in halves], 0)
            else:
                x = _split(x, 0, shard, path)
        elif len(spec) == 2 and spec[1] == tp_axis:
            x = _split(x, 1, shard, path)
        # a shard of its own, not a view that keeps the whole tensor alive
        out[path] = x.clone(memory_format=torch.contiguous_format) if spec else x
    return nest(out, "")


def replicate(tree: dict, mesh) -> dict:
    """Every rank holds the whole tree: the tree itself (each process has
    its copy; the JAX package places one copy on every chip)."""
    return tree


def shard_engine_data(engine_data, mesh, axis: str = "dp"):
    """This rank's frames of every tensor leaf of an EngineData (its
    leading axis), the host fields (sprites, prompts, maps) kept."""
    shard = frame_sharding(mesh, axis)
    kwargs = {}
    for f in dataclasses.fields(engine_data):
        v = getattr(engine_data, f.name)
        kwargs[f.name] = shard.take(v) if isinstance(v, torch.Tensor) else v
    return type(engine_data)(**kwargs)

