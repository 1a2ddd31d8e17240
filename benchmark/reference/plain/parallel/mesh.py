"""The process group, the device mesh and the frame shards of a rank.

Counterpart of stable_renderer_tpu/parallel/mesh.py. The JAX package is one
controller over a ``jax.sharding.Mesh`` of chips, with axes

    dp — data parallel over the frame batch (the reference's frame batching)
    tp — tensor parallel over the UNet's attention heads and MLP

and XLA inserts the collectives from sharding annotations. The port runs one
process per card (torchrun's idiom): ``init_distributed`` joins the process
group, ``create_mesh`` lays the world out as a ``DeviceMesh`` with the same
axis names in the same order, and every cross-rank coupling is an explicit
collective over one axis's group. Each rank holds its own shards as plain
tensors: the kernels take no DTensor.

``FrameShard`` is one rank's view of a frame batch split over an axis: its
rows, the whole-batch draws it takes its rows of, and the collectives the
frame path needs (sums, minima, row gathers, the stage shift). Each is the
identity on an axis of one rank, so a one-rank mesh computes what no mesh
computes. ``copy_to_tp`` / ``reduce_from_tp`` are Megatron's pair of
tensor-parallel collectives, differentiable, for the training step.
``tp_context`` / ``dp_context`` carry the tensor-parallel group and the
frame shard into the UNet and the sampler for the length of one render:
nothing is left set after it.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
import tempfile
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from benchmark.reference.plain.device import resolve_device

GROUP_TIMEOUT = timedelta(minutes=10)  # a hung collective fails instead of waiting forever


def default_mesh_shape(n_devices: int, prefer_tp: int = 1) -> Dict[str, int]:
    """Split n devices into dp x tp; tp only when it divides evenly."""
    tp = prefer_tp if prefer_tp > 1 and n_devices % prefer_tp == 0 else 1
    return {"dp": n_devices // tp, "tp": tp}


def init_distributed(device=None) -> torch.device:
    """Join the process group and return this rank's device.

    Under torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
    set) the rank joins torchrun's world; otherwise it starts a world of one
    rank on a file store in a new temporary directory. ``device`` None is the
    card (raises without one) and takes NCCL, rank r on card ``LOCAL_RANK``;
    ``"cpu"`` takes gloo. Neither falls back to the other. A group that is
    already up is kept when its backend is the one ``device`` needs."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, but {dev} "
                               f"needs {backend}")
        return dev
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=GROUP_TIMEOUT)
    else:
        store = os.path.join(tempfile.mkdtemp(prefix="sr-group-"), "store")
        dist.init_process_group(backend, init_method=f"file://{store}", rank=0, world_size=1,
                                timeout=GROUP_TIMEOUT)
    return dev


def create_mesh(shape: Optional[Dict[str, int]] = None, devices: Optional[str] = None):
    """A ``DeviceMesh`` over the process group's world with named axes from
    a {axis: size} dict (insertion order = mesh dims); by default all ranks
    on a ('dp', 'tp') grid. ``devices`` is the device type of the ranks
    ("cuda" or "cpu"), by default the group's ("cuda" under NCCL). Raises
    ValueError when the shape does not cover the world."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call init_distributed first")
    world = dist.get_world_size()
    if shape is None:
        shape = default_mesh_shape(world)
    total = math.prod(shape.values())
    if total != world:
        raise ValueError(f"mesh shape {shape} does not cover {world} ranks")
    device_type = devices or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, tuple(shape.values()), mesh_dim_names=tuple(shape))


def _check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"want a torch DeviceMesh (parallel.create_mesh), got {type(mesh)}")


def has_axis(mesh, axis: str) -> bool:
    """Whether ``mesh`` (a DeviceMesh or None) names ``axis``."""
    if mesh is None:
        return False
    _check_mesh(mesh)
    return axis in (mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``; 1 for no mesh or an axis it does not name."""
    return mesh[axis].size() if has_axis(mesh, axis) else 1


# --- one rank's share of a frame batch -------------------------------------------


@dataclass(frozen=True)
class FrameShard:
    """This rank's share of a batch split in equal contiguous blocks over
    ``group`` (``size`` ranks, this one ``rank``); ``group`` None for one
    rank. Frame i of the batch is row i - rank * (batch / size) here."""

    group: Optional[object]
    rank: int
    size: int

    def local_count(self, n: int) -> int:
        if n % self.size:
            raise ValueError(f"{self.size} ranks do not divide a batch of {n}")
        return n // self.size

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n``."""
        b = self.local_count(n)
        return slice(self.rank * b, (self.rank + 1) * b)

    def take(self, x: Optional[torch.Tensor], dim: int = 0) -> Optional[torch.Tensor]:
        """This rank's rows of the whole batch ``x`` along ``dim``."""
        if x is None or self.size == 1:
            return x
        r = self.rows(x.shape[dim])
        return x.narrow(dim, r.start, r.stop - r.start)

    def randn(self, shape: Sequence[int], generator=None, device=None,
              dtype=None) -> torch.Tensor:
        """This rank's rows of one draw of the whole batch's tensor: ``shape``
        is the local one, dim 0 the rows of this rank's frames (frames, or
        frames x pixels). Every rank draws the whole batch from its copy of
        the generator, so the rows are those the unsharded batch draws."""
        if self.size == 1:
            return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
        full = torch.randn((shape[0] * self.size, *shape[1:]), generator=generator,
                           device=device, dtype=dtype)
        return full[self.rank * shape[0]:(self.rank + 1) * shape[0]]

    def _peer(self, rank: int) -> int:
        return dist.get_global_rank(self.group, rank)

    def all_reduce_(self, x: torch.Tensor, op=None) -> torch.Tensor:
        """``x`` reduced in place over the ranks (a sum by default)."""
        if self.size > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op, group=self.group)
        return x

    def all_reduce_min_(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_reduce_(x, dist.ReduceOp.MIN)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch from every rank's rows (dim 0), on every rank."""
        if self.size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, 0)

    def gather_rows(self, x: torch.Tensor, index: Sequence[int]) -> torch.Tensor:
        """Rows ``index`` of the whole batch (global frame numbers) from the
        ranks that hold them, on every rank: one broadcast a row."""
        b = x.shape[0]
        if self.size == 1:
            return x[torch.as_tensor(list(index), device=x.device).long()]
        out = []
        for j in index:
            owner = j // b
            row = x[j % b].contiguous() if owner == self.rank else torch.empty_like(x[0])
            dist.broadcast(row, src=self._peer(owner), group=self.group)
            out.append(row)
        return torch.stack(out)

    def broadcast_from_last(self, x: torch.Tensor) -> torch.Tensor:
        """The last rank's ``x`` (same shape and type on every rank)."""
        if self.size > 1:
            x = x.contiguous()
            dist.broadcast(x, src=self._peer(self.size - 1), group=self.group)
        return x

    def shift(self, last_rows: List[torch.Tensor]) -> Optional[List[torch.Tensor]]:
        """Each rank sends ``last_rows`` (its last row of each stacked state)
        to the next rank and returns what the previous rank sent: None on
        rank 0 (whose incoming rows come from outside). Rows arrive in the
        sender's shapes and types, which every rank shares."""
        if self.size == 1:
            return None
        ops, got = [], None
        if self.rank + 1 < self.size:
            ops += [dist.P2POp(dist.isend, t.contiguous(), self._peer(self.rank + 1), self.group)
                    for t in last_rows]
        if self.rank > 0:
            got = [torch.empty_like(t) for t in last_rows]
            ops += [dist.P2POp(dist.irecv, t, self._peer(self.rank - 1), self.group) for t in got]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got

    def rotate(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Ring exchange: send ``tensors`` to the next rank, return the
        previous rank's (the K/V rotation of ring attention)."""
        if self.size == 1:
            return tensors
        nxt, prv = self._peer((self.rank + 1) % self.size), self._peer((self.rank - 1) % self.size)
        got = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, self.group) for t in tensors]
        ops += [dist.P2POp(dist.irecv, t, prv, self.group) for t in got]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got


# --- Megatron's pair of tensor-parallel collectives, differentiable --------------------


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp ranks backward."""

    @staticmethod
    def forward(ctx, x, shard: FrameShard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.all_reduce_(grad.clone(memory_format=torch.contiguous_format)), None


class _ReduceFromTP(torch.autograd.Function):
    """The sum over the tp ranks forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, shard: FrameShard):
        return shard.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, shard: Optional[FrameShard]) -> torch.Tensor:
    """``x`` entering column-parallel products over ``shard``'s group: the
    same tensor forward, and under grad a node whose backward all-reduces
    the gradient, which each rank holds only for its share of the columns.
    Without grad (or without a group) ``x`` itself."""
    if shard is None or shard.size == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTP.apply(x, shard)


def reduce_from_tp(x: torch.Tensor, shard: Optional[FrameShard]) -> torch.Tensor:
    """The sum over ``shard``'s group of each rank's row-parallel partial
    product ``x``: in place without grad (the serving path), under grad a
    node whose backward passes the gradient through unchanged."""
    if shard is None or shard.size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, shard)
    return shard.all_reduce_(x)


def frame_sharding(mesh, axis: str = "dp") -> FrameShard:
    """This rank's FrameShard over ``axis`` of ``mesh`` (one rank, no group,
    for no mesh or an axis it does not name)."""
    if not has_axis(mesh, axis) or mesh[axis].size() == 1:
        return FrameShard(None, 0, 1)
    return FrameShard(mesh.get_group(axis), mesh.get_local_rank(axis), mesh[axis].size())


# --- the groups a render runs under ------------------------------------------------

_TP: contextvars.ContextVar = contextvars.ContextVar("sr_tp", default=None)
_DP: contextvars.ContextVar = contextvars.ContextVar("sr_dp", default=None)


@contextlib.contextmanager
def tp_context(shard: Optional[FrameShard]):
    """Run the enclosed UNet and ControlNet evaluations tensor-parallel over
    ``shard``'s group (its ``size`` ranks split the attention heads and the
    MLP, the params being ``apply_param_sharding``'s local shards). None or
    one rank: unsharded."""
    token = _TP.set(shard if shard is not None and shard.size > 1 else None)
    try:
        yield
    finally:
        _TP.reset(token)


@contextlib.contextmanager
def dp_context(shard: Optional[FrameShard]):
    """Run the enclosed render on this rank's frames of a batch split over
    ``shard``: whole-batch draws, corresponder couplings over its group."""
    token = _DP.set(shard if shard is not None and shard.size > 1 else None)
    try:
        yield
    finally:
        _DP.reset(token)


def active_tp() -> Optional[FrameShard]:
    """The tensor-parallel group of the running evaluation (None: none)."""
    return _TP.get()


def active_dp() -> Optional[FrameShard]:
    """The frame shard of the running render (None: the whole batch here)."""
    return _DP.get()


def randn_frames(shape: Sequence[int], generator=None, device=None, dtype=None) -> torch.Tensor:
    """``torch.randn(shape)``, or under ``dp_context`` this rank's rows of
    the whole batch's draw (``FrameShard.randn``)."""
    dp = active_dp()
    if dp is None:
        return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
    return dp.randn(shape, generator=generator, device=device, dtype=dtype)
