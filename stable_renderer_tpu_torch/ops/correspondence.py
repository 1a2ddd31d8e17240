"""Correspondence / temporal-consistency algorithms — the stable-rendering core.

Counterpart of stable_renderer_tpu/ops/correspondence.py (the reference's
corresponder.py: the Corresponder protocol :29-98, DefaultCorresponder
:100-155, OverlapCorresponder :157-377). The hooks plug into the denoise loop
through ``models.unet.AttnHooks`` and the sampler's step callback:

  * ``broadcast_kv_injection`` — every frame attends to the K/V context of
    selected frames (OverlapCorresponder.pre_atten_inject).
  * ``vertex_average_injection`` — blend each latent pixel toward the mean of
    all pixels (across frames) that show the same 3D vertex, then AdaIN back
    to the original statistics (OverlapCorresponder.step_finished), with
    the reference's legacy weightings.
  * ``vertex_noise`` — CreateNoiseSequenceFromIdMap: the same starting noise
    for a 3D vertex in every frame.

  * ``DefaultCorresponder.finished`` — the bake: scatter the decoded frames
    into every submitted CorrespondMap (data/corrmap.py), without a host sync.
  * ``OverlapCorresponder(all_frames=True)`` — every frame attends to the K/V
    of all frames (parallel/ring_attention.py ``cross_frame_attention``, K1
    on the card; its ring form over a mesh's ranks with ``mesh``).

With the frames split over ranks (``DiffusionPipeline.render(mesh=...)``,
``parallel.mesh.dp_context``) the couplings across frames are collectives
over the frame axis, where the JAX package's GSPMD inserts them: the
injected K/V rows come from the ranks that hold them, the vertex averages
sum over every rank's frames, and all-frames attention runs the ring.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from stable_renderer_tpu_torch.data.framebuffers import NON_AI_MAP_INDEX
from stable_renderer_tpu_torch.models.unet import AttnHooks
from stable_renderer_tpu_torch.ops.math import (
    adain,
    group_average_by_id,
    group_frame_distance_average,
    group_randn_by_id,
    group_weighted_average_by_id,
)
from stable_renderer_tpu_torch.parallel.mesh import FrameShard, active_dp, randn_frames
from stable_renderer_tpu_torch.utils.timer import staged


def broadcast_kv_injection(
    k: torch.Tensor,  # (B, L, C) self-attn key context (pre-projection)
    v: torch.Tensor,  # (B, L, C)
    frame_indices=(0,),
    shard: Optional[FrameShard] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace every frame's K/V context with the concatenation of the
    selected frames' contexts (OverlapCorresponder.pre_atten_inject). With
    ``shard`` the rows are this rank's frames of a batch of B * shard.size,
    the indices count that batch, and each selected row comes from the rank
    that holds it (one broadcast a row; once when k is v)."""
    b, l, c = k.shape
    if shard is None or shard.size == 1:
        idx = torch.as_tensor(frame_indices, device=k.device).long().reshape(-1) % b
        k_sel, v_sel = k[idx], v[idx]
    else:
        idx = [int(i) % (b * shard.size) for i in torch.as_tensor(frame_indices).reshape(-1)]
        k_sel = shard.gather_rows(k, idx)
        v_sel = k_sel if v is k else shard.gather_rows(v, idx)
    n_sel = k_sel.shape[0]
    k_out = k_sel.reshape(n_sel * l, c)[None].expand(b, n_sel * l, c)
    v_out = v_sel.reshape(n_sel * l, c)[None].expand(b, n_sel * l, c)
    return k_out, v_out


def latent_vertex_ids(id_maps: torch.Tensor, height: int, width: int):
    """Nearest-downsample the (B, H, W, 4) id map to latent resolution; return
    (vertex_ids (B, h, w), valid (B, h, w)) — the reference's screen-ratio
    scaling (corresponder.py:313-318)."""
    _, ih, iw, _ = id_maps.shape
    rows = torch.arange(height, device=id_maps.device) * ih // height
    cols = torch.arange(width, device=id_maps.device) * iw // width
    small = id_maps[:, rows][:, :, cols]
    valid = (small[..., 2] != NON_AI_MAP_INDEX) & (small != 0).any(-1)
    return small[..., 3], valid


@staged("correspond")
def vertex_average_injection(
    latent: torch.Tensor,    # (B, h, w, C)
    id_maps: torch.Tensor,   # (B, H, W, 4)
    ratio: float = 0.1,
    num_segments: int = 262144,
    weighting: str = "average",
    normal_maps: Optional[torch.Tensor] = None,
    adain_mode: str = "content",
    shard: Optional[FrameShard] = None,
) -> torch.Tensor:
    """Blend each latent pixel toward the (weighted) mean of all pixels
    (across frames) sharing its 3D vertex, then AdaIN: ``content``
    renormalizes the averaged latent to the original statistics;
    ``reference`` is bug-compatible with the reference's step_finished
    (original content, averaged statistics).

    ``weighting``, the reference's legacy overlap schemes (legacy_codes/
    stable_rendering_algo/overlap/algorithms.py:6-121):
      * "average"        — uniform group mean (AverageDistance);
      * "frame_distance" — pairwise 1/(|f_i - f_j| + 1) mixing over frames;
      * "pixel_distance" — trust 1/(|x - x̄_g| + |y - ȳ_g| + 1), pixels far
                           from the vertex's mean screen position count less;
      * "view_normal"    — trust 1/(|1 - facing| + 1), facing = |n_z| of the
                           encoded normal map; "average" when normal_maps is
                           None.

    With ``shard`` the B frames are this rank's of a batch split over its
    ranks: the group sums add over every rank's frames (``all_reduce``) and
    frame_distance counts frames in the whole batch."""
    b, h, w, c = latent.shape
    vids, valid = latent_vertex_ids(id_maps, h, w)
    flat = latent.reshape(-1, c)
    flat_ids = vids.reshape(-1)
    flat_valid = valid.reshape(-1)
    dev = latent.device
    if shard is not None and shard.size == 1:
        shard = None
    reduce = None if shard is None else shard.all_reduce_
    if weighting == "frame_distance":
        first, n_frames = (0, b) if shard is None else (shard.rank * b, b * shard.size)
        frames = torch.arange(first, first + b, device=dev).repeat_interleave(h * w)
        per_row = group_frame_distance_average(flat, flat_ids, frames, num_segments, n_frames,
                                               valid=flat_valid, reduce=reduce)
    elif weighting == "pixel_distance":
        xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(b * h)
        ys = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w).repeat(b)
        pos = torch.stack([xs, ys], -1)
        mean_pos, _ = group_average_by_id(pos, flat_ids, num_segments, valid=flat_valid,
                                          reduce=reduce)
        dist = (pos - mean_pos).abs().sum(-1)
        per_row = group_weighted_average_by_id(flat, flat_ids, 1.0 / (dist + 1.0),
                                               num_segments, valid=flat_valid, reduce=reduce)
    elif weighting == "view_normal" and normal_maps is not None:
        rows = torch.arange(h, device=dev) * normal_maps.shape[1] // h
        cols = torch.arange(w, device=dev) * normal_maps.shape[2] // w
        small = normal_maps[:, rows][:, :, cols]
        # encoded [0, 1] -> view-space normal; facing = |n_z| (1 = toward the camera)
        facing = (small[..., 2] * 2.0 - 1.0).abs().reshape(-1)
        per_row = group_weighted_average_by_id(flat, flat_ids, 1.0 / ((1.0 - facing).abs() + 1.0),
                                               num_segments, valid=flat_valid, reduce=reduce)
    else:
        per_row, _ = group_average_by_id(flat, flat_ids, num_segments, valid=flat_valid,
                                         reduce=reduce)
    blended = (1.0 - ratio) * flat + ratio * per_row
    blended = torch.where(flat_valid[:, None], blended, flat)
    modified = blended.reshape(b, h, w, c)
    if adain_mode == "reference":
        return adain(latent, modified)
    return adain(modified, latent)


def vertex_noise(
    generator: Optional[torch.Generator],
    id_maps: torch.Tensor,  # (B, H, W, 4)
    height: int,
    width: int,
    channels: int = 4,
    num_segments: int = 262144,
    table: Optional[torch.Tensor] = None,
    fallback: Optional[torch.Tensor] = None,
    indep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-vertex-consistent starting noise at latent resolution
    (CreateNoiseSequenceFromIdMap): pixels of one 3D vertex get the same
    gaussian sample in every frame, background pixels independent ones.
    Draws, from ``generator`` in this order unless passed in: the per-id
    ``table`` (num_segments, channels), the out-of-range ids' ``fallback``
    and the background's ``indep`` (both (B*height*width, channels)).
    Under ``parallel.mesh.dp_context`` the per-pixel draws are this rank's
    rows of the whole batch's."""
    b = id_maps.shape[0]
    vids, valid = latent_vertex_ids(id_maps, height, width)
    rows = (b * height * width, channels)
    if active_dp() is not None:
        if table is None:
            table = torch.randn((num_segments, channels), generator=generator,
                                device=id_maps.device)
        if fallback is None:
            fallback = randn_frames(rows, generator=generator, device=id_maps.device)
    flat = group_randn_by_id(generator, vids.reshape(-1), num_segments, channels,
                             table=table, fallback=fallback)
    if indep is None:
        indep = randn_frames(rows, generator=generator, device=id_maps.device)
    out = torch.where(valid.reshape(-1, 1), flat, indep.to(flat.device, flat.dtype))
    return out.reshape(b, height, width, channels)


# ---------------------------------------------------------------------------
# host-level corresponder objects (the reference protocol surface)


@dataclass(eq=False)
class Corresponder:
    """Protocol base (corresponder.py:29-98)."""

    layer_range: Optional[Tuple[int, ...]] = (6,)

    def prepare(self, engine_data) -> None:  # noqa: ANN001
        """Called before a render; the base does nothing."""

    def attn_hooks(self, engine_data, generator: Optional[torch.Generator] = None) -> AttnHooks:  # noqa: ANN001
        """Attention hooks for the UNet; ``generator`` seeds per-run choices."""
        return AttnHooks()

    def _gate_layer(self, layer: int) -> bool:
        """layer_range gating (corresponder.py:162-166): the transformer
        indices the hooks act on (one a SpatialTransformer, 0..15 for SD1.5
        and 0..10 for SDXL); None = all."""
        return self.layer_range is None or layer in self.layer_range

    def step_callback(self, engine_data, ms=None, sigmas=None):  # noqa: ANN001
        """``make_step_callback`` over ``engine_data``'s id and normal maps
        (None without engine data) and ``ms``'s log sigmas (None without a
        ModelSampling): ``(x, denoised, sigma, i) -> x``, or None."""
        log_sigmas = None if ms is None else torch.as_tensor(ms.log_sigmas)
        id_maps = None if engine_data is None else engine_data.id_maps
        normals = None if engine_data is None else engine_data.normal_maps
        return self.make_step_callback(id_maps, log_sigmas, normals)

    def make_step_callback(self, id_maps, log_sigmas, normal_maps=None):  # noqa: ANN001
        """Per-step latent callback ``(x, denoised, sigma, i) -> x``, or None."""
        return None

    def finished(self, engine_data, images: torch.Tensor) -> None:  # noqa: ANN001
        pass


@dataclass(eq=False)
class DefaultCorresponder(Corresponder):
    """Bake-path corresponder (corresponder.py:100-155): on ``finished``
    (after the VAE decode) scatter the decoded frames into every submitted
    CorrespondMap, the AI pixels only (``masks=id_masks(id_maps)`` inverted).
    The update stays on the device and never waits for it."""

    update_corrmap: bool = True
    update_corrmap_mode: str = "first_avg"
    ignore_obj_mat_id_when_update: bool = False

    def finished(self, engine_data, images: torch.Tensor) -> None:  # noqa: ANN001
        if not self.update_corrmap or images is None or engine_data is None \
                or engine_data.id_maps is None:
            return
        from stable_renderer_tpu_torch.data.idmap import id_masks

        id_maps = engine_data.id_maps
        masks = id_masks(id_maps)
        for (sprite_id, material_id), cmap in engine_data.correspond_maps.items():
            cmap.update(
                color_frames=images,
                id_maps=id_maps,
                mode=self.update_corrmap_mode,
                masks=masks,
                spriteID=sprite_id,
                materialID=material_id,
                ignore_obj_mat_id=self.ignore_obj_mat_id_when_update,
                inverse_masks=True,  # update the non-background pixels
            )


_DEFAULT_CORRESPONDER: Optional[DefaultCorresponder] = None


def default_corresponder() -> DefaultCorresponder:
    """The shared default corresponder instance (stateless config)."""
    global _DEFAULT_CORRESPONDER
    if _DEFAULT_CORRESPONDER is None:
        _DEFAULT_CORRESPONDER = DefaultCorresponder()
    return _DEFAULT_CORRESPONDER


@dataclass(eq=False)
class OverlapCorresponder(DefaultCorresponder):
    """Cross-frame-consistency corresponder (corresponder.py:157-377): at the
    gated layers every frame attends to the K/V of ``pre_attn_frames`` (or of
    ``pre_attn_inject_num_random_frames`` frames picked per run when that is
    None), and each step vertex-averages the latent while the timestep is
    at or above ``step_finished_stop_inject_timestep``.

    ``all_frames=True``: at the gated layers every frame attends to the K/V
    of all frames instead (``cross_frame_attention``; under CFG the
    positive rows, as the denoiser hands the hook). ``mesh`` (a DeviceMesh)
    runs it as the ring over the ranks of ``mesh_axis``: in a render with
    that mesh each rank holds its frames; without one, each rank runs the
    ring on its share of the batch and gathers the outputs. A render over a
    mesh runs the ring over its frame axis whether or not ``mesh`` is set.

    In a render over a mesh the injected frames are numbered in the whole
    batch and fetched from their ranks, the random pick draws the same bits
    on every rank, and the step's vertex averaging sums over all ranks."""

    update_corrmap_mode: str = "first"
    pre_attn_inject_num_random_frames: int = 1
    pre_attn_frames: Optional[Tuple[int, ...]] = (1,)
    step_finished_inject_ratio: float = 0.1
    step_finished_stop_inject_timestep: float = 500.0
    vertex_segments: int = 262144
    weighting: str = "average"
    step_finished_adain: str = "content"
    all_frames: bool = False
    mesh: Optional[object] = None  # a DeviceMesh: the ring form over mesh_axis
    mesh_axis: str = "dp"

    def attn_hooks(self, engine_data, generator: Optional[torch.Generator] = None) -> AttnHooks:  # noqa: ANN001
        if self.all_frames:
            from stable_renderer_tpu_torch.parallel.mesh import frame_sharding
            from stable_renderer_tpu_torch.parallel.ring_attention import (
                cross_frame_attention,
                ring_attention_shard,
            )

            own = None if self.mesh is None else frame_sharding(self.mesh, self.mesh_axis)

            def attn(q, k, v, heads, layer):
                from stable_renderer_tpu_torch.models.layers import attention as _plain

                if not self._gate_layer(layer):
                    return _plain(q, k, v, heads)
                dp = active_dp()
                if dp is not None:  # this rank's frames of the render's batch
                    return ring_attention_shard(q, k, v, heads, dp)
                if own is not None and own.size > 1:  # the whole batch on every rank
                    local = ring_attention_shard(own.take(q), own.take(k), own.take(v), heads, own)
                    return own.gather(local)
                return cross_frame_attention(q, k, v, heads)

            return AttnHooks(attn=attn)
        if self.pre_attn_inject_num_random_frames < 0:
            return AttnHooks()
        n_sel = max(self.pre_attn_inject_num_random_frames, 1)
        random_pick = self.pre_attn_frames is None
        if not random_pick:
            frames = torch.as_tensor(self.pre_attn_frames[:n_sel])
        elif generator is not None:
            # mapped to [1, B) inside pre, where the frame count is known
            frames = torch.randint(0, 1_000_003, (n_sel,), generator=generator,
                                   device=generator.device).cpu()
        else:
            frames = torch.arange(1, n_sel + 1)
            random_pick = False

        def pre(q, k, v, layer):
            if not self._gate_layer(layer):
                return q, k, v
            dp = active_dp()
            n = k.shape[0] * (1 if dp is None else dp.size)  # frames in the whole batch
            idx = 1 + frames % max(n - 1, 1) if random_pick else frames
            k2, v2 = broadcast_kv_injection(k, v, idx, shard=dp)
            return q, k2, v2

        return AttnHooks(pre=pre)

    def make_step_callback(self, id_maps, log_sigmas, normal_maps=None):  # noqa: ANN001
        if id_maps is None:
            return None
        from stable_renderer_tpu_torch.models.sampling.cfg import timestep_from_sigma

        def cb(x, denoised, sigma, i):
            # sigma lives on the host: the timestep gate is a host branch
            if log_sigmas is not None and float(timestep_from_sigma(log_sigmas, sigma)) < \
                    self.step_finished_stop_inject_timestep:
                return x
            return vertex_average_injection(
                x, id_maps, self.step_finished_inject_ratio,
                num_segments=self.vertex_segments, weighting=self.weighting,
                normal_maps=normal_maps, adain_mode=self.step_finished_adain,
                shard=active_dp())

        return cb
