"""Correspondence / temporal-consistency algorithms — the stable-rendering core.

Counterpart of stable_renderer_tpu/ops/correspondence.py (the reference's
corresponder.py: the Corresponder protocol :29-98, DefaultCorresponder
:100-155, OverlapCorresponder :157-377). The hooks plug into the denoise loop
through ``models.unet.AttnHooks`` and the sampler's step callback:

  * ``broadcast_kv_injection`` — every frame attends to the K/V context of
    selected frames (OverlapCorresponder.pre_atten_inject).
  * ``vertex_average_injection`` — blend each latent pixel toward the mean of
    all pixels (across frames) that show the same 3D vertex, then AdaIN back
    to the original statistics (OverlapCorresponder.step_finished).

Ported so far: the ``average`` weighting, both AdaIN modes, and the
corresponders without the bake-time corrmap update or all-frames attention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from stable_renderer_tpu_torch.data.framebuffers import NON_AI_MAP_INDEX
from stable_renderer_tpu_torch.models.unet import AttnHooks
from stable_renderer_tpu_torch.ops.math import adain, group_average_by_id


def broadcast_kv_injection(
    k: torch.Tensor,  # (B, L, C) self-attn key context (pre-projection)
    v: torch.Tensor,  # (B, L, C)
    frame_indices=(0,),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace every frame's K/V context with the concatenation of the
    selected frames' contexts (OverlapCorresponder.pre_atten_inject)."""
    b, l, c = k.shape
    idx = torch.as_tensor(frame_indices, device=k.device).long().reshape(-1) % b
    n_sel = idx.shape[0]
    k_out = k[idx].reshape(n_sel * l, c)[None].expand(b, n_sel * l, c)
    v_out = v[idx].reshape(n_sel * l, c)[None].expand(b, n_sel * l, c)
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


def vertex_average_injection(
    latent: torch.Tensor,    # (B, h, w, C)
    id_maps: torch.Tensor,   # (B, H, W, 4)
    ratio: float = 0.1,
    num_segments: int = 262144,
    weighting: str = "average",
    normal_maps: Optional[torch.Tensor] = None,
    adain_mode: str = "content",
) -> torch.Tensor:
    """Blend each latent pixel toward the mean of all pixels sharing its 3D
    vertex, then AdaIN: ``content`` renormalizes the averaged latent to the
    original statistics; ``reference`` is bug-compatible with the
    reference's step_finished (original content, averaged statistics)."""
    if weighting in ("frame_distance", "pixel_distance") or (
            weighting == "view_normal" and normal_maps is not None):
        raise NotImplementedError(f"weighting={weighting!r} is not ported yet")
    b, h, w, c = latent.shape
    vids, valid = latent_vertex_ids(id_maps, h, w)
    flat = latent.reshape(-1, c)
    per_row, _ = group_average_by_id(flat, vids.reshape(-1), num_segments,
                                     valid=valid.reshape(-1))
    blended = (1.0 - ratio) * flat + ratio * per_row
    blended = torch.where(valid.reshape(-1, 1), blended, flat)
    modified = blended.reshape(b, h, w, c)
    if adain_mode == "reference":
        return adain(latent, modified)
    return adain(modified, latent)


# ---------------------------------------------------------------------------
# host-level corresponder objects (the reference protocol surface)


@dataclass(eq=False)
class Corresponder:
    """Protocol base (corresponder.py:29-98)."""

    layer_range: Optional[Tuple[int, ...]] = (6,)

    def attn_hooks(self, engine_data, generator: Optional[torch.Generator] = None) -> AttnHooks:  # noqa: ANN001
        """Attention hooks for the UNet; ``generator`` seeds per-run choices."""
        return AttnHooks()

    def _gate_layer(self, layer: int) -> bool:
        return self.layer_range is None or layer in self.layer_range

    def make_step_callback(self, id_maps, log_sigmas, normal_maps=None):  # noqa: ANN001
        """Per-step latent callback ``(x, denoised, sigma, i) -> x``, or None."""
        return None

    def finished(self, engine_data, images: torch.Tensor) -> None:  # noqa: ANN001
        pass


@dataclass(eq=False)
class DefaultCorresponder(Corresponder):
    """Bake-path corresponder (corresponder.py:100-155). Its ``finished`` hook
    scatters decoded frames into the submitted CorrespondMaps; that update
    is not ported yet, so it raises when there is a map to update."""

    update_corrmap: bool = True

    def finished(self, engine_data, images: torch.Tensor) -> None:  # noqa: ANN001
        if (self.update_corrmap and images is not None and engine_data is not None
                and engine_data.id_maps is not None and engine_data.correspond_maps):
            raise NotImplementedError("the CorrespondMap update is not ported yet")


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
    at or above ``step_finished_stop_inject_timestep``."""

    pre_attn_inject_num_random_frames: int = 1
    pre_attn_frames: Optional[Tuple[int, ...]] = (1,)
    step_finished_inject_ratio: float = 0.1
    step_finished_stop_inject_timestep: float = 500.0
    vertex_segments: int = 262144
    weighting: str = "average"
    step_finished_adain: str = "content"
    all_frames: bool = False

    def attn_hooks(self, engine_data, generator: Optional[torch.Generator] = None) -> AttnHooks:  # noqa: ANN001
        if self.all_frames:
            raise NotImplementedError("all-frames cross-frame attention is not ported yet")
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
            idx = 1 + frames % max(k.shape[0] - 1, 1) if random_pick else frames
            k2, v2 = broadcast_kv_injection(k, v, idx)
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
                normal_maps=normal_maps, adain_mode=self.step_finished_adain)

        return cb
