"""Multi-card serving and training: the counterpart of
stable_renderer_tpu/parallel/, one process a card over ``torch.distributed``.

  * ``mesh`` — ``init_distributed`` (torchrun's world, or one rank on a file
    store; NCCL on the card, gloo on the CPU), ``create_mesh`` (a
    ``DeviceMesh`` with the JAX package's axis names), the frame shards of a
    rank and the contexts a render runs under.
  * ``sharding`` — the Megatron TP spec tree of a UNet / ControlNet, this
    rank's param shards, this rank's frames of an EngineData.
  * ``ring_attention`` — all-frames attention on one device (K1 on the
    card) and its ring over a mesh axis.

  * ``train`` — the AdamW diffusion step with remat over dp x tp
    (``make_train_state``, ``diffusion_train_step``).
  * ``pipeline`` — GPipe over the ``pp`` axis (``pipeline_apply``,
    ``stack_stage_params``, ``clip_pipeline_encode``,
    ``unet_middle_pipeline``).

``DiffusionPipeline.render(mesh=...)``, ``enable_stream_mesh``,
``OverlapCorresponder(mesh=...)`` and ``CorrespondMap.update_batch`` use
the serving side."""

from stable_renderer_tpu_torch.parallel.mesh import (
    FrameShard,
    create_mesh,
    default_mesh_shape,
    frame_sharding,
    init_distributed,
)
from stable_renderer_tpu_torch.parallel.pipeline import (
    clip_pipeline_encode,
    pipeline_apply,
    stack_stage_params,
)
from stable_renderer_tpu_torch.parallel.ring_attention import (
    cross_frame_attention,
    ring_cross_frame_attention,
)
from stable_renderer_tpu_torch.parallel.sharding import (
    P,
    apply_param_sharding,
    replicate,
    shard_engine_data,
    unet_param_specs,
)
from stable_renderer_tpu_torch.parallel.train import diffusion_train_step, make_train_state

__all__ = [
    "FrameShard",
    "P",
    "apply_param_sharding",
    "clip_pipeline_encode",
    "create_mesh",
    "cross_frame_attention",
    "default_mesh_shape",
    "diffusion_train_step",
    "frame_sharding",
    "init_distributed",
    "make_train_state",
    "pipeline_apply",
    "replicate",
    "ring_cross_frame_attention",
    "shard_engine_data",
    "stack_stage_params",
    "unet_param_specs",
]
