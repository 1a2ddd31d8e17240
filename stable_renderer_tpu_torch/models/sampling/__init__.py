from stable_renderer_tpu_torch.models.sampling.assemble import (
    build_denoiser,
    inpaint_concat_channels,
)
from stable_renderer_tpu_torch.models.sampling.samplers import SAMPLER_NAMES, sample
from stable_renderer_tpu_torch.models.sampling.schedules import (
    SCHEDULER_NAMES,
    ModelSampling,
    calculate_sigmas,
)

__all__ = [
    "ModelSampling",
    "calculate_sigmas",
    "SCHEDULER_NAMES",
    "sample",
    "SAMPLER_NAMES",
    "build_denoiser",
    "inpaint_concat_channels",
]
