"""Host utilities: logging, registries, events, timers and output paths."""

from stable_renderer_tpu_torch.utils.log import EngineLogger, get_logger
from stable_renderer_tpu_torch.utils.registry import (
    GetGlobalValue,
    GetOrAddGlobalValue,
    SetGlobalValue,
    cross_module_singleton,
)
from stable_renderer_tpu_torch.utils.events import Event, AutoSortTask
from stable_renderer_tpu_torch.utils.timer import StageTimer, FPSCounter

__all__ = [
    "EngineLogger",
    "get_logger",
    "GetGlobalValue",
    "GetOrAddGlobalValue",
    "SetGlobalValue",
    "cross_module_singleton",
    "Event",
    "AutoSortTask",
    "StageTimer",
    "FPSCounter",
]
