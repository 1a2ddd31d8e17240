"""Render configuration and the workflow JSON loader."""

from stable_renderer_tpu_torch.workflow.config import ControlNetSpec, RenderConfig
from stable_renderer_tpu_torch.workflow.loader import Workflow

__all__ = ["RenderConfig", "ControlNetSpec", "Workflow"]
