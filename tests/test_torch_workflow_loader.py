"""The port's workflow loader (workflow/loader.py) against the JAX package's.

Two workflows built here in the reference's UI format: a miku-control-shaped
graph (checkpoint, LoRA, KSampler lcm / sgm_uniform 4 steps cfg 2, two
ControlNetApplyAdvanced fed from EngineData normal and depth, one through a
passthrough node, a third ControlNetApply whose source is found by the
model's name, a negative CLIPTextEncode, unknown nodes) and a
CorrespondSampler variant. Both packages' ``build_config()`` must give equal
RenderConfig fields, ``unknown_types`` and ``corresponder_name()``.
"""

from __future__ import annotations

import dataclasses
import json

import pytest

from stable_renderer_tpu.workflow import Workflow as JWorkflow
from stable_renderer_tpu_torch.workflow import Workflow as PWorkflow
from stable_renderer_tpu_torch.workflow.config import ControlNetSpec, RenderConfig

ENGINE_DATA_OUTPUTS = ["color", "id", "pos", "normal", "depth", "canny", "noise", "masks",
                       "correspond_maps", "sprites", "env_prompt"]


def _graph(nodes: list, edges: list) -> dict:
    """A UI-format workflow: ``nodes`` as (id, type, widgets, outputs),
    ``edges`` as (from node, from slot, to node, input name)."""
    inputs = {}
    links = []
    for lid, (a, slot, b, name) in enumerate(edges, start=1):
        links.append([lid, a, slot, b, 0, "*"])
        inputs.setdefault(b, []).append({"name": name, "link": lid})
    return {"nodes": [{"id": i, "type": t, "widgets_values": w,
                       "outputs": [{"name": o} for o in outs],
                       "inputs": inputs.get(i, [])} for i, t, w, outs in nodes],
            "links": links}


def miku_control() -> dict:
    nodes = [
        (1, "CheckpointLoaderSimple", ["sd15\\v1-5-pruned-emaonly.safetensors"],
         ["MODEL", "CLIP", "VAE"]),
        (2, "LoraLoader", ["loras\\lcm-lora-sdv1-5.safetensors", 0.8, 1.0], ["MODEL", "CLIP"]),
        (3, "CLIPTextEncode", ["hatsune miku, masterpiece"], ["CONDITIONING"]),
        (4, "CLIPTextEncode", ["lowres, bad anatomy"], ["CONDITIONING"]),
        (5, "EngineData", [], ENGINE_DATA_OUTPUTS),
        (6, "ImageInvert", [], ["IMAGE"]),  # passthrough between EngineData and the apply
        (7, "ControlNetLoader", ["control_v11p_sd15_normalbae.pth"], ["CONTROL_NET"]),
        (8, "ControlNetLoader", ["control_v11f1p_sd15_depth.pth"], ["CONTROL_NET"]),
        (9, "ControlNetApplyAdvanced", [0.6, 0.0, 0.8], ["positive", "negative"]),
        (10, "ControlNetApplyAdvanced", [0.5, 0.1, 1.0], ["positive", "negative"]),
        (11, "LoadImage", ["pose.png"], ["IMAGE"]),
        (12, "ControlNetLoader", ["control_v11p_sd15_openpose.pth"], ["CONTROL_NET"]),
        (13, "ControlNetApply", [0.7], ["CONDITIONING"]),
        (14, "KSampler", [2**31 + 123, "fixed", 4, 2.0, "lcm", "sgm_uniform", 1.0], ["LATENT"]),
        (15, "VAEDecode", [], ["IMAGE"]),
        (16, "InferenceOutput", [], []),
        (17, "OverlapCorresponder", [], ["CORRESPONDER"]),
        (18, "FancyUpscaler", [2.0], ["IMAGE"]),
        (19, "Note", ["a note"], []),
    ]
    edges = [
        (1, 0, 2, "model"), (1, 1, 2, "clip"), (2, 1, 3, "clip"), (2, 1, 4, "clip"),
        (5, 3, 6, "image"),
        (3, 0, 9, "positive"), (4, 0, 9, "negative"), (7, 0, 9, "control_net"),
        (6, 0, 9, "image"),
        (9, 0, 10, "positive"), (9, 1, 10, "negative"), (8, 0, 10, "control_net"),
        (5, 4, 10, "image"),
        (10, 0, 13, "conditioning"), (12, 0, 13, "control_net"), (11, 0, 13, "image"),
        (2, 0, 14, "model"), (13, 0, 14, "positive"), (10, 1, 14, "negative"),
        (14, 0, 15, "samples"), (15, 0, 18, "image"), (18, 0, 16, "images"),
    ]
    return _graph(nodes, edges)


def correspond_sampler() -> dict:
    nodes = [
        (1, "CheckpointLoaderSimple", ["dreamshaper_8.safetensors"], ["MODEL", "CLIP", "VAE"]),
        (2, "LoraLoaderModelOnly", ["lcm.safetensors"], ["MODEL"]),
        (3, "CLIPTextEncode", ["a boat"], ["CONDITIONING"]),
        (4, "CLIPTextEncode", [""], ["CONDITIONING"]),
        (5, "VirtualEngineData", [], []),  # no named outputs: slots by position
        (6, "ControlNetLoader", ["my_controlnet.safetensors"], ["CONTROL_NET"]),
        (7, "ControlNetApplyAdvanced", [1.0, 0.0, 1.0], ["positive", "negative"]),
        (8, "CorrespondSampler", [6, 3.0, "euler", "karras", 0.7], ["LATENT"]),
        (9, "DefaultCorresponder", [], ["CORRESPONDER"]),
        (10, "SceneTextEncode", ["scene"], ["CONDITIONING"]),
    ]
    edges = [(3, 0, 7, "positive"), (4, 0, 7, "negative"), (6, 0, 7, "control_net"),
             (5, 5, 7, "image"), (2, 0, 8, "model"), (7, 0, 8, "positive"),
             (7, 1, 8, "negative")]
    return _graph(nodes, edges)


@pytest.mark.parametrize("make", [miku_control, correspond_sampler])
def test_build_config_matches_jax(tmp_path, make):
    path = tmp_path / "wf.json"
    path.write_text(json.dumps(make()))
    jw, pw = JWorkflow.Load(path), PWorkflow.Load(path)
    assert pw.path == jw.path == str(path)
    for i, jn in jw.nodes.items():
        assert dataclasses.asdict(pw.nodes[i]) == dataclasses.asdict(jn)
    jc, pc = jw.build_config(), pw.build_config()
    assert isinstance(pc, RenderConfig)
    assert [f.name for f in dataclasses.fields(pc)] == [f.name for f in dataclasses.fields(jc)]
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert all(isinstance(s, ControlNetSpec) for s in pc.controlnets)
    assert pw.unknown_types == jw.unknown_types
    assert pw.corresponder_name() == jw.corresponder_name()


def test_miku_control_config():
    """What the miku-control graph maps to, field by field."""
    wf = PWorkflow.from_dict(miku_control())
    cfg = wf.build_config()
    assert (cfg.seed, cfg.steps, cfg.cfg_scale, cfg.sampler, cfg.scheduler, cfg.denoise) == (
        123, 4, 2.0, "lcm", "sgm_uniform", 1.0)
    assert cfg.prompt == "hatsune miku, masterpiece"
    assert cfg.negative_prompt == "lowres, bad anatomy"
    assert cfg.checkpoint_path == "sd15\\v1-5-pruned-emaonly.safetensors"
    assert cfg.lora_paths == (("loras/lcm-lora-sdv1-5.safetensors", 0.8),)
    # ControlNetApply nodes come first, then ControlNetApplyAdvanced, in graph order
    assert [(c.source, c.strength, c.start_percent, c.end_percent) for c in cfg.controlnets] == [
        ("color", 0.7, 0.0, 1.0), ("normal", 0.6, 0.0, 0.8), ("depth", 0.5, 0.1, 1.0)]
    assert wf.unknown_types == ["FancyUpscaler", "ImageInvert", "LoadImage"]
    assert wf.corresponder_name() == "OverlapCorresponder"


def test_correspond_sampler_config():
    wf = PWorkflow.from_dict(correspond_sampler())
    cfg = wf.build_config()
    assert (cfg.seed, cfg.steps, cfg.cfg_scale, cfg.sampler, cfg.scheduler, cfg.denoise) == (
        0, 6, 3.0, "euler", "karras", 0.7)
    assert [c.source for c in cfg.controlnets] == ["canny"]  # slot 5 of EngineData
    assert wf.corresponder_name() == "DefaultCorresponder"
    assert wf.unknown_types == []
