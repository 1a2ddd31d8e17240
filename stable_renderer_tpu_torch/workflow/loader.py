"""Workflow — loader for the reference's ComfyUI UI-format workflow JSON.

Counterpart of stable_renderer_tpu/workflow/loader.py, node type for node
type. The reference parses the graph into an executable prompt (reference:
engine/static/workflow.py:39-594); here the graph is compiled away: the
loader walks the nodes and extracts the RenderConfig that runs the same
inference (checkpoint, LoRAs, sampler settings, ControlNets with their hint
source, prompts) and the corresponder's name.

Known node types and what they contribute:
  CheckpointLoaderSimple        -> checkpoint_path
  LoraLoader/LoraLoaderModelOnly-> lora_paths (+ strength)
  KSampler/CorrespondSampler    -> seed, steps, cfg, sampler, scheduler, denoise
  ControlNetLoader + ControlNetApply(Advanced) -> ControlNetSpec; the hint source
      is inferred from the EngineData output slot feeding the apply node
  CLIPTextEncode                -> prompt / negative_prompt
  DefaultCorresponder/OverlapCorresponder nodes -> corresponder name
Unknown node types are recorded in ``unknown_types``, not fatal.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from stable_renderer_tpu_torch.utils.log import EngineLogger
from stable_renderer_tpu_torch.workflow.config import ControlNetSpec, RenderConfig

# EngineDataNode output slot names (stable_rendering/_nodes/data.py EngineDataNode
# unpacks EngineData into these outputs, in order)
_ENGINE_DATA_SLOTS = [
    "color", "id", "pos", "normal", "depth", "canny", "noise", "masks",
    "correspond_maps", "sprites", "env_prompt",
]

_CN_NAME_SOURCES = [
    ("normal", "normal"),
    ("depth", "depth"),
    ("canny", "canny"),
    ("openpose", "color"),
    ("pose", "color"),
]


@dataclass
class WorkflowNode:
    id: int
    type: str
    widgets: list
    inputs: Dict[str, Tuple[int, int]] = field(default_factory=dict)  # name -> (node, slot)
    output_names: List[str] = field(default_factory=list)


@dataclass
class Workflow:
    nodes: Dict[int, WorkflowNode]
    unknown_types: List[str]
    path: Optional[str] = None

    @classmethod
    def Load(cls, path: str | Path) -> "Workflow":
        with open(path) as f:
            data = json.load(f)
        wf = cls.from_dict(data)
        wf.path = str(path)
        return wf

    @classmethod
    def from_dict(cls, data: dict) -> "Workflow":
        """Parse an in-memory ComfyUI workflow dict (the web-server POST /prompt
        payload shape; reference workflow.py:39-594)."""
        links = {}  # link_id -> (from_node, from_slot)
        for link in data.get("links", []):
            # link = [id, from_node, from_slot, to_node, to_slot, type]
            links[link[0]] = (link[1], link[2])
        nodes: Dict[int, WorkflowNode] = {}
        unknown: List[str] = []
        for n in data.get("nodes", []):
            node = WorkflowNode(
                id=n["id"],
                type=n.get("type", ""),
                widgets=n.get("widgets_values") or [],
                output_names=[o.get("name", "") for o in (n.get("outputs") or [])],
            )
            for inp in n.get("inputs") or []:
                lid = inp.get("link")
                if lid is not None and lid in links:
                    node.inputs[inp.get("name", "")] = links[lid]
            nodes[node.id] = node
        return cls(nodes=nodes, unknown_types=unknown, path=None)

    # --- graph helpers ---

    def by_type(self, type_name: str) -> List[WorkflowNode]:
        return [n for n in self.nodes.values() if n.type == type_name]

    def upstream(self, node: WorkflowNode, input_name: str) -> Optional[WorkflowNode]:
        ref = node.inputs.get(input_name)
        return self.nodes.get(ref[0]) if ref else None

    def _trace_engine_data_slot(self, node: WorkflowNode, input_name: str) -> Optional[str]:
        """Follow an input link upstream until an EngineData node output is found;
        return the slot name (normal/depth/canny/...)."""
        seen = set()
        cur, name = node, input_name
        while cur is not None and cur.id not in seen:
            seen.add(cur.id)
            ref = cur.inputs.get(name)
            if ref is None:
                # try common passthrough input names
                for alt in ("image", "images", "IMAGE", "pixels"):
                    if alt in cur.inputs:
                        ref = cur.inputs[alt]
                        break
            if ref is None:
                return None
            up = self.nodes.get(ref[0])
            if up is None:
                return None
            if up.type in ("EngineData", "EngineDataNode", "VirtualEngineData"):
                slot = ref[1]
                if up.output_names and slot < len(up.output_names):
                    out = up.output_names[slot].lower()
                else:
                    out = _ENGINE_DATA_SLOTS[slot] if slot < len(_ENGINE_DATA_SLOTS) else ""
                for key in ("normal", "depth", "canny", "color", "noise", "pos"):
                    if key in out:
                        return key
                return None
            cur, name = up, "image"
        return None

    # --- config extraction ---

    def build_config(self) -> RenderConfig:
        """The reference's build_prompt() (workflow.py:488-517) counterpart:
        instead of a node execution plan, produce the RenderConfig that compiles
        the same inference."""
        checkpoint = None
        loras: List[Tuple[str, float]] = []
        prompt, negative = "", ""
        seed, steps, cfg, sampler, scheduler, denoise = 0, 20, 7.0, "euler", "normal", 1.0
        controlnets: List[ControlNetSpec] = []
        known = set()

        for n in self.by_type("CheckpointLoaderSimple"):
            known.add(n.id)
            if n.widgets:
                checkpoint = str(n.widgets[0])
        for t in ("LoraLoaderModelOnly", "LoraLoader"):
            for n in self.by_type(t):
                known.add(n.id)
                if n.widgets:
                    path = str(n.widgets[0]).replace("\\", "/")
                    strength = float(n.widgets[1]) if len(n.widgets) > 1 else 1.0
                    loras.append((path, strength))

        sampler_nodes = (
            self.by_type("KSampler")
            + self.by_type("CorrespondSampler")
            + self.by_type("KSamplerAdvanced")
        )
        for n in sampler_nodes:
            known.add(n.id)
            w = n.widgets
            if len(w) >= 7:
                # KSampler widgets: [seed, seed_mode, steps, cfg, sampler, scheduler, denoise]
                seed = int(w[0]) % (2**31)
                steps = int(w[2])
                cfg = float(w[3])
                sampler = str(w[4])
                scheduler = str(w[5])
                denoise = float(w[6])
            elif len(w) >= 5:
                # CorrespondSampler: [steps, cfg, sampler, scheduler, denoise]
                # — no seed widget (stable_rendering/_nodes/samplers.py:139-143)
                steps = int(w[0])
                cfg = float(w[1])
                sampler = str(w[2])
                scheduler = str(w[3])
                denoise = float(w[4])

        for n in self.by_type("CLIPTextEncode"):
            known.add(n.id)
            text = str(n.widgets[0]) if n.widgets else ""
            # negative if it feeds a 'negative' input downstream
            is_negative = any(
                ref == (n.id, 0) and name == "negative"
                for m in self.nodes.values()
                for name, ref in m.inputs.items()
            )
            if is_negative:
                negative = text
            elif text:
                prompt = text

        loaders = {}
        for n in self.by_type("ControlNetLoader"):
            known.add(n.id)
            loaders[n.id] = str(n.widgets[0]) if n.widgets else ""
        for t in ("ControlNetApply", "ControlNetApplyAdvanced"):
            for n in self.by_type(t):
                known.add(n.id)
                up = self.upstream(n, "control_net")
                model_name = loaders.get(up.id, "") if up else ""
                source = self._trace_engine_data_slot(n, "image")
                if source is None:
                    source = "canny"
                    for key, src in _CN_NAME_SOURCES:
                        if key in model_name.lower():
                            source = src
                            break
                strength = float(n.widgets[0]) if n.widgets else 1.0
                start_p, end_p = 0.0, 1.0
                if t == "ControlNetApplyAdvanced" and len(n.widgets) >= 3:
                    start_p, end_p = float(n.widgets[1]), float(n.widgets[2])
                controlnets.append(
                    ControlNetSpec(
                        source=source,
                        strength=strength,
                        start_percent=start_p,
                        end_percent=end_p,
                        model_path=model_name or None,
                    )
                )

        unknown = sorted(
            {
                n.type
                for n in self.nodes.values()
                if n.id not in known
                and n.type
                not in (
                    "EngineData", "EngineDataNode", "VirtualEngineData", "VAEDecode",
                    "InferenceOutput", "EmptyCorrMaps", "DefaultCorresponder",
                    "OverlapCorresponder", "SceneTextEncode", "MaskedTextEncode",
                    "Note", "Reroute",
                )
            }
        )
        if unknown:
            EngineLogger.info(f"Workflow {self.path}: unmapped node types {unknown}")
        self.unknown_types = unknown

        return RenderConfig(
            prompt=prompt,
            negative_prompt=negative,
            steps=steps,
            cfg_scale=cfg,
            sampler=sampler,
            scheduler=scheduler,
            denoise=denoise,
            seed=seed,
            controlnets=tuple(controlnets),
            checkpoint_path=checkpoint,
            lora_paths=tuple(loras),
        )

    def corresponder_name(self) -> Optional[str]:
        for t in ("OverlapCorresponder", "DefaultCorresponder"):
            if self.by_type(t):
                return t
        return None
