"""Workflow type system: validation, adapters, lazy inputs.

Counterpart of stable_renderer_tpu/workflow/validation.py, spec for spec, so
both packages accept and reject the same graphs. Three reference subsystems:

  * prompt validation (reference: comfyUI/execution.py:1170-1512
    validate_inputs/validate_prompt) — structural link checks, widget
    coercion + min/max/combo checks, producer->consumer type compatibility,
    collected as the reference's structured error dicts;
  * type adapters (reference: comfyUI/adapters.py:18-150 Adapter registry +
    find_adapter) — automatic conversions inserted at input binding when the
    producer's declared return type differs from the consumer's declared
    input type, with ANY->T fallback exactly like the reference;
  * lazy inputs (reference: comfyUI/types/basic.py:1026-1133 Lazy[T]) — a
    declared-lazy input arrives as a ``Lazy`` handle; the producing subgraph
    only executes if ``.value`` is forced, so If branches not taken are never
    computed.

All of this is host-side graph plumbing that runs once per submit; it
launches nothing on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# adapters (reference adapters.py:18-150)

ADAPTERS: Dict[Tuple[str, str], Callable[[Any], Any]] = {}


def register_adapter(frm: str, to: str):
    def deco(fn: Callable[[Any], Any]) -> Callable[[Any], Any]:
        ADAPTERS[(frm, to)] = fn
        return fn

    return deco


def type_matchings() -> Dict[str, List[str]]:
    """Available type conversions, keyed by source type (the reference's
    /type_matchings route, Adapter._AvailableTypeConvertionInfo,
    adapters.py:60-80 + server.py:524-528)."""
    out: Dict[str, List[str]] = {}
    for frm, to in sorted(ADAPTERS):
        out.setdefault(frm, []).append(to)
    return out


# node types that may appear at most once per graph (reference node_base.py
# UNIQUE flag; InferenceOutputNode is the only shipped Unique node,
# stable_rendering/_nodes/data.py:117; served at /unique_node_types)
UNIQUE_NODE_TYPES = frozenset({"InferenceOutput", "InferenceOutputNode"})


def find_adapter(frm: str, to: str) -> Optional[Callable[[Any], Any]]:
    """Find a converter frm->to; ANY->to is the fallback (adapters.py:83-110)."""
    if frm in ("*",):
        frm = "ANY"
    if to in ("*",):
        to = "ANY"
    if frm == to:
        return None
    if (frm, to) in ADAPTERS:
        return ADAPTERS[(frm, to)]
    return ADAPTERS.get(("ANY", to))


@register_adapter("ANY", "STRING")
def _any_to_str(v):
    return str(v)


@register_adapter("STRING", "INT")
def _str_to_int(v):
    return int(v)


@register_adapter("STRING", "FLOAT")
def _str_to_float(v):
    return float(v)


@register_adapter("STRING", "COMBO")
def _str_to_combo(v):
    return v


@register_adapter("INT", "FLOAT")
def _int_to_float(v):
    return float(v)


@register_adapter("FLOAT", "INT")
def _float_to_int(v):
    return int(v)


@register_adapter("IMAGE", "MASK")
def _image_to_mask(v):
    """(B,H,W,C) image -> (B,H,W) mask: alpha if present else first channel
    (reference TextureToMASK, adapters.py:136-146)."""
    if v is None or getattr(v, "ndim", 0) < 3:
        return v
    if v.ndim == 4:
        return v[..., 3] if v.shape[-1] == 4 else v[..., 0]
    return v


@register_adapter("MASK", "IMAGE")
def _mask_to_image(v):
    if v is None or getattr(v, "ndim", 0) == 0:
        return v
    if v.ndim == 3:  # (B,H,W) -> (B,H,W,3)
        import torch

        return torch.as_tensor(v)[..., None].repeat(1, 1, 1, 3)
    return v


@register_adapter("IMAGE", "NUMPY")
def _image_to_numpy(v):
    import numpy as np

    if hasattr(v, "detach"):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


# ---------------------------------------------------------------------------
# node specs

@dataclass(frozen=True)
class WidgetSpec:
    """Positional widget contract (the reference's named INPUT_TYPES entry —
    our loader keeps ComfyUI widget values positional)."""

    name: str
    type: str = "ANY"  # INT | FLOAT | STRING | COMBO:<choices-key> | ANY
    min: Optional[float] = None
    max: Optional[float] = None
    choices: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class NodeSpec:
    """Declared IO contract for one node type (reference INPUT_TYPES /
    RETURN_TYPES, types/node_base.py). Undeclared = everything ANY."""

    input_types: Dict[str, str] = field(default_factory=dict)
    return_types: Tuple[str, ...] = ()
    widgets: Tuple[WidgetSpec, ...] = ()
    lazy_inputs: Tuple[str, ...] = ()  # Lazy[T] inputs (types/basic.py:1026)


NODE_SPECS: Dict[str, NodeSpec] = {}


def register_spec(name: str, *aliases: str, **kw) -> None:
    spec = NodeSpec(**kw)
    NODE_SPECS[name] = spec
    for a in aliases:
        NODE_SPECS[a] = spec


# ---------------------------------------------------------------------------
# lazy inputs (reference types/basic.py:1026-1133)

class Lazy:
    """Deferred input: the producing subgraph executes only when ``value`` is
    forced. Mirrors the reference's Lazy handle (from_node/slot + context +
    executor continuation + adapter on resolve)."""

    __slots__ = ("_executor", "_ctx", "_src", "_slot", "_to_type", "_got", "_val")

    def __init__(self, executor, ctx, src_node, slot: int, to_type: str = "ANY"):
        self._executor = executor
        self._ctx = ctx
        self._src = src_node
        self._slot = slot
        self._to_type = to_type
        self._got = False
        self._val = None

    @property
    def value(self):
        if not self._got:
            out = self._executor._run_node(self._src, self._ctx)
            val = out[self._slot] if self._slot < len(out) else None
            spec = NODE_SPECS.get(self._src.type)
            if spec and self._slot < len(spec.return_types):
                adapter = find_adapter(spec.return_types[self._slot], self._to_type)
                if adapter is not None:
                    val = adapter(val)
            self._val = val
            self._got = True
        return self._val


def resolve(v):
    """Force a maybe-lazy value."""
    return v.value if isinstance(v, Lazy) else v


# ---------------------------------------------------------------------------
# validation (reference execution.py:1170-1512)

class WorkflowValidationError(ValueError):
    def __init__(self, errors: List[dict]):
        self.errors = errors
        lines = [f"  [{e['type']}] node {e.get('node_id', '?')}: {e['message']}"
                 f" ({e.get('details', '')})" for e in errors]
        super().__init__("workflow validation failed:\n" + "\n".join(lines))


def _err(type_: str, node_id, message: str, details: str = "", **extra) -> dict:
    return {"type": type_, "node_id": node_id, "message": message,
            "details": details, "extra_info": extra}


def validate_workflow(workflow, node_registry: Dict[str, Callable]) -> List[dict]:
    """Structural + typed validation of a Workflow graph. Returns the error
    list (empty = valid), using the reference's error-dict vocabulary:
    node_not_found / required_input_missing / bad_linked_input /
    return_type_mismatch / invalid_input_type / value_smaller_than_min /
    value_bigger_than_max / value_not_in_list."""
    errors: List[dict] = []
    nodes = workflow.nodes
    # UNIQUE node types may appear at most once per graph (node_base.py
    # UNIQUE; aliases of one implementation count together)
    unique_seen = [n for n in nodes.values() if n.type in UNIQUE_NODE_TYPES]
    if len(unique_seen) > 1:
        for extra in unique_seen[1:]:
            errors.append(_err(
                "duplicate_unique_node", extra.id,
                f"node type '{extra.type}' is unique and already present "
                f"(node {unique_seen[0].id})"))
    for node in nodes.values():
        if node.type in ("Note",):
            continue
        if node.type not in node_registry:
            errors.append(_err(
                "node_not_found", node.id,
                f"workflow node type '{node.type}' has no implementation"))
            continue
        spec = NODE_SPECS.get(node.type)
        # --- links ---
        for name, link in node.inputs.items():
            if not (isinstance(link, tuple) and len(link) == 2):
                errors.append(_err(
                    "bad_linked_input", node.id,
                    "linked input must be (node_id, slot_index)", name))
                continue
            src_id, slot = link
            if src_id not in nodes:
                errors.append(_err(
                    "bad_linked_input", node.id,
                    f"input '{name}' links to missing node {src_id}", name))
                continue
            src = nodes[src_id]
            src_spec = NODE_SPECS.get(src.type)
            if src_spec and src_spec.return_types and slot >= len(src_spec.return_types):
                errors.append(_err(
                    "bad_linked_input", node.id,
                    f"input '{name}' links to slot {slot} of {src.type} "
                    f"which declares only {len(src_spec.return_types)} outputs",
                    name))
                continue
            # typed link: both ends declared and neither is ANY
            if spec and src_spec and name in spec.input_types and src_spec.return_types:
                want = spec.input_types[name]
                got = src_spec.return_types[slot] if slot < len(src_spec.return_types) else "ANY"
                if "ANY" not in (want, got) and want != got:
                    if find_adapter(got, want) is None:
                        errors.append(_err(
                            "return_type_mismatch", node.id,
                            f"input '{name}' expects {want}, linked {src.type}"
                            f"[{slot}] returns {got} and no adapter exists",
                            name, received_type=got, expected_type=want))
        # --- widgets ---
        if spec is None:
            continue
        for i, wspec in enumerate(spec.widgets):
            if i >= len(node.widgets):
                continue  # trailing widgets are optional (nodes default them)
            val = node.widgets[i]
            try:
                if wspec.type == "INT":
                    val = int(val)
                elif wspec.type == "FLOAT":
                    val = float(val)
                elif wspec.type == "STRING":
                    val = str(val)
            except (TypeError, ValueError) as ex:
                errors.append(_err(
                    "invalid_input_type", node.id,
                    f"failed to convert widget '{wspec.name}' to {wspec.type}",
                    f"{wspec.name}={val!r}: {ex}"))
                continue
            node.widgets[i] = val  # coerced in place (execution.py:1279-1287)
            if wspec.min is not None and isinstance(val, (int, float)) and val < wspec.min:
                errors.append(_err(
                    "value_smaller_than_min", node.id,
                    f"widget '{wspec.name}' value {val} smaller than min {wspec.min}",
                    wspec.name))
            if wspec.max is not None and isinstance(val, (int, float)) and val > wspec.max:
                errors.append(_err(
                    "value_bigger_than_max", node.id,
                    f"widget '{wspec.name}' value {val} bigger than max {wspec.max}",
                    wspec.name))
            if wspec.choices is not None and val not in wspec.choices:
                errors.append(_err(
                    "value_not_in_list", node.id,
                    f"widget '{wspec.name}': '{val}' not in list",
                    f"{wspec.name}: '{val}' not in {wspec.choices}"))
    return errors


# ---------------------------------------------------------------------------
# specs for the shipped node set (reference INPUT_TYPES declarations in
# comfyUI/nodes.py + stable_rendering/_nodes)

def _declare_default_specs() -> None:
    from stable_renderer_tpu_torch.models.sampling.samplers import SAMPLER_NAMES
    from stable_renderer_tpu_torch.models.sampling.schedules import SCHEDULER_NAMES

    register_spec(
        "CheckpointLoaderSimple",
        return_types=("MODEL", "CLIP", "VAE"),
        widgets=(WidgetSpec("ckpt_name", "STRING"),),
    )
    register_spec(
        "CLIPTextEncode",
        input_types={"clip": "CLIP"},
        return_types=("CONDITIONING",),
        widgets=(WidgetSpec("text", "STRING"),),
    )
    register_spec(
        "KSamplerAdvanced",
        input_types={"model": "MODEL", "positive": "CONDITIONING",
                     "negative": "CONDITIONING", "latent_image": "LATENT"},
        return_types=("LATENT",),
        # [add_noise, noise_seed, seed_mode, steps, cfg, sampler, scheduler,
        #  start_at_step, end_at_step, return_with_leftover_noise]
        widgets=(
            WidgetSpec("add_noise", "COMBO", choices=("enable", "disable")),
            WidgetSpec("noise_seed", "INT", min=0),
            WidgetSpec("control_after_generate", "ANY"),
            WidgetSpec("steps", "INT", min=1, max=10000),
            WidgetSpec("cfg", "FLOAT", min=0.0, max=100.0),
            WidgetSpec("sampler_name", "COMBO", choices=tuple(SAMPLER_NAMES)),
            WidgetSpec("scheduler", "COMBO", choices=tuple(SCHEDULER_NAMES)),
            WidgetSpec("start_at_step", "INT", min=0, max=10000),
            WidgetSpec("end_at_step", "INT", min=0, max=10000),
            WidgetSpec("return_with_leftover_noise", "COMBO",
                       choices=("enable", "disable")),
        ),
    )
    register_spec(
        "KSampler",
        input_types={"model": "MODEL", "positive": "CONDITIONING",
                     "negative": "CONDITIONING", "latent_image": "LATENT"},
        return_types=("LATENT",),
        # loader widget order: [seed, seed_mode, steps, cfg, sampler,
        # scheduler, denoise] (loader.py:163)
        widgets=(
            WidgetSpec("seed", "INT", min=0),
            WidgetSpec("control_after_generate", "ANY"),
            WidgetSpec("steps", "INT", min=1, max=10000),
            WidgetSpec("cfg", "FLOAT", min=0.0, max=100.0),
            WidgetSpec("sampler_name", "COMBO", choices=tuple(SAMPLER_NAMES)),
            WidgetSpec("scheduler", "COMBO", choices=tuple(SCHEDULER_NAMES)),
            WidgetSpec("denoise", "FLOAT", min=0.0, max=1.0),
        ),
    )
    register_spec(
        "CorrespondSampler",
        input_types={"model": "MODEL", "positive": "CONDITIONING",
                     "negative": "CONDITIONING", "latent_image": "LATENT"},
        return_types=("LATENT",),
        # no seed widget: [steps, cfg, sampler_name, scheduler, denoise]
        # (stable_rendering/_nodes/samplers.py:139-143)
        widgets=(
            WidgetSpec("steps", "INT", min=1, max=10000),
            WidgetSpec("cfg", "FLOAT", min=0.0, max=100.0),
            WidgetSpec("sampler_name", "COMBO", choices=tuple(SAMPLER_NAMES)),
            WidgetSpec("scheduler", "COMBO", choices=tuple(SCHEDULER_NAMES)),
            WidgetSpec("denoise", "FLOAT", min=0.0, max=1.0),
        ),
    )
    register_spec(
        "EmptyLatentImage",
        return_types=("LATENT",),
        widgets=(WidgetSpec("width", "INT", min=8, max=16384),
                 WidgetSpec("height", "INT", min=8, max=16384),
                 WidgetSpec("batch_size", "INT", min=1, max=4096)),
    )
    register_spec(
        "VAEDecode",
        input_types={"samples": "LATENT", "vae": "VAE"},
        return_types=("IMAGE",),
    )
    register_spec(
        "VAEEncode",
        input_types={"pixels": "IMAGE", "vae": "VAE"},
        return_types=("LATENT",),
    )
    register_spec(
        "ControlNetApply", "ControlNetApplyAdvanced",
        input_types={"conditioning": "CONDITIONING", "control_net": "CONTROL_NET",
                     "image": "IMAGE"},
        return_types=("CONDITIONING",),
        widgets=(WidgetSpec("strength", "FLOAT", min=0.0, max=10.0),),
    )
    register_spec("ControlNetLoader", return_types=("CONTROL_NET",),
                  widgets=(WidgetSpec("control_net_name", "STRING"),))
    register_spec("LoadImage", return_types=("IMAGE", "MASK"),
                  widgets=(WidgetSpec("image", "STRING"),))
    register_spec(
        "LatentUpscale",
        input_types={"samples": "LATENT"}, return_types=("LATENT",),
        widgets=(WidgetSpec("upscale_method", "COMBO",
                            choices=("nearest", "nearest-exact", "bilinear",
                                     "area", "bicubic", "bislerp", "lanczos")),
                 WidgetSpec("width", "INT", min=0, max=16384),
                 WidgetSpec("height", "INT", min=0, max=16384)),
    )
    register_spec("ImageUpscaleWithModel",
                  input_types={"upscale_model": "UPSCALE_MODEL", "image": "IMAGE"},
                  return_types=("IMAGE",))
    register_spec("UpscaleModelLoader", return_types=("UPSCALE_MODEL",),
                  widgets=(WidgetSpec("model_name", "STRING"),))
    register_spec("CLIPSetLastLayer", input_types={"clip": "CLIP"},
                  return_types=("CLIP",),
                  widgets=(WidgetSpec("stop_at_clip_layer", "INT", min=-24, max=-1),))
    register_spec("ConditioningCombine",
                  input_types={"conditioning_1": "CONDITIONING",
                               "conditioning_2": "CONDITIONING"},
                  return_types=("CONDITIONING",))
    register_spec("ConditioningSetArea", "ConditioningSetAreaPercentage",
                  input_types={"conditioning": "CONDITIONING"},
                  return_types=("CONDITIONING",))
    register_spec("ConditioningSetMask",
                  input_types={"conditioning": "CONDITIONING", "mask": "MASK"},
                  return_types=("CONDITIONING",))
    register_spec("SolidMask", return_types=("MASK",),
                  widgets=(WidgetSpec("value", "FLOAT", min=0.0, max=1.0),
                           WidgetSpec("width", "INT", min=1, max=16384),
                           WidgetSpec("height", "INT", min=1, max=16384)))
    register_spec("SaveImage", "PreviewImage", input_types={"images": "IMAGE"},
                  return_types=())
    register_spec("InferenceOutput", return_types=("ANY",))
    register_spec("IsNotNone", return_types=("BOOLEAN",))
    # If: branches are Lazy — the untaken branch's subgraph never executes
    # (reference logic.py If with Lazy[T] params, types/basic.py:1026-1133)
    register_spec("If", "IfNode",
                  lazy_inputs=("true_value", "false_value", "if_true", "if_false"),
                  return_types=("ANY",))
    register_spec("IfValTypeEqual", return_types=("BOOLEAN",))
    # slot order per reference EngineDataNode (stable_rendering/_nodes/data.py)
    register_spec("EngineData", "EngineDataNode", "VirtualEngineData",
                  return_types=("IMAGE", "IDMAP", "IMAGE", "IMAGE", "IMAGE",
                                "IMAGE", "LATENT", "MASK", "CORRMAPS",
                                "SPRITES", "ENV_PROMPT"))
    register_spec("GLIGENLoader", return_types=("GLIGEN",),
                  widgets=(WidgetSpec("gligen_name", "STRING"),))
    register_spec("GLIGENTextBoxApply",
                  input_types={"conditioning_to": "CONDITIONING",
                               "clip": "CLIP", "gligen_textbox_model": "GLIGEN"},
                  return_types=("CONDITIONING",),
                  widgets=(WidgetSpec("text", "STRING"),
                           WidgetSpec("width", "INT", min=8, max=16384),
                           WidgetSpec("height", "INT", min=8, max=16384),
                           WidgetSpec("x", "INT", min=0, max=16384),
                           WidgetSpec("y", "INT", min=0, max=16384)))
    register_spec("ImageBlur", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("blur_radius", "INT", min=0, max=31),
                           WidgetSpec("sigma", "FLOAT", min=0.1, max=10.0)))
    register_spec("ImageSharpen", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("sharpen_radius", "INT", min=0, max=31),
                           WidgetSpec("sigma", "FLOAT", min=0.1, max=10.0),
                           WidgetSpec("alpha", "FLOAT", min=0.0, max=5.0)))
    register_spec("ImageQuantize", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("colors", "INT", min=1, max=256),))
    register_spec("MaskToImage", input_types={"mask": "MASK"},
                  return_types=("IMAGE",))
    register_spec("ImageToMask", input_types={"image": "IMAGE"},
                  return_types=("MASK",),
                  widgets=(WidgetSpec("channel", "COMBO",
                                      choices=("red", "green", "blue", "alpha")),))
    register_spec("InvertMask", input_types={"mask": "MASK"},
                  return_types=("MASK",))
    register_spec("ThresholdMask", input_types={"mask": "MASK"},
                  return_types=("MASK",),
                  widgets=(WidgetSpec("value", "FLOAT", min=0.0, max=1.0),))
    register_spec("FeatherMask", input_types={"mask": "MASK"},
                  return_types=("MASK",))
    register_spec("GrowMask", input_types={"mask": "MASK"},
                  return_types=("MASK",))
    register_spec("ImageBlend",
                  input_types={"image1": "IMAGE", "image2": "IMAGE"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("blend_factor", "FLOAT", min=0.0, max=1.0),
                           WidgetSpec("blend_mode", "COMBO",
                                      choices=("normal", "multiply", "screen",
                                               "difference"))))
    register_spec("ImageInvert", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",))
    register_spec("ImageBatch",
                  input_types={"image1": "IMAGE", "image2": "IMAGE"},
                  return_types=("IMAGE",))
    register_spec("ImagePadForOutpaint", input_types={"image": "IMAGE"},
                  return_types=("IMAGE", "MASK"))
    register_spec("ConditioningZeroOut",
                  input_types={"conditioning": "CONDITIONING"},
                  return_types=("CONDITIONING",))
    register_spec("VAEEncodeForInpaint",
                  input_types={"pixels": "IMAGE", "vae": "VAE", "mask": "MASK"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("grow_mask_by", "INT", min=0, max=64),))
    register_spec("InpaintModelConditioning",
                  input_types={"positive": "CONDITIONING",
                               "negative": "CONDITIONING", "vae": "VAE",
                               "pixels": "IMAGE", "mask": "MASK"},
                  return_types=("CONDITIONING", "CONDITIONING", "LATENT"))
    register_spec("LatentComposite",
                  input_types={"samples_to": "LATENT", "samples_from": "LATENT"},
                  return_types=("LATENT",))
    register_spec("LatentAdd", "LatentSubtract",
                  input_types={"samples1": "LATENT", "samples2": "LATENT"},
                  return_types=("LATENT",))
    register_spec("LatentMultiply", input_types={"samples1": "LATENT"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("multiplier", "FLOAT", min=-10.0, max=10.0),))
    register_spec("CLIPVisionLoader", return_types=("CLIP_VISION",),
                  widgets=(WidgetSpec("clip_name", "STRING"),))
    register_spec("CLIPVisionEncode",
                  input_types={"clip_vision": "CLIP_VISION", "image": "IMAGE"},
                  return_types=("CLIP_VISION_OUTPUT",))
    register_spec("unCLIPConditioning",
                  input_types={"conditioning": "CONDITIONING",
                               "clip_vision_output": "CLIP_VISION_OUTPUT"},
                  return_types=("CONDITIONING",),
                  widgets=(WidgetSpec("strength", "FLOAT", min=-10.0, max=10.0),
                           WidgetSpec("noise_augmentation", "FLOAT", min=0.0, max=1.0)))
    # --- tier-2 comfy_extras packs (workflow/nodes_extra.py) ---
    register_spec("KSamplerSelect", return_types=("SAMPLER",),
                  widgets=(WidgetSpec("sampler_name", "STRING"),))
    register_spec("SamplerDPMPP_2M_SDE", "SamplerDPMPP_SDE",
                  return_types=("SAMPLER",))
    register_spec("BasicScheduler", input_types={"model": "MODEL"},
                  return_types=("SIGMAS",),
                  widgets=(WidgetSpec("scheduler", "STRING"),
                           WidgetSpec("steps", "INT", min=1, max=10000),
                           WidgetSpec("denoise", "FLOAT", min=0.0, max=1.0)))
    register_spec("KarrasScheduler", "ExponentialScheduler",
                  "PolyexponentialScheduler", "VPScheduler",
                  return_types=("SIGMAS",),
                  widgets=(WidgetSpec("steps", "INT", min=1, max=10000),))
    register_spec("SDTurboScheduler", input_types={"model": "MODEL"},
                  return_types=("SIGMAS",),
                  widgets=(WidgetSpec("steps", "INT", min=1, max=10),
                           WidgetSpec("denoise", "FLOAT", min=0.0, max=1.0)))
    register_spec("SplitSigmas", input_types={"sigmas": "SIGMAS"},
                  return_types=("SIGMAS", "SIGMAS"),
                  widgets=(WidgetSpec("step", "INT", min=0, max=10000),))
    register_spec("FlipSigmas", input_types={"sigmas": "SIGMAS"},
                  return_types=("SIGMAS",))
    register_spec("SamplerCustom",
                  input_types={"model": "MODEL", "positive": "CONDITIONING",
                               "negative": "CONDITIONING", "sampler": "SAMPLER",
                               "sigmas": "SIGMAS", "latent_image": "LATENT"},
                  return_types=("LATENT", "LATENT"))
    register_spec("ModelMergeSimple",
                  input_types={"model1": "MODEL", "model2": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("ratio", "FLOAT", min=0.0, max=1.0),))
    register_spec("ModelMergeAdd",
                  input_types={"model1": "MODEL", "model2": "MODEL"},
                  return_types=("MODEL",))
    register_spec("ModelMergeSubtract",
                  input_types={"model1": "MODEL", "model2": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("multiplier", "FLOAT", min=-10.0, max=10.0),))
    register_spec("ModelMergeBlocks",
                  input_types={"model1": "MODEL", "model2": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("input", "FLOAT", min=0.0, max=1.0),
                           WidgetSpec("middle", "FLOAT", min=0.0, max=1.0),
                           WidgetSpec("out", "FLOAT", min=0.0, max=1.0)))
    register_spec("CLIPMergeSimple",
                  input_types={"clip1": "CLIP", "clip2": "CLIP"},
                  return_types=("CLIP",),
                  widgets=(WidgetSpec("ratio", "FLOAT", min=0.0, max=1.0),))
    register_spec("CheckpointSave",
                  input_types={"model": "MODEL", "clip": "CLIP", "vae": "VAE"},
                  return_types=(),
                  widgets=(WidgetSpec("filename_prefix", "STRING"),))
    register_spec("CLIPSave", input_types={"clip": "CLIP"}, return_types=(),
                  widgets=(WidgetSpec("filename_prefix", "STRING"),))
    register_spec("VAESave", input_types={"vae": "VAE"}, return_types=(),
                  widgets=(WidgetSpec("filename_prefix", "STRING"),))
    register_spec("FreeU", "FreeU_V2", input_types={"model": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("b1", "FLOAT", min=0.0, max=10.0),
                           WidgetSpec("b2", "FLOAT", min=0.0, max=10.0),
                           WidgetSpec("s1", "FLOAT", min=0.0, max=10.0),
                           WidgetSpec("s2", "FLOAT", min=0.0, max=10.0)))
    register_spec("TomePatchModel", input_types={"model": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("ratio", "FLOAT", min=0.0, max=1.0),))
    register_spec("HyperTile", input_types={"model": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("tile_size", "INT", min=1, max=2048),
                           WidgetSpec("swap_size", "INT", min=1, max=128),
                           WidgetSpec("max_depth", "INT", min=0, max=10)))
    register_spec("HypernetworkLoader", input_types={"model": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("hypernetwork_name", "STRING"),
                           WidgetSpec("strength", "FLOAT", min=-10.0, max=10.0)))
    register_spec("SelfAttentionGuidance", input_types={"model": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("scale", "FLOAT", min=-2.0, max=5.0),
                           WidgetSpec("blur_sigma", "FLOAT", min=0.0, max=10.0)))
    register_spec("PerpNeg",
                  input_types={"model": "MODEL",
                               "empty_conditioning": "CONDITIONING"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("neg_scale", "FLOAT", min=0.0, max=100.0),))
    register_spec("DifferentialDiffusion", input_types={"model": "MODEL"},
                  return_types=("MODEL",))
    register_spec("Morphology", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("operation", "COMBO",
                                      choices=("erode", "dilate", "open",
                                               "close", "gradient",
                                               "bottom_hat", "top_hat")),
                           WidgetSpec("kernel_size", "INT", min=3, max=999)))
    register_spec("PorterDuffImageComposite",
                  input_types={"source": "IMAGE", "source_alpha": "MASK",
                               "destination": "IMAGE",
                               "destination_alpha": "MASK"},
                  return_types=("IMAGE", "MASK"))
    register_spec("SplitImageWithAlpha", input_types={"image": "IMAGE"},
                  return_types=("IMAGE", "MASK"))
    register_spec("JoinImageWithAlpha",
                  input_types={"image": "IMAGE", "alpha": "MASK"},
                  return_types=("IMAGE",))
    register_spec("RebatchLatents", input_types={"latents": "LATENT"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("batch_size", "INT", min=1, max=4096),))
    register_spec("RebatchImages", input_types={"images": "IMAGE"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("batch_size", "INT", min=1, max=4096),))
    register_spec("ImageOnlyCheckpointLoader",
                  return_types=("MODEL", "CLIP_VISION", "VAE"),
                  widgets=(WidgetSpec("ckpt_name", "STRING"),))
    register_spec("SVD_img2vid_Conditioning",
                  input_types={"clip_vision": "CLIP_VISION",
                               "init_image": "IMAGE", "vae": "VAE"},
                  return_types=("CONDITIONING", "CONDITIONING", "LATENT"),
                  widgets=(WidgetSpec("width", "INT", min=16, max=16384),
                           WidgetSpec("height", "INT", min=16, max=16384),
                           WidgetSpec("video_frames", "INT", min=1, max=4096),
                           WidgetSpec("motion_bucket_id", "INT", min=1, max=1023),
                           WidgetSpec("fps", "INT", min=1, max=1024),
                           WidgetSpec("augmentation_level", "FLOAT",
                                      min=0.0, max=10.0)))
    register_spec("PhotoMakerLoader", return_types=("PHOTOMAKER",),
                  widgets=(WidgetSpec("photomaker_model_name", "STRING"),))
    register_spec("PhotoMakerEncode",
                  input_types={"photomaker": "PHOTOMAKER", "image": "IMAGE",
                               "clip": "CLIP"},
                  return_types=("CONDITIONING",),
                  widgets=(WidgetSpec("text", "STRING"),))
    register_spec("StableCascade_EmptyLatentImage",
                  return_types=("LATENT", "LATENT"),
                  widgets=(WidgetSpec("width", "INT", min=256, max=16384),
                           WidgetSpec("height", "INT", min=256, max=16384),
                           WidgetSpec("compression", "INT", min=4, max=128),
                           WidgetSpec("batch_size", "INT", min=1, max=4096)))
    register_spec("StableCascade_StageB_Conditioning",
                  input_types={"conditioning": "CONDITIONING",
                               "stage_c": "LATENT"},
                  return_types=("CONDITIONING",))
    register_spec("CascadeStageLoader", "UNETLoader",
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("unet_name", "STRING"),))
    register_spec("StableZero123_Conditioning",
                  input_types={"clip_vision": "CLIP_VISION",
                               "init_image": "IMAGE", "vae": "VAE"},
                  return_types=("CONDITIONING", "CONDITIONING", "LATENT"),
                  widgets=(WidgetSpec("width", "INT", min=16, max=16384),
                           WidgetSpec("height", "INT", min=16, max=16384),
                           WidgetSpec("batch_size", "INT", min=1, max=4096),
                           WidgetSpec("elevation", "FLOAT", min=-180.0, max=180.0),
                           WidgetSpec("azimuth", "FLOAT", min=-180.0, max=180.0)))
    register_spec("VideoLinearCFGGuidance", input_types={"model": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("min_cfg", "FLOAT", min=0.0, max=100.0),))
    register_spec("ImageOnlyCheckpointSave",
                  input_types={"model": "MODEL", "clip_vision": "CLIP_VISION",
                               "vae": "VAE"},
                  return_types=(),
                  widgets=(WidgetSpec("filename_prefix", "STRING"),))
    register_spec("SD_4XUpscale_Conditioning",
                  input_types={"images": "IMAGE", "positive": "CONDITIONING",
                               "negative": "CONDITIONING"},
                  return_types=("CONDITIONING", "CONDITIONING", "LATENT"),
                  widgets=(WidgetSpec("scale_ratio", "FLOAT", min=0.0, max=10.0),
                           WidgetSpec("noise_augmentation", "FLOAT",
                                      min=0.0, max=1.0)))
    # --- remaining builtin/extras parity nodes (workflow/nodes_parity.py) ---
    register_spec("SetLatentNoiseMask",
                  input_types={"samples": "LATENT", "mask": "MASK"},
                  return_types=("LATENT",))
    register_spec("LatentFromBatch", input_types={"samples": "LATENT"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("batch_index", "INT", min=0, max=4095),
                           WidgetSpec("length", "INT", min=1, max=4096)))
    register_spec("RepeatLatentBatch", input_types={"samples": "LATENT"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("amount", "INT", min=1, max=4096),))
    register_spec("LatentBlend",
                  input_types={"samples1": "LATENT", "samples2": "LATENT"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("blend_factor", "FLOAT", min=0.0,
                                      max=1.0),))
    register_spec("LatentRotate", input_types={"samples": "LATENT"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("rotation", "COMBO", choices=(
                      "none", "90 degrees", "180 degrees", "270 degrees")),))
    register_spec("LatentFlip", input_types={"samples": "LATENT"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("flip_method", "COMBO", choices=(
                      "x-axis: vertically", "y-axis: horizontally")),))
    register_spec("LatentCrop", input_types={"samples": "LATENT"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("width", "INT", min=64, max=16384),
                           WidgetSpec("height", "INT", min=64, max=16384),
                           WidgetSpec("x", "INT", min=0, max=16384),
                           WidgetSpec("y", "INT", min=0, max=16384)))
    register_spec("LatentInterpolate",
                  input_types={"samples1": "LATENT", "samples2": "LATENT"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("ratio", "FLOAT", min=0.0, max=1.0),))
    register_spec("LatentBatch",
                  input_types={"samples1": "LATENT", "samples2": "LATENT"},
                  return_types=("LATENT",))
    register_spec("LatentBatchSeedBehavior", input_types={"samples": "LATENT"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("seed_behavior", "COMBO",
                                      choices=("random", "fixed")),))
    register_spec("LatentCompositeMasked",
                  input_types={"destination": "LATENT", "source": "LATENT",
                               "mask": "MASK"},
                  return_types=("LATENT",))
    register_spec("ImageCompositeMasked",
                  input_types={"destination": "IMAGE", "source": "IMAGE",
                               "mask": "MASK"},
                  return_types=("IMAGE",))
    register_spec("SaveLatent", input_types={"samples": "LATENT"},
                  return_types=("STRING",))
    register_spec("LoadLatent", return_types=("LATENT",))
    register_spec("EmptyImage", return_types=("IMAGE",),
                  widgets=(WidgetSpec("width", "INT", min=1, max=16384),
                           WidgetSpec("height", "INT", min=1, max=16384),
                           WidgetSpec("batch_size", "INT", min=1, max=4096),
                           WidgetSpec("color", "INT", min=0, max=0xFFFFFF)))
    register_spec("ImageCrop", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",))
    register_spec("RepeatImageBatch", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("amount", "INT", min=1, max=4096),))
    register_spec("ImageFromBatch", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",))
    register_spec("ImageColorToMask", input_types={"image": "IMAGE"},
                  return_types=("MASK",),
                  widgets=(WidgetSpec("color", "INT", min=0, max=0xFFFFFF),))
    register_spec("CropMask", input_types={"mask": "MASK"},
                  return_types=("MASK",))
    register_spec("LoadImageMask", return_types=("MASK",),
                  widgets=(WidgetSpec("image", "STRING"),
                           WidgetSpec("channel", "COMBO", choices=(
                               "alpha", "red", "green", "blue"))))
    register_spec("ImageScaleToTotalPixels", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("upscale_method", "STRING"),
                           WidgetSpec("megapixels", "FLOAT", min=0.01,
                                      max=16.0)))
    register_spec("Canny", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("low_threshold", "FLOAT", min=0.01,
                                      max=0.99),
                           WidgetSpec("high_threshold", "FLOAT", min=0.01,
                                      max=0.99)))
    register_spec("SaveAnimatedWEBP", "SaveAnimatedPNG",
                  input_types={"images": "IMAGE"}, return_types=("IMAGE",))
    register_spec("ConditioningAverage",
                  input_types={"conditioning_to": "CONDITIONING",
                               "conditioning_from": "CONDITIONING"},
                  return_types=("CONDITIONING",),
                  widgets=(WidgetSpec("conditioning_to_strength", "FLOAT",
                                      min=0.0, max=1.0),))
    register_spec("ConditioningSetAreaStrength",
                  input_types={"conditioning": "CONDITIONING"},
                  return_types=("CONDITIONING",),
                  widgets=(WidgetSpec("strength", "FLOAT", min=0.0,
                                      max=10.0),))
    register_spec("CLIPTextEncodeSDXL", input_types={"clip": "CLIP"},
                  return_types=("CONDITIONING",))
    register_spec("CLIPTextEncodeSDXLRefiner", input_types={"clip": "CLIP"},
                  return_types=("CONDITIONING",))
    register_spec("CLIPTextEncodeControlnet",
                  input_types={"clip": "CLIP",
                               "conditioning": "CONDITIONING"},
                  return_types=("CONDITIONING",),
                  widgets=(WidgetSpec("text", "STRING"),))
    register_spec("VAELoader", return_types=("VAE",),
                  widgets=(WidgetSpec("vae_name", "STRING"),))
    register_spec("CLIPLoader", return_types=("CLIP",),
                  widgets=(WidgetSpec("clip_name", "STRING"),))
    register_spec("DualCLIPLoader", return_types=("CLIP",),
                  widgets=(WidgetSpec("clip_name1", "STRING"),
                           WidgetSpec("clip_name2", "STRING")))
    register_spec("LoraLoader",
                  input_types={"model": "MODEL", "clip": "CLIP"},
                  return_types=("MODEL", "CLIP"),
                  widgets=(WidgetSpec("lora_name", "STRING"),
                           WidgetSpec("strength_model", "FLOAT", min=-20.0,
                                      max=20.0),
                           WidgetSpec("strength_clip", "FLOAT", min=-20.0,
                                      max=20.0)))
    register_spec("CheckpointLoader", return_types=("MODEL", "CLIP", "VAE"),
                  widgets=(WidgetSpec("config_name", "STRING"),
                           WidgetSpec("ckpt_name", "STRING")))
    register_spec("unCLIPCheckpointLoader",
                  return_types=("MODEL", "CLIP", "VAE", "CLIP_VISION"),
                  widgets=(WidgetSpec("ckpt_name", "STRING"),))
    register_spec("DiffusersLoader", return_types=("MODEL", "CLIP", "VAE"),
                  widgets=(WidgetSpec("model_path", "STRING"),))
    register_spec("StyleModelLoader", return_types=("STYLE_MODEL",),
                  widgets=(WidgetSpec("style_model_name", "STRING"),))
    register_spec("StyleModelApply",
                  input_types={"conditioning": "CONDITIONING",
                               "style_model": "STYLE_MODEL",
                               "clip_vision_output": "CLIP_VISION_OUTPUT"},
                  return_types=("CONDITIONING",))
    register_spec("DiffControlNetLoader", input_types={"model": "MODEL"},
                  return_types=("CONTROL_NET",),
                  widgets=(WidgetSpec("control_net_name", "STRING"),))
    register_spec("VAEDecodeTiled",
                  input_types={"samples": "LATENT", "vae": "VAE"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("tile_size", "INT", min=64,
                                      max=16384),))
    register_spec("VAEEncodeTiled",
                  input_types={"pixels": "IMAGE", "vae": "VAE"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("tile_size", "INT", min=64,
                                      max=16384),))
    register_spec("ModelSamplingDiscrete", input_types={"model": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("sampling", "COMBO", choices=(
                      "eps", "v_prediction", "lcm", "x0")),))
    register_spec("ModelSamplingContinuousEDM", input_types={"model": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("sampling", "COMBO", choices=(
                      "v_prediction", "eps")),
                      WidgetSpec("sigma_max", "FLOAT", min=0.0, max=1000.0),
                      WidgetSpec("sigma_min", "FLOAT", min=0.0, max=1000.0)))
    register_spec("ModelSamplingStableCascade", input_types={"model": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("shift", "FLOAT", min=0.0, max=100.0),))
    register_spec("RescaleCFG", input_types={"model": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("multiplier", "FLOAT", min=0.0,
                                      max=1.0),))
    register_spec("PatchModelAddDownscale", input_types={"model": "MODEL"},
                  return_types=("MODEL",),
                  widgets=(WidgetSpec("block_number", "INT", min=1, max=32),
                           WidgetSpec("downscale_factor", "FLOAT", min=0.1,
                                      max=9.0),
                           WidgetSpec("start_percent", "FLOAT", min=0.0,
                                      max=1.0),
                           WidgetSpec("end_percent", "FLOAT", min=0.0,
                                      max=1.0)))
    register_spec("StableCascade_StageC_VAEEncode",
                  input_types={"image": "IMAGE", "vae": "VAE"},
                  return_types=("LATENT", "LATENT"),
                  widgets=(WidgetSpec("compression", "INT", min=4,
                                      max=128),))
    register_spec("StableZero123_Conditioning_Batched",
                  input_types={"clip_vision": "CLIP_VISION",
                               "init_image": "IMAGE", "vae": "VAE"},
                  return_types=("CONDITIONING", "CONDITIONING", "LATENT"))
    # --- stable_rendering custom nodes (workflow/nodes_sr.py; reference
    # source/comfyUI/stable_rendering/_nodes/{loaders,data,processing}) ---
    register_spec("ImageSequenceLoader",
                  input_types={"directory": "STRING"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("frame_start", "INT", min=0,
                                      max=100000),
                           WidgetSpec("num_frames", "INT", min=1,
                                      max=100000),
                           WidgetSpec("sd_version", "COMBO",
                                      choices=("SD15", "SDXL"))))
    register_spec("NoiseSequenceLoader",
                  input_types={"directory": "STRING"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("frame_start", "INT", min=0,
                                      max=100000),
                           WidgetSpec("num_frames", "INT", min=1,
                                      max=100000),
                           WidgetSpec("sd_version", "COMBO",
                                      choices=("SD15", "SDXL"))))
    register_spec("IDSequenceLoader",
                  input_types={"directory": "STRING"},
                  return_types=("IDMAP",),
                  widgets=(WidgetSpec("frame_start", "INT", min=0,
                                      max=100000),
                           WidgetSpec("num_frames", "INT", min=1,
                                      max=100000)))
    register_spec("LegacyImageSequenceLoader",
                  input_types={"imgs": "STRING"},
                  return_types=("IMAGE", "MASK"),
                  widgets=(WidgetSpec("imgs", "STRING"),))
    register_spec("LegacyNoiseSequenceLoader",
                  input_types={"data_paths": "STRING"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("data_paths", "STRING"),))
    register_spec("LegacyIDSequenceLoader",
                  input_types={"data_paths": "STRING"},
                  return_types=("IDMAP",),
                  widgets=(WidgetSpec("data_paths", "STRING"),))
    register_spec("CreateNoiseSequenceFromIdMap",
                  input_types={"id_map": "IDMAP"},
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("seed", "INT", min=0,
                                      max=0xFFFFFFFFFFFFFFFF),
                           WidgetSpec("sd_version", "COMBO",
                                      choices=("SD15", "SDXL")),
                           WidgetSpec("downsample_option", "COMBO",
                                      choices=("mean", "max", "min",
                                               "nearest"))))
    register_spec("CreateIdenticalNoiseSequence",
                  return_types=("LATENT",),
                  widgets=(WidgetSpec("seed", "INT", min=0,
                                      max=0xFFFFFFFFFFFFFFFF),
                           WidgetSpec("num_frames", "INT", min=1,
                                      max=100000),
                           WidgetSpec("sd_version", "COMBO",
                                      choices=("SD15", "SDXL"))))
    register_spec("VirtualEngineDataNode",
                  input_types={"color_maps": "IMAGE", "id_maps": "IDMAP",
                               "pos_maps": "IMAGE", "normal_maps": "IMAGE",
                               "depth_maps": "IMAGE", "canny_maps": "IMAGE",
                               "noise_maps": "LATENT", "masks": "MASK"},
                  return_types=("ENGINE_DATA",))
    register_spec("RGBAToRGB", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("color", "STRING"),))
    register_spec("RGBAThreshold", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",),
                  widgets=(WidgetSpec("threshold", "FLOAT", min=0.0,
                                      max=1.0),))
    register_spec("RemoveBGNode", input_types={"image": "IMAGE"},
                  return_types=("IMAGE",))
    register_spec("TextConcat",
                  input_types={"text_a": "STRING", "text_b": "STRING"},
                  return_types=("STRING",))
    register_spec("TextReplace",
                  input_types={"text": "STRING", "pattern": "STRING",
                               "replace": "STRING"},
                  return_types=("STRING",))
    register_spec("SimpleVideoCombine", input_types={"images": "IMAGE"},
                  return_types=("STRING",),
                  widgets=(WidgetSpec("alpha_threshold", "FLOAT", min=0.0,
                                      max=1.0),
                           WidgetSpec("enable_alpha_threshold", "BOOLEAN"),
                           WidgetSpec("frame_rate", "INT", min=1, max=240),
                           WidgetSpec("loop_count", "INT", min=0, max=100),
                           WidgetSpec("filename_prefix", "STRING"),
                           WidgetSpec("pingpong", "BOOLEAN")))


_declare_default_specs()


# ---------------------------------------------------------------------------
# signature-reflection node authoring (reference types/node_base.py
# AdvancedNodeBase: INPUT_TYPES/RETURN_TYPES derived from __call__ reflection)

_PY_TO_COMFY = {int: "INT", float: "FLOAT", str: "STRING", bool: "BOOLEAN"}


def spec_from_callable(fn, return_types=None) -> NodeSpec:
    """Build a NodeSpec by reflecting a node callable's signature: string
    annotations are comfy type names (link inputs); int/float/str/bool
    annotations (or defaults of those types) become positional widgets —
    the reference's AdvancedNodeBase authoring model."""
    import inspect

    sig = inspect.signature(fn)
    input_types: Dict[str, str] = {}
    widgets: List[WidgetSpec] = []
    params = list(sig.parameters.values())
    # skip self/ctx/node leading params
    skip = {"self", "ctx", "node"}
    for p in params:
        if p.name in skip or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        ann = p.annotation
        if isinstance(ann, str):
            input_types[p.name] = ann
        elif ann in _PY_TO_COMFY:
            widgets.append(WidgetSpec(p.name, _PY_TO_COMFY[ann]))
        elif p.default is not p.empty and type(p.default) in _PY_TO_COMFY:
            widgets.append(WidgetSpec(p.name, _PY_TO_COMFY[type(p.default)]))
        else:
            input_types[p.name] = "ANY"
    rts = return_types
    if rts is None:
        rts = getattr(fn, "RETURN_TYPES", None)
    if rts is None and hasattr(fn, "__self__"):
        rts = getattr(type(fn.__self__), "RETURN_TYPES", None)
    return NodeSpec(input_types=input_types,
                    return_types=tuple(rts) if rts else ("ANY",),
                    widgets=tuple(widgets))


def register_reflected(name: str, node) -> None:
    """Register a class/function node with a reflected spec (the reference's
    auto registration, node_base.py:179-691). Classes reflect __call__ and
    honor a RETURN_TYPES class attribute; the executor's NodePool keeps one
    instance per (node_id, type)."""
    from stable_renderer_tpu_torch.workflow.executor import NODE_REGISTRY

    target = node.__call__ if isinstance(node, type) else node
    NODE_SPECS[name] = spec_from_callable(
        target, getattr(node, "RETURN_TYPES", None))
    NODE_REGISTRY[name] = node
