"""Graph executor — run reference workflow JSONs node by node.

Counterpart of stable_renderer_tpu/workflow/executor.py, node for node
(reference comfyUI/execution.py:344-1168: dependency-ordered recursive
execution, a per-node output cache with IS_CHANGED invalidation, hidden-value
injection of EngineData), over the node set the stable-rendering workflows
use (comfyUI/nodes.py + stable_rendering/_nodes).

  * A node is host-side orchestration over the port's modules (models/,
    models/sampling/); the graph runs once per execute, eagerly.
  * Frame-dependent nodes (EngineData and what depends on it) re-run on every
    execute while loader nodes stay cached: the reference's IS_CHANGED =
    FrameCount fast path (execution.py:839-928).
  * Every tensor a node returns lies on the executor's device (default: the
    card; ``device="cpu"`` as the tests run it). File readers read on the
    host and move what they read there.

The registry holds the JAX package's node names exactly, each one
implemented, so validation accepts and rejects what the JAX package's does;
a node that raises fails the execute with the structured
NodeExecutionError.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.data.engine_data import EngineData
from stable_renderer_tpu_torch.device import keep_f32, resolve_device
from stable_renderer_tpu_torch.models.sampling import sample
from stable_renderer_tpu_torch.ops.math import resize_nearest
from stable_renderer_tpu_torch.utils.log import get_logger
from stable_renderer_tpu_torch.workflow.loader import Workflow, WorkflowNode

logger = get_logger("sr_tpu_torch.executor")

NODE_REGISTRY: Dict[str, Callable] = {}


class InterruptProcessingException(Exception):
    """User interrupt between node executions (reference
    comfyUI/nodes.py before_node_execution +
    comfy/model_management.py InterruptProcessingException)."""


class NodeExecutionError(Exception):
    """A node implementation raised: carries the reference's structured
    error_details (execution.py:950-993 handle_execution_error: node id and
    type, exception, input summary, executed set, traceback)."""

    def __init__(self, details: dict):
        super().__init__(
            f"node {details.get('node_id')} ({details.get('node_type')}): "
            f"{details.get('exception_message')}"
        )
        self.details = details


def _summarize_value(v) -> str:
    """Compact input repr for error_details (tensors become shape/dtype)."""
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return f"<array shape={tuple(v.shape)} dtype={str(v.dtype).replace('torch.', '')}>"
    r = repr(v)
    return r if len(r) <= 120 else r[:117] + "..."


_INTERRUPT = threading.Event()


def interrupt_processing(value: bool = True) -> None:
    """Request (or clear) an interrupt of the running prompt, from any
    thread; honored at the next node boundary."""
    if value:
        _INTERRUPT.set()
    else:
        _INTERRUPT.clear()


def processing_interrupted() -> bool:
    return _INTERRUPT.is_set()


def before_node_execution() -> None:
    """Raise if an interrupt is pending (reference nodes.before_node_execution).
    The flag is consumed so the next prompt starts clean."""
    if _INTERRUPT.is_set():
        _INTERRUPT.clear()
        raise InterruptProcessingException("processing interrupted")


def register_node(name: str, *aliases: str):
    def deco(fn: Callable) -> Callable:
        NODE_REGISTRY[name] = fn
        for a in aliases:
            NODE_REGISTRY[a] = fn
        return fn

    return deco


def widget(node, i: int, default, cast=None):
    """Positional widget with default + optional coercion (trailing widgets
    are optional, matching the reference's INPUT_TYPES defaults)."""
    w = node.widgets
    if len(w) <= i or w[i] is None:
        return default
    return cast(w[i]) if cast else w[i]


@dataclass
class InferenceContext:
    """Per-execute context (reference comfyUI/types/hidden.py InferenceContext),
    with the device every node's tensors go to."""

    engine_data: Optional[EngineData] = None
    outputs: Dict[int, tuple] = field(default_factory=dict)
    final_output: Any = None
    frame_count: int = 0
    model_dirs: Tuple[str, ...] = ()
    corresponder: Any = None
    status_messages: List[str] = field(default_factory=list)
    # mutable 1-slot holder for a host progress sink
    # (step, total, preview_rgb|None) -> None, called from the sampler's step
    # callback when set (reference websocket progress, comfyUI/main.py:187-195)
    progress_holder: Any = None
    # default: the card (raises without one), as the executor's
    device: torch.device = field(default_factory=resolve_device)


class PromptExecutor:
    """Execute a Workflow graph. Loader-node outputs persist across calls;
    frame-dependent nodes re-run per execute (IS_CHANGED semantics). Node
    outputs lie on ``device`` (default: the card; raises without one)."""

    FRAME_DEPENDENT = {"EngineData", "EngineDataNode", "VirtualEngineData",
                       # composes + installs ctx.engine_data as a side effect,
                       # so a cached re-execute would lose it (nodes_sr.py)
                       "VirtualEngineDataNode"}

    def __init__(self, workflow: Workflow, model_dirs: Tuple[str, ...] = (),
                 validate: bool = True, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            keep_f32()
        self.workflow = workflow
        self.model_dirs = model_dirs
        self._cache: Dict[int, tuple] = {}
        self.progress_holder: list = [None]  # [sink]; see InferenceContext
        # NodePool (reference comfyUI/types/runtime.py): persistent node
        # INSTANCES keyed (node_id, type) for class-registered nodes
        self.node_pool: Dict[Tuple[int, str], Any] = {}
        self._frame_tainted: set = set()
        self._compute_taint()
        self.validation_errors: List[dict] = []
        if validate:
            self.validate()

    def validate(self) -> List[dict]:
        """Validate the graph before execution (execution.py:1170-1512);
        raises WorkflowValidationError when invalid."""
        from stable_renderer_tpu_torch.workflow.validation import (
            WorkflowValidationError,
            validate_workflow,
        )

        self.validation_errors = validate_workflow(self.workflow, NODE_REGISTRY)
        if self.validation_errors:
            raise WorkflowValidationError(self.validation_errors)
        return self.validation_errors

    def _compute_taint(self) -> None:
        """Mark nodes downstream of frame-dependent nodes (re-run every frame)."""
        nodes = self.workflow.nodes
        tainted = {n.id for n in nodes.values() if n.type in self.FRAME_DEPENDENT}
        changed = True
        while changed:
            changed = False
            for n in nodes.values():
                if n.id in tainted:
                    continue
                for _, (src, _slot) in n.inputs.items():
                    if src in tainted:
                        tainted.add(n.id)
                        changed = True
                        break
        self._frame_tainted = tainted

    def execute(
        self,
        engine_data: Optional[EngineData] = None,
        frame_count: int = 0,
        extra: Optional[dict] = None,
    ) -> InferenceContext:
        ctx = InferenceContext(
            engine_data=engine_data,
            frame_count=frame_count,
            model_dirs=self.model_dirs,
            progress_holder=self.progress_holder,
            device=self.device,
        )
        if extra:
            for k, v in extra.items():
                setattr(ctx, k, v)
        # outputs: start from the persistent cache for untainted nodes
        ctx.outputs = {
            nid: out for nid, out in self._cache.items() if nid not in self._frame_tainted
        }
        # output nodes: InferenceOutput, or any node nothing depends on
        consumed = {src for n in self.workflow.nodes.values() for (src, _) in n.inputs.values()}
        sinks = [
            n for n in self.workflow.nodes.values()
            if n.type == "InferenceOutput" or n.id not in consumed
        ]
        try:
            for sink in sinks:
                self._run_node(sink, ctx)
        except NodeExecutionError as err:
            # prune cached outputs that were not (re)computed this run: they
            # may depend on the failed node's stale state (execution.py:984-993)
            executed = set(ctx.outputs)
            for nid in [n for n in self._cache if n not in executed]:
                del self._cache[nid]
            ctx.error_details = err.details
            raise
        for nid, out in ctx.outputs.items():
            if nid not in self._frame_tainted:
                self._cache[nid] = out
        return ctx

    def _run_node(self, node: WorkflowNode, ctx: InferenceContext) -> tuple:
        if node.id in ctx.outputs:
            return ctx.outputs[node.id]
        before_node_execution()
        impl = NODE_REGISTRY.get(node.type)
        if impl is None:
            import difflib

            close = difflib.get_close_matches(node.type, NODE_REGISTRY, n=3)
            hint = f" (did you mean: {', '.join(close)}?)" if close else ""
            raise NodeExecutionError({
                "node_id": node.id,
                "node_type": node.type,
                "exception_type": "NotImplementedError",
                "exception_message": f"node type '{node.type}' has no "
                                     f"implementation{hint}",
                "traceback": [],
                "current_inputs": {},
                "executed": sorted(ctx.outputs, key=str),
            })
        from stable_renderer_tpu_torch.workflow.validation import NODE_SPECS, Lazy, find_adapter

        spec = NODE_SPECS.get(node.type)
        inputs: Dict[str, Any] = {}
        for name, (src_id, slot) in node.inputs.items():
            src = self.workflow.nodes[src_id]
            if spec and name in spec.lazy_inputs:
                # Lazy[T]: the producing subgraph runs only if forced
                inputs[name] = Lazy(self, ctx, src, slot, spec.input_types.get(name, "ANY"))
                continue
            out = self._run_node(src, ctx)
            val = out[slot] if slot < len(out) else None
            # adapter insertion on typed links (adapters.py find_adapter)
            src_spec = NODE_SPECS.get(src.type)
            if (spec and src_spec and name in spec.input_types
                    and slot < len(src_spec.return_types)):
                adapter = find_adapter(src_spec.return_types[slot], spec.input_types[name])
                if adapter is not None:
                    val = adapter(val)
            inputs[name] = val
        try:
            if isinstance(impl, type):
                # class-based node: one persistent instance per (node_id, type)
                key = (node.id, node.type)
                inst = self.node_pool.get(key)
                if inst is None:
                    inst = self.node_pool[key] = impl()
                result = inst(ctx, node, **inputs)
            else:
                result = impl(ctx, node, **inputs)
        except (InterruptProcessingException, NodeExecutionError):
            raise  # innermost failing node wins; interrupts pass through
        except Exception as exc:
            import traceback as _tb

            raise NodeExecutionError({
                "node_id": node.id,
                "node_type": node.type,
                "exception_type": type(exc).__name__,
                "exception_message": str(exc),
                "traceback": _tb.format_exception(type(exc), exc, exc.__traceback__),
                "current_inputs": {name: _summarize_value(v) for name, v in inputs.items()},
                "executed": sorted(ctx.outputs, key=str),
            }) from exc
        if not isinstance(result, tuple):
            result = (result,)
        ctx.outputs[node.id] = result
        return result


# ---------------------------------------------------------------------------
# node implementations


def _find_model_file(ctx: InferenceContext, name: str) -> Optional[str]:
    name = name.replace("\\", "/")
    for d in ctx.model_dirs:
        for cand in (Path(d) / name, Path(d) / Path(name).name):
            if cand.exists():
                return str(cand)
    if Path(name).exists():
        return name
    return None


def _on(ctx: InferenceContext, t) -> torch.Tensor:
    """``t`` (a tensor or an array) on the context's device, its dtype kept."""
    if isinstance(t, torch.Tensor):
        return t.to(ctx.device)
    return torch.as_tensor(np.asarray(t), device=ctx.device)


def _generator(ctx: InferenceContext, seed: int) -> torch.Generator:
    return torch.Generator(device=ctx.device).manual_seed(int(seed))


def tiny_models(device, generator: torch.Generator):
    """(MODEL, CLIP, VAE) of the tiny configs, drawn from ``generator`` on
    ``device``: CheckpointLoaderSimple's fallback without a file."""
    from dataclasses import replace

    from stable_renderer_tpu_torch.models.clip import TINY_CLIP_CONFIG, CLIPTextModel, Tokenizer
    from stable_renderer_tpu_torch.models.sampling import ModelSampling
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG, UNetModel
    from stable_renderer_tpu_torch.models.vae import TINY_VAE_CONFIG, VAE

    ccfg = replace(TINY_CLIP_CONFIG, hidden_size=TINY_UNET_CONFIG.context_dim)
    unet, vae, clip = UNetModel(TINY_UNET_CONFIG), VAE(TINY_VAE_CONFIG), CLIPTextModel(ccfg)
    model = {"unet": unet, "params": unet.init(generator, device=device),
             "sampling": ModelSampling()}
    vae_d = {"vae": vae, "params": vae.init(generator, device=device)}
    clip_d = {"clip": clip, "params": clip.init(generator, device=device),
              "tokenizer": Tokenizer(ccfg)}
    return model, clip_d, vae_d


@register_node("CheckpointLoaderSimple")
def checkpoint_loader(ctx: InferenceContext, node: WorkflowNode):
    """-> (MODEL, CLIP, VAE), the UNet and VAE in bf16 and the text towers
    in f32 (SD2's in the file's dtype) as the JAX package's node loads them.
    The family picks the prediction (the x4 upscaler with its betas 1e-4 ->
    2e-2) and the text towers (comfy sd.py clip_target): SD2, SD2.1-unclip and x4 ``SD2ClipH``
    at ``cond_stage_model.model.``; SDXL CLIP-L and CLIP-G at
    ``conditioner.embedders.{0,1}``; the refiner CLIP-G alone at
    ``embedders.0`` (``g_only``). The VAE is ``SD15_VAE_CONFIG`` for every
    family, SDXL's included (the JAX node's scale 0.18215, where
    ``from_checkpoint`` takes SDXL's 0.13025). Falls back to tiny random
    models when the file is absent (keeps reference workflows runnable
    offline)."""
    from stable_renderer_tpu_torch.models import clip as clip_mod
    from stable_renderer_tpu_torch.models.sampling import ModelSampling
    from stable_renderer_tpu_torch.models.unet import UNetModel
    from stable_renderer_tpu_torch.models.vae import SD15_VAE_CONFIG, VAE
    from stable_renderer_tpu_torch.models.weights import (
        load_checkpoint_flat,
        load_state_dict,
        nest,
        tree_to,
    )

    name = str(node.widgets[0]) if node.widgets else ""
    path = _find_model_file(ctx, name)
    if path:
        # one flat read serves split, family detection and tower nesting
        if Path(path).is_dir():
            from stable_renderer_tpu_torch.models.diffusers_convert import load_diffusers_folder

            flat = load_diffusers_folder(path)
        else:
            flat = load_state_dict(path)
        unet_p, vae_p, clip_p, ucfg, fam = load_checkpoint_flat(flat, path)
        if fam["family"] == "sd-x4-upscaler":  # supported_models.py:326
            ms = ModelSampling(beta_start=0.0001, beta_end=0.02, prediction=fam["prediction"])
        else:
            ms = ModelSampling(prediction=fam["prediction"])
        model = {"unet": UNetModel(ucfg),
                 "params": tree_to(unet_p, ctx.device, torch.bfloat16),
                 "sampling": ms,
                 "family": fam["family"],
                 "noise_aug_dim": fam["noise_aug_dim"]}
        vae = {"vae": VAE(SD15_VAE_CONFIG), "params": tree_to(vae_p, ctx.device, torch.bfloat16)}
        l_cfg = clip_mod.SD15_CLIP_CONFIG
        clip = {"clip": clip_mod.CLIPTextModel(l_cfg),
                "params": tree_to(clip_p, ctx.device, torch.float32),
                "tokenizer": clip_mod.Tokenizer(l_cfg)}
        if fam["family"] in ("sd2", "sd21-unclip", "sd-x4-upscaler"):
            # the tower in the file's dtype, as the JAX node leaves it
            clip["clip"] = clip_mod.SD2ClipH(clip_mod.SD2_CLIP_H_CONFIG)
            clip["params"] = {"model": tree_to(nest(flat, "cond_stage_model.model."),
                                               ctx.device)}
        elif fam["family"] in ("sdxl", "sdxl-refiner"):
            refiner = fam["family"] == "sdxl-refiner"
            clip["params"] = {} if refiner else tree_to(
                nest(flat, "conditioner.embedders.0.transformer."), ctx.device, torch.float32)
            clip["clip_g"] = clip_mod.OpenCLIPTextModel(clip_mod.SDXL_CLIP_G_CONFIG)
            clip["params_g"] = tree_to(
                {"model": nest(flat, f"conditioner.embedders.{0 if refiner else 1}.model.")},
                ctx.device, torch.float32)
            if refiner:
                clip["g_only"] = True
        return model, clip, vae
    logger.warning(f"checkpoint '{name}' not found in {ctx.model_dirs}; using tiny random models")
    return tiny_models(ctx.device, _generator(ctx, 0))


@register_node("LoraLoaderModelOnly")
def lora_loader_model_only(ctx: InferenceContext, node: WorkflowNode, model=None):
    name = str(node.widgets[0]) if node.widgets else ""
    strength = float(node.widgets[1]) if len(node.widgets) > 1 else 1.0
    path = _find_model_file(ctx, name)
    if path is None:
        logger.warning(f"lora '{name}' not found; passing model through")
        return (model,)
    from stable_renderer_tpu_torch.models.lora import merge_lora
    from stable_renderer_tpu_torch.models.weights import load_state_dict

    new_params, _ = merge_lora(model["params"], load_state_dict(path), strength,
                               prefix="lora_unet_")
    return ({**model, "params": new_params},)


def _encode_weighted(clip: dict, prompts: list, device) -> torch.Tensor:
    """Weighted multi-chunk CLIP encode honoring CLIPSetLastLayer's clip_skip
    (sd1_clip.py encode_token_weights + CLIPTextEncode semantics): CLIP-G
    alone for a refiner's ``g_only`` CLIP (clip skip -2 by default), the
    ``clip`` tower otherwise (an SDXL CLIP's L tower only, as in the JAX
    package: its dual encode is CLIPTextEncodeSDXL's)."""
    from stable_renderer_tpu_torch.models.clip import (
        encode_token_weights_batch,
        encode_token_weights_batch_g,
    )

    ids, w, custom = clip["tokenizer"].tokenize_weighted_batch(prompts)
    ids, w = torch.as_tensor(ids, device=device), torch.as_tensor(w, device=device)
    if clip.get("g_only"):
        return encode_token_weights_batch_g(clip["clip_g"], clip["params_g"], ids, w,
                                            clip_skip=int(clip.get("clip_skip", -2)))[0]
    ctx_, _ = encode_token_weights_batch(
        clip["clip"], clip["params"], ids, w,
        None if custom is None else torch.as_tensor(custom, device=device),
        clip_skip=int(clip.get("clip_skip", -1)))
    return ctx_


@register_node("CLIPTextEncode")
def clip_text_encode(ctx: InferenceContext, node: WorkflowNode, clip=None, text=None):
    prompt = text if text is not None else (str(node.widgets[0]) if node.widgets else "")
    cond = _encode_weighted(clip, [prompt], ctx.device)
    return ({"context": cond, "controls": [], "prompt": prompt},)


@register_node("SceneTextEncode")
def scene_text_encode(ctx: InferenceContext, node: WorkflowNode, clip=None, **kw):
    """Per-sprite masked conditioning (stable_rendering conditions.py:52-110):
    each prompted sprite's text conditions only its ID-map pixels, the env
    prompt the background."""
    ed = ctx.engine_data
    sprited = []
    env_texts = []
    if ed is not None:
        sprited = [(sid, s.prompt) for sid, s in ed.sprite_infos.items() if s.prompt]
        env_texts = [p.prompt for p in ed.env_prompts if p.prompt]
    env_text = ", ".join(env_texts)
    if len(sprited) >= 1 and ed is not None and ed.id_maps is not None:
        texts = [t for _, t in sprited] + [env_text]
        ctx_s = _encode_weighted(clip, texts, ctx.device)  # (S+1, L, D)
        joint = ", ".join([t for t in texts if t])
        return ({
            "context": _encode_weighted(clip, [joint], ctx.device),
            "scene_contexts": ctx_s,
            "sprite_ids": tuple(sid for sid, _ in sprited),
            "controls": [], "prompt": joint,
        },)
    prompt = ", ".join([t for _, t in sprited] + env_texts)
    return ({"context": _encode_weighted(clip, [prompt], ctx.device), "controls": [],
             "prompt": prompt},)


@register_node("ConditioningSetArea", "ConditioningSetAreaPercentage")
def conditioning_set_area(ctx: InferenceContext, node: WorkflowNode, conditioning=None):
    """Restrict a conditioning to a rectangle (nodes.py ConditioningSetArea;
    pixel widgets /8 to latent units, strength kept)."""
    w = node.widgets
    if node.type == "ConditioningSetAreaPercentage":
        # percentages resolved at sampler time need latent dims; store raw
        width, height, x, y = [float(v) for v in w[:4]]
        strength = float(w[4]) if len(w) > 4 else 1.0
        return ({**conditioning, "area_pct": (height, width, y, x), "strength": strength},)
    width, height, x, y = [int(v) for v in w[:4]]
    strength = float(w[4]) if len(w) > 4 else 1.0
    return ({**conditioning, "area": (height // 8, width // 8, y // 8, x // 8),
             "strength": strength},)


@register_node("SolidMask")
def solid_mask(ctx: InferenceContext, node: WorkflowNode):
    """(comfy_extras nodes_mask.py SolidMask) constant-value mask."""
    w = node.widgets
    value = float(w[0]) if w else 1.0
    width = int(w[1]) if len(w) > 1 else 512
    height = int(w[2]) if len(w) > 2 else 512
    return (torch.full((1, height, width), value, device=ctx.device),)


@register_node("MaskComposite")
def mask_composite(ctx: InferenceContext, node: WorkflowNode, destination=None, source=None):
    """(comfy_extras nodes_mask.py MaskComposite) paste source into
    destination at (x, y) with an operation."""
    w = node.widgets
    x = int(w[0]) if w else 0
    y = int(w[1]) if len(w) > 1 else 0
    op = str(w[2]) if len(w) > 2 else "add"
    dst, src = _on(ctx, destination), _on(ctx, source)
    sh = min(src.shape[1], dst.shape[1] - y)
    sw = min(src.shape[2], dst.shape[2] - x)
    region = dst[:, y:y + sh, x:x + sw]
    patch = src[:1, :sh, :sw]
    if op == "add":
        new = torch.clamp(region + patch, 0, 1)
    elif op == "subtract":
        new = torch.clamp(region - patch, 0, 1)
    elif op == "multiply":
        new = region * patch
    else:  # 'or'/'and'/'xor' as max/min/abs-diff on soft masks
        new = {"or": torch.maximum, "and": torch.minimum}.get(
            op, lambda a, b: torch.abs(a - b))(region, patch)
    out = dst.clone()
    out[:, y:y + sh, x:x + sw] = new
    return (out,)


@register_node("ConditioningSetMask")
def conditioning_set_mask(ctx: InferenceContext, node: WorkflowNode,
                          conditioning=None, mask=None):
    """Mask a conditioning (nodes.py ConditioningSetMask); the mask itself
    stands in for set_cond_area's 'mask bounds' (no bbox crop)."""
    strength = float(node.widgets[0]) if node.widgets else 1.0
    return ({**conditioning, "mask": mask, "mask_strength": strength},)


@register_node("ConditioningSetTimestepRange")
def conditioning_set_timestep_range(ctx: InferenceContext, node: WorkflowNode,
                                    conditioning=None):
    """Gate a conditioning to a sampling-progress window (percents -> sigmas
    at sampler time)."""
    w = node.widgets
    start = float(w[0]) if w else 0.0
    end = float(w[1]) if len(w) > 1 else 1.0
    return ({**conditioning, "timestep_range": (start, end)},)


@register_node("ControlNetLoader")
def controlnet_loader(ctx: InferenceContext, node: WorkflowNode):
    """The file's name and path: the KSampler reads it (as the JAX package's)."""
    name = str(node.widgets[0]) if node.widgets else ""
    return ({"name": name, "path": _find_model_file(ctx, name)},)


@register_node("ControlNetApply", "ControlNetApplyAdvanced")
def controlnet_apply(ctx: InferenceContext, node: WorkflowNode, conditioning=None,
                     control_net=None, image=None, positive=None, negative=None):
    strength = float(node.widgets[0]) if node.widgets else 1.0
    start_p, end_p = 0.0, 1.0
    if node.type == "ControlNetApplyAdvanced" and len(node.widgets) >= 3:
        start_p, end_p = float(node.widgets[1]), float(node.widgets[2])
    entry = {"control": control_net, "hint": image, "strength": strength,
             "percent": (start_p, end_p)}
    cond = conditioning or positive
    out = {**cond, "controls": list(cond.get("controls", [])) + [entry]}
    if node.type == "ControlNetApplyAdvanced":
        neg = {**(negative or {}), "controls": list((negative or {}).get("controls", []))}
        return out, neg
    return (out,)


def _mask_at(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if mask.dim() == 2:
        mask = mask[None]
    if tuple(mask.shape[1:3]) != (h, w):
        mask = resize_nearest(mask[..., None], h, w)[..., 0]
    return mask


@register_node("VAEEncodeForInpaint")
def vae_encode_for_inpaint(ctx: InferenceContext, node: WorkflowNode,
                           pixels=None, vae=None, mask=None):
    """Inpaint-ready encode (nodes.py VAEEncodeForInpaint:349-386): grow the
    mask, neutralize masked pixels around 0.5 before encoding, attach
    noise_mask to the latent."""
    grow = int(node.widgets[0]) if node.widgets else 6
    mask = _mask_at(_on(ctx, mask), pixels.shape[1], pixels.shape[2])
    if grow > 0:
        # dilate the rounded mask with a grow x grow ones kernel, zero padded
        pad = grow // 2
        grown = F.max_pool2d(F.pad(torch.round(mask)[:, None],
                                   (pad, grow - 1 - pad, pad, grow - 1 - pad)),
                             grow, stride=1)[:, 0]
        grown = torch.clamp(grown, 0.0, 1.0)
    else:
        grown = mask
    m = (1.0 - torch.round(mask))[..., None]
    neutral = (pixels - 0.5) * m + 0.5
    z = vae["vae"].encode(vae["params"], neutral * 2.0 - 1.0)
    return ({"samples": z, "noise_mask": torch.round(grown)},)


@register_node("InpaintModelConditioning")
def inpaint_model_conditioning(ctx: InferenceContext, node: WorkflowNode, positive=None,
                               negative=None, vae=None, pixels=None, mask=None):
    """Conditioning for 9-channel inpaint checkpoints (nodes.py
    InpaintModelConditioning): the masked pixels' latent rides both conds
    as their c_concat source, and the latent carries the noise mask."""
    mask = _mask_at(_on(ctx, mask), pixels.shape[1], pixels.shape[2])
    m = (1.0 - torch.round(mask))[..., None]
    masked_pixels = (pixels - 0.5) * m + 0.5
    model = vae["vae"]
    z = model.encode(vae["params"], pixels * 2.0 - 1.0)
    zm = model.encode(vae["params"], masked_pixels * 2.0 - 1.0)
    out_latent = {"samples": z, "noise_mask": torch.round(mask), "concat_latent_image": zm}
    return ({**(positive or {}), "concat_latent_image": zm},
            {**(negative or {}), "concat_latent_image": zm}, out_latent)


@register_node("LatentComposite")
def latent_composite(ctx: InferenceContext, node: WorkflowNode,
                     samples_to=None, samples_from=None):
    """Paste one latent into another with optional feathered edges
    (nodes.py LatentComposite:1264-1304)."""
    w = node.widgets
    x = (int(w[0]) if w else 0) // 8
    y = (int(w[1]) if len(w) > 1 else 0) // 8
    feather = (int(w[2]) if len(w) > 2 else 0) // 8
    to = samples_to["samples"] if isinstance(samples_to, dict) else samples_to
    frm = samples_from["samples"] if isinstance(samples_from, dict) else samples_from
    fh = min(frm.shape[1], to.shape[1] - y)
    fw = min(frm.shape[2], to.shape[2] - x)
    frm = frm[:, :fh, :fw]
    out = to.clone()
    if feather == 0:
        out[:, y: y + fh, x: x + fw] = frm
    else:
        m = torch.ones((fh, fw), device=to.device)
        for t in range(feather):
            f = (t + 1) / feather
            if y != 0:
                m[t] *= f
            if y + fh < to.shape[1]:
                m[fh - 1 - t] *= f
            if x != 0:
                m[:, t] *= f
            if x + fw < to.shape[2]:
                m[:, fw - 1 - t] *= f
        m = m[None, :, :, None]
        out[:, y: y + fh, x: x + fw] = frm * m + to[:, y: y + fh, x: x + fw] * (1 - m)
    res = dict(samples_to) if isinstance(samples_to, dict) else {}
    res["samples"] = out
    return (res,)


@register_node("ImageBlend")
def image_blend(ctx: InferenceContext, node: WorkflowNode, image1=None, image2=None):
    """Blend two images (comfy_extras nodes_post_processing Blend)."""
    w = node.widgets
    factor = float(w[0]) if w else 0.5
    mode = str(w[1]) if len(w) > 1 else "normal"
    if image2.shape != image1.shape:
        image2 = resize_nearest(image2, image1.shape[1], image1.shape[2])
    if mode == "multiply":
        blended = image1 * image2
    elif mode == "screen":
        blended = 1.0 - (1.0 - image1) * (1.0 - image2)
    elif mode == "difference":
        blended = torch.abs(image1 - image2)
    else:  # normal
        blended = image2
    return (torch.clamp(image1 * (1 - factor) + blended * factor, 0.0, 1.0),)


@register_node("ImageInvert")
def image_invert(ctx: InferenceContext, node: WorkflowNode, image=None):
    return (1.0 - image,)


@register_node("ImageBatch")
def image_batch(ctx: InferenceContext, node: WorkflowNode, image1=None, image2=None):
    if image2.shape[1:3] != image1.shape[1:3]:
        image2 = resize_nearest(image2, image1.shape[1], image1.shape[2])
    return (torch.cat([image1, image2], 0),)


@register_node("EngineData", "EngineDataNode", "VirtualEngineData")
def engine_data_node(ctx: InferenceContext, node: WorkflowNode):
    """Unpack EngineData into its output slots (stable_rendering _nodes/data.py):
    colors, ids, positions, normals, depths, canny, noises, masks,
    correspond_maps, sprites, env_prompt."""
    ed = ctx.engine_data
    if ed is None:
        raise ValueError("no engine_data in context (game/bake mode required)")
    return (
        ed.color_maps,
        ed.id_maps,
        ed.pos_maps,
        ed.normal_maps,
        ed.depth_maps,
        ed.canny_maps,
        {"samples": ed.noise_maps, "noise": ed.noise_maps},
        ed.masks,
        ed.correspond_maps,
        ed.sprite_infos,
        ed.env_prompts,
    )


@register_node("EmptyCorrMaps")
def empty_corrmaps(ctx: InferenceContext, node: WorkflowNode, **kw):
    return ({},)


@register_node("DefaultCorresponder")
def default_corresponder_node(ctx: InferenceContext, node: WorkflowNode, **kw):
    from stable_renderer_tpu_torch.ops.correspondence import DefaultCorresponder

    return (DefaultCorresponder(),)


@register_node("OverlapCorresponder")
def overlap_corresponder_node(ctx: InferenceContext, node: WorkflowNode, **kw):
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    return (OverlapCorresponder(),)


def load_control(c: dict, model: dict, device, generator: Optional[torch.Generator] = None):
    """One control entry's (net, params), as the KSampler builds it: the
    control file read and its format sniffed as comfy load_controlnet /
    load_t2i_adapter (controlnet.py:360-560) do (a ``lora_controlnet`` key
    makes a control-LoRA over the model's UNet; ``adapter.`` / ``body.`` keys
    or ``conv_in.weight`` a T2I-Adapter; else the ``control_model.`` tree,
    with a DiffControlNetLoader's base added back), in bf16; without a file,
    a fresh f32 ControlNet from ``generator`` (default: seeded with 5)."""
    from stable_renderer_tpu_torch.models.controlnet import ControlNet, ControlNetConfig
    from stable_renderer_tpu_torch.models.weights import load_state_dict, nest, tree_to

    cn = ControlNet(ControlNetConfig(unet=model["unet"].config))
    if not (c["control"] and c["control"].get("path")):
        gen = generator or torch.Generator(device=device).manual_seed(5)
        return cn, cn.init(gen, device=device)
    flat = load_state_dict(c["control"]["path"])
    if "lora_controlnet" in flat:
        return cn, cn.init_control_lora(model["params"], flat)
    if any(k.startswith(("adapter.", "body.")) or k == "conv_in.weight" for k in flat):
        from stable_renderer_tpu_torch.models.t2i_adapter import load_t2i_adapter

        ad, params = load_t2i_adapter(flat)
        return ad, tree_to(params, device, torch.bfloat16)
    params = tree_to(nest(flat, "control_model."), device, torch.bfloat16)
    diff_base = c["control"].get("diff_base")
    if diff_base is not None:
        # diff checkpoints hold controlnet-minus-base weights: add the base
        # UNet's matching tensors back (comfy controlnet.py model-diff path)
        def add_base(cp, bp):
            if isinstance(cp, dict):
                return {k: (add_base(v, bp[k]) if isinstance(bp, dict) and k in bp else v)
                        for k, v in cp.items()}
            if getattr(bp, "shape", None) == cp.shape:
                return cp + bp.to(cp.device, cp.dtype)
            return cp

        params = add_base(params, diff_base["params"])
    return cn, params


def _control_fn(controls: list, hints: list):
    """The per-evaluation control callable over ``controls`` [(net, params,
    strength, percent)]: every control's residuals summed entry by entry
    (ControlBase.control_merge). Each hint is brought to 8x the latent size
    and its tower runs once per batch size, tiled to the batch (the hint
    does not change within a sampler call)."""
    from stable_renderer_tpu_torch.models.controlnet import ControlNet

    guided: dict = {}

    def tiled(t: torch.Tensor, reps: int) -> torch.Tensor:
        return torch.cat([t] * reps, 0) if reps > 1 else t

    def control_fn(x_in, t, c_):
        total = None
        for i, ((cn, params, strength, percent), hint) in enumerate(zip(controls, hints)):
            g = guided.get((i, x_in.shape[0]))
            if g is None:
                want = (x_in.shape[1] * 8, x_in.shape[2] * 8)
                if tuple(hint.shape[1:3]) != want:
                    hint = resize_nearest(hint, want[0], want[1])
                reps = x_in.shape[0] // hint.shape[0]
                if isinstance(cn, ControlNet):
                    g = tiled(cn.apply_hint(params, hint), reps)
                else:  # T2I-Adapter: one feature (or None) per input block
                    g = [None if f is None else tiled(f, reps)
                         for f in cn.apply_hint(params, hint, x_in.dtype)]
                guided[(i, x_in.shape[0])] = g
            ctl = cn.apply(params, x_in, None, t, c_, strength=strength, percent_range=percent,
                           guided_hint=g)
            if total is None:
                total = dict(ctl)
                continue
            for k2, lst in ctl.items():
                if k2 not in total:
                    total[k2] = lst
                else:
                    total[k2] = [a if b is None else (b if a is None else a + b)
                                 for a, b in zip(total[k2], lst)]
        return total

    return control_fn


@register_node("KSampler", "CorrespondSampler", "KSamplerAdvanced")
def ksampler(
    ctx: InferenceContext, node: WorkflowNode,
    model=None, positive=None, negative=None, latent_image=None,
    corresponder=None, engine_data=None, **kw,
):
    """The sampler nodes over the shared denoiser assembly
    (models/sampling/assemble.py), run eagerly. Noise comes from the latent's
    ``noise`` slot, else a generator seeded with the seed widget on the
    context's device (so do the sampler's draws)."""
    from stable_renderer_tpu_torch.models.sampling import calculate_sigmas
    from stable_renderer_tpu_torch.models.sampling.assemble import (
        build_denoiser,
        inpaint_concat_channels,
    )
    from stable_renderer_tpu_torch.models.sampling.conds import CondSpec
    from stable_renderer_tpu_torch.models.unet import AttnHooks
    from stable_renderer_tpu_torch.workflow.nodes_extra import model_patch_options

    dev = ctx.device
    w = node.widgets
    add_noise = True
    start_at_step, end_at_step = 0, 10000
    force_full_denoise = True
    if node.type == "CorrespondSampler":
        # no seed widget: [steps, cfg, sampler_name, scheduler, denoise]
        # (stable_rendering/_nodes/samplers.py:139-143)
        seed = 0
        steps = int(w[0]) if w else 20
        cfg_scale = float(w[1]) if len(w) > 1 else 8.0
        sampler_name = str(w[2]) if len(w) > 2 else "euler"
        scheduler = str(w[3]) if len(w) > 3 else "normal"
        denoise = float(w[4]) if len(w) > 4 else 1.0
    elif node.type == "KSamplerAdvanced":
        # [add_noise, noise_seed, seed_mode, steps, cfg, sampler, scheduler,
        #  start_at_step, end_at_step, return_with_leftover_noise]
        add_noise = str(w[0]) != "disable" if w else True
        seed = int(w[1]) % (2**31) if len(w) > 1 else 0
        steps = int(w[3]) if len(w) > 3 else 20
        cfg_scale = float(w[4]) if len(w) > 4 else 7.0
        sampler_name = str(w[5]) if len(w) > 5 else "euler"
        scheduler = str(w[6]) if len(w) > 6 else "normal"
        start_at_step = int(w[7]) if len(w) > 7 else 0
        end_at_step = int(w[8]) if len(w) > 8 else 10000
        force_full_denoise = (str(w[9]) != "enable") if len(w) > 9 else True
        denoise = 1.0
    else:
        # KSampler: [seed, seed_mode, steps, cfg, sampler, scheduler, denoise]
        seed = int(w[0]) % (2**31) if w else 0
        steps = int(w[2]) if len(w) > 2 else 20
        cfg_scale = float(w[3]) if len(w) > 3 else 7.0
        sampler_name = str(w[4]) if len(w) > 4 else "euler"
        scheduler = str(w[5]) if len(w) > 5 else "normal"
        denoise = float(w[6]) if len(w) > 6 else 1.0

    if node.type == "CorrespondSampler" and corresponder is not None:
        # reference gate: OverlapCorresponder only with ddim/ddpm
        # (stable_rendering/_nodes/samplers.py:163), with an explicit opt-out
        from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

        if (isinstance(corresponder, OverlapCorresponder)
                and sampler_name not in ("ddim", "ddpm")
                and not getattr(corresponder, "allow_any_sampler", False)):
            raise ValueError(
                "OverlapCorresponder only works with ddim or ddpm sampler_name "
                "(set allow_any_sampler=True to override)")

    ms = model["sampling"]
    if sampler_name == "lcm":
        ms = type(ms)(prediction="lcm")
    is_dict = isinstance(latent_image, dict)
    latent = _on(ctx, latent_image["samples"] if is_dict else latent_image)
    noise = latent_image.get("noise") if is_dict else None
    # InpaintModelConditioning's masked-image latent for 9-channel inpaint UNets
    concat_zm = latent_image.get("concat_latent_image") if is_dict else None
    if concat_zm is None and isinstance(positive, dict):
        concat_zm = positive.get("concat_latent_image")
    neg_concat = negative.get("concat_latent_image") if isinstance(negative, dict) else None
    y_pos = positive.get("y") if isinstance(positive, dict) else None
    y_neg = negative.get("y") if isinstance(negative, dict) else None
    if model.get("noise_aug_dim"):
        # SD2.1-unclip: unCLIPConditioning's entries folded into the ADM
        # vector by the CLIP-embed noise augmentor (model_base.py:271-295);
        # zeros without image conditioning. Both conds draw from the same
        # seed, as the JAX package's one key serves both
        from stable_renderer_tpu_torch.models import noise_aug

        aug = noise_aug.NoiseAugmentor(timestep_dim=int(model["noise_aug_dim"]))
        adm = []
        for c in (positive, negative):
            entries = c.get("unclip") if isinstance(c, dict) else None
            adm.append(noise_aug.unclip_adm(entries, aug, _generator(ctx, abs(seed - 10)))
                       if entries else torch.zeros((1, 2 * aug.timestep_dim), device=dev))
        y_pos, y_neg = adm
    if (isinstance(positive, dict) and positive.get("concat_image") is not None
            and getattr(model["unet"].config, "num_classes", None)):
        # SD_X4Upscaler (model_base.py:454-479): the low-res image is
        # noise-augmented at round(350 * noise_augmentation) on the linear
        # schedule; the level feeds the class-embedding table as y
        from stable_renderer_tpu_torch.models.noise_aug import NoiseAugmentor
        from stable_renderer_tpu_torch.workflow.nodes_extra import _resize_image

        img = _on(ctx, positive["concat_image"]).float()
        if img.shape[1:3] != latent.shape[1:3]:
            img = _resize_image(img, latent.shape[1], latent.shape[2], "bilinear")
        aug_amt = float(positive.get("noise_augmentation", 0.0))
        level = round(350 * aug_amt)
        if aug_amt > 0:
            x4_aug = NoiseAugmentor(timestep_dim=1, max_noise_level=350, schedule="linear")
            img = x4_aug.q_sample(img, level, _generator(ctx, abs(seed - 10)))
        concat_zm = neg_concat = img  # the reference attaches the same pixels to both conds
        y_pos = y_neg = torch.full((1, 1), float(level), device=dev)
    # Stable Cascade's Stage B: Stage C's latent feeds the effnet mapper
    # (model_base.py StableCascade_B.extra_conds; the uncond rows take zeros)
    cascade_prior = positive.get("stable_cascade_prior") if isinstance(positive, dict) else None
    # inpaint: a latent-attached noise_mask restricts denoising to the hole
    noise_mask = latent_image.get("noise_mask") if is_dict else None
    if noise_mask is not None:
        noise_mask = _mask_at(_on(ctx, noise_mask), latent.shape[1], latent.shape[2])[..., None]
    b = latent.shape[0]
    ctx_pos = positive["context"]
    ctx_neg = negative["context"] if negative else None
    ccp = model.get("cc_projection")
    if ccp is not None and ctx_pos.shape[-1] != model["unet"].config.context_dim:
        # Zero123: project [clip-vision embed, camera embedding] (772) into the
        # UNet's 768-wide cross-attention space (comfy model_base.py Zero123)
        w_cc = _on(ctx, ccp["weight"])
        b_cc = _on(ctx, ccp["bias"]) if "bias" in ccp else torch.zeros(w_cc.shape[0], device=dev)
        ctx_pos = ctx_pos @ w_cc.T + b_cc
        if ctx_neg is not None:
            if ctx_neg.shape[-1] != w_cc.shape[1]:
                ctx_neg = torch.cat([ctx_neg, torch.zeros(
                    (*ctx_neg.shape[:-1], w_cc.shape[1] - ctx_neg.shape[-1]),
                    device=ctx_neg.device)], -1)
            ctx_neg = ctx_neg @ w_cc.T + b_cc
    if ctx_pos.shape[0] != b:
        ctx_pos = ctx_pos[:1].expand((b,) + tuple(ctx_pos.shape[1:]))
    if ctx_neg is not None and ctx_neg.shape[0] != b:
        ctx_neg = ctx_neg[:1].expand((b,) + tuple(ctx_neg.shape[1:]))

    # --- cond-list assembly: area / mask / timestep-range / combine ----------
    lh, lw = latent.shape[1], latent.shape[2]
    entries = [positive] + list(positive.get("extra_conds", []))
    scene_ctx = positive.get("scene_contexts")
    sprite_ids = tuple(positive.get("sprite_ids", ()))
    specs, cond_ctxs, cond_masks = [], [], []
    for e in entries:
        area = e.get("area")
        if area is None and e.get("area_pct") is not None:
            hp, wp, yp, xp = e["area_pct"]
            area = (max(1, int(hp * lh)), max(1, int(wp * lw)), int(yp * lh), int(xp * lw))
        tr = e.get("timestep_range")
        sigma_start, sigma_end = float("inf"), 0.0
        if tr is not None:
            sigma_start = ms.percent_to_sigma(float(tr[0]))
            sigma_end = ms.percent_to_sigma(float(tr[1]))
        m = e.get("mask")
        if m is not None:
            m = _mask_at(_on(ctx, m), lh, lw)
            if m.shape[0] != b:
                m = m[:1].expand(b, lh, lw)
        c_e = e["context"]
        if c_e.shape[0] != b:
            c_e = c_e[:1].expand((b,) + tuple(c_e.shape[1:]))
        specs.append(CondSpec(
            area=area, strength=float(e.get("strength", 1.0)),
            mask_strength=float(e.get("mask_strength", 1.0)),
            sigma_start=sigma_start, sigma_end=sigma_end, has_mask=m is not None))
        cond_ctxs.append(c_e)
        cond_masks.append(m)
    use_conds = len(entries) > 1 or any(
        s.area is not None or s.has_mask or s.sigma_start != float("inf")
        or s.sigma_end != 0.0 or s.strength != 1.0 for s in specs)

    # ControlNet files are read here, on every execute, as the JAX package does
    controls, hints = [], []
    for c in positive.get("controls", []):
        cn, params = load_control(c, model, dev)
        controls.append((cn, params, float(c["strength"]), tuple(c["percent"])))
        hints.append(_on(ctx, c["hint"])[..., :3])

    if corresponder is not None and ctx.engine_data is not None:
        ctx.corresponder = corresponder
    id_maps = ctx.engine_data.id_maps if ctx.engine_data is not None else None
    normal_maps = ctx.engine_data.normal_maps if ctx.engine_data is not None else None
    use_corr = corresponder is not None and id_maps is not None
    use_scene = scene_ctx is not None and id_maps is not None and len(sprite_ids) > 0
    holder = getattr(ctx, "progress_holder", None)
    use_progress = bool(holder) and holder[0] is not None

    sigmas = torch.as_tensor(np.asarray(calculate_sigmas(ms, scheduler, steps, denoise)),
                             dtype=torch.float32)
    if node.type == "KSamplerAdvanced":
        # sigma-window slicing (comfy sample.py sample_custom semantics): run
        # steps [start_at, end_at); leftover noise keeps the tail sigma
        sigmas = sigmas[start_at_step: min(end_at_step, steps) + 1]
        if force_full_denoise:
            sigmas = torch.cat([sigmas[:-1], torch.zeros(1)])
        if sigmas.shape[0] < 2:
            raise ValueError(f"KSamplerAdvanced window [{start_at_step}, {end_at_step}) "
                             "leaves no steps")
    if noise is None:
        if add_noise:
            noise = torch.randn(latent.shape, generator=_generator(ctx, seed), device=dev)
        else:
            noise = torch.zeros_like(latent)
    noise = _on(ctx, noise)

    log_sigmas = torch.as_tensor(ms.log_sigmas)
    unet = model["unet"]
    from stable_renderer_tpu_torch.models.video_unet import VideoUNetModel

    if isinstance(unet, VideoUNetModel):
        # frame groups of the latent's batch, so CFG's 2T batch splits into
        # [cond, uncond] sequences (model_base.py SVD_img2vid num_video_frames)
        unet = VideoUNetModel(unet.config, num_frames=b)
    # model patches (FreeU, HyperTile, hypernetworks, SAG, PerpNeg,
    # DifferentialDiffusion) -> hook points and denoiser options
    patch_hooks, patch_opts = model_patch_options(model, unet, sigmas, ms)
    linear_cfg_min = patch_opts.pop("linear_cfg_min", None)
    mode = getattr(ms, "timestep_mode", "")
    if mode == "edm":
        # EDM models (SVD) take 0.25 * log(sigma) as the UNet's timestep
        patch_opts["t_fn"] = lambda s: 0.25 * torch.log(torch.clamp(s, min=1e-10))
    elif mode == "cascade":
        # Stable Cascade: the continuous cosine t (StableCascadeSampling.timestep)
        cs, init = float(ms.cosine_s), float(ms._init_alpha)

        def cascade_t(s):
            var = torch.clamp(1.0 / (s * s + 1.0), 0.0, 1.0)
            return (torch.arccos(torch.sqrt(var * init)) / (math.pi * 0.5)) * (1 + cs) - cs

        patch_opts["t_fn"] = cascade_t
    hooks = (corresponder.attn_hooks(None, generator=_generator(ctx, seed))
             if use_corr else AttnHooks())
    hooks = hooks._replace(
        pre_all=patch_hooks.pre_all, pre_cross=patch_hooks.pre_cross,
        attn_all=patch_hooks.attn_all, out_block=patch_hooks.out_block,
        in_block=patch_hooks.in_block, in_block_after=patch_hooks.in_block_after)
    gligen_spec = positive.get("gligen")
    if gligen_spec is not None:
        # grounded boxes -> the fusers' mid hook by transformer index
        # (models/gligen.py); the plain CFG path applies it to positive rows
        _, gl_model, gl_pos = gligen_spec
        objs = gl_model.grounding_tokens(b, gl_pos, (lh, lw))
        hooks = hooks._replace(mid=gl_model.make_mid_hook(objs))
    step_cb = (corresponder.make_step_callback(id_maps, log_sigmas, normal_maps)
               if use_corr else None)
    if use_progress:
        from stable_renderer_tpu_torch.models.sampling.preview import progress_step_callback

        def _sink(s, t, img):
            if holder[0] is not None:
                holder[0](s, t, img)

        step_cb = progress_step_callback(_sink, int(sigmas.shape[0]) - 1, inner=step_cb)
    uncond = None if cfg_scale == 1.0 else ctx_neg

    scene_sc = scene_smasks = None
    if use_scene:
        from stable_renderer_tpu_torch.models.sampling.scene_cond import sprite_masks

        scene_sc = scene_ctx[:, None].expand(
            (scene_ctx.shape[0], b) + tuple(scene_ctx.shape[1:]))
        scene_smasks = sprite_masks(id_maps, sprite_ids, lh, lw)
    concat_latent = None
    gap = getattr(unet.config, "in_channels", latent.shape[-1]) - latent.shape[-1]
    if gap > 0:
        def fit_batch(z):
            z = _on(ctx, z)
            return z[:1].expand((b,) + tuple(z.shape[1:])) if z.shape[0] != b else z

        if concat_zm is not None and concat_zm.shape[-1] == gap:
            # image-concat models: the negative cond concats its own image
            cc = fit_batch(concat_zm)
            concat_latent = (cc, fit_batch(neg_concat)) if neg_concat is not None else cc
        elif concat_zm is not None:
            # 9-channel inpaint checkpoint: [mask, masked latent]
            mask_ch = (noise_mask if noise_mask is not None
                       else torch.ones(latent.shape[:3] + (1,), dtype=latent.dtype, device=dev))
            concat_latent = torch.cat([mask_ch.to(latent.dtype), fit_batch(concat_zm)], -1)
        else:
            concat_latent = inpaint_concat_channels(latent, noise_mask)
    cfg_eff = cfg_scale
    if linear_cfg_min is not None:
        # VideoLinearCFGGuidance: per-frame cfg ramp min_cfg -> cfg
        cfg_eff = torch.linspace(linear_cfg_min, cfg_scale, b, device=dev).reshape(-1, 1, 1, 1)
    den = build_denoiser(
        unet, model["params"],
        cond_context=ctx_pos,
        scene_contexts=scene_sc,
        scene_masks=scene_smasks,
        cond_contexts=None if use_scene or not use_conds else cond_ctxs,
        cond_specs=specs,
        cond_masks=None if use_scene or not use_conds else cond_masks,
        uncond_context=uncond,
        log_sigmas=log_sigmas,
        cfg_scale=cfg_eff,
        prediction=ms.prediction,
        hooks=hooks,
        control_fn=_control_fn(controls, hints) if controls else None,
        inpaint_mask=noise_mask,
        inpaint_latent=None if noise_mask is None else latent,
        concat_latent=concat_latent,
        y_cond=None if y_pos is None else _on(ctx, y_pos)[:1].expand(b, y_pos.shape[-1]),
        y_uncond=None if y_neg is None else _on(ctx, y_neg)[:1].expand(b, y_neg.shape[-1]),
        model_extra_cond=None if cascade_prior is None else {
            "effnet": _on(ctx, cascade_prior)[:1].expand((b,) + tuple(cascade_prior.shape[1:]))},
        **patch_opts,
    )
    out = sample(den, noise, sigmas, latent_image=latent, sampler=sampler_name,
                 generator=_generator(ctx, seed), step_callback=step_cb)
    return ({"samples": out},)


@register_node("VAEEncode")
def vae_encode(ctx: InferenceContext, node: WorkflowNode, pixels=None, vae=None):
    dtype = vae["params"]["quant_conv"]["weight"].dtype
    z = vae["vae"].encode(vae["params"], (_on(ctx, pixels) * 2.0 - 1.0).to(dtype))
    return ({"samples": z.float()},)


@register_node("VAEDecode")
def vae_decode(ctx: InferenceContext, node: WorkflowNode, samples=None, vae=None, callback=None):
    dtype = vae["params"]["quant_conv"]["weight"].dtype
    z = samples["samples"] if isinstance(samples, dict) else samples
    img = vae["vae"].decode(vae["params"], _on(ctx, z).to(dtype)).float()
    img = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)
    # VAE-decode callback = corresponder.finished (reference nodes.py:287-302)
    corr = callback if callback is not None else ctx.corresponder
    if corr is not None and hasattr(corr, "finished") and ctx.engine_data is not None:
        corr.finished(ctx.engine_data, img)
    return (img,)


@register_node("InferenceOutput", "InferenceOutputNode")
def inference_output(ctx: InferenceContext, node: WorkflowNode, **kw):
    for v in kw.values():
        if v is not None:
            ctx.final_output = v
            break
    return (ctx.final_output,)


@register_node("Note", "Reroute")
def passthrough(ctx: InferenceContext, node: WorkflowNode, **kw):
    return tuple(kw.values()) or (None,)


# --- logic / IO nodes (stable_rendering/_nodes/logic.py, comfyUI nodes) -----


@register_node("IsNotNone", "IsNotNoneNode")
def is_not_none(ctx: InferenceContext, node: WorkflowNode, **kw):
    return (next(iter(kw.values()), None) is not None,)


@register_node("If", "IfNode", "IfValTypeEqual")
def if_node(ctx: InferenceContext, node: WorkflowNode, **kw):
    """Logic branch (logic.py If/IfNode). Branch inputs are declared Lazy, so
    only the taken branch's subgraph executes (types/basic.py:1026-1133)."""
    from stable_renderer_tpu_torch.workflow.validation import resolve

    cond = resolve(kw.get("condition", kw.get("val", None)))
    true_val = kw.get("true_value", kw.get("if_true"))
    false_val = kw.get("false_value", kw.get("if_false"))
    if node.type == "IfValTypeEqual":
        type_name = str(node.widgets[0]) if node.widgets else ""
        cond = type(cond).__name__.lower() == type_name.lower()
    return (resolve(true_val if cond else false_val),)


@register_node("LoadImage")
def load_image(ctx: InferenceContext, node: WorkflowNode):
    """-> (IMAGE rgb, MASK = 1 - alpha), read on the host."""
    name = str(node.widgets[0]) if node.widgets else ""
    path = _find_model_file(ctx, name)
    if path is None:
        logger.warning(f"LoadImage: '{name}' not found; returning blank 64x64")
        return (torch.zeros((1, 64, 64, 3), device=ctx.device),
                torch.ones((1, 64, 64), device=ctx.device))
    from PIL import Image

    rgba = np.asarray(Image.open(path).convert("RGBA"), np.float32) / 255.0
    return _on(ctx, rgba[None, ..., :3]), _on(ctx, 1.0 - rgba[None, ..., 3])


@register_node("FrameData")
def frame_data(ctx: InferenceContext, node: WorkflowNode):
    """Legacy alias of the EngineData node (older reference workflows)."""
    return engine_data_node(ctx, node)


# --- common builtin nodes (comfyUI/nodes.py) --------------------------------


@register_node("EmptyLatentImage")
def empty_latent_image(ctx: InferenceContext, node: WorkflowNode):
    w = node.widgets
    width = int(w[0]) if w else 512
    height = int(w[1]) if len(w) > 1 else 512
    batch = int(w[2]) if len(w) > 2 else 1
    return ({"samples": torch.zeros((batch, height // 8, width // 8, 4), device=ctx.device)},)


@register_node("LatentUpscale", "LatentUpscaleBy")
def latent_upscale(ctx: InferenceContext, node: WorkflowNode, samples=None):
    z = samples["samples"]
    if node.type == "LatentUpscaleBy":
        scale = float(node.widgets[1]) if len(node.widgets) > 1 else 1.5
        h, w = int(z.shape[1] * scale), int(z.shape[2] * scale)
    else:
        w = int(node.widgets[1]) // 8 if len(node.widgets) > 1 else z.shape[2]
        h = int(node.widgets[2]) // 8 if len(node.widgets) > 2 else z.shape[1]
    return ({"samples": resize_nearest(z, h, w)},)


@register_node("ImageScale", "ImageScaleBy")
def image_scale(ctx: InferenceContext, node: WorkflowNode, image=None):
    if node.type == "ImageScaleBy":
        scale = float(node.widgets[1]) if len(node.widgets) > 1 else 2.0
        h, w = int(image.shape[1] * scale), int(image.shape[2] * scale)
    else:
        w = int(node.widgets[1]) if len(node.widgets) > 1 else image.shape[2]
        h = int(node.widgets[2]) if len(node.widgets) > 2 else image.shape[1]
    return (resize_nearest(image, h, w),)


@register_node("SaveImage", "PreviewImage")
def save_image(ctx: InferenceContext, node: WorkflowNode, images=None, **kw):
    from stable_renderer_tpu_torch.utils.media import write_png_sequence
    from stable_renderer_tpu_torch.utils.paths import OUTPUT_DIR

    if images is not None:
        paths = write_png_sequence(images.detach().float().cpu().numpy(),
                                   OUTPUT_DIR / "workflow")
        ctx.status_messages.append(f"saved {len(paths)} images")
        if ctx.final_output is None:
            ctx.final_output = images
    return (images,)


@register_node("CLIPSetLastLayer")
def clip_set_last_layer(ctx: InferenceContext, node: WorkflowNode, clip=None):
    skip = int(node.widgets[0]) if node.widgets else -1
    return ({**clip, "clip_skip": skip},)


@register_node("ConditioningCombine")
def conditioning_combine(ctx: InferenceContext, node: WorkflowNode,
                         conditioning_1=None, conditioning_2=None):
    """comfy ConditioningCombine returns the cond LIST [a, b]; here the second
    cond rides along as extra_conds and the sampler blends all entries with
    the calc_cond_uncond_batch semantics (conds.py)."""
    a, b = conditioning_1, conditioning_2
    return ({
        **a,
        "extra_conds": list(a.get("extra_conds", [])) + [b] + list(b.get("extra_conds", [])),
        "controls": list(a.get("controls", [])) + list(b.get("controls", [])),
        "prompt": f"{a.get('prompt', '')}, {b.get('prompt', '')}",
    },)


@register_node("ConditioningConcat")
def conditioning_concat(ctx: InferenceContext, node: WorkflowNode,
                        conditioning_to=None, conditioning_from=None):
    """nodes.py ConditioningConcat: concatenate along the token axis."""
    a, b = conditioning_to, conditioning_from
    return ({**a, "context": torch.cat([a["context"], b["context"]], 1),
             "prompt": f"{a.get('prompt', '')} {b.get('prompt', '')}"},)


@register_node("MaskedTextEncode")
def masked_text_encode(ctx: InferenceContext, node: WorkflowNode, clip=None,
                       text=None, mask=None):
    """Per-mask conditioning (stable_rendering conditions.py MaskedTextEncode):
    the mask rides the cond into KSampler's cond blending."""
    prompt = text if text is not None else (str(node.widgets[0]) if node.widgets else "")
    cond = _encode_weighted(clip, [prompt], ctx.device)
    return ({"context": cond, "controls": [], "prompt": prompt, "mask": mask},)


# --- comfy_extras: post-processing + mask node packs ------------------------


def _gaussian_kernel(kernel_size: int, sigma: float) -> np.ndarray:
    x = np.arange(kernel_size) - kernel_size // 2
    g = np.exp(-(x ** 2) / (2 * sigma * sigma))
    k = np.outer(g, g)
    return k / k.sum()


def _depthwise(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Apply a (k, k) numpy kernel per channel with reflect padding, NHWC."""
    c, k = img.shape[-1], kernel.shape[0]
    pad = k // 2
    x = F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    w = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)[None, None]
    return F.conv2d(x, w.expand(c, 1, k, k), groups=c).permute(0, 2, 3, 1)


@register_node("ImageBlur")
def image_blur(ctx: InferenceContext, node: WorkflowNode, image=None):
    """Gaussian blur (comfy_extras nodes_post_processing Blur:101-115)."""
    w = node.widgets
    radius = int(w[0]) if w else 1
    sigma = float(w[1]) if len(w) > 1 else 1.0
    if radius == 0:
        return (image,)
    return (_depthwise(image, _gaussian_kernel(radius * 2 + 1, sigma)),)


@register_node("ImageSharpen")
def image_sharpen(ctx: InferenceContext, node: WorkflowNode, image=None):
    """Unsharp sharpen (nodes_post_processing Sharpen:223-240)."""
    w = node.widgets
    radius = int(w[0]) if w else 1
    sigma = float(w[1]) if len(w) > 1 else 1.0
    alpha = float(w[2]) if len(w) > 2 else 1.0
    if radius == 0:
        return (image,)
    k = _gaussian_kernel(radius * 2 + 1, sigma) * -(alpha * 10.0)
    k[radius, radius] = k[radius, radius] - k.sum() + 1.0
    return (torch.clamp(_depthwise(image, k), 0.0, 1.0),)


@register_node("ImageQuantize")
def image_quantize(ctx: InferenceContext, node: WorkflowNode, image=None):
    """Posterize to N levels (nodes_post_processing Quantize, no dither)."""
    colors = int(node.widgets[0]) if node.widgets else 256
    q = torch.round(image * (colors - 1)) / max(colors - 1, 1)
    return (torch.clamp(q, 0.0, 1.0),)


@register_node("MaskToImage")
def mask_to_image(ctx: InferenceContext, node: WorkflowNode, mask=None):
    m = mask if mask.dim() == 3 else mask[None]
    return (m[..., None].repeat(1, 1, 1, 3),)


@register_node("ImageToMask")
def image_to_mask(ctx: InferenceContext, node: WorkflowNode, image=None):
    channel = str(node.widgets[0]) if node.widgets else "red"
    idx = {"red": 0, "green": 1, "blue": 2, "alpha": 3}.get(channel, 0)
    return (image[..., min(idx, image.shape[-1] - 1)],)


@register_node("InvertMask")
def invert_mask(ctx: InferenceContext, node: WorkflowNode, mask=None):
    return (1.0 - mask,)


@register_node("ThresholdMask")
def threshold_mask(ctx: InferenceContext, node: WorkflowNode, mask=None):
    value = float(node.widgets[0]) if node.widgets else 0.5
    return ((mask > value).to(mask.dtype),)


@register_node("FeatherMask")
def feather_mask(ctx: InferenceContext, node: WorkflowNode, mask=None):
    """Edge feathering (nodes_mask.py FeatherMask:264-307)."""
    w = node.widgets
    left = int(w[0]) if w else 0
    top = int(w[1]) if len(w) > 1 else 0
    right = int(w[2]) if len(w) > 2 else 0
    bottom = int(w[3]) if len(w) > 3 else 0
    m = mask if mask.dim() == 3 else mask[None]
    h, wd = m.shape[-2], m.shape[-1]

    def ramp(n: int, edge: int, flip: bool) -> torch.Tensor:
        if not edge:
            return torch.ones(n, device=m.device)
        r = torch.arange(n, device=m.device, dtype=torch.float32)
        r = r.flip(0) if flip else r
        return torch.clamp((r + 1) / max(edge, 1), max=1.0)

    return (m * ramp(wd, left, False)[None, None] * ramp(wd, right, True)[None, None]
            * ramp(h, top, False)[None, :, None] * ramp(h, bottom, True)[None, :, None],)


@register_node("GrowMask")
def grow_mask(ctx: InferenceContext, node: WorkflowNode, mask=None):
    """Iterated 3x3 dilation/erosion (nodes_mask.py GrowMask:309-344)."""
    w = node.widgets
    expand = int(w[0]) if w else 0
    tapered = bool(w[1]) if len(w) > 1 else True
    m = mask if mask.dim() == 3 else mask[None]
    c = 0.0 if tapered else 1.0
    foot = [[c, 1, c], [1, 1, 1], [c, 1, c]]

    def dilate(x):
        xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
        windows = [torch.roll(xp, (-i + 1, -j + 1), dims=(1, 2))[:, 1:-1, 1:-1]
                   + (0.0 if foot[i][j] > 0 else float("-inf"))
                   for i in range(3) for j in range(3)]
        return torch.stack(windows, 0).amax(0)

    out = m
    for _ in range(abs(expand)):
        out = dilate(out) if expand > 0 else -dilate(-out)
    return (torch.clamp(out, 0.0, 1.0),)


@register_node("LatentAdd", "LatentSubtract", "LatentMultiply")
def latent_arith(ctx: InferenceContext, node: WorkflowNode,
                 samples1=None, samples2=None, samples=None):
    """Latent arithmetic (comfy_extras nodes_latent.py)."""
    a = (samples1 or samples)["samples"]
    if node.type == "LatentMultiply":
        out = a * (float(node.widgets[0]) if node.widgets else 1.0)
    else:
        b_ = samples2["samples"]
        out = a + b_ if node.type == "LatentAdd" else a - b_
    res = dict(samples1 or samples)
    res["samples"] = out
    return (res,)


@register_node("ImagePadForOutpaint")
def image_pad_for_outpaint(ctx: InferenceContext, node: WorkflowNode, image=None):
    """Pad an image for outpainting, returning the hole mask with feathered
    interior edges (nodes.py ImagePadForOutpaint:1855-1900)."""
    w = node.widgets
    left = int(w[0]) if w else 0
    top = int(w[1]) if len(w) > 1 else 0
    right = int(w[2]) if len(w) > 2 else 0
    bottom = int(w[3]) if len(w) > 3 else 0
    feather = int(w[4]) if len(w) > 4 else 0
    b, h, wd, c = image.shape
    new = torch.full((b, h + top + bottom, wd + left + right, c), 0.5, dtype=image.dtype,
                     device=image.device)
    new[:, top: top + h, left: left + wd] = image
    # interior: 0 = keep; feathered ramp toward padded edges (ref t matrix)
    t = np.zeros((h, wd), np.float32)
    if feather > 0 and feather * 2 < h and feather * 2 < wd:
        ii = np.arange(h)[:, None]
        jj = np.arange(wd)[None, :]
        dt = ii if top != 0 else np.full_like(ii, h)
        db = (h - ii) if bottom != 0 else np.full_like(ii, h)
        dl = jj if left != 0 else np.full_like(jj, wd)
        dr = (wd - jj) if right != 0 else np.full_like(jj, wd)
        d = np.minimum(np.minimum(dt, db), np.minimum(dl, dr))
        t = np.where(d < feather, (1.0 - d / feather) ** 2, 0.0).astype(np.float32)
    mask = torch.ones((h + top + bottom, wd + left + right), device=image.device)
    mask[top: top + h, left: left + wd] = torch.as_tensor(t, device=image.device)
    return new, mask[None]


@register_node("ConditioningZeroOut")
def conditioning_zero_out(ctx: InferenceContext, node: WorkflowNode, conditioning=None):
    """Zero the conditioning tensors (nodes.py ConditioningZeroOut)."""
    cond = dict(conditioning)
    cond["context"] = torch.zeros_like(conditioning["context"])
    if cond.get("pooled") is not None:
        cond["pooled"] = torch.zeros_like(cond["pooled"])
    return (cond,)


# --- image conditioning: GLIGEN, the CLIP vision tower, unCLIP --------------------


@register_node("GLIGENLoader")
def gligen_loader(ctx: InferenceContext, node: WorkflowNode):
    """A GLIGEN checkpoint (nodes.py GLIGENLoader; gligen.py load_gligen)."""
    from stable_renderer_tpu_torch.models.gligen import load_gligen
    from stable_renderer_tpu_torch.models.weights import load_state_dict

    name = str(node.widgets[0]) if node.widgets else ""
    path = _find_model_file(ctx, name)
    if path is None:
        raise FileNotFoundError(f"gligen checkpoint '{name}' not found")
    return (load_gligen(load_state_dict(path), device=ctx.device),)


@register_node("GLIGENTextBoxApply")
def gligen_textbox_apply(ctx: InferenceContext, node: WorkflowNode, conditioning_to=None,
                         conditioning=None, clip=None, gligen_textbox_model=None):
    """Ground a phrase to a box (nodes.py GLIGENTextBoxApply): appends
    (pooled phrase, h/8, w/8, y/8, x/8) to the cond's gligen position params,
    read by the KSampler's mid hook. The pooled phrase is the mean of the
    encoded chunk over its tokens, as the JAX package takes it."""
    w = node.widgets
    text = str(w[0]) if w else ""
    bw = int(w[1]) if len(w) > 1 else 64
    bh = int(w[2]) if len(w) > 2 else 64
    bx = int(w[3]) if len(w) > 3 else 0
    by = int(w[4]) if len(w) > 4 else 0
    cond = conditioning_to or conditioning or {}
    pooled = _encode_weighted(clip, [text], ctx.device)[0].mean(0)
    prev = cond.get("gligen")
    params = list(prev[2]) if prev else []
    params.append((pooled, bh // 8, bw // 8, by // 8, bx // 8))
    return ({**cond, "gligen": ("position", gligen_textbox_model, params)},)


@register_node("CLIPVisionLoader")
def clip_vision_loader(ctx: InferenceContext, node: WorkflowNode):
    """A CLIP vision checkpoint (nodes.py CLIPVisionLoader; clip_vision.py
    load), the file's dtypes kept."""
    from stable_renderer_tpu_torch.models.clip_vision import load_clip_vision

    name = str(node.widgets[0]) if node.widgets else ""
    path = _find_model_file(ctx, name)
    if path is None:
        raise FileNotFoundError(f"clip vision checkpoint '{name}' not found")
    model, params = load_clip_vision(path, device=ctx.device)
    return ({"model": model, "params": params},)


@register_node("CLIPVisionEncode")
def clip_vision_encode(ctx: InferenceContext, node: WorkflowNode, clip_vision=None,
                       image=None):
    """Image -> the CLIP vision output (nodes.py CLIPVisionEncode;
    clip_vision.py:71-80 encode_image), a dict of its three tensors."""
    out = clip_vision["model"].encode_image(clip_vision["params"], _on(ctx, image))
    return ({"last_hidden_state": out.last_hidden_state,
             "penultimate_hidden_states": out.penultimate_hidden_states,
             "image_embeds": out.image_embeds},)


@register_node("unCLIPConditioning")
def unclip_conditioning(ctx: InferenceContext, node: WorkflowNode, conditioning=None,
                        clip_vision_output=None):
    """Attach image-embed guidance to a conditioning (nodes.py
    unCLIPConditioning): an {embeds, strength, noise_augmentation} entry,
    which the KSampler folds into an unCLIP model's ADM vector."""
    w = node.widgets
    entry = {"embeds": clip_vision_output["image_embeds"],
             "strength": float(w[0]) if w else 1.0,
             "noise_augmentation": float(w[1]) if len(w) > 1 else 0.0}
    cond = conditioning or {}
    return ({**cond, "unclip": list(cond.get("unclip", [])) + [entry]},)


@register_node("ImageUpscaleWithModel")
def image_upscale_with_model(ctx: InferenceContext, node: WorkflowNode, upscale_model=None,
                             image=None):
    """Apply an UPSCALE_MODEL to the IMAGE as the JAX package's node does: the
    whole image at once, no [-1, 1] mapping, in the image's dtype."""
    net, params = upscale_model
    return (net.apply(params, _on(ctx, image)),)


@register_node("UpscaleModelLoader")
def upscale_model_loader(ctx: InferenceContext, node: WorkflowNode):
    """The architecture-sniffing zoo loader (``models.upscale.
    load_upscale_model``) on the context's device. Without the file, as the
    JAX package's node: a warning and the tiny RRDBNet, drawn from a
    generator seeded 0 (JAX draws it from PRNGKey(0))."""
    from stable_renderer_tpu_torch.models.upscale import (
        TINY_RRDB_CONFIG,
        RRDBNet,
        load_upscale_model,
    )

    name = str(node.widgets[0]) if node.widgets else ""
    path = _find_model_file(ctx, name)
    if path:
        return (load_upscale_model(path, device=ctx.device),)
    logger.warning(f"upscale model '{name}' not found; random tiny RRDBNet")
    net = RRDBNet(TINY_RRDB_CONFIG)
    return ((net, net.init(_generator(ctx, 0))),)


# the node packs register themselves on import (at the module's end: they
# import register_node from here)
from stable_renderer_tpu_torch.workflow import nodes_extra as _nodes_extra  # noqa: E402,F401
from stable_renderer_tpu_torch.workflow import nodes_parity as _nodes_parity  # noqa: E402,F401
from stable_renderer_tpu_torch.workflow import nodes_sr as _nodes_sr  # noqa: E402,F401
