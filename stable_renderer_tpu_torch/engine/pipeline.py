"""DiffusionPipeline — the img2img render program.

Counterpart of stable_renderer_tpu/engine/pipeline.py (reference: the ComfyUI
executor round trip, diffusionManager.py:289-352 -> execution.py). One call
runs CLIP conditioning (cached per prompt) -> VAE encode -> CFG denoise over
the UNet with the corresponder's hooks -> VAE decode. ``_render`` is the
counterpart of the JAX package's jitted ``_jit_render``: PyTorch runs it
eagerly, with model params passed in as arguments. ``_render_stream`` is the
counterpart of ``_jit_render_stream``, the StreamDiffusion-style program
(S = steps frames in flight, one batched UNet evaluation an engine frame,
lag-1 K/V correspondence).

Ported so far: SD1.x, SD2 (768-v and eps, 9-channel inpaint UNets included),
SDXL and its refiner from a checkpoint (``from_checkpoint``: an ldm file, or a
diffusers folder of the SD1.x family, with LoRAs merged), SD1.5 and SDXL from
random weights, the dual-tower text conditioning and the ADM vectors of SDXL
and the refiner, plain and per-sprite scene conditioning with textual
inversion, every sampler and scheduler of the JAX package, the sequential and
stream programs, ControlNets, control-LoRAs and T2I-Adapters
(``add_controlnet``, ``add_random_controlnet``, ``add_control_lora``,
``add_t2i_adapter``, ``add_control_from_state_dict``), the calibrated int8
conv path (``quantize_convs``), the TAESD autoencoder for realtime frames
(``with_taesd``, ``RenderConfig.realtime_taesd``) and per-vertex starting
noise (``RenderConfig.vertex_noise`` without noise maps). SVD's video UNet
and Stable Cascade run through the workflow executor's nodes, as in the JAX
package (``models/video_unet.py``, ``models/cascade.py``). The pipeline's
tensors live on the card unless ``device`` names another device.

Many cards (one process a card, parallel/): ``render(mesh=...)`` splits the
frame batch over the mesh's dp ranks and, with a tp axis of more than one
rank, the UNet's and ControlNets' attention and MLP over its tp ranks
(``compute_params(mesh)``); ``enable_stream_mesh`` splits the stream's
in-flight stages over dp in the same way. A one-rank mesh computes what no
mesh computes.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

from stable_renderer_tpu_torch.data.engine_data import EngineData
from stable_renderer_tpu_torch.device import keep_f32, resolve_device, to_device
from stable_renderer_tpu_torch.models.clip import (
    SD2_CLIP_H_CONFIG,
    SD15_CLIP_CONFIG,
    SDXL_CLIP_G_CONFIG,
    TINY_CLIP_CONFIG,
    TINY_CLIP_G_CONFIG,
    CLIPTextModel,
    OpenCLIPTextModel,
    SD2ClipH,
    Tokenizer,
    encode_token_weights_batch,
    encode_token_weights_batch_g,
    encode_token_weights_batch_xl,
)
from stable_renderer_tpu_torch.models.controlnet import ControlNet, ControlNetConfig
from stable_renderer_tpu_torch.models.sampling import (
    SAMPLER_NAMES,
    ModelSampling,
    calculate_sigmas,
    sample,
)
from stable_renderer_tpu_torch.models.sampling.assemble import (
    build_denoiser,
    inpaint_concat_channels,
)
from stable_renderer_tpu_torch.models.sampling.cfg import make_denoiser, timestep_from_sigma
from stable_renderer_tpu_torch.models.taesd import TAESD
from stable_renderer_tpu_torch.models.sdxl import sdxl_adm_vector, sdxl_refiner_adm_vector
from stable_renderer_tpu_torch.models.unet import (
    SD15_UNET_CONFIG,
    SDXL_UNET_CONFIG,
    TINY_SDXL_UNET_CONFIG,
    TINY_UNET_CONFIG,
    AttnHooks,
    UNetModel,
)
from stable_renderer_tpu_torch.models.vae import (
    SD15_VAE_CONFIG,
    SDXL_VAE_CONFIG,
    TINY_VAE_CONFIG,
    VAE,
)
from stable_renderer_tpu_torch.ops.correspondence import (
    Corresponder,
    default_corresponder,
    vertex_average_injection,
    vertex_noise,
)
from stable_renderer_tpu_torch.ops.math import resize_nearest
from stable_renderer_tpu_torch.parallel.mesh import (
    axis_size,
    dp_context,
    frame_sharding,
    has_axis,
    randn_frames,
    tp_context,
)
from stable_renderer_tpu_torch.parallel.sharding import apply_param_sharding
from stable_renderer_tpu_torch.utils.timer import staged
from stable_renderer_tpu_torch.workflow.config import ControlNetSpec, RenderConfig


@dataclass(eq=False)
class DiffusionPipeline:
    unet: UNetModel
    vae: VAE
    clip: CLIPTextModel
    tokenizer: Tokenizer
    unet_params: dict
    vae_params: dict
    clip_params: dict
    config: RenderConfig = field(default_factory=RenderConfig)
    model_sampling: ModelSampling = field(default_factory=ModelSampling)
    device: Optional[torch.device] = None  # None: the card
    controlnets: List[Tuple[ControlNet, dict, ControlNetSpec]] = field(default_factory=list)
    # TAESD tiny autoencoder for RenderConfig.realtime_taesd frames
    taesd: Optional[TAESD] = None
    taesd_params: Optional[dict] = None
    # SDXL's second text tower (comfy sdxl_clip.py SDXLClipModel); None for
    # SD1.x and SD2. A refiner has it and an empty clip_params (G only)
    clip_g: Optional[OpenCLIPTextModel] = None
    clip_g_params: Optional[dict] = None
    # set by from_checkpoint, as the JAX package sets them: the checkpoint's
    # family ("sd1", "sd2", "sdxl", ...) and the SD2.1-unclip
    # noise-augmentor width (None otherwise)
    model_family: str = "sd1"
    noise_aug_dim: Optional[int] = None
    # from_checkpoint's LoRAs: {"path", "strength", "unet", "te"} with the
    # number of modules each merged into the UNet and the CLIP
    lora_modules_applied: List[dict] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        keep_f32()  # from_random and from_checkpoint construct through here
        self._cond_cache: dict = {}
        self._prep_cond_cache: dict = {}
        self._sigma_cache: Optional[Tuple[tuple, torch.Tensor]] = None
        self._compute_param_cache: dict = {}
        # the stream's mesh (enable_stream_mesh); none: one device
        self.stream_mesh = None
        self.stream_dp_axis, self.stream_tp_axis = "dp", "tp"
        self._stream_version = 0

    def __setattr__(self, name, value) -> None:
        # a new UNet or VAE tree invalidates compute_params' cached shards
        if name in ("unet_params", "vae_params"):
            self._bump_models()
        object.__setattr__(self, name, value)

    def _bump_models(self) -> None:
        """Invalidate compute_params' cache after a change in place to the
        model trees (ControlNet params, quantization)."""
        object.__setattr__(self, "_model_version", getattr(self, "_model_version", 0) + 1)

    @property
    def is_sdxl(self) -> bool:
        """The UNet takes an ADM vector (SDXL, the refiner, SD2.1-unclip)."""
        return self.unet.config.adm_in_channels is not None

    @property
    def _clip_g_only(self) -> bool:
        """The refiner's text path: no CLIP-L tower, G alone encodes
        (comfy sdxl_clip.py SDXLRefinerClipModel)."""
        return self.clip_g is not None and not self.clip_params

    # --- constructors --------------------------------------------------------

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        config: Optional[RenderConfig] = None,
        dtype: torch.dtype = torch.bfloat16,
        loras: Sequence[Tuple[str, float]] = (),
        device=None,
    ) -> "DiffusionPipeline":
        """A checkpoint (an ldm ``.safetensors`` / ``.ckpt`` file, or a
        diffusers folder of the SD1.x family) with optional LoRAs, e.g. LCM
        (comfy sd.py:592-712 load_checkpoint_guess_config).

        The state dict is read once (a mapped file) and threaded through
        detection, the split into towers and the LoRA merges
        (``loras=[(path, strength)]``: ``lora_unet_`` into the UNet,
        ``lora_te_`` into the CLIP-L tree, in the files' dtypes). The family
        (``weights.detect_model_family``) picks the prediction and the text
        towers, as in the JAX package: SD2, SD2.1-unclip and the x4
        upscaler take ``SD2ClipH`` at ``cond_stage_model.model.`` (the x4
        its betas 1e-4 -> 2e-2); SDXL CLIP-L at ``conditioner.embedders.0``
        and CLIP-G at ``embedders.1``, the refiner CLIP-G alone at
        ``embedders.0``, both with ``SDXL_VAE_CONFIG``. An SD2 or SDXL
        diffusers folder raises, as in the JAX package. The trees then go to
        ``device`` (default: the card; checked before anything is read) in
        the JAX package's types: the UNet in ``dtype``, the VAE and the
        towers in f32. ``config.int8_conv`` quantizes the convs afterwards.
        The merged module counts are kept in ``lora_modules_applied``."""
        from stable_renderer_tpu_torch.models.lora import merge_lora
        from stable_renderer_tpu_torch.models.weights import (
            load_checkpoint_flat,
            load_state_dict,
            nest,
            tree_to,
        )

        device = resolve_device(device)
        is_dir = Path(path).is_dir()
        if is_dir:
            from stable_renderer_tpu_torch.models.diffusers_convert import load_diffusers_folder

            flat = load_diffusers_folder(str(path))
        else:
            flat = load_state_dict(path)
        unet_p, vae_p, clip_p, ucfg, fam = load_checkpoint_flat(flat, str(path))
        applied = []
        for lora_path, strength in loras:
            lora_flat = load_state_dict(lora_path)
            unet_p, n_unet = merge_lora(unet_p, lora_flat, strength, prefix="lora_unet_")
            clip_p, n_te = merge_lora(clip_p, lora_flat, strength, prefix="lora_te_")
            applied.append({"path": str(lora_path), "strength": strength, "unet": n_unet,
                            "te": n_te})
        if is_dir and (ucfg.adm_in_channels is not None or ucfg.context_dim >= 1024):
            raise NotImplementedError(
                "diffusers folders are supported for the SD1.x family; "
                "convert SDXL/SD2 diffusers repos to a single .safetensors")
        config = config or RenderConfig()
        pred = config.prediction or ("lcm" if config.sampler == "lcm" else fam["prediction"])
        if fam["family"] == "sd-x4-upscaler":
            # SD_X4Upscaler's sampling settings (supported_models.py:326)
            ms = ModelSampling(beta_start=0.0001, beta_end=0.02, prediction=pred)
        else:
            ms = ModelSampling(prediction=pred)
        clip = CLIPTextModel(SD15_CLIP_CONFIG)
        vcfg, clip_g, clip_g_p = SD15_VAE_CONFIG, None, None
        if fam["family"] in ("sd2", "sd21-unclip", "sd-x4-upscaler"):
            clip = SD2ClipH(SD2_CLIP_H_CONFIG)
            clip_p = {"model": nest(flat, "cond_stage_model.model.")}
        elif ucfg.adm_in_channels is not None:
            if fam["family"] == "sdxl-refiner":  # CLIP-G alone, at embedders.0
                g_prefix, clip_p = "conditioner.embedders.0.model.", {}
            else:
                g_prefix = "conditioner.embedders.1.model."
                clip_p = nest(flat, "conditioner.embedders.0.transformer.")
            clip_g = OpenCLIPTextModel(SDXL_CLIP_G_CONFIG)
            clip_g_p = tree_to({"model": nest(flat, g_prefix)}, device, torch.float32)
            vcfg = SDXL_VAE_CONFIG
        pipe = cls(
            unet=UNetModel(ucfg), vae=VAE(vcfg), clip=clip, tokenizer=Tokenizer(SD15_CLIP_CONFIG),
            unet_params=tree_to(unet_p, device, dtype),
            vae_params=tree_to(vae_p, device, torch.float32),
            clip_params=tree_to(clip_p, device, torch.float32),
            config=config, model_sampling=ms, device=device, clip_g=clip_g,
            clip_g_params=clip_g_p, model_family=fam["family"],
            noise_aug_dim=fam["noise_aug_dim"], lora_modules_applied=applied,
        )
        if config.int8_conv:
            pipe.quantize_convs()
        return pipe

    @classmethod
    def from_random(
        cls,
        config: Optional[RenderConfig] = None,
        tiny: bool = True,
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
        family: str = "sd15",
        device=None,
    ) -> "DiffusionPipeline":
        """Random-weight pipeline: tiny f32 for tests, full-width bf16 UNet
        and VAE otherwise (the text towers stay f32). ``family="sdxl"``
        builds the SDXL pipeline: the ADM UNet, CLIP-L and CLIP-G (the
        L tower's width is the UNet's context less G's), and
        ``SDXL_VAE_CONFIG`` at full width; any other family SD1.5, as in the
        JAX package. Weights are drawn on ``device`` (default: the card)
        from a generator seeded with ``seed``: UNet, VAE, CLIP-L, then
        CLIP-G. ``config.int8_conv`` quantizes the conv trees
        (``quantize_convs``)."""
        clip_g = None
        if family == "sdxl":
            ucfg = TINY_SDXL_UNET_CONFIG if tiny else SDXL_UNET_CONFIG
            vcfg = TINY_VAE_CONFIG if tiny else SDXL_VAE_CONFIG
            gcfg = TINY_CLIP_G_CONFIG if tiny else SDXL_CLIP_G_CONFIG
            ccfg = replace(TINY_CLIP_CONFIG if tiny else SD15_CLIP_CONFIG,
                           hidden_size=ucfg.context_dim - gcfg.width)
            clip_g = OpenCLIPTextModel(gcfg)
        else:
            ucfg = TINY_UNET_CONFIG if tiny else SD15_UNET_CONFIG
            vcfg = TINY_VAE_CONFIG if tiny else SD15_VAE_CONFIG
            ccfg = TINY_CLIP_CONFIG if tiny else SD15_CLIP_CONFIG
            if ccfg.hidden_size != ucfg.context_dim:
                ccfg = replace(ccfg, hidden_size=ucfg.context_dim)
        if dtype is None:
            dtype = torch.float32 if tiny else torch.bfloat16
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        unet, vae, clip = UNetModel(ucfg), VAE(vcfg), CLIPTextModel(ccfg)
        config = config or RenderConfig()
        ms = ModelSampling(prediction=config.prediction or (
            "lcm" if config.sampler == "lcm" else "eps"))
        pipe = cls(
            unet=unet, vae=vae, clip=clip, tokenizer=Tokenizer(ccfg),
            unet_params=unet.init(gen, dtype=dtype, device=device),
            vae_params=vae.init(gen, dtype=dtype, device=device),
            clip_params=clip.init(gen, dtype=torch.float32, device=device),
            config=config, model_sampling=ms, device=device, clip_g=clip_g,
            clip_g_params=None if clip_g is None else clip_g.init(gen, device=device),
        )
        if config.int8_conv:
            pipe.quantize_convs()
        return pipe

    def with_taesd(self, encoder_path: Optional[str] = None,
                   decoder_path: Optional[str] = None, seed: int = 11) -> "DiffusionPipeline":
        """Attach a TAESD tiny autoencoder for ``RenderConfig.realtime_taesd``
        frames: the official weight files (``encoder_path``,
        ``decoder_path``: taesd .pth / .safetensors, moved to the pipeline's
        device in their own dtype), or without them random f32 weights from a
        generator seeded with ``seed`` on the pipeline's device.

        A config with ``realtime_taesd`` runs TAESD only once it is attached;
        before, both programs run the full VAE, as the JAX package's do."""
        if encoder_path or decoder_path:
            from stable_renderer_tpu_torch.models.weights import tree_to

            params = tree_to(TAESD.load(encoder_path, decoder_path), self.device)
        else:
            params = TAESD().init(torch.Generator(device=self.device).manual_seed(seed),
                                  device=self.device)
        self.taesd, self.taesd_params = TAESD(), params
        return self

    def _use_taesd(self) -> bool:
        return self.config.realtime_taesd and self.taesd is not None

    @staged("vae_encode")
    def _encode(self, vae_params: dict, color: torch.Tensor, vae_dtype) -> torch.Tensor:
        """[0, 1] colour (N, H, W, 3) -> the f32 latent: TAESD takes the
        colour as it is, the VAE takes it in [-1, 1]; both in ``vae_dtype``."""
        if self._use_taesd():
            return self.taesd.encode(self.taesd_params, color.to(vae_dtype)).float()
        return self.vae.encode(vae_params, (color * 2.0 - 1.0).to(vae_dtype)).float()

    @staged("vae_decode")
    def _decode(self, vae_params: dict, latent: torch.Tensor, vae_dtype) -> torch.Tensor:
        """Latent -> f32 pixels in [0, 1] (TAESD's decode clamps itself)."""
        if self._use_taesd():
            return self.taesd.decode(self.taesd_params, latent.to(vae_dtype)).float()
        decoded = self.vae.decode(vae_params, latent.to(vae_dtype)).float()
        return torch.clamp(decoded * 0.5 + 0.5, 0.0, 1.0)

    def quantize_convs(self, render_size: Tuple[int, int] = (512, 512)) -> "DiffusionPipeline":
        """Apply the int8 conv path (models/quant.py) to the UNet and VAE
        trees, as ``RenderConfig(int8_conv=True)`` asks.

        Static per-conv activation scales come from one eager run per model at
        the render resolution: for the UNet, a latent at each of the
        schedule's sigmas (but the last) times the cfg pair of conditionings;
        an ADM UNet takes zero vectors (a class-table UNet class 0);
        for the VAE, a decode of random latents and an ``encode_moments`` of
        random pixels. Convs whose calibrated input is below 32 x 32 pixels
        stay in the float type, as do the first and last convs
        (``quant.DEFAULT_SKIP_RE``). The random inputs come from a generator
        seeded with 7 on the pipeline's device, as the JAX package's key."""
        import numpy as np

        from stable_renderer_tpu_torch.models.quant import calibrate_act_scales, quantize_tree

        dt = torch.bfloat16
        ucfg = self.unet.config
        # calibrate at the render resolution, so the recorded spatial sizes
        # (the min_pixels gate) are what the frame's convs see
        rh, rw = int(render_size[0]), int(render_size[1])
        lh, lw = max(rh // 8, 8), max(rw // 8, 8)
        gen = torch.Generator(device=self.device).manual_seed(7)
        sig = np.asarray(self.scheduler_sigmas())
        s = max(int(sig.shape[0]) - 1, 1)
        b = 2 * s  # cfg pair at every schedule sigma
        x = torch.randn((b, lh, lw, ucfg.in_channels), generator=gen, device=self.device).to(dt)
        t = torch.as_tensor(np.tile(self.model_sampling.timestep(sig[:s]), 2),
                            dtype=torch.float32, device=self.device)
        # the cfg batch is [cond rows | uncond rows]: calibrate the same split
        cp, cn = self.encode_prompts([self.config.prompt], [self.config.negative_prompt])
        ctx = torch.cat([cp[:1].expand((s,) + cp.shape[1:]),
                         cn[:1].expand((s,) + cn.shape[1:])], 0).to(dt)
        y = None
        if ucfg.num_classes is not None:
            y = torch.zeros((b,), dtype=torch.int32, device=self.device)
        elif ucfg.adm_in_channels is not None:
            y = torch.zeros((b, ucfg.adm_in_channels), dtype=dt, device=self.device)
        scales_u = calibrate_act_scales(lambda p, *a: self.unet.apply(p, *a),
                                        self.unet_params, x, t, ctx, y)
        z = torch.randn((1, lh, lw, 4), generator=gen, device=self.device).to(dt)
        px = torch.tanh(torch.randn((1, rh, rw, 3), generator=gen, device=self.device).to(dt))

        def _vae_both(p, z, px):
            return self.vae.decode(p, z), self.vae.encode_moments(p, px)

        scales_v = calibrate_act_scales(_vae_both, self.vae_params, z, px)
        self.unet_params = quantize_tree(self.unet_params, scales_u, min_pixels=32 * 32)
        self.vae_params = quantize_tree(self.vae_params, scales_v, min_pixels=32 * 32)
        return self

    # --- ControlNets ----------------------------------------------------------

    def add_controlnet(self, params: dict, spec: ControlNetSpec) -> None:
        """Chain a ControlNet with ``params`` (the checkpoint tree under
        ``control_model.``, as tensors on the pipeline's device)."""
        cn = ControlNet(ControlNetConfig(unet=self.unet.config))
        self._bump_models()
        self.controlnets.append((cn, params, spec))

    def add_random_controlnet(self, spec: ControlNetSpec, seed: int = 5) -> None:
        """Chain a random ControlNet: ``ControlNet.init`` from a generator
        seeded with ``seed`` on the pipeline's device, in the UNet's param
        type. Its zero convs are zeros, so it adds nothing to the frame."""
        cn = ControlNet(ControlNetConfig(unet=self.unet.config))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dtype = self.unet_params["time_embed"]["0"]["weight"].dtype
        self.controlnets.append((cn, cn.init(gen, dtype=dtype, device=self.device), spec))

    def add_control_lora(self, control_weights: dict, spec: ControlNetSpec) -> None:
        """Chain a control-LoRA (comfy controlnet.py:303): the UNet's trunk
        with the file's low-rank deltas merged and its full tensors
        (``ControlNet.init_control_lora``), on the pipeline's device."""
        cn = ControlNet(ControlNetConfig(unet=self.unet.config))
        self.controlnets.append((cn, cn.init_control_lora(self.unet_params, control_weights),
                                 spec))

    def add_t2i_adapter(self, params: dict, spec: ControlNetSpec, config=None) -> None:
        """Chain a T2I-Adapter with ``params`` (its checkpoint tree, as
        tensors on the pipeline's device) and ``config`` (default: the SD1.x
        adapter)."""
        from stable_renderer_tpu_torch.models.t2i_adapter import T2IAdapter, T2IAdapterConfig

        self.controlnets.append((T2IAdapter(config or T2IAdapterConfig()), params, spec))

    def add_control_from_state_dict(self, flat: dict, spec: ControlNetSpec) -> None:
        """Chain a control checkpoint's flat state dict, its format sniffed as
        comfy load_controlnet / load_t2i_adapter (controlnet.py:360-560) do:
        a ``lora_controlnet`` key makes a control-LoRA; ``adapter.`` or
        ``body.`` keys or ``conv_in.weight`` a T2I-Adapter; anything else a
        ControlNet, its ``control_model.`` prefix stripped. The tensors move
        to the pipeline's device in the file's dtype (the layers cast weights
        to the activations' type, as the JAX package's do)."""
        from stable_renderer_tpu_torch.models.weights import nest, tree_to

        if "lora_controlnet" in flat:
            self.add_control_lora(flat, spec)
            return
        if any(k.startswith(("adapter.", "body.")) or k == "conv_in.weight" for k in flat):
            from stable_renderer_tpu_torch.models.t2i_adapter import load_t2i_adapter

            ad, params = load_t2i_adapter(flat)
            self.controlnets.append((ad, tree_to(params, self.device), spec))
            return
        if any(k.startswith("control_model.") for k in flat):
            flat = {k[len("control_model."):]: v for k, v in flat.items()
                    if k.startswith("control_model.")}
        self.add_controlnet(tree_to(nest(flat, ""), self.device), spec)

    def _make_control_fn(self, hints: tuple, cn_params=None):
        """The per-evaluation control callable: every control's residuals
        (ControlNet: middle and output; T2I-Adapter: input), summed entry by
        entry (chained controls, ControlBase.control_merge), or None without
        controls. ``hints`` is aligned with ``self.controlnets``; each is
        brought to 8x the latent size (the hint tower's factor). A hint does
        not change within a frame, so each control's hint tower (a
        ControlNet's input_hint_block, in the hint's type; an adapter's
        features, in the UNet's) runs once, on the first evaluation, at the
        hint's own batch, and its output is tiled to the cfg batch for every
        evaluation of the frame."""
        if not self.controlnets:
            return None
        total_t = self.model_sampling.num_timesteps
        if cn_params is None:
            cn_params = tuple(p for _, p, _ in self.controlnets)
        guided: dict = {}  # (net index, batch) -> the tiled hint tower output

        def control_fn(x_in, t, ctx):
            total: Optional[dict] = None
            for i, ((cn, _, spec), params, hint) in enumerate(
                    zip(self.controlnets, cn_params, hints)):
                g = guided.get((i, x_in.shape[0]))
                if g is None:
                    want = (x_in.shape[1] * 8, x_in.shape[2] * 8)
                    if tuple(hint.shape[1:3]) != want:
                        hint = resize_nearest(hint, want[0], want[1])
                    reps = x_in.shape[0] // hint.shape[0]
                    if isinstance(cn, ControlNet):
                        g = _tiled(cn.apply_hint(params, hint), reps)
                    else:  # T2I-Adapter: one residual (or None) per input block
                        g = [None if f is None else _tiled(f, reps)
                             for f in cn.apply_hint(params, hint, x_in.dtype)]
                    guided[(i, x_in.shape[0])] = g
                ctl = cn.apply(params, x_in, None, t, ctx, strength=spec.strength,
                               percent_range=(spec.start_percent, spec.end_percent),
                               total_timesteps=total_t, guided_hint=g)
                if total is None:
                    total = dict(ctl)
                    continue
                for k, lst in ctl.items():
                    if k not in total:
                        total[k] = lst
                    else:
                        total[k] = [a if b is None else (b if a is None else a + b)
                                    for a, b in zip(total[k], lst)]
            return total

        return control_fn

    # --- conditioning ---------------------------------------------------------

    def encode_prompts(self, prompts: List[str], negatives: List[str]):
        """Weighted multi-chunk conditioning ((word:1.2) weighting, >75-token
        chunk concat, textual-inversion embeddings). cond and uncond are tokenized together so both pad to
        the same chunk count. Cached by (texts, clip_skip)."""
        ctx_p, ctx_n, _, _ = self._encode_prompts_full(prompts, negatives)
        return ctx_p, ctx_n

    def encode_prompts_xl(self, prompts: List[str], negatives: List[str]):
        """(ctx_p, ctx_n, pooled_p, pooled_n): ``encode_prompts`` and the
        pooled embeddings that feed the ADM vector (CLIP-G's projection for
        SDXL, sdxl_clip.py SDXLClipModel.encode_token_weights)."""
        return self._encode_prompts_full(prompts, negatives)

    def _encode_prompts_full(self, prompts: List[str], negatives: List[str]):
        """The towers by pipeline: CLIP-G alone for the refiner, CLIP-L +
        CLIP-G for SDXL (clip skip -1 read as -2: SDXL conditions on the
        penultimate layer), the one tower otherwise."""
        key = (tuple(prompts), tuple(negatives), self.config.clip_skip)
        hit = self._cond_cache.get(key)
        if hit is not None:
            return hit
        np_b = len(prompts)
        ids, weights, custom = self.tokenizer.tokenize_weighted_batch(
            list(prompts) + list(negatives))
        ids = torch.as_tensor(ids, device=self.device)
        weights = torch.as_tensor(weights, device=self.device)
        custom = None if custom is None else torch.as_tensor(custom, device=self.device)
        skip = self.config.clip_skip
        if self.clip_g is not None and skip == -1:
            skip = -2
        with torch.no_grad():
            if self._clip_g_only:
                ctx, pooled = encode_token_weights_batch_g(self.clip_g, self.clip_g_params, ids,
                                                           weights, clip_skip=skip)
            elif self.clip_g is not None:
                ctx, pooled = encode_token_weights_batch_xl(
                    self.clip, self.clip_g, self.clip_params, self.clip_g_params, ids, weights,
                    custom_embeds=custom, clip_skip=skip)
            else:
                ctx, pooled = encode_token_weights_batch(self.clip, self.clip_params, ids,
                                                         weights, custom_embeds=custom,
                                                         clip_skip=skip)
        result = (ctx[:np_b], ctx[np_b:], pooled[:np_b], pooled[np_b:])
        if len(self._cond_cache) > 32:
            self._cond_cache.clear()
        self._cond_cache[key] = result
        return result

    def scheduler_sigmas(self) -> torch.Tensor:
        """Sigma schedule for the configured (scheduler, steps, denoise), as a
        host f32 tensor."""
        cfg = self.config
        key = (cfg.scheduler, cfg.steps, cfg.denoise)
        if self._sigma_cache is None or self._sigma_cache[0] != key:
            sig = calculate_sigmas(self.model_sampling, cfg.scheduler, cfg.steps, cfg.denoise)
            self._sigma_cache = (key, torch.as_tensor(sig, dtype=torch.float32))
        return self._sigma_cache[1]

    def prepare_conditioning(
        self,
        sprite_infos: dict,
        env_prompts: tuple,
        n: int,
        have_id_maps: bool = True,
        prompts: Optional[List[str]] = None,
        negatives: Optional[List[str]] = None,
        image_size: Optional[Tuple[int, int]] = None,
    ):
        """Host-side prompt assembly + encoding for a frame batch of size n.
        Returns (sprite_ids, ctx, nctx, y_cond, y_uncond). With
        ``scene_conditioning``, two or more prompted sprites and id maps,
        sprite_ids lists those sprites and ctx is (S+1, n, L, D): each
        sprite's prompt, then the environment prompt, with one uncond a frame
        (SceneTextEncode, conditions.py:52-110). Otherwise sprite_ids is ()
        and the sprite prompts and the environment prompt join into one
        prompt, ctx (n, L, D). The ADM vectors (model_base.py encode_adm),
        None for a UNet without one: SDXL's from the pooled embeddings at
        ``image_size`` (default 1024 x 1024) as original and target size,
        the environment prompt's on the scene path; the refiner's with the
        aesthetic scores 6.0 and 2.5; SD2.1-unclip's zeros (no image
        conditioning)."""
        cfg = self.config
        pc_key = (
            tuple(sorted((sid, sp.prompt, sp.negative_prompt) for sid, sp in sprite_infos.items())),
            tuple((p.prompt, p.negative_prompt) for p in env_prompts),
            n, have_id_maps, image_size,
            None if prompts is None else tuple(prompts),
            None if negatives is None else tuple(negatives),
            cfg.prompt, cfg.negative_prompt, cfg.clip_skip, cfg.scene_conditioning,
        )
        hit = self._prep_cond_cache.get(pc_key)
        if hit is not None:
            return hit
        neg = ", ".join(
            [s.negative_prompt for s in sprite_infos.values() if s.negative_prompt]
            + [p.negative_prompt for p in env_prompts if p.negative_prompt]
        ) or cfg.negative_prompt
        if negatives is None:
            negatives = [neg] * n
        sprited = [(sid, sp.prompt) for sid, sp in sprite_infos.items() if sp.prompt]
        env_text = ", ".join([p.prompt for p in env_prompts if p.prompt]) or cfg.prompt
        sprite_ids: tuple = ()
        if prompts is None and cfg.scene_conditioning and len(sprited) >= 2 and have_id_maps:
            sprite_ids = tuple(sid for sid, _ in sprited)
            scene_prompts = [t for _, t in sprited] + [env_text]
            ctx_s, nctx_s, pooled_s, npooled_s = self._encode_prompts_full(
                scene_prompts, [neg] * len(scene_prompts))
            ctx = ctx_s[:, None].expand(ctx_s.shape[0], n, *ctx_s.shape[1:])
            nctx = nctx_s[:1].expand(n, *nctx_s.shape[1:])
            # the scene path's ADM: the environment prompt's pooled embedding
            pooled = pooled_s[-1:].expand(n, pooled_s.shape[-1])
            npooled = npooled_s[:1].expand(n, npooled_s.shape[-1])
        else:
            if prompts is None:
                text = ", ".join([t for _, t in sprited] + ([env_text] if env_text else [])) \
                    or cfg.prompt
                prompts = [text] * n
            ctx, nctx, pooled, npooled = self._encode_prompts_full(prompts, negatives)
        y_cond = y_uncond = None
        if self.model_family == "sd21-unclip":
            # SD21UNCLIP.encode_adm without image conditioning: zeros
            y_cond = y_uncond = torch.zeros((n, self.unet.config.adm_in_channels),
                                            dtype=torch.float32, device=self.device)
        elif self.is_sdxl:
            size = tuple(image_size) if image_size is not None else (1024, 1024)
            if (self.model_family == "sdxl-refiner"
                    or self.unet.config.adm_in_channels == 2560):
                y_cond = sdxl_refiner_adm_vector(pooled, original_size=size, aesthetic_score=6.0)
                y_uncond = sdxl_refiner_adm_vector(npooled, original_size=size,
                                                   aesthetic_score=2.5)
            else:
                y_cond = sdxl_adm_vector(pooled, original_size=size, target_size=size)
                y_uncond = sdxl_adm_vector(npooled, original_size=size, target_size=size)
        result = (sprite_ids, ctx, nctx, y_cond, y_uncond)
        if len(self._prep_cond_cache) > 64:
            self._prep_cond_cache.clear()
        self._prep_cond_cache[pc_key] = result
        return result

    def compute_params(self, mesh=None, tp_axis: str = "tp"):
        """(unet_params, vae_params, cn_params) as fed to the render programs,
        ``cn_params`` aligned with ``self.controlnets``. The JAX package
        builds a TPU (HWIO) view here; the port feeds the checkpoint-layout
        trees as they are. When ``mesh`` has a ``tp_axis`` of more than one
        rank, the UNet and ControlNet trees are this rank's Megatron shards
        (``parallel.sharding.apply_param_sharding``), cached: one live view,
        keyed by the model version (bumped by a new UNet or VAE tree), the
        mesh, the axis and the number of ControlNets."""
        cn_params = tuple(p for _, p, _ in self.controlnets)
        if axis_size(mesh, tp_axis) == 1:
            return self.unet_params, self.vae_params, cn_params
        key = (getattr(self, "_model_version", 0), mesh, tp_axis, len(self.controlnets))
        hit = self._compute_param_cache.get(key)
        if hit is None:
            hit = (apply_param_sharding(self.unet_params, mesh, tp_axis), self.vae_params,
                   tuple(apply_param_sharding(p, mesh, tp_axis) for p in cn_params))
            self._compute_param_cache.clear()  # one live view: the shards hold GBs
            self._compute_param_cache[key] = hit
        return hit

    def _tp_params(self, mesh, tp_axis: str):
        """(unet_params, cn_params) of ``compute_params(mesh, tp_axis)``."""
        u, _, c = self.compute_params(mesh, tp_axis)
        return u, c

    # --- the render program ---------------------------------------------------

    def render(
        self,
        engine_data: EngineData,
        corresponder: Optional[Corresponder] = None,
        key: Optional[torch.Generator] = None,
        prompts: Optional[List[str]] = None,
        negatives: Optional[List[str]] = None,
        mesh=None,
        dp_axis: str = "dp",
        tp_axis: str = "tp",
    ) -> torch.Tensor:
        """EngineData -> decoded frames (N, H, W, 3) in [0, 1]. ``key`` is the
        generator for the sampler's draws (default: seeded with config.seed).

        With ``mesh`` (a DeviceMesh from ``parallel.create_mesh``; every rank
        calls with the whole batch and the same key) each rank of
        ``dp_axis`` renders its block of frames, and every rank returns the
        whole batch, gathered. The couplings across frames are collectives
        over dp: the corresponder's injected K/V rows, vertex averages and
        all-frames attention, and the draws are each rank's rows of the
        whole batch's, so the result is the one-device render's. A
        ``tp_axis`` of more than one rank splits the UNet's and ControlNets'
        heads and MLP over it. The scene contexts (S+1, N, L, D) split on
        their frame axis, the other conditioning and the hints on axis 0."""
        cfg = self.config
        n = engine_data.frame_count
        if key is None:
            key = torch.Generator(device=self.device).manual_seed(cfg.seed)
        sprite_ids, ctx, nctx, y_cond, y_uncond = self.prepare_conditioning(
            engine_data.sprite_infos, engine_data.env_prompts, n,
            have_id_maps=engine_data.id_maps is not None, prompts=prompts, negatives=negatives,
            image_size=tuple(engine_data.color_maps.shape[1:3]),
        )
        corresponder = corresponder or default_corresponder()
        hint_sources = {
            "normal": engine_data.normal_maps, "depth": engine_data.depth_maps,
            "canny": engine_data.canny_maps, "color": engine_data.color_maps,
            "pos": engine_data.pos_maps,
        }
        hints = tuple(hint_sources[spec.source] for _, _, spec in self.controlnets)
        unet_params, vae_params, cn_params = self.compute_params(mesh, tp_axis)
        dp = frame_sharding(mesh, dp_axis)
        take = dp.take
        with tp_context(frame_sharding(mesh, tp_axis)), dp_context(dp):
            images = self._render(
                corresponder, sprite_ids, unet_params, vae_params, cn_params,
                take(engine_data.color_maps), take(engine_data.noise_maps),
                take(engine_data.id_maps), tuple(take(h) for h in hints),
                take(ctx, 1 if ctx.dim() == 4 else 0), take(nctx), self.scheduler_sigmas(), key,
                take(y_cond), take(y_uncond), normal_maps=take(engine_data.normal_maps),
            )
        images = dp.gather(images)
        corresponder.finished(engine_data, images)
        return images

    @torch.no_grad()
    def _render(
        self, corresponder, sprite_ids, unet_params, vae_params, cn_params, color,
        noise_maps, id_maps, hints, ctx, nctx, sigmas, key,
        y_cond=None, y_uncond=None, normal_maps=None, step_noise=None,
    ) -> torch.Tensor:
        """VAE encode -> CFG denoise with the corresponder's hooks -> VAE
        decode, for a frame batch (N, H, W, 3) in [0, 1]. ``key`` is the
        sampler's generator; ``step_noise`` optionally replaces its draws
        (``samplers.sample``). ``hints`` (aligned with ``self.controlnets``)
        feed the ControlNets. With ``sprite_ids``, ctx is the (S+1, N, L, D)
        scene conditioning and each sprite's latent pixels take their own
        prompt (``sprite_masks`` of ``id_maps``); ``keep_background`` then
        applies only through a 9-channel UNet's mask channel, as in the JAX
        package. A UNet with more input channels than the latent (inpaint)
        takes the mask and the masked latent as its extra channels."""
        cfg = self.config
        vae_dtype = vae_params["quant_conv"]["weight"].dtype  # kept out of int8 by the skip list
        latent = self._encode(vae_params, color, vae_dtype)
        lh, lw = latent.shape[1], latent.shape[2]
        if noise_maps is not None:
            noise = noise_maps[..., : latent.shape[-1]]
            if noise.shape[1:3] != (lh, lw):
                # engine noise is pooled by 8 (the SD VAE factor); adapt for
                # VAEs with other factors (the tiny test config)
                from stable_renderer_tpu_torch.ops.math import resize_nearest

                noise = resize_nearest(noise, lh, lw)
        elif id_maps is not None and cfg.vertex_noise:
            noise = vertex_noise(key, id_maps, lh, lw, latent.shape[-1])
        else:
            noise = randn_frames(latent.shape, generator=key, device=latent.device)
        uncond = None if cfg.cfg_scale == 1.0 else nctx
        log_sigmas = torch.as_tensor(self.model_sampling.log_sigmas)
        hooks = corresponder.attn_hooks(None, generator=key)
        step_cb = corresponder.make_step_callback(id_maps, log_sigmas, normal_maps)
        inpaint_mask = inpaint_latent = None
        if cfg.keep_background and id_maps is not None:
            # denoise only AI-object pixels; the background keeps its latent
            from stable_renderer_tpu_torch.ops.correspondence import latent_vertex_ids

            _, valid = latent_vertex_ids(id_maps, lh, lw)
            inpaint_mask = valid.float()[..., None]
            inpaint_latent = latent
        concat_latent = None
        if self.unet.config.in_channels > latent.shape[-1]:
            # 9-channel inpaint UNet: [mask, masked-image latent] as extra inputs
            concat_latent = inpaint_concat_channels(latent, inpaint_mask)
        scene_masks = None
        if sprite_ids:
            from stable_renderer_tpu_torch.models.sampling.scene_cond import sprite_masks

            scene_masks = sprite_masks(id_maps, sprite_ids, lh, lw)
        den = build_denoiser(
            self.unet, unet_params,
            cond_context=None if sprite_ids else ctx,
            scene_contexts=ctx if sprite_ids else None, scene_masks=scene_masks,
            uncond_context=uncond, log_sigmas=log_sigmas, cfg_scale=cfg.cfg_scale,
            prediction=self.model_sampling.prediction, hooks=hooks,
            control_fn=self._make_control_fn(hints, cn_params),
            inpaint_mask=None if sprite_ids else inpaint_mask,
            inpaint_latent=None if sprite_ids else inpaint_latent,
            concat_latent=concat_latent, y_cond=y_cond, y_uncond=y_uncond,
        )
        out_latent = sample(den, noise, sigmas, latent_image=latent, sampler=cfg.sampler,
                            generator=key, step_callback=step_cb, step_noise=step_noise)
        return self._decode(vae_params, out_latent, vae_dtype)

    # --- the stream-pipelined realtime program ----------------------------------

    def enable_stream_mesh(self, mesh, dp_axis: str = "dp",
                           tp_axis: str = "tp") -> "DiffusionPipeline":
        """Multi-card latency mode: the stream's S in-flight stages split
        over ``dp_axis`` of ``mesh`` (a DeviceMesh; None: one device), one
        engine frame then costing each rank S / dp of the UNet batch, and a
        ``tp_axis`` of more than one rank splits the UNet Megatron-style on
        top (``stream_params``). Bumps ``stream_version``. A stream state
        built before holds every stage; the next frame takes its rank's."""
        has_axis(mesh, dp_axis)  # raises for what is not a DeviceMesh
        self.stream_mesh, self.stream_dp_axis, self.stream_tp_axis = mesh, dp_axis, tp_axis
        self._stream_version += 1
        return self

    @property
    def stream_version(self) -> int:
        """A counter bumped by every ``enable_stream_mesh`` call (the JAX
        package keys its compiled stream program on it)."""
        return self._stream_version

    def stream_params(self):
        """(unet_params, cn_params) for the stream program: the trees, or this
        rank's tensor-parallel shards when the stream mesh has a tp axis of
        more than one rank."""
        u, _, c = self.compute_params(self.stream_mesh, self.stream_tp_axis)
        return u, c

    @torch.no_grad()
    def _render_stream(
        self, unet_params, vae_params, color, noise_maps, id_maps, state, sigmas, key, ctx,
        nctx, stream_init: bool = False, kv_state=None, cn_params=None, hints=None,
        corresponder=None, step_noise=None,
    ):
        """StreamDiffusion-style frame pipelining: S = steps frames are in
        flight at different denoise stages, and one engine frame costs one
        batched UNet evaluation (batch 2S with cfg).

        ``state`` holds the (S, h, w, 4) latents, row i at sigma_i, or, when
        ControlNet hints or id maps ride the stream, a dict {"x": latents,
        "hints": per-ControlNet (S, H, W, C) stacks, "ids": (S, H, W, 4)
        stack}, so each in-flight frame keeps its own conditioning. A call
        pushes the new frame's noised latent (and hints and ids) in at stage
        0, advances every stage one step and decodes the completed stage;
        ``stream_init`` fills the S stages with the incoming frame. With
        ``RenderConfig.stream_kv_layers``, the self-attention contexts of the
        positive rows at those transformer indices are captured, and the
        previous frame's stored contexts replace K and V (lag-1 K/V); with a
        corresponder's ``step_finished_inject_ratio`` > 0 the x0 predictions
        are vertex-averaged across the S rows, gated per row by timestep.

        ``key`` is the frame's generator: the initial noise when there are no
        noise maps, then the LCM re-noise draws, which ``step_noise`` of
        shape (S, h, w, 4) replaces. ``lcm`` re-noises each stage; every
        other sampler name takes an Euler step, as in the JAX package. The
        stream takes one conditioning a frame: a scene's (S+1, B, L, D)
        contexts raise (the JAX package's stream fails on them too). Returns
        (image (1, H, W, 3), new state, captured contexts or None).

        With a stream mesh (``enable_stream_mesh``) every rank calls with the
        same frame and generator and holds S / dp stages: rank r stages
        [r S/dp, (r+1) S/dp), the state and the captured contexts its rows.
        Each rank advances its stages (with ``stream_params``' shards under a
        tp axis); the shift hands each rank's last stage (and its hints and
        ids) to the next rank, rank 0 taking the new frame's; the output
        latent is the last rank's last stage, broadcast, so every rank
        decodes the same image; the vertex averages sum over the ranks and
        the LCM draws are each rank's rows of the whole (S, h, w, 4) draw
        (``step_noise`` is that whole draw). dp must divide S."""
        cfg = self.config
        if cfg.sampler not in SAMPLER_NAMES:
            raise ValueError(f"Unknown sampler '{cfg.sampler}' (have {SAMPLER_NAMES})")
        if ctx.dim() != 3:
            raise ValueError("the stream program takes one (B, L, D) conditioning, not per-sprite "
                             f"scene contexts of shape {tuple(ctx.shape)}; render a scene with "
                             "two prompted sprites sequentially or with scene_conditioning=False")
        vae_dtype = vae_params["quant_conv"]["weight"].dtype
        latent = self._encode(vae_params, color, vae_dtype)
        lh, lw = latent.shape[1], latent.shape[2]
        if noise_maps is not None:
            noise = noise_maps[..., : latent.shape[-1]]
            if noise.shape[1:3] != (lh, lw):
                noise = resize_nearest(noise, lh, lw)
        elif id_maps is not None and cfg.vertex_noise:
            noise = vertex_noise(key, id_maps, lh, lw, latent.shape[-1])
        else:
            noise = torch.randn(latent.shape, generator=key, device=latent.device)
        sigmas = torch.as_tensor(sigmas, dtype=torch.float32).cpu()
        s = sigmas.shape[0] - 1  # pipeline depth = steps
        dp = frame_sharding(self.stream_mesh, self.stream_dp_axis)
        rows = dp.rows(s)  # this rank's stages
        s_loc = rows.stop - rows.start
        x_t = latent + noise * sigmas[0]  # (1, h, w, C)
        carry_hints = bool(self.controlnets) and hints is not None
        avg_ratio = float(getattr(corresponder, "step_finished_inject_ratio", 0.0) or 0.0)
        carry_ids = avg_ratio > 0.0 and id_maps is not None
        if stream_init:
            xs = x_t.expand(s_loc, *x_t.shape[1:])
            hint_s = tuple(hh.expand(s_loc, *hh.shape[1:]) for hh in hints) if carry_hints else ()
            ids_s = id_maps.expand(s_loc, *id_maps.shape[1:]) if carry_ids else None
        elif isinstance(state, dict):
            xs, hint_s, ids_s = state["x"], tuple(state.get("hints") or ()), state.get("ids")
        else:
            xs, hint_s, ids_s = state, (), None
        if xs.shape[0] != s_loc:
            if xs.shape[0] != s:
                raise ValueError(f"a stream state of {xs.shape[0]} stages, where this rank holds "
                                 f"{s_loc} of {s}: reset the stream after changing its mesh")
            # built before the mesh: every stage; this rank keeps its own
            xs, hint_s, ids_s = xs[rows], tuple(hh[rows] for hh in hint_s), (
                None if ids_s is None else ids_s[rows])
            kv_state = None if kv_state is None else {k: v[rows] for k, v in kv_state.items()}

        kv_layers = tuple(cfg.stream_kv_layers or ())
        if kv_state is not None and set(kv_state) != {str(layer) for layer in kv_layers}:
            raise ValueError(
                f"stale stream kv_state: carries layers {sorted(kv_state)} but "
                f"RenderConfig.stream_kv_layers expects {sorted(str(x) for x in kv_layers)}; "
                "reset the stream (pass kv_state=None) after changing stream_kv_layers")
        captured: dict = {}
        hooks = AttnHooks()
        if kv_layers:
            def kv_pre(q, k, v, layer):
                if layer not in kv_layers:
                    return q, k, v
                captured[str(layer)] = k
                if kv_state is None:
                    return q, k, v  # first frame: self-reference
                pk = kv_state[str(layer)].to(k.dtype)
                return q, pk, pk

            hooks = AttnHooks(pre=kv_pre)

        uncond = None if cfg.cfg_scale == 1.0 else nctx
        log_sigmas = torch.as_tensor(self.model_sampling.log_sigmas, dtype=torch.float32)
        den = make_denoiser(
            self.unet, unet_params, ctx[:1].expand(s_loc, *ctx.shape[1:]),
            None if uncond is None else uncond[:1].expand(s_loc, *uncond.shape[1:]),
            log_sigmas, cfg_scale=cfg.cfg_scale, prediction=self.model_sampling.prediction,
            hooks=hooks,
            control_fn=self._make_control_fn(hint_s, cn_params) if carry_hints else None,
        )
        # stage i steps sigma_i -> sigma_i+1
        sig_vec, sig_next = sigmas[rows], sigmas[rows.start + 1:rows.stop + 1]
        with tp_context(frame_sharding(self.stream_mesh, self.stream_tp_axis)):
            denoised = den(xs, sig_vec)
        dev = denoised.device
        if carry_ids:
            # vertex averaging over the in-flight rows in x0 space (the rows
            # sit at different sigmas); the per-row timestep gate comes from
            # the host sigmas: no device value is read
            injected = vertex_average_injection(
                denoised, ids_s, avg_ratio,
                num_segments=int(getattr(corresponder, "vertex_segments", 262144)),
                weighting=getattr(corresponder, "weighting", "average"),
                adain_mode=getattr(corresponder, "step_finished_adain", "content"), shard=dp)
            stop_t = float(getattr(corresponder, "step_finished_stop_inject_timestep", 500.0))
            gate = to_device(timestep_from_sigma(log_sigmas, sig_vec) >= stop_t, dev)
            denoised = torch.where(gate[:, None, None, None], injected, denoised)
        sv = to_device(sig_vec, dev)[:, None, None, None]
        sn = to_device(sig_next, dev)[:, None, None, None]
        if cfg.sampler == "lcm":
            if step_noise is not None:
                fresh = dp.take(step_noise).to(device=dev, dtype=denoised.dtype)
            else:
                fresh = dp.randn(denoised.shape, generator=key, device=dev)
            stepped = denoised + sn * fresh
        else:  # every other sampler: an Euler step
            stepped = xs + (xs - denoised) / torch.clamp(sv, min=1e-8) * (sn - sv)
        # the last stage's sigma is a host value: choosing the output is a
        # host branch, not a device sync
        out_latent = dp.broadcast_from_last(
            stepped[-1:] if float(sigmas[s]) > 0 else denoised[-1:])
        # each rank's last stage, with its conditioning rows, moves to the
        # next rank; rank 0 takes the new frame's
        moved = dp.shift([stepped[-1:], *(hh[-1:] for hh in hint_s),
                          *(() if ids_s is None else (ids_s[-1:],))])
        if moved is None:
            x_in, hints_in, ids_in = x_t, hints or (), id_maps
        else:
            x_in, hints_in, ids_in = moved[0], moved[1:1 + len(hint_s)], moved[-1]
        new_state = torch.cat([x_in, stepped[:-1]], 0)
        if carry_hints or carry_ids:
            # each conditioning row shifts with its frame
            new_state = {
                "x": new_state,
                "hints": tuple(torch.cat([new, old[:-1]], 0)
                               for new, old in zip(hints_in, hint_s)),
                "ids": None if ids_s is None else torch.cat([ids_in, ids_s[:-1]], 0),
            }
        image = self._decode(vae_params, out_latent, vae_dtype)
        return image, new_state, (captured if kv_layers else None)


def _tiled(t: torch.Tensor, reps: int) -> torch.Tensor:
    """``t`` repeated ``reps`` times along the batch (itself for one)."""
    return torch.cat([t] * reps, 0) if reps > 1 else t
