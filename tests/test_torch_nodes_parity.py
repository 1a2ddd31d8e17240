"""The port's workflow/nodes_parity.py against the JAX package's, node by
node, on the CPU at tiny widths: one parametrised case (or more) per name.

Each case runs the node in both packages' executors on the same numpy-seeded
inputs, handed in by a ``_Const`` node registered in both registries, and
by ``_Models``, which gives both packages the same tiny (MODEL, CLIP, VAE)
(the port's tiny inits, their numbers copied into the JAX models). Pure
tensor nodes agree within PURE (1e-6); model nodes within
test_torch_executor.py's TOL; loaders on files written here, and the file
round trips (.latent both ways, animated saves), bit for bit. ``_Models``
also hands in tiny dual-tower CLIPs (CLIP-L + CLIP-G, and G alone for the
refiner) for the SDXL encode nodes. The image-conditioning nodes take the
same tiny CLIP vision tower, style adapter and PhotoMaker encoder in both
packages (``vision_pair``, ``style_pair``, ``photomaker_pair``: the port's
inits copied into JAX's) and their loaders files written by
``image_model_files``. The EDM and Stable Cascade schedule nodes keep
their float64-built tables bit for bit, and StableCascade_StageC_VAEEncode
encodes with the tiny VAE. The helpers here serve
tests/test_torch_nodes_extra_rest.py, tests/test_torch_image_conditioning.py
and tests/test_torch_video_graphs.py too.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_executor import TOL, run_both

import stable_renderer_tpu.workflow.executor as je
import stable_renderer_tpu_torch.workflow.executor as pe

torch.set_num_threads(1)

PURE = dict(atol=1e-6, rtol=1e-6)  # tensor work in f32: rounding of the same ops
RNG = np.random.default_rng(15)
F32 = np.float32


def _quantized(shape):
    return (RNG.integers(0, 4, size=shape) * 85 / 255.0).astype(F32)


CONSTS = {
    "image": RNG.uniform(size=(1, 16, 16, 3)).astype(F32),
    "image2": RNG.uniform(size=(1, 12, 20, 3)).astype(F32),
    "image_b2": RNG.uniform(size=(2, 16, 16, 3)).astype(F32),
    "image_q": _quantized((1, 16, 16, 3)),
    "image_96": RNG.uniform(size=(1, 96, 80, 3)).astype(F32),
    "image_128": RNG.uniform(size=(1, 128, 128, 3)).astype(F32),
    "rgba": RNG.uniform(size=(1, 16, 16, 4)).astype(F32),
    "mask": (RNG.uniform(size=(1, 16, 16)) > 0.6).astype(F32),
    "soft_mask": RNG.uniform(size=(1, 16, 16)).astype(F32),
    "mask2d": RNG.uniform(size=(8, 10)).astype(F32),
    "mask_small": RNG.uniform(size=(1, 6, 7)).astype(F32),
    "latent": {"samples": RNG.standard_normal((1, 8, 8, 4)).astype(F32)},
    "latent2": {"samples": RNG.standard_normal((1, 4, 6, 4)).astype(F32)},
    "latent_16": {"samples": RNG.standard_normal((1, 16, 12, 4)).astype(F32)},
    "latent_b3": {"samples": RNG.standard_normal((3, 8, 8, 4)).astype(F32),
                  "noise_mask": RNG.uniform(size=(3, 8, 8)).astype(F32),
                  "batch_index": [4, 5, 6]},
    "latent_b2m": {"samples": RNG.standard_normal((2, 8, 8, 4)).astype(F32),
                   "noise_mask": RNG.uniform(size=(2, 8, 8)).astype(F32)},
    "cond": {"context": RNG.standard_normal((1, 77, 32)).astype(F32), "controls": [],
             "prompt": "p", "pooled": RNG.standard_normal((1, 32)).astype(F32)},
    "cond_short": {"context": RNG.standard_normal((1, 40, 32)).astype(F32),
                   "controls": [], "prompt": "q",
                   "pooled": RNG.standard_normal((1, 32)).astype(F32)},
    "sigmas": np.asarray([14.6, 7.1, 3.2, 1.1, 0.3, 0.0], F32),
}
CONSTS["image_q"][0, 4:9, 3:7] = [0.2, 0.4, 0.6]  # a colour block to pick


class Pair:
    """A value given per package: (JAX's, the port's)."""

    def __init__(self, jax_value, port_value):
        self.values = {je: jax_value, pe: port_value}


def _for(mod, v):
    if isinstance(v, Pair):
        return v.values[mod]
    if isinstance(v, dict):
        return {k: _for(mod, x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_for(mod, x) for x in v)
    if isinstance(v, np.ndarray):
        return jnp.asarray(v) if mod is je else torch.from_numpy(v.copy())
    return v


def jax_config(jcls, pcfg):
    """The JAX config dataclass ``jcls`` with the port config's fields."""
    names = {f.name for f in dataclasses.fields(jcls)}
    return jcls(**{f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)
                   if f.name in names})


def as_jax(tree):
    if isinstance(tree, dict):
        return {k: as_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.float().numpy())


def model_pair(seed: int = 0):
    """The tiny (MODEL, CLIP, VAE) of the port (``tiny_models`` from a
    generator seeded with ``seed``, f32 on the CPU) and the JAX package's
    with the same numbers: a tuple of three Pairs."""
    import stable_renderer_tpu.models as jm
    from stable_renderer_tpu.models.sampling import ModelSampling as JMS

    pm, pc, pv = pe.tiny_models(torch.device("cpu"), torch.Generator().manual_seed(seed))
    jccfg = jax_config(jm.CLIPConfig, pc["clip"].config)
    jmodel = {"unet": jm.UNetModel(jax_config(jm.UNetConfig, pm["unet"].config)),
              "params": as_jax(pm["params"]), "sampling": JMS()}
    jclip = {"clip": jm.CLIPTextModel(jccfg), "params": as_jax(pc["params"]),
             "tokenizer": jm.Tokenizer(jccfg)}
    jvae = {"vae": jm.VAE(jax_config(jm.VAEConfig, pv["vae"].config)),
            "params": as_jax(pv["params"])}
    return Pair(jmodel, pm), Pair(jclip, pc), Pair(jvae, pv)


def dual_clip_pair(g_only: bool, seed: int = 4):
    """A tiny SDXL CLIP of both packages (the port's inits from a generator
    seeded with ``seed``): CLIP-L and DualCLIPLoader's tiny CLIP-G, 64 wide;
    or, ``g_only``, the refiner's G tower alone (empty CLIP-L params)."""
    import stable_renderer_tpu.models as jm
    import stable_renderer_tpu.models.clip as jclip

    from stable_renderer_tpu_torch.models import clip as pclip

    g = torch.Generator().manual_seed(seed)
    lcfg = pclip.TINY_CLIP_CONFIG
    gcfg = pclip.OpenCLIPConfig(vocab_size=1000, width=64, num_layers=2, num_heads=2,
                                projection_dim=64)
    clip_l, clip_g = pclip.CLIPTextModel(lcfg), pclip.OpenCLIPTextModel(gcfg)
    pl, pg = clip_l.init(g), clip_g.init(g)
    port = {"clip": clip_l, "params": {} if g_only else pl, "clip_g": clip_g, "params_g": pg,
            "tokenizer": pclip.Tokenizer(lcfg)}
    jl = jax_config(jm.CLIPConfig, lcfg)
    jax_clip = {"clip": jm.CLIPTextModel(jl), "params": {} if g_only else as_jax(pl),
                "clip_g": jclip.OpenCLIPTextModel(jax_config(jclip.OpenCLIPConfig, gcfg)),
                "params_g": as_jax(pg), "tokenizer": jm.Tokenizer(jl)}
    if g_only:
        port["g_only"] = jax_clip["g_only"] = True
    return Pair(jax_clip, port)


def vision_pair(cfg=None, seed: int = 5):
    """A CLIP vision tower of both packages, {"model", "params"}: the
    port's init of ``cfg`` (default the tiny one) from a generator seeded
    with ``seed``, copied into JAX's."""
    import stable_renderer_tpu.models.clip_vision as jcv

    from stable_renderer_tpu_torch.models import clip_vision as pcv

    cfg = cfg or pcv.TINY_VISION_CONFIG
    m = pcv.CLIPVisionModel(cfg)
    p = m.init(torch.Generator().manual_seed(seed))
    return Pair({"model": jcv.CLIPVisionModel(jax_config(jcv.CLIPVisionConfig, cfg)),
                 "params": as_jax(p)}, {"model": m, "params": p})


def vision_output_pair(seed: int = 6, tokens: int = 5, width: int = 64, proj: int = 32):
    """A VisionOutput of both packages from one numpy draw."""
    import stable_renderer_tpu.models.clip_vision as jcv

    from stable_renderer_tpu_torch.models import clip_vision as pcv

    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(F32) for s in ((1, tokens, width),
                                                          (1, tokens, width), (1, proj))]
    return Pair(jcv.VisionOutput(*map(jnp.asarray, arrs)),
                pcv.VisionOutput(*(torch.from_numpy(a) for a in arrs)))


def style_pair(seed: int = 7, context_dim: int = 32):
    """A tiny style adapter of both packages (width 64, 4 heads, 2 layers, 4
    tokens), the port's init copied into JAX's."""
    import stable_renderer_tpu.models.t2i_adapter as jt2i

    from stable_renderer_tpu_torch.models import t2i_adapter as pt2i

    cfg = pt2i.StyleAdapterConfig(width=64, context_dim=context_dim, num_head=4, n_layers=2,
                                  num_token=4)
    m = pt2i.StyleAdapter(cfg)
    p = m.init(torch.Generator().manual_seed(seed))
    return Pair({"model": jt2i.StyleAdapter(jax_config(jt2i.StyleAdapterConfig, cfg)),
                 "params": as_jax(p)}, {"model": m, "params": p})


def photomaker_pair(proj2: int = 32, seed: int = 8):
    """A tiny PhotoMaker encoder of both packages, {"vision", "params"}."""
    from chip_smoke import photomaker_tree

    import stable_renderer_tpu.models.clip_vision as jcv

    from stable_renderer_tpu_torch.models import clip_vision as pcv

    cfg = pcv.TINY_VISION_CONFIG
    p = photomaker_tree(cfg, proj2, torch.Generator().manual_seed(seed))
    return Pair({"vision": jcv.CLIPVisionModel(jax_config(jcv.CLIPVisionConfig, cfg)),
                 "params": as_jax(p)}, {"vision": pcv.CLIPVisionModel(cfg), "params": p})


@pytest.fixture
def image_model_files(tmp_path, monkeypatch):
    """The image-conditioning loaders' files, in ``tmp_path``: a tiny
    SD2.1-unclip-H checkpoint (chip_smoke.write_family_file's, its vision
    tower ViT-H deep and narrow), a style adapter with the upstream
    ``transformer_layes.`` keys, and a PhotoMaker file (``id_encoder.``, a
    ViT-L-deep narrow tower); both packages' loader configs set to the files'
    (the VAE, the H text tower, ViT-H and ViT-L) and to tiny_sd15's CLIP-L
    (the tokenizer's: the hash tokenizer over the towers' 1000 ids)."""
    import chip_smoke

    import stable_renderer_tpu.models as jmodels
    import stable_renderer_tpu.models.clip as jclip
    import stable_renderer_tpu.models.clip_vision as jcv

    import stable_renderer_tpu_torch.models.clip as pclip
    import stable_renderer_tpu_torch.models.clip_vision as pcv
    import stable_renderer_tpu_torch.models.vae as pvae
    from stable_renderer_tpu_torch.models.t2i_adapter import StyleAdapterConfig
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    h = pclip.OpenCLIPConfig(**chip_smoke.FAMILY_TOWERS["h"])
    vit_h = pcv.CLIPVisionConfig(**chip_smoke.UNCLIP_TINY_VISION)
    vit_l = pcv.CLIPVisionConfig(**chip_smoke.VITL_TINY_VISION)
    monkeypatch.setattr(jmodels, "SD15_VAE_CONFIG", jmodels.TINY_VAE_CONFIG)
    monkeypatch.setattr(pvae, "SD15_VAE_CONFIG", pvae.TINY_VAE_CONFIG)
    monkeypatch.setattr(jmodels, "SD15_CLIP_CONFIG",
                        replace(jmodels.TINY_CLIP_CONFIG, hidden_size=768))
    monkeypatch.setattr(pclip, "SD15_CLIP_CONFIG",
                        replace(pclip.TINY_CLIP_CONFIG, hidden_size=768))
    j_h = jclip.SD2ClipH
    monkeypatch.setattr(jclip, "SD2ClipH", lambda: j_h(jax_config(jclip.OpenCLIPConfig, h)))
    monkeypatch.setattr(pclip, "SD2_CLIP_H_CONFIG", h)
    for name, cfg in (("VITH_CONFIG", vit_h), ("VITL_CONFIG", vit_l)):
        monkeypatch.setattr(pcv, name, cfg)
        monkeypatch.setattr(jcv, name, jax_config(jcv.CLIPVisionConfig, cfg))
    chip_smoke.write_family_file("unclip", tmp_path / "unclip.safetensors", torch.float32)
    g = torch.Generator().manual_seed(11)
    write_safetensors(chip_smoke.style_flat(StyleAdapterConfig(
        width=32, context_dim=32, num_head=8, n_layers=3, num_token=8), g, torch.float32),
        tmp_path / "style.safetensors")
    write_safetensors({"id_encoder." + k: v for k, v in flatten(
        chip_smoke.photomaker_tree(vit_l, 32, g)).items()}, tmp_path / "photomaker.safetensors")
    return tmp_path


@pytest.fixture(scope="module")
def models():
    m0 = model_pair(0)
    return {"m0": m0, "m1": model_pair(1), "xl": (m0[0], dual_clip_pair(False), m0[2]),
            "rf": (m0[0], dual_clip_pair(True), m0[2])}


@pytest.fixture(autouse=True)
def const_nodes(models):
    """_Const (CONSTS by key) and _Models (the tiny model pairs) in both
    registries."""
    for mod in (je, pe):
        mod.register_node("_Const")(
            lambda ctx, node, _m=mod: tuple(_for(_m, CONSTS[k]) for k in node.widgets))
        mod.register_node("_Models")(
            lambda ctx, node, _m=mod: tuple(_for(_m, p) for k in node.widgets
                                            for p in models[k]))
    yield
    for mod in (je, pe):
        mod.NODE_REGISTRY.pop("_Const", None)
        mod.NODE_REGISTRY.pop("_Models", None)


def same(out, ref, tol, path="out"):
    """A port output against JAX's: arrays within ``tol`` (numpy outputs
    stay numpy), containers entry by entry, models by kind."""
    if isinstance(ref, np.ndarray) and not isinstance(out, torch.Tensor):
        assert isinstance(out, np.ndarray), path
        np.testing.assert_allclose(out, ref, err_msg=path, **tol)
    elif hasattr(ref, "shape") and hasattr(ref, "dtype"):
        assert isinstance(out, torch.Tensor), path
        assert tuple(out.shape) == tuple(ref.shape), path
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   err_msg=path, **tol)
    elif isinstance(ref, dict):
        assert sorted(out) == sorted(ref), path
        for k in ref:
            same(out[k], ref[k], tol, f"{path}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(out, (list, tuple)) and len(out) == len(ref), path
        for i, (a, b) in enumerate(zip(out, ref)):
            same(a, b, tol, f"{path}[{i}]")
    elif isinstance(ref, (str, int, float, bool)) or ref is None:
        assert out == ref, path
    else:  # models, schedules: the same kind of object
        assert type(out).__name__ == type(ref).__name__, path


def node_spec(ntype, widgets, inputs):
    """(spec rows, node id of ``ntype``): inputs are CONSTS keys, or
    ("m0" | "m1", slot) for a tiny model pair's MODEL / CLIP / VAE."""
    spec, links, consts, pairs = [], {}, [], []
    for name, src in inputs.items():
        if isinstance(src, tuple):
            if src[0] not in pairs:
                pairs.append(src[0])
            links[name] = (1, 3 * pairs.index(src[0]) + src[1])
        else:
            consts.append(src)
            links[name] = (2, len(consts) - 1)
    if pairs:
        spec.append((1, "_Models", pairs, {}))
    if consts:
        spec.append((2, "_Const", consts, {}))
    spec.append((3, ntype, widgets, links))
    return spec, 3


def run_node(ntype, widgets, inputs, monkeypatch, tol=PURE, model_dirs=(), seeds=()):
    """Both packages' outputs of one node, compared; returns (JAX ctx, port ctx)."""
    spec, nid = node_spec(ntype, widgets, inputs)
    jctx, pctx, _, _ = run_both(spec, monkeypatch, model_dirs=model_dirs, seeds=seeds)
    same(pctx.outputs[nid], jctx.outputs[nid], tol)
    return jctx, pctx


def bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).contiguous().numpy()
    else:
        x = np.asarray(x)
        x = x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x
    return x.tobytes()


def same_tree_bits(out: dict, ref: dict, dtype=None):
    from stable_renderer_tpu.models.weights import flatten as jflatten

    from stable_renderer_tpu_torch.models.weights import flatten

    mine, theirs = flatten(out), jflatten(ref)
    assert sorted(mine) == sorted(theirs)
    for k, v in mine.items():
        assert dtype is None or v.dtype == dtype, k
        assert bits(v) == bits(theirs[k]), k


@pytest.fixture
def output_dirs(tmp_path, monkeypatch):
    """Both packages' OUTPUT_DIR, apart: (JAX's, the port's)."""
    import stable_renderer_tpu.utils.paths as jpaths
    import stable_renderer_tpu_torch.utils.paths as ppaths

    dirs = (tmp_path / "jax_out", tmp_path / "port_out")
    monkeypatch.setattr(jpaths, "OUTPUT_DIR", dirs[0])
    monkeypatch.setattr(ppaths, "OUTPUT_DIR", dirs[1])
    return dirs


@pytest.fixture
def tiny_sd15(monkeypatch):
    """Both packages' SD15 VAE and CLIP configs set to tiny ones (the CLIP
    768 wide, as an SD1.x UNet's cross-attention takes)."""
    import stable_renderer_tpu.models as jmodels

    import stable_renderer_tpu_torch.models.clip as pclip
    import stable_renderer_tpu_torch.models.vae as pvae

    monkeypatch.setattr(jmodels, "SD15_VAE_CONFIG", jmodels.TINY_VAE_CONFIG)
    monkeypatch.setattr(jmodels, "SD15_CLIP_CONFIG",
                        replace(jmodels.TINY_CLIP_CONFIG, hidden_size=768))
    monkeypatch.setattr(pvae, "SD15_VAE_CONFIG", pvae.TINY_VAE_CONFIG)
    monkeypatch.setattr(pclip, "SD15_CLIP_CONFIG",
                        replace(pclip.TINY_CLIP_CONFIG, hidden_size=768))


def load_both(spec, model_dirs):
    """Both executors' outputs of ``spec`` (no carried randomness)."""
    from test_torch_executor import graphs

    outs = []
    for mod, wf in zip((je, pe), graphs(spec)):
        ex = mod.PromptExecutor(wf, model_dirs=tuple(map(str, model_dirs)),
                                **({} if mod is je else {"device": "cpu"}))
        outs.append(ex.execute().outputs)
    return outs


# --- the cases ------------------------------------------------------------------------

CONSTS.update({
    "vision": vision_pair(),
    "vision_output": vision_output_pair(),
    "style": style_pair(),
})

# (node type, widgets, inputs, tolerance)
CASES = [
    ("SetLatentNoiseMask", [], {"samples": "latent", "mask": "mask2d"}, PURE),
    ("LatentFromBatch", [1, 2], {"samples": "latent_b3"}, PURE),
    ("RepeatLatentBatch", [3], {"samples": "latent_b2m"}, PURE),
    ("LatentBlend", [0.3], {"samples1": "latent", "samples2": "latent2"}, PURE),
    ("LatentRotate", ["90 degrees"], {"samples": "latent_16"}, PURE),
    ("LatentFlip", ["y-axis: horizontally"], {"samples": "latent_16"}, PURE),
    ("LatentCrop", [64, 64, 8, 16], {"samples": "latent_16"}, PURE),
    ("LatentInterpolate", [0.3], {"samples1": "latent", "samples2": "latent2"}, PURE),
    ("LatentBatch", [], {"samples1": "latent_b3", "samples2": "latent2"}, PURE),
    ("LatentBatchSeedBehavior", ["fixed"], {"samples": "latent_b3"}, PURE),
    ("LatentCompositeMasked", [8, 16, False],
     {"destination": "latent_16", "source": "latent2", "mask": "mask_small"}, PURE),
    ("ImageCompositeMasked", [3, -2, True],
     {"destination": "image", "source": "image2", "mask": "soft_mask"}, PURE),
    ("EmptyImage", [20, 12, 2, 0x3366CC], {}, PURE),
    ("ImageCrop", [8, 6, 3, 2], {"image": "image"}, PURE),
    ("RepeatImageBatch", [2], {"image": "image"}, PURE),
    ("ImageFromBatch", [1, 1], {"image": "image_b2"}, PURE),
    ("ImageColorToMask", [0x336699], {"image": "image_q"}, PURE),
    ("CropMask", [2, 3, 8, 6], {"mask": "mask"}, PURE),
    ("ImageScaleToTotalPixels", ["bilinear", 0.01], {"image": "image_128"}, PURE),
    ("ImageScaleToTotalPixels", ["bicubic", 0.01], {"image": "image"}, PURE),
    ("Canny", [0.2, 0.5], {"image": "image"}, PURE),
    ("ConditioningAverage", [0.3], {"conditioning_to": "cond",
                                    "conditioning_from": "cond_short"}, PURE),
    ("ConditioningSetAreaStrength", [0.6], {"conditioning": "cond"}, PURE),
    ("CLIPTextEncodeControlnet", ["a red (boat:1.2)"],
     {"clip": ("m0", 1), "conditioning": "cond"}, TOL),
    ("CLIPTextEncodeControlnet", ["a red (boat:1.2)"],
     {"clip": ("xl", 1), "conditioning": "cond"}, TOL),
    # the dual encode: one prompt; split prompts (L columns of one, G of the
    # other, the shorter chunk stream zero-padded); the CLIP-L tower alone
    ("CLIPTextEncodeSDXL", [1024, 1024, 0, 0, 1024, 1024, "a red ball", "a red ball"],
     {"clip": ("xl", 1)}, TOL),
    ("CLIPTextEncodeSDXL", [768, 1344, 16, 8, 1024, 960, "a (red:1.2) ball, " * 12, "a ball"],
     {"clip": ("xl", 1)}, TOL),
    ("CLIPTextEncodeSDXL", [64, 64, 0, 0, 64, 64, "a ball", "a ball"], {"clip": ("m0", 1)}, TOL),
    ("CLIPTextEncodeSDXLRefiner", [2.5, 896, 1152, "a red ball"], {"clip": ("rf", 1)}, TOL),
    ("DiffControlNetLoader", ["cn.safetensors"], {"model": ("m0", 0)}, PURE),
    ("VAEDecodeTiled", [64], {"samples": "latent_16", "vae": ("m0", 2)}, TOL),
    ("VAEEncodeTiled", [64], {"pixels": "image_96", "vae": ("m0", 2)}, TOL),
    ("ModelSamplingDiscrete", ["v_prediction", True], {"model": ("m0", 0)}, PURE),
    ("ModelSamplingContinuousEDM", ["v_prediction", 120.0, 0.002], {"model": ("m0", 0)}, PURE),
    ("ModelSamplingContinuousEDM", ["eps", 80.0, 0.03], {"model": ("m0", 0)}, PURE),
    ("ModelSamplingStableCascade", [2.0], {"model": ("m0", 0)}, PURE),
    ("ModelSamplingStableCascade", [1.0], {"model": ("m0", 0)}, PURE),
    ("RescaleCFG", [0.6], {"model": ("m0", 0)}, PURE),
    ("PatchModelAddDownscale", [2, 1.5, 0.1, 0.5, False, "bilinear", "bicubic"],
     {"model": ("m0", 0)}, PURE),
    # image conditioning; a fifth entry names the fixture whose directory of
    # files the loaders read
    ("unCLIPCheckpointLoader", ["unclip.safetensors"], {}, PURE, "image_model_files"),
    ("StyleModelLoader", ["style.safetensors"], {}, PURE, "image_model_files"),
    ("StyleModelApply", [], {"conditioning": "cond", "style_model": "style",
                             "clip_vision_output": "vision_output"}, TOL),
    ("StableZero123_Conditioning_Batched", [32, 24, 3, 10.0, 20.0, 5.0, 15.0],
     {"clip_vision": "vision", "init_image": "image", "vae": ("m0", 2)}, TOL),
    # Stable Cascade's Stage C encode with the VAE it is given (the tiny
    # one's ratio 2): 128 // 32 = 4 -> an 8x8 bicubic resize
    ("StableCascade_StageC_VAEEncode", [32], {"image": "image_128", "vae": ("m0", 2)}, TOL),
    ("StableCascade_StageC_VAEEncode", [42], {"image": "image_96", "vae": ("m0", 2)}, TOL),
]
FILE_NODES = ("SaveLatent", "LoadLatent", "LoadImageMask", "SaveAnimatedWEBP",
              "SaveAnimatedPNG", "VAELoader", "CLIPLoader", "DualCLIPLoader", "LoraLoader",
              "CheckpointLoader", "DiffusersLoader")


def _case_id(case):
    return f"{case[0]}-{'-'.join(map(str, case[1]))}"


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_node_matches_jax(monkeypatch, request, case):
    ntype, widgets, inputs, tol = case[:4]
    dirs = [request.getfixturevalue(f) for f in case[4:]]
    jctx, pctx = run_node(ntype, widgets, inputs, monkeypatch, tol=tol, model_dirs=dirs)
    if ntype == "ModelSamplingDiscrete":  # the schedule itself
        jms, pms = jctx.outputs[3][0]["sampling"], pctx.outputs[3][0]["sampling"]
        assert pms.prediction == jms.prediction == "v"
        np.testing.assert_allclose(pms.sigmas, np.asarray(jms.sigmas), **PURE)
        assert pms.sigmas[-1] > 1e3  # zero terminal SNR
    if ntype.startswith("ModelSampling") and ntype != "ModelSamplingDiscrete":
        # the EDM and Cascade tables, built in float64 in both: bit for bit
        jms, pms = jctx.outputs[3][0]["sampling"], pctx.outputs[3][0]["sampling"]
        assert (pms.prediction, pms.timestep_mode) == (jms.prediction, jms.timestep_mode)
        np.testing.assert_array_equal(pms.sigmas, np.asarray(jms.sigmas))
        assert pms.percent_to_sigma(0.3) == jms.percent_to_sigma(0.3)


def test_every_name_of_the_pack_has_a_case():
    import stable_renderer_tpu.workflow.nodes_parity as jparity

    names = {n for n, f in je.NODE_REGISTRY.items() if f.__module__ == jparity.__name__}
    assert len(names) == 49
    assert names == {c[0] for c in CASES} | set(FILE_NODES)


# --- file nodes, bit for bit across packages ----------------------------------------------


@pytest.mark.parametrize("legacy", [False, True])
def test_save_and_load_latent_across_packages(monkeypatch, output_dirs, legacy):
    """SaveLatent in each package, then LoadLatent of the other's file: the
    latent comes back bit for bit; a legacy file (no version marker, NCHW
    from a torch writer) loads un-scaled and in NHWC in both."""
    from stable_renderer_tpu_torch.models.weights import write_safetensors

    spec, nid = node_spec("SaveLatent", ["latents/t"], {"samples": "latent_16"})
    jctx, pctx, _, _ = run_both(spec, monkeypatch)
    jpath, ppath = jctx.outputs[nid][0], pctx.outputs[nid][0]
    assert ppath.endswith("latents/t_00000_.latent") and jpath.endswith("latents/t_00000_.latent")
    assert pctx.status_messages == [f"saved latent {ppath}"]
    if legacy:
        nchw = np.ascontiguousarray(CONSTS["latent_16"]["samples"].transpose(0, 3, 1, 2))
        write_safetensors({"latent_tensor": nchw}, ppath)
        jpath = ppath
    outs = load_both([(1, "LoadLatent", [jpath], {}), (2, "LoadLatent", [ppath], {})], ())
    want = CONSTS["latent_16"]["samples"] * (np.float32(1.0 / 0.18215) if legacy else 1)
    for jo_or_po in outs:
        for nid in (1, 2):
            got = jo_or_po[nid][0]["samples"]
            assert bits(np.asarray(got)) == bits(want.astype(F32)), nid
    jo, po = outs
    assert bits(po[1][0]["samples"]) == bits(jo[2][0]["samples"])


def test_load_latent_missing_file_raises_in_both():
    for mod, wf in zip((je, pe), __import__("test_torch_executor").graphs(
            [(1, "LoadLatent", ["absent.latent"], {})])):
        ex = mod.PromptExecutor(wf, **({} if mod is je else {"device": "cpu"}))
        with pytest.raises(mod.NodeExecutionError, match="absent.latent' not found"):
            ex.execute()


@pytest.mark.parametrize("channel", ["alpha", "red"])
def test_load_image_mask_matches_jax(tmp_path, monkeypatch, channel):
    from PIL import Image

    rgba = (RNG.uniform(size=(10, 12, 4)) * 255).astype(np.uint8)
    Image.fromarray(rgba).save(tmp_path / "m.png")
    run_node("LoadImageMask", ["m.png", channel], {}, monkeypatch, model_dirs=(tmp_path,))
    run_node("LoadImageMask", ["absent.png", channel], {}, monkeypatch, model_dirs=(tmp_path,))


@pytest.mark.parametrize("ntype, widgets", [
    ("SaveAnimatedWEBP", ["x", 8.0, True, 80, "default"]),
    ("SaveAnimatedPNG", ["x", 5.0, 4]),
])
def test_animated_saves_match_jax(monkeypatch, output_dirs, ntype, widgets):
    from PIL import Image, ImageSequence

    jctx, pctx = run_node(ntype, widgets, {"images": "image_b2"}, monkeypatch)
    suffix = ".webp" if ntype.endswith("WEBP") else ".png"
    jfile, pfile = (d / "workflow" / f"anim_00000{suffix}" for d in output_dirs)
    assert pctx.status_messages == [f"saved {pfile}"]
    frames = [[np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(Image.open(p))]
              for p in (jfile, pfile)]
    assert len(frames[1]) == len(frames[0]) == 2
    for a, b in zip(*frames):
        assert np.array_equal(a, b)


def test_vae_and_clip_loaders_match_jax(tmp_path, tiny_sd15):
    """VAELoader on a whole checkpoint's first_stage_model subtree (bf16) and
    on a bare VAE file; CLIPLoader on the text tower (f32): every leaf equals
    JAX's bit for bit. CLIPLoader on OpenCLIP-G and -H files (open_clip's
    ``transformer.`` prefix stripped, as JAX strips it) loads the same leaves
    behind the CLIP-L model in both packages, which then cannot encode them
    (ROADMAP queue 3)."""
    from test_torch_checkpoint_pipeline import _write_checkpoint

    from stable_renderer_tpu_torch.models.clip import (
        TINY_CLIP_G_CONFIG,
        TINY_CLIP_H_CONFIG,
        OpenCLIPTextModel,
    )
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    flat = _write_checkpoint(tmp_path / "sd.safetensors")
    write_safetensors({k[len("first_stage_model."):]: v for k, v in flat.items()
                       if k.startswith("first_stage_model.")}, tmp_path / "vae.safetensors")
    for name, cfg in (("g", TINY_CLIP_G_CONFIG), ("h", TINY_CLIP_H_CONFIG)):
        tree = OpenCLIPTextModel(cfg).init(torch.Generator().manual_seed(7))["model"]
        write_safetensors(flatten(tree), tmp_path / f"open_clip_{name}.safetensors")
    spec = [(1, "VAELoader", ["sd.safetensors"], {}), (2, "VAELoader", ["vae.safetensors"], {}),
            (3, "CLIPLoader", ["sd.safetensors"], {}),
            (4, "CLIPLoader", ["open_clip_g.safetensors"], {}),
            (5, "CLIPLoader", ["open_clip_h.safetensors"], {})]
    jo, po = load_both(spec, (tmp_path,))
    for nid, dt in ((1, torch.bfloat16), (2, torch.bfloat16), (3, torch.float32),
                    (4, torch.float32), (5, torch.float32)):
        same_tree_bits(po[nid][0]["params"], jo[nid][0]["params"], dt)
        assert type(po[nid][0]["clip"] if nid > 2 else po[nid][0]["vae"]).__name__ == type(
            jo[nid][0]["clip"] if nid > 2 else jo[nid][0]["vae"]).__name__
    assert po[3][0]["clip"].config.hidden_size == 768
    assert sorted(po[4][0]["params"]) == ["resblocks"]  # open_clip's other leaves drop
    spec.append((6, "CLIPTextEncode", ["a ball"], {"clip": (4, 0)}))
    for mod, wf in zip((je, pe), __import__("test_torch_executor").graphs(spec)):
        ex = mod.PromptExecutor(wf, model_dirs=(str(tmp_path),),
                                **({} if mod is je else {"device": "cpu"}))
        with pytest.raises(mod.NodeExecutionError, match="text_model"):
            ex.execute()


@pytest.mark.parametrize("files", [True, False])
def test_dual_clip_loader_matches_jax(tmp_path, files):
    """DualCLIPLoader on a CLIP-L file and a CLIP-G file: both trees (f32)
    equal JAX's bit for bit, behind SD1.x's CLIP-L and SDXL's CLIP-G configs;
    without the files both packages build the tiny towers (64 wide, a 2-layer
    G), their trees of the same keys and shapes."""
    from stable_renderer_tpu.models.weights import flatten as jflatten

    from stable_renderer_tpu_torch.models.clip import (
        TINY_CLIP_CONFIG,
        TINY_CLIP_G_CONFIG,
        CLIPTextModel,
        OpenCLIPTextModel,
    )
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    if files:
        g = torch.Generator().manual_seed(8)
        write_safetensors(flatten(CLIPTextModel(TINY_CLIP_CONFIG).init(g)),
                          tmp_path / "clip_l.safetensors")
        write_safetensors(flatten(OpenCLIPTextModel(TINY_CLIP_G_CONFIG).init(g)["model"]),
                          tmp_path / "clip_g.safetensors")
    jo, po = load_both([(1, "DualCLIPLoader", ["clip_l.safetensors", "clip_g.safetensors"],
                         {})], (tmp_path,))
    (jc,), (pc,) = jo[1], po[1]
    assert sorted(pc) == sorted(jc)
    for key in ("clip", "clip_g"):
        assert type(pc[key]).__name__ == type(jc[key]).__name__
        assert dataclasses.asdict(pc[key].config) == dataclasses.asdict(jc[key].config)
    for key in ("params", "params_g"):
        if files:
            same_tree_bits(pc[key], jc[key], torch.float32)
        else:
            assert ({k: tuple(v.shape) for k, v in flatten(pc[key]).items()}
                    == {k: tuple(v.shape) for k, v in jflatten(jc[key]).items()})
    assert pc["clip_g"].config.width == (1280 if files else 64)


def test_lora_and_checkpoint_loaders_match_jax(tmp_path, tiny_sd15):
    """CheckpointLoader (the config widget ignored) as JAX's, and LoraLoader
    merging an F16 LoRA into the UNet (lora_unet_) and the CLIP (lora_te_):
    every leaf of both equals JAX's bit for bit; a missing LoRA passes both
    through."""
    from test_torch_checkpoint_pipeline import _write_checkpoint, _write_lora

    flat = _write_checkpoint(tmp_path / "sd.safetensors")
    _write_lora(tmp_path / "lora.safetensors", flat)
    spec = [(1, "CheckpointLoader", ["v1-inference.yaml", "sd.safetensors"], {}),
            (2, "LoraLoader", ["lora.safetensors", 0.8, 0.6], {"model": (1, 0), "clip": (1, 1)}),
            (3, "LoraLoader", ["absent.safetensors", 0.8, 0.6],
             {"model": (1, 0), "clip": (1, 1)})]
    jo, po = load_both(spec, (tmp_path,))
    for nid, slot, dt in ((1, 0, torch.bfloat16), (1, 1, torch.float32), (1, 2, torch.bfloat16),
                          (2, 0, torch.bfloat16), (2, 1, torch.float32)):
        same_tree_bits(po[nid][slot]["params"], jo[nid][slot]["params"], dt)
    assert po[3][0] is po[1][0] and po[3][1] is po[1][1]
    for slot in (0, 1):  # the merge moved both towers
        a, b = po[2][slot]["params"], po[1][slot]["params"]
        from stable_renderer_tpu_torch.models.weights import flatten

        assert any(not torch.equal(v, flatten(b)[k]) for k, v in flatten(a).items())


def test_diffusers_loader_matches_jax(tmp_path, tiny_sd15):
    """DiffusersLoader on a diffusers folder of a small SD1.x-topology model:
    the UNet and VAE in bf16, the CLIP in f32, every leaf as JAX's."""
    from test_torch_weights import _to_diffusers_unet, _to_diffusers_vae

    from stable_renderer_tpu_torch.models.clip import TINY_CLIP_CONFIG, CLIPTextModel
    from stable_renderer_tpu_torch.models.unet import UNetConfig, UNetModel
    from stable_renderer_tpu_torch.models.vae import TINY_VAE_CONFIG, VAE
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    ucfg = UNetConfig(model_channels=32, channel_mult=(1, 2, 4, 4), num_heads=8,
                      context_dim=768)
    g = torch.Generator().manual_seed(0)
    unet = flatten(UNetModel(ucfg).init(g))
    vae = flatten(VAE(TINY_VAE_CONFIG).init(g))
    te = flatten(CLIPTextModel(replace(TINY_CLIP_CONFIG, hidden_size=768)).init(g))
    base = tmp_path / "sd_folder"
    for sub, tensors, name in (
            ("unet", {_to_diffusers_unet(k): v for k, v in unet.items()},
             "diffusion_pytorch_model.safetensors"),
            ("vae", dict(_to_diffusers_vae(k, v.numpy()) for k, v in vae.items()),
             "diffusion_pytorch_model.safetensors"),
            ("text_encoder", te, "model.safetensors")):
        (base / sub).mkdir(parents=True)
        write_safetensors(tensors, base / sub / name)
    jo, po = load_both([(1, "DiffusersLoader", ["sd_folder"], {})], (tmp_path,))
    for slot, dt in ((0, torch.bfloat16), (1, torch.float32), (2, torch.bfloat16)):
        same_tree_bits(po[1][slot]["params"], jo[1][slot]["params"], dt)
    assert __import__("test_torch_checkpoint_pipeline").same_layout(po[1][0]["unet"].config, ucfg)
