"""The port's executor nodes (workflow/executor.py) against the JAX
package's, on the CPU at tiny widths: every implemented node other than the
samplers, each on the same inputs (handed in by a ``_Const`` source node
registered in both packages), the checkpoint and LoRA loaders on files
written here, then the KSampler variants: KSamplerAdvanced in two windows,
inpainting through VAEEncodeForInpaint, and a cond list of an area, a mask
and a timestep range. f32 throughout: TOL."""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_executor import (
    TOL,
    assert_close,
    engine_maps,
    graphs,
    jax_engine_data,
    port_engine_data,
    run_both,
)

import stable_renderer_tpu.workflow.executor as je
import stable_renderer_tpu_torch.workflow.executor as pe

torch.set_num_threads(1)

RNG = np.random.default_rng(21)
F32 = np.float32


class Pair:
    """A value given per package: (JAX's, the port's)."""

    def __init__(self, jax_value, port_value):
        self.values = {je: jax_value, pe: port_value}


def _for(mod, v):
    """A numpy-built constant as the package's value."""
    if isinstance(v, Pair):
        return v.values[mod]
    if isinstance(v, dict):
        return {k: _for(mod, x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_for(mod, x) for x in v)
    if isinstance(v, np.ndarray):
        return jnp.asarray(v) if mod is je else torch.from_numpy(v.copy())
    return v


CONSTS = {
    "image": RNG.uniform(size=(1, 16, 16, 3)).astype(F32),
    "image2": RNG.uniform(size=(1, 12, 20, 3)).astype(F32),
    "image_b2": RNG.uniform(size=(2, 16, 16, 3)).astype(F32),
    "rgba": RNG.uniform(size=(1, 16, 16, 4)).astype(F32),
    "mask": (RNG.uniform(size=(1, 16, 16)) > 0.6).astype(F32),
    "soft_mask": RNG.uniform(size=(1, 16, 16)).astype(F32),
    "mask2d": (RNG.uniform(size=(8, 10)) > 0.5).astype(F32),
    "mask_small": (RNG.uniform(size=(1, 6, 7)) > 0.5).astype(F32),
    "latent": {"samples": RNG.standard_normal((1, 8, 8, 4)).astype(F32)},
    "latent2": {"samples": RNG.standard_normal((1, 4, 6, 4)).astype(F32),
                "noise_mask": np.ones((1, 4, 6), F32)},
    "cond": {"context": RNG.standard_normal((1, 77, 64)).astype(F32), "controls": [],
             "prompt": "p"},
    "cond2": {"context": RNG.standard_normal((1, 77, 64)).astype(F32), "controls": [],
              "prompt": "q", "extra_conds": []},
    "control": {"name": "cn.safetensors", "path": None},
    "none": None,
    "number": 3,
}


@pytest.fixture(autouse=True)
def const_node():
    for mod in (je, pe):
        mod.register_node("_Const")(
            lambda ctx, node, _m=mod: tuple(_for(_m, CONSTS[k]) for k in node.widgets))
    yield
    for mod in (je, pe):
        mod.NODE_REGISTRY.pop("_Const", None)


def _same(out, ref, path="out"):
    """Recursive comparison of a port output with JAX's."""
    if isinstance(ref, (jax.Array, np.ndarray)):
        assert isinstance(out, torch.Tensor), path
        assert tuple(out.shape) == tuple(ref.shape), path
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   err_msg=path, **TOL)
    elif isinstance(ref, dict):
        assert sorted(out) == sorted(ref), path
        for k in ref:
            _same(out[k], ref[k], f"{path}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert type(out) is type(ref) and len(out) == len(ref), path
        for i, (a, b) in enumerate(zip(out, ref)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(ref, (str, int, float, bool)) or ref is None:
        assert out == ref, path
    else:  # models, corresponders: the same kind of object
        assert type(out).__name__ == type(ref).__name__, path


def _const(nid, *keys):
    return (nid, "_Const", list(keys), {})


LOADER = (1, "CheckpointLoaderSimple", ["missing.safetensors"], {})

# (node type, widgets, {input: const key or (loader slot,)})
NODE_CASES = [
    ("CLIPTextEncode", ["a red (boat:1.2), masterpiece"], {"clip": (1,)}),
    ("MaskedTextEncode", ["a mask"], {"clip": (1,), "mask": "mask"}),
    ("SceneTextEncode", [], {"clip": (1,)}),
    ("ConditioningSetArea", [64, 32, 8, 16, 0.7], {"conditioning": "cond"}),
    ("ConditioningSetAreaPercentage", [0.5, 0.25, 0.1, 0.2, 0.9], {"conditioning": "cond"}),
    ("SolidMask", [0.3, 24, 16], {}),
    *[("MaskComposite", [4, 2, op], {"destination": "soft_mask", "source": "mask_small"})
      for op in ("add", "subtract", "multiply", "or", "and", "xor")],
    ("ConditioningSetMask", [0.8], {"conditioning": "cond", "mask": "mask"}),
    ("ConditioningSetTimestepRange", [0.2, 0.7], {"conditioning": "cond"}),
    ("ControlNetLoader", ["cn.safetensors"], {}),
    ("ControlNetApply", [0.7], {"conditioning": "cond", "control_net": "control",
                                "image": "image"}),
    ("ControlNetApplyAdvanced", [0.6, 0.1, 0.9],
     {"positive": "cond", "negative": "cond2", "control_net": "control", "image": "image"}),
    ("VAEEncodeForInpaint", [6], {"pixels": "image", "vae": (2,), "mask": "mask_small"}),
    ("VAEEncodeForInpaint", [0], {"pixels": "image", "vae": (2,), "mask": "mask2d"}),
    ("InpaintModelConditioning", [], {"positive": "cond", "negative": "cond2", "vae": (2,),
                                      "pixels": "image", "mask": "mask_small"}),
    ("LatentComposite", [8, 16, 0], {"samples_to": "latent", "samples_from": "latent2"}),
    ("LatentComposite", [8, 8, 16], {"samples_to": "latent", "samples_from": "latent2"}),
    *[("ImageBlend", [0.3, mode], {"image1": "image", "image2": "image2"})
      for mode in ("normal", "multiply", "screen", "difference")],
    ("ImageInvert", [], {"image": "image"}),
    ("ImageBatch", [], {"image1": "image", "image2": "image2"}),
    *[(t, [], {}) for t in ("EngineData", "EngineDataNode", "VirtualEngineData", "FrameData",
                            "EmptyCorrMaps", "DefaultCorresponder", "OverlapCorresponder")],
    ("VAEEncode", [], {"pixels": "image", "vae": (2,)}),
    ("VAEDecode", [], {"samples": "latent", "vae": (2,)}),
    ("InferenceOutput", [], {"images": "image"}),
    ("InferenceOutputNode", [], {"value": "none", "images": "image"}),
    ("Note", ["a note"], {}),
    ("Reroute", [], {"x": "latent"}),
    ("IsNotNone", [], {"value": "none"}),
    ("IsNotNoneNode", [], {"value": "number"}),
    ("IfValTypeEqual", ["int"], {"val": "number"}),
    ("EmptyLatentImage", [48, 32, 2], {}),
    ("LatentUpscale", ["nearest-exact", 96, 40], {"samples": "latent"}),
    ("LatentUpscaleBy", ["nearest-exact", 1.5], {"samples": "latent"}),
    ("ImageScale", ["nearest-exact", 24, 20], {"image": "image"}),
    ("ImageScaleBy", ["nearest-exact", 0.5], {"image": "image"}),
    ("CLIPSetLastLayer", [-2], {"clip": (1,)}),
    ("ConditioningCombine", [], {"conditioning_1": "cond", "conditioning_2": "cond2"}),
    ("ConditioningConcat", [], {"conditioning_to": "cond", "conditioning_from": "cond2"}),
    ("ImageBlur", [2, 1.5], {"image": "image"}),
    ("ImageBlur", [0, 1.0], {"image": "image"}),
    ("ImageSharpen", [1, 0.8, 0.6], {"image": "image"}),
    ("ImageQuantize", [5], {"image": "image"}),
    ("MaskToImage", [], {"mask": "mask"}),
    *[("ImageToMask", [c], {"image": "rgba"}) for c in ("red", "green", "blue", "alpha")],
    ("InvertMask", [], {"mask": "soft_mask"}),
    ("ThresholdMask", [0.4], {"mask": "soft_mask"}),
    ("FeatherMask", [3, 2, 0, 5], {"mask": "soft_mask"}),
    *[("GrowMask", [e, t], {"mask": "mask"}) for e in (2, -1) for t in (True, False)],
    ("LatentAdd", [], {"samples1": "latent", "samples2": "latent"}),
    ("LatentSubtract", [], {"samples1": "latent", "samples2": "latent"}),
    ("LatentMultiply", [0.7], {"samples1": "latent"}),
    ("ImagePadForOutpaint", [4, 2, 6, 0, 3], {"image": "image"}),
    ("ImagePadForOutpaint", [0, 0, 0, 0, 0], {"image": "image"}),
    ("ConditioningZeroOut", [], {"conditioning": "cond"}),
]


def _case_id(case):
    return f"{case[0]}-{'-'.join(map(str, case[1]))}"


@pytest.mark.parametrize("case", NODE_CASES, ids=[_case_id(c) for c in NODE_CASES])
def test_node_matches_jax(monkeypatch, case):
    from stable_renderer_tpu.data.sprite import EnvPrompt as JEnv, Sprite as JSprite

    from stable_renderer_tpu_torch.data.sprite import EnvPrompt as PEnv, Sprite as PSprite

    ntype, widgets, inputs = case
    spec, links, consts = [], {}, []
    if any(isinstance(v, tuple) for v in inputs.values()):
        spec.append(LOADER)
    for name, src in inputs.items():
        if isinstance(src, tuple):
            links[name] = (1, src[0])
        else:
            consts.append(src)
            links[name] = (2, len(consts) - 1)
    if consts:
        spec.append(_const(2, *consts))
    spec.append((3, ntype, widgets, links))
    maps = engine_maps(h=16, w=16)
    jctx, pctx, _, _ = run_both(
        spec, monkeypatch, maps=maps,
        jax_extra=dict(sprite_infos={1: JSprite(spriteID=1, prompt="a girl")},
                       env_prompts=(JEnv(prompt="a stage"),)),
        port_extra=dict(sprite_infos={1: PSprite(spriteID=1, prompt="a girl")},
                        env_prompts=(PEnv(prompt="a stage"),)))
    _same(pctx.outputs[3], jctx.outputs[3])
    if ntype == "CLIPSetLastLayer":  # the skip reaches the encoding
        for mod, ctx in ((je, jctx), (pe, pctx)):
            assert ctx.outputs[3][0]["clip_skip"] == -2
    if ntype in ("InferenceOutput", "InferenceOutputNode"):
        _same(pctx.final_output, jctx.final_output)


def test_load_and_save_image_match_jax(tmp_path, monkeypatch):
    from PIL import Image

    import stable_renderer_tpu.utils.paths as jpaths
    import stable_renderer_tpu_torch.utils.paths as ppaths

    rgba = (RNG.uniform(size=(10, 12, 4)) * 255).astype(np.uint8)
    Image.fromarray(rgba).save(tmp_path / "in.png")
    for mod, d in ((jpaths, "jax"), (ppaths, "port")):
        monkeypatch.setattr(mod, "OUTPUT_DIR", tmp_path / d)
    spec = [(1, "LoadImage", ["in.png"], {}), (2, "LoadImage", ["absent.png"], {}),
            (3, "SaveImage", ["x"], {"images": (1, 0)}),
            (4, "PreviewImage", [], {"images": (2, 0)})]
    jctx, pctx, _, _ = run_both(spec, monkeypatch, model_dirs=(tmp_path,))
    for nid in (1, 2, 3, 4):
        _same(pctx.outputs[nid], jctx.outputs[nid])
    _same(pctx.final_output, jctx.final_output)
    assert pctx.status_messages == jctx.status_messages
    for name in ("frame_0000.png", "frame_0001.png"):
        a, b = tmp_path / "port" / "workflow" / name, tmp_path / "jax" / "workflow" / name
        assert a.exists() == b.exists()
        if a.exists():
            assert np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


@pytest.fixture
def tiny_sd15(monkeypatch):
    """Both loaders' SD15 VAE and CLIP configs set to tiny ones (the CLIP 768
    wide, as an SD1.x UNet's cross-attention takes)."""
    import stable_renderer_tpu.models as jmodels

    import stable_renderer_tpu_torch.models.clip as pclip
    import stable_renderer_tpu_torch.models.vae as pvae

    monkeypatch.setattr(jmodels, "SD15_VAE_CONFIG", jmodels.TINY_VAE_CONFIG)
    monkeypatch.setattr(jmodels, "SD15_CLIP_CONFIG",
                        replace(jmodels.TINY_CLIP_CONFIG, hidden_size=768))
    monkeypatch.setattr(pvae, "SD15_VAE_CONFIG", pvae.TINY_VAE_CONFIG)
    monkeypatch.setattr(pclip, "SD15_CLIP_CONFIG",
                        replace(pclip.TINY_CLIP_CONFIG, hidden_size=768))


def test_checkpoint_and_lora_loaders_match_jax(tmp_path, tiny_sd15):
    """CheckpointLoaderSimple on a tiny SD1.x file (UNet and VAE bf16, CLIP
    f32), LoraLoaderModelOnly on an LDM-named LoRA: every leaf equals JAX's
    bit for bit; the loaded CLIP encodes alike; a missing LoRA passes the
    model through."""
    from test_torch_checkpoint_pipeline import _bits, _write_checkpoint, _write_lora

    from stable_renderer_tpu.models.weights import flatten as jflatten
    from stable_renderer_tpu_torch.models.weights import flatten

    flat = _write_checkpoint(tmp_path / "sd.safetensors")
    _write_lora(tmp_path / "lora.safetensors", flat)
    spec = [(1, "CheckpointLoaderSimple", ["sub\\sd.safetensors"], {}),
            (2, "LoraLoaderModelOnly", ["lora.safetensors", 0.8], {"model": (1, 0)}),
            (3, "LoraLoaderModelOnly", ["absent.safetensors", 0.8], {"model": (1, 0)}),
            (4, "CLIPTextEncode", ["a boat"], {"clip": (1, 1)})]
    outs = []
    for mod, wf in zip((je, pe), graphs(spec)):
        ex = mod.PromptExecutor(wf, model_dirs=(str(tmp_path),),
                                **({} if mod is je else {"device": "cpu"}))
        outs.append(ex.execute().outputs)
    jo, po = outs
    for nid, slot, key, dt in ((1, 0, "params", torch.bfloat16), (1, 2, "params", torch.bfloat16),
                               (1, 1, "params", torch.float32), (2, 0, "params", torch.bfloat16)):
        mine, ref = flatten(po[nid][slot][key]), jflatten(jo[nid][slot][key])
        assert sorted(mine) == sorted(ref)
        for k, v in mine.items():
            assert v.dtype == dt and _bits(v) == _bits(ref[k]), (nid, slot, k)
    assert po[1][0]["unet"].config.context_dim == 768
    assert (po[1][0]["family"], po[1][0]["sampling"].prediction) == (
        jo[1][0]["family"], jo[1][0]["sampling"].prediction)
    assert po[3][0] is po[1][0]
    _same(po[4], jo[4])


# --- the KSampler variants ---------------------------------------------------------------


def _sampler_graph(sampler_nodes, latent_from=(5, 0), extra=()):
    """Loader, positive and negative prompts, a latent from _Const, then
    ``sampler_nodes`` (ids from 10) and a decode of the last."""
    last = sampler_nodes[-1][0]
    return [LOADER,
            (2, "CLIPTextEncode", ["a red boat"], {"clip": (1, 1)}),
            (3, "CLIPTextEncode", ["blurry"], {"clip": (1, 1)}),
            _const(5, "latent"),
            *extra, *sampler_nodes,
            (20, "VAEDecode", [], {"samples": (last, 0), "vae": (1, 2)})]


def test_ksampler_advanced_in_two_windows_matches_jax(monkeypatch):
    """KSamplerAdvanced with noise over steps [0, 2) returning the leftover
    noise (euler_ancestral: JAX's draws handed in), then a second without
    noise over [2, end): the pair equals JAX's pair, and the first window's
    latent is not fully denoised."""
    io = {"model": (1, 0), "positive": (2, 0), "negative": (3, 0)}
    nodes = [(10, "KSamplerAdvanced",
              ["enable", 11, "fixed", 4, 2.0, "euler_ancestral", "karras", 0, 2, "enable"],
              {**io, "latent_image": (5, 0)}),
             (11, "KSamplerAdvanced",
              ["disable", 11, "fixed", 4, 2.0, "euler", "karras", 2, 10000, "disable"],
              {**io, "latent_image": (10, 0)})]
    jctx, pctx, _, _ = run_both(_sampler_graph(nodes), monkeypatch, seeds=(11,))
    assert_close(pctx.outputs[10][0], jctx.outputs[10][0])
    assert_close(pctx.outputs[11][0], jctx.outputs[11][0])
    assert_close(pctx.outputs[20][0], jctx.outputs[20][0])


def test_ksampler_inpaint_matches_jax(monkeypatch):
    """VAEEncodeForInpaint's grown mask rides the latent as noise_mask: the
    KSampler (denoise 0.8) keeps the latent outside it."""
    nodes = [(9, "VAEEncodeForInpaint", [2], {"pixels": (6, 0), "vae": (1, 2),
                                               "mask": (6, 1)}),
             (10, "KSampler", [5, "fixed", 3, 3.0, "euler", "normal", 0.8],
              {"model": (1, 0), "positive": (2, 0), "negative": (3, 0),
               "latent_image": (9, 0)})]
    spec = _sampler_graph(nodes, extra=[_const(6, "image", "mask")])
    jctx, pctx, _, _ = run_both(spec, monkeypatch, seeds=(5,))
    assert_close(pctx.outputs[10][0], jctx.outputs[10][0])
    from stable_renderer_tpu_torch.ops.math import resize_nearest

    keep = resize_nearest(pctx.outputs[9][0]["noise_mask"][..., None], 8, 8)[..., 0] == 0
    assert keep.any()
    # kept up to the last euler step's rounding (x + d * (0 - sigma))
    torch.testing.assert_close(pctx.outputs[10][0]["samples"][keep],
                               pctx.outputs[9][0]["samples"][keep], atol=1e-5, rtol=0)


def test_ksampler_cond_list_matches_jax(monkeypatch):
    """Positive = an area cond (strength 0.8) combined with a masked cond and
    a cond gated to the first half of sampling: the cond-list denoiser, with
    percent_to_sigma's windows, as JAX's."""
    nodes = [(10, "KSampler", [2, "fixed", 4, 4.0, "dpmpp_2m", "karras", 1.0],
              {"model": (1, 0), "positive": (9, 0), "negative": (3, 0),
               "latent_image": (5, 0)})]
    extra = [_const(4, "mask"),
             (6, "ConditioningSetArea", [32, 48, 8, 0, 0.8], {"conditioning": (2, 0)}),
             (7, "ConditioningSetMask", [0.7], {"conditioning": (3, 0), "mask": (4, 0)}),
             (8, "ConditioningSetTimestepRange", [0.0, 0.5], {"conditioning": (2, 0)}),
             (12, "ConditioningCombine", [], {"conditioning_1": (6, 0),
                                              "conditioning_2": (7, 0)}),
             (9, "ConditioningCombine", [], {"conditioning_1": (12, 0),
                                             "conditioning_2": (8, 0)})]
    jctx, pctx, _, _ = run_both(_sampler_graph(nodes, extra=extra), monkeypatch, seeds=(2,))
    assert len(pctx.outputs[9][0]["extra_conds"]) == 2
    assert_close(pctx.outputs[10][0], jctx.outputs[10][0])


def test_ksampler_without_engine_data_and_unported_branches(monkeypatch):
    """The KSampler without engine data, on the fallback models, and the
    inputs that take models/noise_aug.py, against JAX with its draws handed
    in: unCLIP's ADM vector (a UNet with a 16-wide ADM: two image entries on
    the positive, the merge path; zeros for the negative, which has none)
    and the x4 layout (a class-table UNet of 7 input channels; a 12x20 image
    resized to the latent and noise-augmented at 0.2). EDM v-prediction
    sampling (0.25 log sigma as the UNet's timestep) and Stable Cascade's
    (the continuous cosine t) on the tiny UNet run as JAX's (the Cascade
    prior's effnet input is held in tests/test_torch_video_graphs.py)."""
    from test_torch_nodes_parity import as_jax, jax_config
    from test_torch_noise_aug import jax_aug_noise

    import stable_renderer_tpu.models as jm
    from stable_renderer_tpu_torch.models.unet import UNetModel

    spec = [LOADER, (2, "CLIPTextEncode", ["x"], {"clip": (1, 1)}),
            (3, "EmptyLatentImage", [64, 64, 1], {}),
            (10, "KSampler", [0, "fixed", 2, 2.0, "euler", "normal", 1.0],
             {"model": (1, 0), "positive": (2, 0), "negative": (2, 0), "latent_image": (3, 0)})]
    jctx, pctx, jex, pex = run_both(spec, monkeypatch, seeds=(0,))  # no engine data: runs
    assert_close(pctx.outputs[10][0], jctx.outputs[10][0])
    jax_aug_noise(monkeypatch)
    model, jmodel = pex._cache[1][0], jex._cache[1][0]
    embeds = RNG.standard_normal((2, 8)).astype(F32)
    variants = {
        "unclip": (dict(adm_in_channels=16), {"noise_aug_dim": 8},
                   {"unclip": [{"embeds": embeds[:1], "strength": 1.0, "noise_augmentation": 0.1},
                               {"embeds": embeds[1], "strength": 0.5,
                                "noise_augmentation": 0.3}]}),
        "x4": (dict(in_channels=7, num_classes=350), {},
               {"concat_image": RNG.uniform(-1, 1, (1, 12, 20, 3)).astype(F32),
                "noise_augmentation": 0.2}),
    }
    for name, (ucfg, extra, cond_extra) in variants.items():
        unet = UNetModel(replace(model["unet"].config, **ucfg))
        params = unet.init(torch.Generator().manual_seed(3))
        for mod, ex in ((je, jex), (pe, pex)):
            m, c, v = ex._cache[1]
            if mod is je:
                m = {**m, "unet": jm.UNetModel(jax_config(jm.UNetConfig, unet.config)),
                     "params": as_jax(params), **extra}
            else:
                m = {**m, "unet": unet, "params": params, **extra}
            ex._cache[1] = (m, c, v)
            cond = ex._cache[2][0]
            ex._cache[2] = ({**cond, **_for(mod, cond_extra)},)
            del ex._cache[10]
        jo, po = jex.execute().outputs, pex.execute().outputs
        assert_close(po[10][0], jo[10][0])
        moved = float((po[10][0]["samples"] - pctx.outputs[10][0]["samples"]).abs().max())
        assert moved > 1e-3, name
        for ex in (jex, pex):
            ex._cache[2] = ({k: v for k, v in ex._cache[2][0].items() if k not in cond_extra},)
    # EDM and Cascade timesteps on the tiny UNet, as JAX's. JAX's compiled
    # KSampler programs are keyed without the model's sampling (ROADMAP
    # queue 3): the EDM model first runs the eps program compiled above; the
    # cache is emptied so that each schedule compiles its own
    from stable_renderer_tpu.models.sampling import schedules as jsched
    from stable_renderer_tpu_torch.models.sampling import schedules as psched

    for kind, kw in (("ModelSamplingEDM", dict(prediction="v")),
                     ("ModelSamplingCascade", dict(shift=2.0))):
        for ex, m, ms in ((jex, jmodel, getattr(jsched, kind)(**kw)),
                          (pex, model, getattr(psched, kind)(**kw))):
            ex._cache[1] = ({**m, "sampling": ms},) + ex._cache[1][1:]
            del ex._cache[10]
        if kind == "ModelSamplingEDM":
            stale = np.asarray(jex.execute().outputs[10][0]["samples"])
            del jex._cache[10]
        jex._jit_cache.clear()
        jo, po = jex.execute().outputs, pex.execute().outputs
        assert_close(po[10][0], jo[10][0])
        if kind == "ModelSamplingEDM":
            assert np.abs(stale - np.asarray(jo[10][0]["samples"])).max() > 1.0
        moved = float((po[10][0]["samples"] - pctx.outputs[10][0]["samples"]).abs().max())
        assert moved > 1e-3, kind


def test_engine_data_node_needs_engine_data():
    for mod, wf in zip((je, pe), graphs([(1, "EngineData", [], {})])):
        ex = mod.PromptExecutor(wf, **({} if mod is je else {"device": "cpu"}))
        with pytest.raises(mod.NodeExecutionError, match="no engine_data"):
            ex.execute()
        ed = (jax_engine_data if mod is je else port_engine_data)(engine_maps(h=16, w=16))
        assert ex.execute(engine_data=ed).outputs[1][6]["noise"] is ed.noise_maps
