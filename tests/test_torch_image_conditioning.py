"""The image-conditioned graphs through both packages' executors, on the CPU
at tiny widths: unCLIP (the checkpoint's embedded vision tower, CLIP vision
encode, unCLIP conditioning, the KSampler's ADM vector), the x4 upscaler's
noise-augmented image, GLIGEN at its two paths, the style adapter from
CLIPVisionLoader's tower, and Zero123 through the KSampler's cc_projection.

Files are written here (the unCLIP checkpoint by chip_smoke's writer, a
GLIGEN file by chip_smoke.gligen_flat at the tiny UNet's widths, a style
file, a CLIP vision file); the loaded bf16 UNet and VAE are widened to f32
in both caches after a first load is compared leaf for leaf. Randomness is
JAX's, handed in: the KSampler's noise and sampler draws (``jax_noise``),
and noise_aug's draws (``jax_aug_noise``). Every node's output is compared
with ``same`` within TOL (f32: summation order only).

Found and held here (ROADMAP queue 3): the JAX StyleModelApply reads the
vision output's ``last_hidden_state`` attribute, and CLIPVisionEncode gives
a dict, so the graph CLIPVisionEncode -> StyleModelApply fails in JAX; the
port reads either. unCLIPCheckpointLoader reads a transformers-layout tower
only: an open_clip-layout one falls back to the tiny random tower, whose
32-wide embeds do not fit an SD2.1-unclip-H ADM, and the KSampler fails in
both packages.
"""

from __future__ import annotations

import collections
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_executor import TOL, graphs, jax_noise
from test_torch_noise_aug import jax_aug_noise
from test_torch_nodes_parity import (  # noqa: F401  (fixtures used by name)
    CONSTS,
    Pair,
    as_jax,
    const_nodes,
    image_model_files,
    jax_config,
    models,
    same,
    tiny_sd15,
    vision_pair,
)

import stable_renderer_tpu.workflow.executor as je
import stable_renderer_tpu_torch.workflow.executor as pe

torch.set_num_threads(1)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float()
    if hasattr(tree, "dtype") and hasattr(tree, "shape"):
        return jnp.asarray(tree, jnp.float32)
    return tree


def widened(outputs):
    """A loader's outputs with every model dict's params widened to f32."""
    return tuple({**o, "params": _f32(o["params"])} if isinstance(o, dict) and "params" in o
                 else o for o in outputs)


def executors(spec, model_dirs):
    jwf, pwf = graphs(spec)
    return (je.PromptExecutor(jwf, model_dirs=tuple(map(str, model_dirs))),
            pe.PromptExecutor(pwf, model_dirs=tuple(map(str, model_dirs)), device="cpu"))


def run_widened(spec, model_dirs, loaders, monkeypatch, seeds):
    """Both executors over ``spec``: the loader nodes run once and their
    trees compared bit for bit, then widened to f32 in both caches, JAX's
    draws handed in, and every node's output compared but the tests' own
    (``_``-named) nodes'. Returns (JAX
    outputs, port outputs, port executor)."""
    jex, pex = executors([r for r in spec if r[0] in loaders], model_dirs)
    jo, po = jex.execute().outputs, pex.execute().outputs
    for nid in loaders:
        same(po[nid], jo[nid], dict(atol=0, rtol=0))
    jex, pex = executors(spec, model_dirs)
    for nid in loaders:
        jex._cache[nid], pex._cache[nid] = widened(jo[nid]), widened(po[nid])
    jax_noise(monkeypatch, set(seeds))
    jax_aug_noise(monkeypatch)
    jo, po = jex.execute().outputs, pex.execute().outputs
    helpers = {r[0] for r in spec if r[1].startswith("_")}  # the tests' own nodes
    for nid in po:
        if nid not in loaders and nid not in helpers:
            same(po[nid], jo[nid], TOL, f"node {nid}")
    return jo, po, pex


# --- unCLIP -----------------------------------------------------------------------------


def unclip_spec(entries: int, name: str = "unclip.safetensors") -> list:
    """unCLIPCheckpointLoader -> two prompts -> CLIPVisionEncode of a 12x20
    image with the checkpoint's tower -> ``entries`` unCLIPConditioning on
    the positive (strengths 1.0, 0.5, 0.8; noise augmentation 0.1, 0.1,
    0.3) -> KSampler (euler, 2 steps, cfg 2) on a 64x64 empty latent ->
    VAEDecode."""
    rows = [(1, "unCLIPCheckpointLoader", [name], {}),
            (2, "CLIPTextEncode", ["a red ball"], {"clip": (1, 1)}),
            (3, "CLIPTextEncode", ["blurry"], {"clip": (1, 1)}),
            (4, "_Const", ["image2"], {}),
            (5, "CLIPVisionEncode", [], {"clip_vision": (1, 3), "image": (4, 0)})]
    src = 2
    for i, (s, a) in enumerate(((1.0, 0.1), (0.5, 0.1), (0.8, 0.3))[:entries]):
        rows.append((6 + i, "unCLIPConditioning", [s, a],
                     {"conditioning": (src, 0), "clip_vision_output": (5, 0)}))
        src = 6 + i
    return rows + [(10, "EmptyLatentImage", [64, 64, 1], {}),
                   (11, "KSampler", [12, "fixed", 2, 2.0, "euler", "normal", 1.0],
                    {"model": (1, 0), "positive": (src, 0), "negative": (3, 0),
                     "latent_image": (10, 0)}),
                   (12, "VAEDecode", [], {"samples": (11, 0), "vae": (1, 2)})]


@pytest.mark.parametrize("entries", [1, 3])
def test_unclip_graph_matches_jax(monkeypatch, image_model_files, entries):
    """The tiny SD2.1-unclip-H file: the loader's four outputs leaf for leaf
    (the embedded ViT-H-deep tower detected), then CLIP vision encode, the
    conditioning entries, the KSampler's latent (one entry, and three: the
    merge path) and the decode within TOL."""
    jo, po, _ = run_widened(unclip_spec(entries), (image_model_files,), (1,), monkeypatch,
                            (12,))
    assert po[1][0]["noise_aug_dim"] == 1024 and po[1][0]["family"] == "sd21-unclip"
    assert po[1][3]["model"].config.num_layers == 32
    assert tuple(po[5][0]["image_embeds"].shape) == (1, 1024)
    assert len(po[5 + entries][0]["unclip"]) == entries
    assert torch.isfinite(po[12][0]).all()


def test_unclip_open_clip_tower_falls_back_in_both(monkeypatch, image_model_files):
    """An unCLIP file whose tower is in open_clip's layout
    (embedder.model.visual.transformer.resblocks.*): both loaders warn and
    give the tiny random tower (projection 32), and the KSampler fails in
    both, its 32-wide embeds against the 2048-wide ADM."""
    import stable_renderer_tpu.workflow.nodes_parity as jparity

    import stable_renderer_tpu_torch.workflow.nodes_parity as pparity
    from stable_renderer_tpu_torch.models.weights import read_safetensors, write_safetensors

    warned = []
    for mod in (jparity, pparity):
        monkeypatch.setattr(mod.logger, "warning", lambda msg, _m=mod: warned.append((_m, msg)))
    flat = {k: v for k, v in read_safetensors(image_model_files / "unclip.safetensors").items()
            if not k.startswith("embedder.")}
    for k in ("conv1.weight", "class_embedding", "transformer.resblocks.0.attn.in_proj_weight",
              "transformer.resblocks.31.ln_1.weight", "proj"):
        flat["embedder.model.visual." + k] = torch.zeros(4, 4)
    write_safetensors(flat, image_model_files / "unclip_open_clip.safetensors")
    spec = unclip_spec(1, "unclip_open_clip.safetensors")
    kw = dict(model_dirs=(str(image_model_files),))
    for mod, wf in zip((je, pe), graphs([r for r in spec if r[0] <= 5])):
        out = mod.PromptExecutor(wf, **kw, **({} if mod is je else {"device": "cpu"})).execute()
        assert out.outputs[1][3]["model"].config.projection_dim == 32
        assert tuple(out.outputs[5][0]["image_embeds"].shape) == (1, 32)
    for mod, wf in zip((je, pe), graphs(spec)):
        ex = mod.PromptExecutor(wf, **kw, **({} if mod is je else {"device": "cpu"}))
        with pytest.raises(mod.NodeExecutionError) as ei:
            ex.execute()
        assert ei.value.details["node_type"] == "KSampler"
    assert [m for m, msg in warned if msg.startswith("unCLIP embedder layout unrecognized")] == [
        jparity, pparity] * 2


# --- the x4 upscaler ---------------------------------------------------------------------


def test_x4_graph_matches_jax(monkeypatch, image_model_files):
    """The tiny x4 file: SD_4XUpscale_Conditioning (scale 4, noise
    augmentation 0.2) -> KSampler: the image resized to the latent, noise-
    augmented on the linear schedule (JAX's draw), its level the class
    label -> VAEDecode, within TOL."""
    import chip_smoke

    chip_smoke.write_family_file("x4", image_model_files / "x4.safetensors", torch.float32)
    spec = [(1, "CheckpointLoaderSimple", ["x4.safetensors"], {}),
            (2, "CLIPTextEncode", ["a sharp photo"], {"clip": (1, 1)}),
            (3, "CLIPTextEncode", ["blurry"], {"clip": (1, 1)}),
            (4, "_Const", ["image"], {}),
            (5, "SD_4XUpscale_Conditioning", [4.0, 0.2],
             {"images": (4, 0), "positive": (2, 0), "negative": (3, 0)}),
            (6, "KSampler", [21, "fixed", 2, 2.0, "euler", "normal", 1.0],
             {"model": (1, 0), "positive": (5, 0), "negative": (5, 1), "latent_image": (5, 2)}),
            (7, "VAEDecode", [], {"samples": (6, 0), "vae": (1, 2)})]
    jo, po, _ = run_widened(spec, (image_model_files,), (1,), monkeypatch, (21,))
    assert po[1][0]["family"] == "sd-x4-upscaler"
    assert tuple(po[6][0]["samples"].shape) == (1, 16, 16, 4)


# --- GLIGEN ---------------------------------------------------------------------------------


def gligen_spec(area_strength=None) -> list:
    """A tiny SD1.x checkpoint -> prompts -> GLIGENLoader -> two
    GLIGENTextBoxApply boxes (optionally ConditioningSetAreaStrength, which
    puts the KSampler on the cond-list path) -> KSampler; beside it the same
    KSampler on the ungrounded prompt; both decoded."""
    pos = 6
    rows = [(1, "CheckpointLoaderSimple", ["sd.safetensors"], {}),
            (2, "CLIPTextEncode", ["a cat and a dog on grass"], {"clip": (1, 1)}),
            (3, "CLIPTextEncode", ["blurry"], {"clip": (1, 1)}),
            (4, "GLIGENLoader", ["gligen.safetensors"], {}),
            (5, "GLIGENTextBoxApply", ["a cat", 32, 24, 8, 16],
             {"conditioning_to": (2, 0), "clip": (1, 1), "gligen_textbox_model": (4, 0)}),
            (6, "GLIGENTextBoxApply", ["a dog", 24, 32, 32, 24],
             {"conditioning_to": (5, 0), "clip": (1, 1), "gligen_textbox_model": (4, 0)}),
            (7, "EmptyLatentImage", [64, 64, 1], {})]
    plain = 2
    if area_strength is not None:
        rows += [(8, "ConditioningSetAreaStrength", [area_strength], {"conditioning": (6, 0)}),
                 (9, "ConditioningSetAreaStrength", [area_strength], {"conditioning": (2, 0)})]
        pos, plain = 8, 9
    for nid, p in ((10, pos), (12, plain)):
        rows += [(nid, "KSampler", [31, "fixed", 2, 2.0, "euler", "normal", 1.0],
                  {"model": (1, 0), "positive": (p, 0), "negative": (3, 0),
                   "latent_image": (7, 0)}),
                 (nid + 1, "VAEDecode", [], {"samples": (nid, 0), "vae": (1, 2)})]
    return rows


@pytest.fixture
def gligen_files(tmp_path, tiny_sd15):
    """A tiny SD1.x checkpoint (context 768, 8 heads) and a GLIGEN file of
    one fuser a transformer at its width, key width 768 (8 heads a fuser),
    the position net 768 -> 768."""
    import chip_smoke
    from test_torch_checkpoint_pipeline import _unet_config, _write_checkpoint

    from stable_renderer_tpu_torch.models.weights import write_safetensors

    _write_checkpoint(tmp_path / "sd.safetensors")
    flat = chip_smoke.gligen_flat(_unet_config(), 768, torch.Generator().manual_seed(4),
                                  torch.float32)
    write_safetensors(flat, tmp_path / "gligen.safetensors")
    return tmp_path


@pytest.mark.parametrize("path", ["cfg", "cond_list"])
def test_gligen_graph_matches_jax(monkeypatch, gligen_files, path):
    """GLIGENLoader (leaf for leaf, 8 heads a fuser at key width 768), the
    two boxes' position params, and both KSamplers within TOL. On the plain
    CFG path the grounded latent moves away from the ungrounded one; on the
    cond-list path (an area strength) the fusers never run and the two are
    equal, in both packages. With every fuser's gates zeroed, the port's
    grounded latent equals the ungrounded one bit for bit."""
    import chip_smoke
    from test_torch_checkpoint_pipeline import _unet_config

    spec = gligen_spec(0.7 if path == "cond_list" else None)
    jo, po, pex = run_widened(spec, (gligen_files,), (1, 4), monkeypatch, (31,))
    gl = po[4][0]
    blocks = chip_smoke.transformer_blocks(_unet_config())
    assert gl.fuser_heads == [8] * len(blocks) == jo[4][0].fuser_heads
    assert [f["linear"]["weight"].shape[0] for f in gl.fusers] == [w for _, w in blocks]
    assert [p[1:] for p in po[6][0]["gligen"][2]] == [(3, 4, 2, 1), (4, 3, 3, 4)]
    grounded, plain = po[10][0]["samples"], po[12][0]["samples"]
    jgap = float(np.abs(np.asarray(jo[10][0]["samples"]) - np.asarray(jo[12][0]["samples"])).max())
    if path == "cfg":
        assert float((grounded - plain).abs().max()) > 1e-3 and jgap > 1e-3
        for f in gl.fusers:
            f["alpha_attn"] = torch.zeros_like(f["alpha_attn"])
            f["alpha_dense"] = torch.zeros_like(f["alpha_dense"])
        del pex._cache[10], pex._cache[11]
        out = pex.execute().outputs[10][0]["samples"]
        assert torch.equal(out, plain)
    else:
        assert torch.equal(grounded, plain) and jgap == 0.0


# --- the style adapter ------------------------------------------------------------------------


def style_spec(style_negative: bool = True) -> list:
    """A tiny SD1.x checkpoint -> prompts -> CLIPVisionLoader ->
    CLIPVisionEncode -> (_AsVisionOutput) -> StyleModelLoader ->
    StyleModelApply on the positive and (``style_negative``) on the negative
    -> KSampler -> VAEDecode. The plain CFG path batches the two contexts
    whole, so both must hold 77 + 8 tokens."""
    neg = 13 if style_negative else 3
    rows = [(1, "CheckpointLoaderSimple", ["sd.safetensors"], {}),
            (2, "CLIPTextEncode", ["a house"], {"clip": (1, 1)}),
            (3, "CLIPTextEncode", ["blurry"], {"clip": (1, 1)}),
            (4, "CLIPVisionLoader", ["vision_l.safetensors"], {}),
            (5, "_Const", ["image2"], {}),
            (6, "CLIPVisionEncode", [], {"clip_vision": (4, 0), "image": (5, 0)}),
            (7, "_AsVisionOutput", [], {"output": (6, 0)}),
            (8, "StyleModelLoader", ["style_768.safetensors"], {}),
            (9, "StyleModelApply", [], {"conditioning": (2, 0), "style_model": (8, 0),
                                        "clip_vision_output": (7, 0)}),
            (10, "EmptyLatentImage", [64, 64, 1], {}),
            (11, "KSampler", [41, "fixed", 2, 2.0, "euler", "normal", 1.0],
             {"model": (1, 0), "positive": (9, 0), "negative": (neg, 0),
              "latent_image": (10, 0)}),
            (12, "VAEDecode", [], {"samples": (11, 0), "vae": (1, 2)})]
    if style_negative:
        rows.append((13, "StyleModelApply", [], {"conditioning": (3, 0), "style_model": (8, 0),
                                                 "clip_vision_output": (7, 0)}))
    return rows


def test_style_graph_matches_jax(monkeypatch, image_model_files):
    """CLIPVisionLoader (a ViT-L-deep narrow file), CLIPVisionEncode,
    StyleModelLoader (``transformer_layes.`` keys, context 768, 8 tokens),
    StyleModelApply (77 + 8 tokens, on both conds) and the KSampler within
    TOL. JAX's StyleModelApply needs the vision output's attribute: between
    CLIPVisionEncode and it, an ``_AsVisionOutput`` node makes JAX's a
    VisionOutput and passes the port's dict on unchanged; without it the JAX
    graph fails where the port's runs. A styled positive beside a 77-token
    negative fails in the KSampler's CFG batch in both packages."""
    import chip_smoke
    from test_torch_checkpoint_pipeline import _write_checkpoint

    import stable_renderer_tpu.models.clip_vision as jcv

    from stable_renderer_tpu_torch.models import clip_vision as pcv
    from stable_renderer_tpu_torch.models.t2i_adapter import StyleAdapterConfig
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    d = image_model_files
    _write_checkpoint(d / "sd.safetensors")
    g = torch.Generator().manual_seed(12)
    write_safetensors(flatten(pcv.CLIPVisionModel(pcv.VITL_CONFIG).init(g)),
                      d / "vision_l.safetensors")
    write_safetensors(chip_smoke.style_flat(StyleAdapterConfig(
        width=32, context_dim=768, num_head=8, n_layers=3, num_token=8), g, torch.float32),
        d / "style_768.safetensors")
    je.register_node("_AsVisionOutput")(
        lambda ctx, node, output=None: (jcv.VisionOutput(**output),))
    pe.register_node("_AsVisionOutput")(lambda ctx, node, output=None: (output,))
    try:
        jo, po, _ = run_widened(style_spec(), (d,), (1, 4, 8), monkeypatch, (41,))
        assert tuple(po[9][0]["context"].shape) == tuple(po[13][0]["context"].shape) == (
            1, 85, 768)
        assert po[8][0]["model"].config.num_token == 8
        spec = [r if r[0] not in (9, 13) else (r[0], r[1], r[2], {
            **r[3], "clip_vision_output": (6, 0)}) for r in style_spec() if r[0] != 7]
        jwf, pwf = graphs(spec)
        with pytest.raises(je.NodeExecutionError, match="last_hidden_state"):
            je.PromptExecutor(jwf, model_dirs=(str(d),)).execute()
        out = pe.PromptExecutor(pwf, model_dirs=(str(d),), device="cpu").execute().outputs
        assert tuple(out[13][0]["context"].shape) == (1, 85, 768)
        for mod, wf in zip((je, pe), graphs(style_spec(style_negative=False))):
            ex = mod.PromptExecutor(wf, model_dirs=(str(d),),
                                    **({} if mod is je else {"device": "cpu"}))
            with pytest.raises(mod.NodeExecutionError) as ei:
                ex.execute()
            assert ei.value.details["node_type"] == "KSampler"
    finally:
        je.NODE_REGISTRY.pop("_AsVisionOutput", None)
        pe.NODE_REGISTRY.pop("_AsVisionOutput", None)


# --- Zero123 ------------------------------------------------------------------------------------


def vae8_pair(seed: int = 10):
    """A narrow VAE of both packages that downsamples by 8, as SD's does (the
    batched node sizes its latent by 8), the port's init copied into JAX's."""
    import stable_renderer_tpu.models as jm

    from stable_renderer_tpu_torch.models.vae import VAE, VAEConfig

    cfg = VAEConfig(ch=16, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
    params = VAE(cfg).init(torch.Generator().manual_seed(seed))
    return Pair({"vae": jm.VAE(jax_config(jm.VAEConfig, cfg)), "params": as_jax(params)},
                {"vae": VAE(cfg), "params": params})


def zero123_pair(seed: int = 9):
    """A tiny Zero123 model of both packages: the tiny UNet with 8 input
    channels and cc_projection (36 = the tiny tower's 32 + the camera's 4
    -> the UNet's context width), the port's init copied into JAX's."""
    import stable_renderer_tpu.models as jm
    from stable_renderer_tpu.models.sampling import ModelSampling as JMS

    from stable_renderer_tpu_torch.models.sampling import ModelSampling
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG, UNetModel

    g = torch.Generator().manual_seed(seed)
    ucfg = replace(TINY_UNET_CONFIG, in_channels=8)
    unet = UNetModel(ucfg)
    params = unet.init(g)
    ccp = {"weight": torch.randn((ucfg.context_dim, 36), generator=g) * 0.1,
           "bias": torch.randn((ucfg.context_dim,), generator=g) * 0.1}
    return Pair({"unet": jm.UNetModel(jax_config(jm.UNetConfig, ucfg)), "params": as_jax(params),
                 "sampling": JMS(), "cc_projection": as_jax(ccp)},
                {"unet": unet, "params": params, "sampling": ModelSampling(),
                 "cc_projection": ccp})


@pytest.mark.parametrize("batched", [False, True])
def test_zero123_graph_matches_jax(monkeypatch, batched):
    """StableZero123_Conditioning (one view) and its batched node (three
    views stepped in elevation and azimuth), with a VAE that downsamples by
    8 -> KSampler, whose cc_projection
    maps [image embed, camera] onto the UNet's context (the negative's
    zeros padded to 36 first) -> VAEDecode, within TOL."""
    CONSTS.update(zero123=zero123_pair(), vision=vision_pair(), vae8=vae8_pair())
    if batched:
        cond = (4, "StableZero123_Conditioning_Batched", [32, 32, 3, 10.0, 20.0, 5.0, 15.0],
                {"clip_vision": (2, 1), "init_image": (3, 0), "vae": (2, 2)})
    else:
        cond = (4, "StableZero123_Conditioning", [32, 32, 1, 10.0, 30.0],
                {"clip_vision": (2, 1), "init_image": (3, 0), "vae": (2, 2)})
    spec = [(2, "_Const", ["zero123", "vision", "vae8"], {}),
            (3, "_Const", ["image"], {}), cond,
            (5, "KSampler", [51, "fixed", 2, 2.5, "euler", "normal", 1.0],
             {"model": (2, 0), "positive": (4, 0), "negative": (4, 1), "latent_image": (4, 2)}),
            (6, "VAEDecode", [], {"samples": (5, 0), "vae": (2, 2)})]
    jex, pex = executors(spec, ())
    jax_noise(monkeypatch, {51})
    jo, po = jex.execute().outputs, pex.execute().outputs
    for nid in (4, 5, 6):
        same(po[nid], jo[nid], TOL, f"node {nid}")
    assert po[5][0]["samples"].shape[0] == (3 if batched else 1)


# --- K1 on the card's graphs, counted on the meta device ------------------------------------------


@pytest.mark.parametrize("graph", ["unclip_768", "gligen_512"])
def test_k1_launches_an_execute_match_chip_smoke(monkeypatch, graph):
    """K1's calls an execute by (BH, Lq, Lk, d), counted on the meta device
    at full width: SD2.1-unclip-H at 768x768 (cfg batch 2: level 0's 5
    self-attentions at 5 heads of 64, level 1's 5 at 10; the bf16 VAE's
    decode) and grounded SD1.5 at 512x512 (level 0's 5 self-attentions at 8
    heads of 40; its 5 fusers on the positive row over 4096 + 30 tokens;
    the decode); 4 UNet evaluations. They are chip_smoke.UNCLIP_K1_SHAPES
    and GLIGEN_K1_SHAPES, which phase 26 holds on the card."""
    import chip_smoke

    from stable_renderer_tpu_torch.models.gligen import Gligen, load_gligen
    from stable_renderer_tpu_torch.models.unet import SD15_UNET_CONFIG, AttnHooks, UNetModel
    from stable_renderer_tpu_torch.models.vae import SD15_VAE_CONFIG, VAE
    from stable_renderer_tpu_torch.ops import flash_attention as fa

    seen = collections.Counter()

    def counted(q, k, v):
        seen[(q.shape[0], q.shape[1], k.shape[1], q.shape[2])
             + (("f32",) if q.dtype == torch.float32 else ())] += 1
        return torch.empty_like(q)

    monkeypatch.setattr(fa, "flash_attention", counted)
    bf = torch.bfloat16

    def meta(*shape, dtype=bf):
        return torch.empty(shape, device="meta", dtype=dtype)

    hooks = AttnHooks()
    if graph == "unclip_768":
        ucfg, size, ctx_len, want = (replace(SD15_UNET_CONFIG, context_dim=1024, head_dim=64,
                                             adm_in_channels=2048), 768, 77,
                                     chip_smoke.UNCLIP_K1_SHAPES)
    else:
        ucfg, size, ctx_len, want = SD15_UNET_CONFIG, 512, 85, chip_smoke.GLIGEN_K1_SHAPES
        gl = load_gligen(chip_smoke.gligen_flat(ucfg, 768, None, bf, device="meta"),
                         device="meta")
        assert isinstance(gl, Gligen) and len(gl.fusers) == 16
        hooks = AttnHooks(mid=gl.make_mid_hook(meta(1, 30, 768)))
    unet, vae = UNetModel(ucfg), VAE(SD15_VAE_CONFIG)
    up = unet.init(device="meta", dtype=bf)
    vp = vae.init(device="meta", dtype=bf)
    lat = size // 8
    y = None if ucfg.adm_in_channels is None else meta(2, ucfg.adm_in_channels)
    with torch.no_grad():
        def mid(x, layer):  # the CFG wrapper's: the positive row only
            return torch.cat([hooks.mid(x[:1], layer), x[1:]], 0)

        unet.apply(up, meta(2, lat, lat, 4), meta(2, dtype=torch.float32),
                   meta(2, ctx_len, ucfg.context_dim), y=y,
                   hooks=AttnHooks(mid=mid) if hooks.mid is not None else AttnHooks())
        frame = collections.Counter({k: 4 * n for k, n in seen.items()})
        seen.clear()
        vae.decode(vp, meta(1, lat, lat, 4))
    frame.update(seen)
    assert dict(frame) == want


def test_photomaker_mlp_is_the_tanh_form():
    """PhotoMaker's MLP against JAX's within TOL, and the erf GELU outside
    it: the port keeps jax.nn.gelu's default (the tanh form)."""
    import stable_renderer_tpu.workflow.nodes_extra as jextra

    import stable_renderer_tpu_torch.workflow.nodes_extra as pextra
    from stable_renderer_tpu_torch.models.layers import layer_norm, linear

    g = torch.Generator().manual_seed(13)
    p = {"layernorm": {"weight": torch.ones(16), "bias": torch.zeros(16)},
         "fc1": {"weight": torch.randn((32, 16), generator=g), "bias": torch.zeros(32)},
         "fc2": {"weight": torch.randn((16, 32), generator=g), "bias": torch.zeros(16)}}
    x = torch.randn((3, 16), generator=g)
    for residual in (False, True):
        got = pextra._pm_mlp(p, x, residual)
        want = jextra._pm_mlp(as_jax(p), jnp.asarray(x.numpy()), residual)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    erf = linear(p["fc2"], torch.nn.functional.gelu(linear(p["fc1"], layer_norm(p["layernorm"],
                                                                               x))))
    assert float((erf - pextra._pm_mlp(p, x, False)).abs().max()) > 10 * TOL["atol"]
