"""The SDXL and SD2 pipelines of the port against the JAX package's, on the
CPU at tiny widths: prepare_conditioning's three ADM paths (plain, scene,
refiner) and their denoisers, one tiny SDXL ``frame_step``, and tiny SD2,
SDXL and refiner files through both executors' CheckpointLoaderSimple, the
SDXL text-encode nodes, KSampler and VAEDecode.

The helpers, the tiny family files and the bars (f32, TOL) are
tests/test_torch_model_families.py's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model_families import (  # noqa: F401  (tiny_families is a fixture)
    H_TEST,
    RNG_SEED,
    SIZE,
    _family_configs,
    _same_tree,
    as_jax,
    close,
    jcfg,
    tiny_families,
    write_family_file,
)

torch.set_num_threads(1)


# --- the SDXL pipeline ------------------------------------------------------------------


def _jax_sdxl_pipe(pipe, jconfig):
    """The JAX pipeline over the port's tiny SDXL (or refiner) pipeline's
    numbers."""
    import stable_renderer_tpu.models as jm
    import stable_renderer_tpu.models.clip as jclip
    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.models.sampling import ModelSampling as JMS

    jccfg = jcfg(jm.CLIPConfig, pipe.clip.config)
    jpipe = JPipe(
        unet=jm.UNetModel(jcfg(jm.UNetConfig, pipe.unet.config)),
        vae=jm.VAE(jcfg(jm.VAEConfig, pipe.vae.config)),
        clip=jm.CLIPTextModel(jccfg), tokenizer=jm.Tokenizer(jccfg),
        unet_params=as_jax(pipe.unet_params), vae_params=as_jax(pipe.vae_params),
        clip_params=as_jax(pipe.clip_params), config=jconfig,
        model_sampling=JMS(prediction=pipe.model_sampling.prediction),
        clip_g=jclip.OpenCLIPTextModel(jcfg(jclip.OpenCLIPConfig, pipe.clip_g.config)),
        clip_g_params=as_jax(pipe.clip_g_params))
    jpipe.model_family = pipe.model_family
    return jpipe


def _tiny_refiner(pipe):
    """A tiny refiner-shaped pipeline: the SDXL pipeline's G tower alone
    (no CLIP-L), a UNet at G's width with the 2560-style ADM (G's projection
    + 5 Fourier rows)."""
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.models.unet import UNetModel

    ucfg = replace(pipe.unet.config, context_dim=pipe.clip_g.config.width,
                   adm_in_channels=pipe.clip_g.config.projection_dim + 5 * 256)
    unet = UNetModel(ucfg)
    return DiffusionPipeline(
        unet=unet, vae=pipe.vae, clip=pipe.clip, tokenizer=pipe.tokenizer,
        unet_params=unet.init(torch.Generator().manual_seed(9)), vae_params=pipe.vae_params,
        clip_params={}, config=pipe.config, model_sampling=pipe.model_sampling, device="cpu",
        clip_g=pipe.clip_g, clip_g_params=pipe.clip_g_params, model_family="sdxl-refiner")


@pytest.mark.parametrize("path", ["plain", "scene", "refiner"])
def test_sdxl_conditioning_paths_match_jax(path):
    """prepare_conditioning of the tiny SDXL pipeline: the dual-tower
    context (clip skip -1 read as -2) and the ADM vectors at the frame's
    size on the plain path, the scene path's (per-sprite contexts, the ADM
    from the environment prompt's pooled embedding), and the refiner's
    (G alone, aesthetic scores 6.0 and 2.5); then the denoiser of each
    path (plain CFG, the scene blend) once over the UNet with those y."""
    from stable_renderer_tpu.data.sprite import EnvPrompt as JEnv, Sprite as JSprite
    from stable_renderer_tpu.models.sampling.assemble import build_denoiser as jbuild
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.models.sampling.assemble import build_denoiser
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(prompt="a ball", cfg_scale=2.0)
    pipe = DiffusionPipeline.from_random(RenderConfig(**kw), family="sdxl", device="cpu")
    if path == "refiner":
        pipe = _tiny_refiner(pipe)
    jpipe = _jax_sdxl_pipe(pipe, JConfig(**kw))
    sprites = {1: ("a red ball", "blurry")}
    if path == "scene":
        sprites[2] = ("a blue cube", "")
    n = 2
    got = pipe.prepare_conditioning({i: Sprite(spriteID=i, prompt=p, negative_prompt=q)
                                     for i, (p, q) in sprites.items()},
                                    (EnvPrompt("a garden"),), n, image_size=(48, SIZE))
    ref = jpipe.prepare_conditioning({i: JSprite(spriteID=i, prompt=p, negative_prompt=q)
                                      for i, (p, q) in sprites.items()},
                                     (JEnv("a garden"),), n, image_size=(48, SIZE))
    assert got[0] == ref[0] and len(got[0]) == (2 if path == "scene" else 0)
    for mine, theirs in zip(got[1:], ref[1:]):
        assert tuple(mine.shape) == tuple(theirs.shape)
        close(mine, theirs)
    assert got[3].shape == (n, pipe.unet.config.adm_in_channels)
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((n, 6, 8, 4)).astype(np.float32)
    masks = None
    if path == "scene":
        masks = rng.uniform(size=(3, n, 6, 8)).astype(np.float32)
    log_sigmas = np.log(pipe.model_sampling.sigmas)
    opts = dict(cfg_scale=2.0, prediction="eps")
    ctx = {} if path == "scene" else {"cond_context": got[1]}
    sc = {"scene_contexts": got[1], "scene_masks": torch.from_numpy(masks)} \
        if path == "scene" else {}
    den = build_denoiser(pipe.unet, pipe.unet_params, uncond_context=got[2],
                         log_sigmas=torch.from_numpy(log_sigmas), y_cond=got[3], y_uncond=got[4],
                         **ctx, **sc, **opts)
    jctx = {} if path == "scene" else {"cond_context": ref[1]}
    jsc = {"scene_contexts": ref[1], "scene_masks": jnp.asarray(masks)} \
        if path == "scene" else {}
    jden = jbuild(jpipe.unet, jpipe.unet_params, uncond_context=ref[2],
                  log_sigmas=jnp.asarray(log_sigmas), y_cond=ref[3], y_uncond=ref[4],
                  **jctx, **jsc, **opts)
    close(den(torch.from_numpy(x), torch.tensor(3.5)),
          jax.jit(jden)(jnp.asarray(x), jnp.float32(3.5)))


def test_sdxl_frame_step_matches_jax():
    """One tiny SDXL frame (from_random(family="sdxl")) through both
    packages' frame_step on the bench sphere at 64x64: dual-tower
    conditioning, the ADM vectors at the frame's size, 4-step LCM over
    sgm_uniform at cfg 2.0 with the corresponder's hooks, JAX's sampler
    draws handed to the port; the pipeline's towers, VAE scale and widths
    are JAX's from_random's."""
    from test_torch_frame import _bench_camera

    from stable_renderer_tpu.data.sprite import EnvPrompt as JEnv, Sprite as JSprite
    from stable_renderer_tpu.engine.frame_program import frame_step as j_frame_step
    from stable_renderer_tpu.engine.mesh import Mesh as JMesh
    from stable_renderer_tpu.engine.render_exec import mesh_device_buffers as j_buffers
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap
    from stable_renderer_tpu.ops.gbuffer import RENDER_MODE_BAKING, DrawUniforms as JUniforms
    from stable_renderer_tpu.ops.postprocess import PostProcessParams as JPP
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.engine.frame_program import frame_step
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.ops.gbuffer import DrawUniforms
    from stable_renderer_tpu_torch.ops.postprocess import PostProcessParams
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform")
    pipe = DiffusionPipeline.from_random(RenderConfig(**kw), family="sdxl", device="cpu")
    # JAX's from_random(family="sdxl", tiny=True) widths
    from stable_renderer_tpu.models.clip import TINY_CLIP_CONFIG as JL, TINY_CLIP_G_CONFIG as JG
    from stable_renderer_tpu.models.unet import TINY_SDXL_UNET_CONFIG as JU
    from stable_renderer_tpu.models.vae import TINY_VAE_CONFIG as JV

    assert dataclasses.asdict(pipe.clip.config) == dataclasses.asdict(
        replace(JL, hidden_size=JU.context_dim - JG.width))
    assert dataclasses.asdict(pipe.clip_g.config) == dataclasses.asdict(JG)
    assert dataclasses.asdict(pipe.vae.config) == dataclasses.asdict(JV)
    assert pipe.clip.config.hidden_size + pipe.clip_g.config.width == pipe.unet.config.context_dim
    assert pipe.unet.config.adm_in_channels == 32 + 6 * 256 and pipe.is_sdxl
    assert not pipe._clip_g_only
    jpipe = _jax_sdxl_pipe(pipe, JConfig(**kw))
    mv, proj = _bench_camera()
    bg = np.random.default_rng(7).standard_normal((1, SIZE, SIZE, 4)).astype(np.float32)
    key = np.array([0, 5], np.uint32)
    jsigs = ((JUniforms(sprite_id=1, material_id=1, render_mode=RENDER_MODE_BAKING),
              (512, 512), None, None),)
    jdraws = (dict(buffers=j_buffers(JMesh.Sphere(1.0, 12)), mv=mv, diffuse=None, noise=None,
                   corrmap=None),)
    _, jctx, jnctx, jy, jny = jpipe.prepare_conditioning(
        {1: JSprite(spriteID=1, prompt="a shiny ball")}, (JEnv("a ball"),), 1,
        image_size=(SIZE, SIZE))
    jimages = j_frame_step(
        jpipe, JOverlap(vertex_segments=SIZE * SIZE, update_corrmap=False), (), jsigs, SIZE,
        SIZE, True, False, JPP(), (), True, jdraws, jnp.asarray(proj), jnp.asarray(bg), None,
        jctx, jnctx, jpipe.scheduler_sigmas(), key, *jpipe.compute_params(), jy, jny)[3]
    k = jax.random.fold_in(jnp.asarray(key), 1)
    step_noise = []
    for _ in range(4):
        k, sub = jax.random.split(k)
        step_noise.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (1, SIZE // 2, SIZE // 2, 4)))))  # tiny VAE: factor 2
    sigs = ((DrawUniforms(sprite_id=1, material_id=1, render_mode=2), (512, 512), None, None),)
    draws = (dict(buffers=mesh_device_buffers(Mesh.Sphere(1.0, 12), "cpu"), mv=mv, diffuse=None,
                  noise=None, corrmap=None),)
    _, ctx, nctx, y, ny = pipe.prepare_conditioning(
        {1: Sprite(spriteID=1, prompt="a shiny ball")}, (EnvPrompt("a ball"),), 1,
        image_size=(SIZE, SIZE))
    close(y, jy)
    images = frame_step(
        pipe, OverlapCorresponder(vertex_segments=SIZE * SIZE, update_corrmap=False), (), sigs,
        SIZE, SIZE, True, False, PostProcessParams(), (), True, draws, torch.from_numpy(proj),
        torch.from_numpy(bg), None, ctx, nctx, pipe.scheduler_sigmas(),
        torch.Generator().manual_seed(3), *pipe.compute_params(), y, ny,
        step_noise=step_noise)[3]
    assert images.shape == (1, SIZE, SIZE, 3) and torch.isfinite(images).all()
    close(images, jimages)
    assert float(images.std()) > 1e-3


# --- the executor's loaders and SDXL nodes ------------------------------------------------


@pytest.fixture
def tiny_executor_families(monkeypatch):
    """Both executors' loader configs (module names the loaders read at call
    time) set to the test files'; returns a function that sets the CLIP-L
    config and the G tower's for a kind."""
    import stable_renderer_tpu.models as jmodels
    import stable_renderer_tpu.models.clip as jclip

    import stable_renderer_tpu_torch.models.clip as pclip
    import stable_renderer_tpu_torch.models.vae as pvae

    monkeypatch.setattr(jmodels, "SD15_VAE_CONFIG", jmodels.TINY_VAE_CONFIG)
    monkeypatch.setattr(pvae, "SD15_VAE_CONFIG", pvae.TINY_VAE_CONFIG)
    j_h = jclip.SD2ClipH
    monkeypatch.setattr(jclip, "SD2ClipH", lambda: j_h(jclip.OpenCLIPConfig(**H_TEST)))
    monkeypatch.setattr(pclip, "SD2_CLIP_H_CONFIG", pclip.OpenCLIPConfig(**H_TEST))

    def for_kind(kind):
        _, lcfg, gcfg = _family_configs(kind)
        lcfg = lcfg or pclip.TINY_CLIP_CONFIG
        monkeypatch.setattr(jmodels, "SD15_CLIP_CONFIG", jcfg(jclip.CLIPConfig, lcfg))
        monkeypatch.setattr(pclip, "SD15_CLIP_CONFIG", lcfg)
        monkeypatch.setattr(jclip, "SDXL_CLIP_G_CONFIG", jcfg(jclip.OpenCLIPConfig, gcfg))
        monkeypatch.setattr(pclip, "SDXL_CLIP_G_CONFIG", gcfg)

    return for_kind


def family_graph(kind, name, seed=3, steps=2):
    """CheckpointLoaderSimple -> the family's text encode (CLIPTextEncodeSDXL,
    ...Refiner, or CLIPTextEncode for SD2) for both prompts ->
    EmptyLatentImage (64x64) -> KSampler (euler, cfg 2.0) -> VAEDecode."""
    if kind == "sdxl":
        enc = [(2, "CLIPTextEncodeSDXL", [64, 48, 0, 8, 64, 64, "a red ball", "a ball"],
                {"clip": (1, 1)}),
               (3, "CLIPTextEncodeSDXL", [64, 48, 0, 8, 64, 64, "blurry", "blurry"],
                {"clip": (1, 1)})]
    elif kind == "refiner":
        enc = [(2, "CLIPTextEncodeSDXLRefiner", [6.0, 64, 48, "a red ball"], {"clip": (1, 1)}),
               (3, "CLIPTextEncodeSDXLRefiner", [2.5, 64, 48, "blurry"], {"clip": (1, 1)})]
    else:
        enc = [(2, "CLIPTextEncode", ["a red ball"], {"clip": (1, 1)}),
               (3, "CLIPTextEncode", ["blurry"], {"clip": (1, 1)})]
    if kind != "sd2_small":  # CLIPTextEncode on this CLIP: L alone, or the refiner's G
        enc.append((7, "CLIPTextEncode", ["a red ball"], {"clip": (1, 1)}))
    return [(1, "CheckpointLoaderSimple", [name], {}), *enc,
            (4, "EmptyLatentImage", [64, 64, 1], {}),
            (5, "KSampler", [seed, "fixed", steps, 2.0, "euler", "normal", 1.0],
             {"model": (1, 0), "positive": (2, 0), "negative": (3, 0), "latent_image": (4, 0)}),
            (6, "VAEDecode", [], {"samples": (5, 0), "vae": (1, 2)})]


def _f32_loads(jout, pout):
    """Both loaders' outputs with the UNet and VAE in f32 (the same numbers:
    the bf16 leaves widened)."""
    (jm, jc, jv), (pm, pc, pv) = jout, pout
    jm, jv = ({**d, "params": jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                                      d["params"])} for d in (jm, jv))
    pm, pv = ({**d, "params": _f32(d["params"])} for d in (pm, pv))
    return (jm, jc, jv), (pm, pc, pv)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


@pytest.mark.parametrize("kind", ["sd2_small", "sdxl", "refiner"])
def test_family_graphs_match_jax(tmp_path, monkeypatch, tiny_executor_families, kind):
    """A tiny f32 file of each family through both executors: the loader's
    trees (UNet and VAE bf16, the towers f32; SD2's in the file's type, as
    JAX's node leaves them) bit for bit, the family and its towers
    (``g_only`` for the refiner); then, with the loaded UNet and VAE widened
    to f32 in both caches, the text encodes (the ADM ``y`` of
    CLIPTextEncodeSDXL at its sizes and crops, and of the refiner's at its
    aesthetic scores), the KSampler (JAX's draws handed in) and the decode
    within TOL."""
    from test_torch_executor import graphs, jax_noise

    import stable_renderer_tpu.workflow.executor as je
    import stable_renderer_tpu_torch.workflow.executor as pe

    tiny_executor_families(kind)
    write_family_file(kind, tmp_path / f"{kind}.safetensors", torch.float32)
    spec = family_graph(kind, f"{kind}.safetensors")
    jwf, pwf = graphs(spec[:1])
    jo = je.PromptExecutor(jwf, model_dirs=(str(tmp_path),)).execute().outputs
    po = pe.PromptExecutor(pwf, model_dirs=(str(tmp_path),), device="cpu").execute().outputs
    (jm, jc, jv), (pm, pc, pv) = jo[1], po[1]
    assert (pm["family"], pm["sampling"].prediction) == (jm["family"], jm["sampling"].prediction)
    assert type(pc["clip"]).__name__ == type(jc["clip"]).__name__
    assert sorted(pc) == sorted(jc) and pc.get("g_only") == jc.get("g_only")
    _same_tree(pm["params"], jm["params"], torch.bfloat16)
    _same_tree(pv["params"], jv["params"], torch.bfloat16)
    _same_tree(pc["params"], jc["params"], torch.float32)
    if "params_g" in jc:
        _same_tree(pc["params_g"], jc["params_g"], torch.float32)
    jwf, pwf = graphs(spec)
    jex = je.PromptExecutor(jwf, model_dirs=(str(tmp_path),))
    pex = pe.PromptExecutor(pwf, model_dirs=(str(tmp_path),), device="cpu")
    jex._cache[1], pex._cache[1] = _f32_loads(jo[1], po[1])  # loaders are not re-run
    jax_noise(monkeypatch, {3})
    jo, po = jex.execute().outputs, pex.execute().outputs
    assert po[1] is pex._cache[1]
    if kind != "sd2_small":
        close(po[7][0]["context"], jo[7][0]["context"])
        assert po[7][0]["context"].shape[-1] == (1280 if kind == "refiner" else 1024)
    for nid in (2, 3):
        assert ("y" in po[nid][0]) == ("y" in jo[nid][0]) == (kind != "sd2_small")
        for key in ("context", "y", "pooled"):
            if key in jo[nid][0]:
                close(po[nid][0][key], jo[nid][0][key], what=f"{nid} {key}")
    close(po[5][0]["samples"], jo[5][0]["samples"])
    close(po[6][0], jo[6][0])
    assert float(po[6][0].std()) > 1e-3


def test_executor_sdxl_vae_takes_sd15_scale_like_jax(tmp_path, tiny_executor_families,
                                                     tiny_families):
    """A property of the JAX reference the port keeps (ROADMAP queue 3): the
    executor's CheckpointLoaderSimple builds an SDXL file's VAE with
    SD15_VAE_CONFIG, scale 0.18215, where from_checkpoint takes SDXL's
    0.13025; so a latent decodes differently through the two."""
    import stable_renderer_tpu.workflow.executor as je
    from test_torch_executor import graphs

    import stable_renderer_tpu_torch.workflow.executor as pe
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline

    tiny_executor_families("sdxl")
    tiny_families("sdxl")
    write_family_file("sdxl", tmp_path / "xl.safetensors")
    jwf, pwf = graphs([(1, "CheckpointLoaderSimple", ["xl.safetensors"], {})])
    jv = je.PromptExecutor(jwf, model_dirs=(str(tmp_path),)).execute().outputs[1][2]
    pv = pe.PromptExecutor(pwf, model_dirs=(str(tmp_path),), device="cpu").execute().outputs[1][2]
    assert pv["vae"].config.scale_factor == jv["vae"].config.scale_factor == 0.18215
    pipe = DiffusionPipeline.from_checkpoint(str(tmp_path / "xl.safetensors"), device="cpu")
    assert pipe.vae.config.scale_factor == 0.13025
    z = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 8, 8, 4)).astype(
        np.float32))
    a = pv["vae"].decode(_f32(pv["params"]), z)
    b = pipe.vae.decode(pipe.vae_params, z)
    assert not torch.allclose(a, b, atol=1e-3)
