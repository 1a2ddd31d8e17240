"""``DiffusionPipeline.from_checkpoint`` of the port against the JAX
package's, on the CPU: a tiny SD1.x checkpoint and an LDM-named LoRA written
to ``tmp_path`` load through both packages, then the 64x64 frame runs with
JAX's sampler draws handed in, as tests/test_torch_frame.py runs it.

Both packages build ``SD15_VAE_CONFIG`` and ``SD15_CLIP_CONFIG`` in
``from_checkpoint``; a full-width VAE and CLIP are too heavy here, so the
tests set those names to tiny configs in both pipeline modules (the CLIP at
768 wide, the width an SD1.x UNet's cross-attention takes). The UNet is the
tiny topology at context 768, which detection reads as SD1.x (8 heads).
"""

from __future__ import annotations

from dataclasses import replace

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SIZE = 64
TOL = dict(atol=2e-4, rtol=2e-4)  # f32: summation order only, as tests/test_torch_frame.py


@pytest.fixture
def tiny_towers(monkeypatch):
    """SD15_VAE_CONFIG / SD15_CLIP_CONFIG set to tiny ones in both pipeline
    modules for the test."""
    import stable_renderer_tpu.engine.pipeline as jp
    from stable_renderer_tpu.models.clip import TINY_CLIP_CONFIG as JCLIP
    from stable_renderer_tpu.models.vae import TINY_VAE_CONFIG as JVAE

    import stable_renderer_tpu_torch.engine.pipeline as tp
    from stable_renderer_tpu_torch.models.clip import TINY_CLIP_CONFIG
    from stable_renderer_tpu_torch.models.vae import TINY_VAE_CONFIG

    monkeypatch.setattr(jp, "SD15_VAE_CONFIG", JVAE)
    monkeypatch.setattr(jp, "SD15_CLIP_CONFIG", replace(JCLIP, hidden_size=768))
    monkeypatch.setattr(tp, "SD15_VAE_CONFIG", TINY_VAE_CONFIG)
    monkeypatch.setattr(tp, "SD15_CLIP_CONFIG", replace(TINY_CLIP_CONFIG, hidden_size=768))


def _unet_config(**kw):
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG

    return replace(TINY_UNET_CONFIG, **{"num_heads": 8, "context_dim": 768, **kw})


def same_layout(detected, preset) -> bool:
    """A detected UNetConfig (explicit per-block depths, as JAX's detection
    gives them) builds the UNet of ``preset`` (chip_smoke's check)."""
    import chip_smoke

    return chip_smoke.same_unet_layout(detected, preset)


def _write_checkpoint(path, ucfg=None, dtype=torch.float32) -> dict:
    """A tiny SD1.x checkpoint in the LDM key layout, from the port's inits
    (generator seeded with 0); returns the flat dict written."""
    from stable_renderer_tpu_torch.models.clip import TINY_CLIP_CONFIG, CLIPTextModel
    from stable_renderer_tpu_torch.models.unet import UNetModel
    from stable_renderer_tpu_torch.models.vae import TINY_VAE_CONFIG, VAE
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    g = torch.Generator().manual_seed(0)
    trees = {"model.diffusion_model.": UNetModel(ucfg or _unet_config()).init(g, dtype=dtype),
             "first_stage_model.": VAE(TINY_VAE_CONFIG).init(g, dtype=dtype),
             "cond_stage_model.transformer.": CLIPTextModel(
                 replace(TINY_CLIP_CONFIG, hidden_size=768)).init(g, dtype=dtype)}
    flat = {p + k: v for p, t in trees.items() for k, v in flatten(t).items()}
    write_safetensors(flat, path)
    return flat


def _write_lora(path, flat) -> int:
    """An LCM-LoRA-shaped kohya file (rank 4, F16, LDM names) over every
    attention projection, ff, proj_in and proj_out of the UNet, and the CLIP's
    q projections under ``lora_te_``. Returns the number of modules."""
    from stable_renderer_tpu_torch.models.weights import write_safetensors

    rng = np.random.default_rng(5)
    lora = {}
    for key, w in flat.items():
        if key.startswith("model.diffusion_model."):
            if not (key.endswith(".weight") and any(
                    t in key for t in ("to_q", "to_k", "to_v", "to_out", "ff.net", "proj_in",
                                       "proj_out"))):
                continue
            name = "lora_unet_" + key[len("model.diffusion_model."):-len(".weight")]
        elif key.endswith("q_proj.weight"):
            name = "lora_te_" + key[len("cond_stage_model.transformer."):-len(".weight")]
        else:
            continue
        name = name.replace(".", "_")
        out_f, in_f = w.shape[0], int(np.prod(w.shape[1:]))
        lora[name + ".lora_up.weight"] = (rng.standard_normal((out_f, 4)) * 0.1).astype(np.float16)
        lora[name + ".lora_down.weight"] = (rng.standard_normal((4, in_f)) * 0.1).astype(np.float16)
        lora[name + ".alpha"] = np.asarray(2.0, np.float16)
    write_safetensors(lora, path)
    return len(lora) // 3


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    else:
        x = np.asarray(x)
        x = x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x
    return x.tobytes()


def test_from_checkpoint_with_lora_matches_jax(tmp_path, tiny_towers):
    """The default types (UNet bf16, VAE and CLIP f32) with an F16 LoRA
    merged at strength 0.8: every leaf of the three trees equals JAX's bit
    for bit; the detected config, family, prediction and LoRA module counts
    agree; the trees live on the device asked for."""
    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.models.weights import flatten as j_flatten
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.models.weights import flatten
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    ckpt, lora_path = tmp_path / "tiny.safetensors", tmp_path / "lcm.safetensors"
    flat = _write_checkpoint(ckpt)
    n_modules = _write_lora(lora_path, flat)
    loras = [(str(lora_path), 0.8)]
    jpipe = JPipe.from_checkpoint(str(ckpt), JConfig(), loras=loras)
    pipe = DiffusionPipeline.from_checkpoint(str(ckpt), RenderConfig(), loras=loras,
                                             device="cpu")
    assert same_layout(pipe.unet.config, _unet_config())
    jc = jpipe.unet.config
    assert (jc.model_channels, jc.channel_mult, jc.num_res_blocks, jc.context_dim,
            jc.heads_for(32)) == (32, (1, 2), 1, 768, pipe.unet.config.heads_for(32))
    assert pipe.model_family == jpipe.model_family == "sd1"
    assert pipe.noise_aug_dim is jpipe.noise_aug_dim is None
    assert pipe.model_sampling.prediction == jpipe.model_sampling.prediction == "lcm"
    n_te = sum(1 for k in flat if k.endswith("q_proj.weight"))
    assert pipe.lora_modules_applied == [{"path": str(lora_path), "strength": 0.8,
                                          "unet": n_modules - n_te, "te": n_te}]
    for mine, ref, dt in ((pipe.unet_params, jpipe.unet_params, torch.bfloat16),
                          (pipe.vae_params, jpipe.vae_params, torch.float32),
                          (pipe.clip_params, jpipe.clip_params, torch.float32)):
        mine, ref = flatten(mine), j_flatten(ref)
        assert sorted(mine) == sorted(ref)
        for k, v in mine.items():
            assert v.dtype == dt and v.device.type == "cpu", k
            assert _bits(v) == _bits(ref[k]), k
    # the merge moved the targets: the tree differs from a load without LoRA
    bare = DiffusionPipeline.from_checkpoint(str(ckpt), device="cpu")
    q = "input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"
    assert not torch.equal(flatten(bare.unet_params)[q], flatten(pipe.unet_params)[q])
    assert bare.lora_modules_applied == []


def _bench_frame(jpipe, pipe):
    """The bench frame at 64x64 through JAX's and the port's frame_step with
    the same camera, background noise and corresponder, JAX's LCM draws
    handed to the port. Returns (port images, JAX images)."""
    import jax

    from test_torch_frame import _bench_camera

    from stable_renderer_tpu.data.sprite import EnvPrompt as JEnv, Sprite as JSprite
    from stable_renderer_tpu.engine.frame_program import frame_step as j_frame_step
    from stable_renderer_tpu.engine.mesh import Mesh as JMesh
    from stable_renderer_tpu.engine.render_exec import mesh_device_buffers as j_buffers
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap
    from stable_renderer_tpu.ops.gbuffer import RENDER_MODE_BAKING, DrawUniforms as JUniforms
    from stable_renderer_tpu.ops.postprocess import PostProcessParams as JPP

    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.engine.frame_program import frame_step
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.ops.gbuffer import DrawUniforms
    from stable_renderer_tpu_torch.ops.postprocess import PostProcessParams

    mv, proj = _bench_camera()
    bg = np.random.default_rng(7).standard_normal((1, SIZE, SIZE, 4)).astype(np.float32)
    key = np.array([0, 3], np.uint32)
    jsigs = ((JUniforms(sprite_id=1, material_id=1, render_mode=RENDER_MODE_BAKING),
              (512, 512), None, None),)
    jdraws = (dict(buffers=j_buffers(JMesh.Sphere(1.0, 12)), mv=mv, diffuse=None, noise=None,
                   corrmap=None),)
    _, jctx, jnctx, _, _ = jpipe.prepare_conditioning(
        {1: JSprite(spriteID=1, prompt="a shiny ball")}, (JEnv("a ball"),), 1)
    jimages = j_frame_step(
        jpipe, JOverlap(vertex_segments=SIZE * SIZE, update_corrmap=False), (), jsigs, SIZE,
        SIZE, True, False, JPP(), (), True, jdraws, jnp.asarray(proj), jnp.asarray(bg), None,
        jctx, jnctx, jpipe.scheduler_sigmas(), key, *jpipe.compute_params())[3]
    k = jax.random.fold_in(jnp.asarray(key), 1)
    step_noise = []
    for _ in range(pipe.config.steps):
        k, sub = jax.random.split(k)
        step_noise.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (1, SIZE // 2, SIZE // 2, 4)))))  # tiny VAE: factor 2
    sigs = ((DrawUniforms(sprite_id=1, material_id=1, render_mode=2), (512, 512), None, None),)
    draws = (dict(buffers=mesh_device_buffers(Mesh.Sphere(1.0, 12), "cpu"), mv=mv, diffuse=None,
                  noise=None, corrmap=None),)
    _, ctx, nctx, _, _ = pipe.prepare_conditioning(
        {1: Sprite(spriteID=1, prompt="a shiny ball")}, (EnvPrompt("a ball"),), 1)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), **TOL)
    images = frame_step(
        pipe, OverlapCorresponder(vertex_segments=SIZE * SIZE, update_corrmap=False), (), sigs,
        SIZE, SIZE, True, False, PostProcessParams(), (), True, draws, torch.from_numpy(proj),
        torch.from_numpy(bg), None, ctx, nctx, pipe.scheduler_sigmas(),
        torch.Generator().manual_seed(3), *pipe.compute_params(), step_noise=step_noise)[3]
    return images, jimages


def test_loaded_frame_matches_jax(tmp_path, tiny_towers):
    """The frame from both packages' loaded pipelines (dtype f32, a LoRA
    merged), 4-step LCM with cfg 2.0, within the f32 bars of
    tests/test_torch_frame.py."""
    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    ckpt, lora_path = tmp_path / "tiny.safetensors", tmp_path / "lcm.safetensors"
    _write_lora(lora_path, _write_checkpoint(ckpt))
    kw = dict(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform")
    loras = [(str(lora_path), 1.0)]
    jpipe = JPipe.from_checkpoint(str(ckpt), JConfig(**kw), dtype=jnp.float32, loras=loras)
    pipe = DiffusionPipeline.from_checkpoint(str(ckpt), RenderConfig(**kw), dtype=torch.float32,
                                             loras=loras, device="cpu")
    images, jimages = _bench_frame(jpipe, pipe)
    assert images.shape == (1, SIZE, SIZE, 3) and torch.isfinite(images).all()
    np.testing.assert_allclose(images.numpy(), np.asarray(jimages), **TOL)
    assert float(images.std()) > 1e-3


@pytest.mark.parametrize("case", ["sd2", "inpaint", "sd2_diffusers_folder"])
def test_other_families_raise(tmp_path, tiny_towers, case):
    """Other families than SD1.x, as both packages load them: a 1024-context
    (SD2) file loads in both (family sd2, ``SD2ClipH``, its empty
    ``cond_stage_model.model.`` tree: this file carries a CLIP-L tower), its
    UNet bit for bit; a diffusers folder of another family raises in both,
    as the JAX package loads SD1.x folders only. A 9-channel inpaint SD1.x
    file loads in both packages: the port detects ``in_channels=9`` and its
    three trees equal JAX's bit for bit."""
    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.models.weights import flatten as j_flatten

    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    ucfg = _unet_config(in_channels=9) if case == "inpaint" else _unet_config(context_dim=1024)
    flat = _write_checkpoint(tmp_path / "m.safetensors", ucfg)
    path = tmp_path / "m.safetensors"
    if case in ("inpaint", "sd2"):
        jpipe = JPipe.from_checkpoint(str(path))
        pipe = DiffusionPipeline.from_checkpoint(str(path), device="cpu")
        assert same_layout(pipe.unet.config, replace(ucfg, head_dim=64) if case == "sd2"
                           else ucfg)
        assert jpipe.unet.config.in_channels == pipe.unet.config.in_channels
        want = "sd1" if case == "inpaint" else "sd2"
        assert pipe.model_family == jpipe.model_family == want
        assert type(pipe.clip).__name__ == type(jpipe.clip).__name__ == (
            "CLIPTextModel" if case == "inpaint" else "SD2ClipH")
        for mine, ref in ((pipe.unet_params, jpipe.unet_params),
                          (pipe.vae_params, jpipe.vae_params),
                          (pipe.clip_params, jpipe.clip_params)):
            mine, ref = flatten(mine), j_flatten(ref)
            assert sorted(mine) == sorted(ref)
            for k, v in mine.items():
                assert _bits(v) == _bits(ref[k]), k
        return
    (tmp_path / "folder" / "unet").mkdir(parents=True)  # the tiny UNet's keys as they are
    unet = {k[len("model.diffusion_model."):]: v for k, v in flat.items()
            if k.startswith("model.diffusion_model.")}
    write_safetensors(unet, tmp_path / "folder" / "unet" / "m.safetensors")
    path = tmp_path / "folder"
    for load in (JPipe.from_checkpoint,
                 lambda p: DiffusionPipeline.from_checkpoint(p, device="cpu")):
        with pytest.raises(NotImplementedError, match="SD1.x family.*SDXL/SD2 diffusers"):
            load(str(path))


def test_from_checkpoint_int8_and_the_card(tmp_path, tiny_towers, monkeypatch):
    """``int8_conv`` quantizes the loaded convs (calibrated at 256x256 here:
    at the default 512x512 the CPU takes a minute); without ``device`` the
    load goes to the card, and raises before reading where there is none."""
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    ckpt = tmp_path / "tiny.safetensors"
    _write_checkpoint(ckpt)
    quantize = DiffusionPipeline.quantize_convs
    monkeypatch.setattr(DiffusionPipeline, "quantize_convs",
                        lambda self: quantize(self, render_size=(256, 256)))
    pipe = DiffusionPipeline.from_checkpoint(
        str(ckpt), RenderConfig(int8_conv=True, steps=2), device="cpu")
    assert "weight_q" in pipe.unet_params["input_blocks"]["1"]["0"]["in_layers"]["2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DiffusionPipeline.from_checkpoint(str(tmp_path / "absent.safetensors"))


def test_inpaint_frame_matches_jax(tmp_path, tiny_towers):
    """The bench frame through both packages' loaded 9-channel inpaint
    pipelines with ``keep_background=True`` (the UNet takes the mask and the
    masked latent as its extra channels; the background latent is kept),
    4-step LCM with cfg 2.0, within the f32 bars of
    tests/test_torch_frame.py."""
    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    ckpt = tmp_path / "inpaint.safetensors"
    _write_checkpoint(ckpt, _unet_config(in_channels=9))
    kw = dict(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform",
              keep_background=True)
    jpipe = JPipe.from_checkpoint(str(ckpt), JConfig(**kw), dtype=jnp.float32)
    pipe = DiffusionPipeline.from_checkpoint(str(ckpt), RenderConfig(**kw), dtype=torch.float32,
                                             device="cpu")
    assert pipe.unet.config.in_channels == 9
    images, jimages = _bench_frame(jpipe, pipe)
    assert images.shape == (1, SIZE, SIZE, 3) and torch.isfinite(images).all()
    np.testing.assert_allclose(images.numpy(), np.asarray(jimages), **TOL)
    assert float(images.std()) > 1e-3
