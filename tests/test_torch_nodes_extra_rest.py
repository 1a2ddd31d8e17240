"""The rest of the port's workflow/nodes_extra.py (all but the model-patch
nodes of tests/test_torch_executor_patches.py) against the JAX package's,
node by node, on the CPU at tiny widths: one parametrised case (or more)
per name, with tests/test_torch_nodes_parity.py's helpers (the _Const and
_Models nodes, the comparisons). Pure tensor nodes and the schedules agree
within PURE (1e-6); SamplerCustom and the merges within TOL; the saves
write files that hold the same tensors bit for bit as JAX's, and a
CheckpointSave of the port loads through JAX's load_checkpoint leaf for
leaf. Zero123 and PhotoMaker take the same tiny towers in both packages
(the _Const pairs) or a written file. The video loader reads the tiny SVD
and Zero123 files of tests/test_torch_video_graphs.py's ``video_files``
leaf for leaf, and the Cascade stage loader its stage files. Last, the
registry walk: the two stubs left name ROADMAP 1.13.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_executor import TOL, graphs, run_both
from test_torch_nodes_parity import (  # noqa: F401  (fixtures used by name)
    CONSTS,
    PURE,
    RNG,
    bits,
    const_nodes,
    image_model_files,
    load_both,
    models,
    node_spec,
    output_dirs,
    photomaker_pair,
    run_node,
    same,
    same_tree_bits,
    tiny_sd15,
    vision_pair,
)
from test_torch_video_graphs import video_files  # noqa: F401  (a fixture used by name)

import stable_renderer_tpu.workflow.executor as je
import stable_renderer_tpu_torch.workflow.executor as pe

torch.set_num_threads(1)

F32 = np.float32
CONSTS.update({
    "latent_b5": {"samples": RNG.standard_normal((5, 4, 4, 4)).astype(F32)},
    "alpha_small": RNG.uniform(size=(1, 8, 5)).astype(F32),
    "cond_ctx": {"context": RNG.standard_normal((1, 77, 64)).astype(F32), "controls": [],
                 "prompt": "a boat"},
    "uncond_ctx": {"context": RNG.standard_normal((1, 77, 64)).astype(F32), "controls": [],
                   "prompt": ""},
    "sampler_2m": {"name": "dpmpp_2m", "extra": {}},
    "karras4": np.asarray([14.614642, 4.3, 1.0, 0.2, 0.0], F32),
    "latent_8": {"samples": RNG.standard_normal((1, 8, 8, 4)).astype(F32)},
    "vision": vision_pair(),
    "photomaker": photomaker_pair(),        # projections 32 + 32 = the 64-wide CLIP-L
    "photomaker_narrow": photomaker_pair(proj2=16),  # 48 wide: tiled and blended
})

# (node type, widgets, inputs, tolerance)
CASES = [
    ("KSamplerSelect", ["dpmpp_2m_gpu"], {}, PURE),
    ("SamplerDPMPP_2M_SDE", ["gpu", 0.5], {}, PURE),
    ("SamplerDPMPP_SDE", [0.7], {}, PURE),
    ("BasicScheduler", ["karras", 5, 0.8], {"model": ("m0", 0)}, PURE),
    ("KarrasScheduler", [6, 14.6, 0.03, 7.0], {}, PURE),
    ("ExponentialScheduler", [6, 10.0, 0.05], {}, PURE),
    ("PolyexponentialScheduler", [6, 10.0, 0.05, 1.5], {}, PURE),
    ("VPScheduler", [6, 19.9, 0.1, 0.001], {}, PURE),
    ("SDTurboScheduler", [2, 0.8], {"model": ("m0", 0)}, PURE),
    ("SplitSigmas", [2], {"sigmas": "sigmas"}, PURE),
    ("FlipSigmas", [], {"sigmas": "sigmas"}, PURE),
    ("ModelMergeSimple", [0.3], {"model1": ("m0", 0), "model2": ("m1", 0)}, TOL),
    ("ModelMergeAdd", [], {"model1": ("m0", 0), "model2": ("m1", 0)}, TOL),
    ("ModelMergeSubtract", [0.5], {"model1": ("m0", 0), "model2": ("m1", 0)}, TOL),
    ("ModelMergeBlocks", [0.2, 0.5, 0.9], {"model1": ("m0", 0), "model2": ("m1", 0)}, TOL),
    ("CLIPMergeSimple", [0.4], {"clip1": ("m0", 1), "clip2": ("m1", 1)}, TOL),
    *[("Morphology", [op, k], {"image": "image"}, PURE)
      for op, k in (("erode", 3), ("dilate", 4), ("open", 3), ("close", 5), ("gradient", 3),
                    ("top_hat", 4), ("bottom_hat", 3))],
    *[("PorterDuffImageComposite", [mode],
       {"source": "image", "source_alpha": "soft_mask", "destination": "image_b2",
        "destination_alpha": "mask"}, PURE)
      for mode in ("ADD", "CLEAR", "DARKEN", "DST", "DST_ATOP", "DST_IN", "DST_OUT",
                   "DST_OVER", "LIGHTEN", "MULTIPLY", "OVERLAY", "SCREEN", "SRC", "SRC_ATOP",
                   "SRC_IN", "SRC_OUT", "SRC_OVER", "XOR")],
    ("SplitImageWithAlpha", [], {"image": "rgba"}, PURE),
    ("JoinImageWithAlpha", [], {"image": "image", "alpha": "alpha_small"}, PURE),
    ("RebatchLatents", [2], {"latents": "latent_b5"}, PURE),
    ("RebatchImages", [1], {"images": "image_b2"}, PURE),
    ("SD_4XUpscale_Conditioning", [2.0, 0.1],
     {"images": "image", "positive": "cond", "negative": "cond_short"}, PURE),
    ("VideoLinearCFGGuidance", [1.5], {"model": ("m0", 0)}, PURE),
    ("TomePatchModel", [0.4], {"model": ("m0", 0)}, PURE),
    ("StableCascade_EmptyLatentImage", [1024, 768, 42, 2], {}, PURE),
    ("StableCascade_StageB_Conditioning", [], {"conditioning": "cond", "stage_c": "latent"},
     PURE),
    # the video loader on a tiny file's both branches (their towers as JAX's
    # ImageOnlyCheckpointSave writes them: no projection), and SVD's
    # conditioning on the tiny tower and VAE
    ("ImageOnlyCheckpointLoader", ["svd_bare.safetensors"], {}, PURE, "video_files"),
    ("ImageOnlyCheckpointLoader", ["zero123_bare.safetensors"], {}, PURE, "video_files"),
    ("SVD_img2vid_Conditioning", [32, 24, 3, 127, 6, 0.0],
     {"clip_vision": "vision", "init_image": "image", "vae": ("m0", 2)}, TOL),
    ("SVD_img2vid_Conditioning", [16, 16, 2, 40, 12, 0.0],
     {"clip_vision": "vision", "init_image": "image2", "vae": ("m0", 2)}, TOL),
    # image conditioning; a fifth entry names the fixture whose directory of
    # files the loader reads
    ("StableZero123_Conditioning", [32, 24, 2, 10.0, 30.0],
     {"clip_vision": "vision", "init_image": "image2", "vae": ("m0", 2)}, TOL),
    ("PhotoMakerLoader", ["photomaker.safetensors"], {}, PURE, "image_model_files"),
    ("PhotoMakerEncode", ["photograph of a man photomaker, smiling"],
     {"photomaker": "photomaker", "image": "image", "clip": ("xl", 1)}, TOL),
    ("PhotoMakerEncode", ["photomaker portrait"],
     {"photomaker": "photomaker_narrow", "image": "image_b2", "clip": ("m0", 1)}, TOL),
    ("PhotoMakerEncode", ["a plain photograph"],
     {"photomaker": "photomaker", "image": "image", "clip": ("m0", 1)}, TOL),
]
SAMPLER_NODES = ("SamplerCustom",)
FILE_NODES = ("CheckpointSave", "CLIPSave", "VAESave", "ImageOnlyCheckpointSave",
              "CascadeStageLoader", "UNETLoader")


def _case_id(case):
    return f"{case[0]}-{'-'.join(map(str, case[1]))}"


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_node_matches_jax(monkeypatch, request, case):
    run_node(*case[:3], monkeypatch, tol=case[3],
             model_dirs=[request.getfixturevalue(f) for f in case[4:]])


def test_every_name_of_the_pack_has_a_case():
    """The JAX pack's names less the model patches of
    tests/test_torch_executor_patches.py: 39."""
    import stable_renderer_tpu.workflow.nodes_extra as jextra

    patches = {"FreeU", "FreeU_V2", "HyperTile", "HypernetworkLoader",
               "SelfAttentionGuidance", "PerpNeg", "DifferentialDiffusion"}
    names = {n for n, f in je.NODE_REGISTRY.items()
             if f.__module__ == jextra.__name__} - patches
    assert len(names) == 39
    assert names == {c[0] for c in CASES} | set(SAMPLER_NODES) | set(FILE_NODES)


@pytest.mark.parametrize("add_noise, widgets", [
    (True, ["enable", 13, "fixed", 3.0]),
    (False, ["disable", 13, "fixed", 1.0]),
])
def test_sampler_custom_matches_jax(monkeypatch, add_noise, widgets):
    """SamplerCustom with dpmpp_2m over four Karras sigmas (the noise JAX's,
    handed in), and without noise at cfg 1: both outputs within TOL and the
    same object in both slots, as JAX's."""
    jctx, pctx = run_node(
        "SamplerCustom", widgets,
        {"model": ("m0", 0), "positive": "cond_ctx", "negative": "uncond_ctx",
         "sampler": "sampler_2m", "sigmas": "karras4", "latent_image": "latent_8"},
        monkeypatch, tol=TOL, seeds=(13,))
    out = pctx.outputs[3]
    assert out[0] is out[1]
    moved = (out[0]["samples"] - torch.from_numpy(CONSTS["latent_8"]["samples"])).abs().max()
    assert float(moved) > 1e-3


def test_saves_write_what_jax_writes(monkeypatch, output_dirs):
    """CheckpointSave (f32, the LDM prefixes), CLIPSave, VAESave and
    ImageOnlyCheckpointSave (no CLIP vision) of the same models: each file
    of the port holds the same names, dtypes and bits as JAX's."""
    from safetensors.numpy import load_file

    from stable_renderer_tpu_torch.models.weights import read_safetensors

    spec = [(1, "_Models", ["m0"], {}),
            (2, "CheckpointSave", ["checkpoints/ck"], {"model": (1, 0), "clip": (1, 1),
                                                       "vae": (1, 2)}),
            (3, "CLIPSave", ["clip/te"], {"clip": (1, 1)}),
            (4, "VAESave", ["vae/v"], {"vae": (1, 2)}),
            (5, "ImageOnlyCheckpointSave", ["checkpoints/svd"], {"model": (1, 0),
                                                                 "vae": (1, 2)})]
    jctx, pctx, _, _ = run_both(spec, monkeypatch)
    for nid, rel in ((2, "checkpoints/ck.safetensors"), (3, "clip/te.safetensors"),
                     (4, "vae/v.safetensors"), (5, "checkpoints/svd.safetensors")):
        jpath, ppath = jctx.outputs[nid][0], pctx.outputs[nid][0]
        assert jpath == str(output_dirs[0] / rel) and ppath == str(output_dirs[1] / rel)
        mine, theirs = read_safetensors(ppath), load_file(jpath)
        assert sorted(mine) == sorted(theirs), rel
        for k, v in mine.items():
            assert v.numpy().dtype == theirs[k].dtype and bits(v) == bits(theirs[k]), (rel, k)
    assert any(k.startswith("model.diffusion_model.") for k in read_safetensors(
        output_dirs[1] / "checkpoints/ck.safetensors"))


def test_checkpoint_save_of_the_port_loads_in_jax(tmp_path, monkeypatch, output_dirs,
                                                  tiny_sd15):
    """A tiny SD1.x checkpoint loaded by CheckpointLoaderSimple (UNet and VAE
    bf16, CLIP f32) and written by the port's CheckpointSave (f32): JAX's
    load_checkpoint reads it back leaf for leaf, each the loaded leaf in
    f32."""
    from test_torch_checkpoint_pipeline import _write_checkpoint

    from stable_renderer_tpu.models.weights import flatten as jflatten, load_checkpoint

    from stable_renderer_tpu_torch.models.weights import flatten

    _write_checkpoint(tmp_path / "sd.safetensors")
    _, pwf = graphs([(1, "CheckpointLoaderSimple", ["sd.safetensors"], {}),
                     (2, "CheckpointSave", ["checkpoints/out"],
                      {"model": (1, 0), "clip": (1, 1), "vae": (1, 2)})])
    po = pe.PromptExecutor(pwf, model_dirs=(str(tmp_path),), device="cpu").execute().outputs
    unet_p, vae_p, clip_p, ucfg = load_checkpoint(po[2][0])
    assert ucfg.context_dim == 768
    for tree, (model, _) in ((unet_p, (po[1][0], 0)), (vae_p, (po[1][2], 0)),
                             (clip_p, (po[1][1], 0))):
        mine, theirs = flatten(model["params"]), jflatten(tree)
        assert sorted(mine) == sorted(theirs)
        for k, v in mine.items():
            assert bits(v.float()) == bits(np.asarray(theirs[k], np.float32)), k


def test_unet_loader_matches_jax_and_cascade_stages_raise(tmp_path, tiny_sd15, video_files):
    """UNETLoader / CascadeStageLoader on a bare SD1.x UNet file (both the
    model.diffusion_model.-prefixed and the bare layout) load every leaf as
    JAX's (bf16); on the tiny Stage C and Stage B files (bare, and Stage C
    prefixed) the stage, its shift and every leaf as JAX's; without a file
    both packages build a tiny random stage (Stage B when the name holds
    'stage_b'), the same config and tree shapes."""
    from test_torch_checkpoint_pipeline import _write_checkpoint

    from stable_renderer_tpu.models.weights import flatten as jflatten

    from stable_renderer_tpu_torch.models.weights import (
        flatten,
        read_safetensors,
        write_safetensors,
    )

    flat = _write_checkpoint(tmp_path / "sd.safetensors")
    unet = {k: v for k, v in flat.items() if k.startswith("model.diffusion_model.")}
    write_safetensors(unet, tmp_path / "unet_prefixed.safetensors")
    write_safetensors({k[len("model.diffusion_model."):]: v for k, v in unet.items()},
                      tmp_path / "unet_bare.safetensors")
    write_safetensors({"model.diffusion_model." + k: v for k, v in read_safetensors(
        video_files / "stage_c.safetensors").items()}, tmp_path / "stage_c_prefixed.safetensors")
    spec = [(1, "UNETLoader", ["unet_prefixed.safetensors"], {}),
            (2, "CascadeStageLoader", ["unet_bare.safetensors"], {}),
            (3, "UNETLoader", ["stage_c_prefixed.safetensors"], {}),
            (4, "CascadeStageLoader", [str(video_files / "stage_c.safetensors")], {}),
            (5, "UNETLoader", [str(video_files / "stage_b.safetensors")], {})]
    jo, po = load_both(spec, (tmp_path,))
    for nid in (1, 2):
        same_tree_bits(po[nid][0]["params"], jo[nid][0]["params"], torch.bfloat16)
        assert po[nid][0]["unet"].config.context_dim == 768
    for nid, stage, shift in ((3, "CascadeStageC", 2.0), (4, "CascadeStageC", 2.0),
                              (5, "CascadeStageB", 1.0)):
        (pm,), (jm,) = po[nid], jo[nid]
        same_tree_bits(pm["params"], jm["params"], torch.bfloat16)
        assert type(pm["unet"]).__name__ == type(jm["unet"]).__name__ == stage
        assert pm["sampling"].shift == jm["sampling"].shift == shift
    jo, po = load_both([(1, "CascadeStageLoader", ["absent.safetensors"], {}),
                        (2, "UNETLoader", ["absent_stage_b.safetensors"], {})], (tmp_path,))
    for nid, stage, shift in ((1, "CascadeStageC", 2.0), (2, "CascadeStageB", 1.0)):
        (pm,), (jm,) = po[nid], jo[nid]
        assert type(pm["unet"]).__name__ == type(jm["unet"]).__name__ == stage
        assert vars(pm["unet"].config) == vars(jm["unet"].config)
        assert pm["sampling"].shift == jm["sampling"].shift == shift
        assert ({k: tuple(v.shape) for k, v in flatten(pm["params"]).items()}
                == {k: tuple(v.shape) for k, v in jflatten(jm["params"]).items()})


def test_video_loader_without_a_file_builds_the_tiny_models_in_both():
    """ImageOnlyCheckpointLoader without a file: the tiny video UNet with
    EDM v-prediction, the tiny vision tower and VAE in both packages, the
    same configs and tree shapes (the draws differ)."""
    import dataclasses

    from stable_renderer_tpu.models.weights import flatten as jflatten

    from stable_renderer_tpu_torch.models.weights import flatten

    jo, po = load_both([(1, "ImageOnlyCheckpointLoader", ["absent.safetensors"], {})], ())
    (jm, jcv, jv), (pm, pcv, pv) = jo[1], po[1]
    assert type(pm["unet"]).__name__ == type(jm["unet"]).__name__ == "VideoUNetModel"
    assert pm["sampling"].prediction == jm["sampling"].prediction == "v"
    assert type(pm["sampling"]).__name__ == type(jm["sampling"]).__name__ == "ModelSamplingEDM"
    for p_, j_, key in ((pm, jm, "unet"), (pcv, jcv, "model"), (pv, jv, "vae")):
        pc_, jc_ = dataclasses.asdict(p_[key].config), dataclasses.asdict(j_[key].config)
        assert pc_ == {k: jc_[k] for k in pc_}
        assert ({k: tuple(v.shape) for k, v in flatten(p_["params"]).items()}
                == {k: tuple(v.shape) for k, v in jflatten(j_["params"]).items()})


def test_no_stub_is_left_and_every_name_runs():
    """The registry walk: JAX's 183 names, none a stub naming a ROADMAP item;
    the last two (ROADMAP 1.13's upscale nodes) run: the loader without a
    file builds the tiny RRDBNet, which upscales an image x4."""
    from stable_renderer_tpu_torch.workflow.loader import WorkflowNode as PNode

    stubs = {n: f.roadmap_item for n, f in pe.NODE_REGISTRY.items()
             if hasattr(f, "roadmap_item")}
    assert stubs == {}
    names = {n for n in pe.NODE_REGISTRY if not n.startswith("_")}  # not this file's _Const
    assert names == {n for n in je.NODE_REGISTRY if not n.startswith("_")} and len(names) == 183
    ctx = pe.InferenceContext(device=torch.device("cpu"))
    node = PNode(id=1, type="UpscaleModelLoader", widgets=["missing.pth"], inputs={},
                 output_names=[])
    (model,) = pe.NODE_REGISTRY["UpscaleModelLoader"](ctx, node)
    node = PNode(id=2, type="ImageUpscaleWithModel", widgets=[], inputs={}, output_names=[])
    (out,) = pe.NODE_REGISTRY["ImageUpscaleWithModel"](ctx, node, upscale_model=model,
                                                        image=torch.rand(1, 8, 8, 3))
    assert tuple(out.shape) == (1, 32, 32, 3) and torch.isfinite(out).all()
