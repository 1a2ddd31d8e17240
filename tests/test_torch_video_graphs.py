"""The video and Stable Cascade graphs through both packages' executors, on
the CPU at tiny widths: SVD img2vid (ImageOnlyCheckpointLoader ->
SVD_img2vid_Conditioning -> VideoLinearCFGGuidance -> KSampler's EDM path
and frame groups -> VAEDecode), Stable Zero123 from its file (the loader's
stills branch), and Stable Cascade C -> B (CascadeStageLoader on both stage
files, the KSampler's Cascade timesteps and Stage B's effnet prior).

Files are written here from the port's inits (chip_smoke's ``video_flat`` and
``cascade_flat``), with both packages' loader configs set to the tiny ones
by name (SVD's UNet preset, ViT-H, SD1.5's VAE, the two Cascade stages).
The loaders' outputs are compared leaf for leaf, then widened to f32 in both
caches; the KSampler's noise is JAX's, handed in (``jax_noise``). Every
node's output within UNET_TOL (2e-4: a graph).

Found and held here (ROADMAP queue 3), faults of the JAX reference that the
port does not share:
  * JAX's ImageOnlyCheckpointLoader nests the file's tower under
    ``vision_model`` with its ``visual_projection`` inside, where
    CLIPVisionModel does not read it: the encode raises KeyError for every
    loaded tower. The port lifts the projection; JAX's graphs here take the
    tower lifted the same way. A tower in open_clip's layout raises at the
    encode in both packages.
  * A Cascade stage file's tree has no repeat-mapper subtree where every
    repeat is 1, and JAX's walkers raise KeyError on it. The port reads the
    subtree as empty; JAX's graphs here take the tree with it added.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_executor import graphs, jax_noise
from test_torch_image_conditioning import widened
from test_torch_nodes_parity import (  # noqa: F401  (fixtures used by name)
    CONSTS,
    const_nodes,
    models,
    same,
    same_tree_bits,
)

import stable_renderer_tpu.workflow.executor as je
import stable_renderer_tpu_torch.workflow.executor as pe

torch.set_num_threads(1)

UNET_TOL = dict(atol=2e-4, rtol=2e-4)  # a graph: a UNet's evaluations in f32
H, W = 24, 32                          # the frames; 12x16 latents under the tiny VAE
RNG = np.random.default_rng(28)
CONSTS.update({
    "cascade_cond": {"context": RNG.standard_normal((1, 5, 48)).astype(np.float32),
                     "controls": [], "prompt": "a castle"},
    "cascade_uncond": {"context": RNG.standard_normal((1, 5, 48)).astype(np.float32),
                       "controls": [], "prompt": ""},
})


@pytest.fixture
def video_files(tmp_path, monkeypatch):
    """svd.safetensors and zero123.safetensors (their towers with the
    projection), svd_bare.safetensors and zero123_bare.safetensors (as JAX's
    ImageOnlyCheckpointSave writes a tower: without it), stage_c and stage_b;
    both packages' loader configs set to the files' tiny ones."""
    from dataclasses import replace

    import chip_smoke

    import stable_renderer_tpu.models as jmodels
    import stable_renderer_tpu.models.cascade as jcascade
    import stable_renderer_tpu.models.clip_vision as jcv
    import stable_renderer_tpu.models.video_unet as jvideo

    import stable_renderer_tpu_torch.models.cascade as pcascade
    import stable_renderer_tpu_torch.models.clip_vision as pcv
    import stable_renderer_tpu_torch.models.vae as pvae
    import stable_renderer_tpu_torch.models.video_unet as pvideo
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG
    from stable_renderer_tpu_torch.models.weights import write_safetensors

    for jmod, pmod, name, tiny in (
            (jvideo, pvideo, "SVD_UNET_CONFIG", "TINY_VIDEO_UNET_CONFIG"),
            (jcv, pcv, "VITH_CONFIG", "TINY_VISION_CONFIG"),
            (jmodels, pvae, "SD15_VAE_CONFIG", "TINY_VAE_CONFIG"),
            (jcascade, pcascade, "STAGE_C_CONFIG", "TINY_CASCADE_C_CONFIG"),
            (jcascade, pcascade, "STAGE_B_CONFIG", "TINY_CASCADE_B_CONFIG")):
        monkeypatch.setattr(jmod, name, getattr(jmod, tiny))
        monkeypatch.setattr(pmod, name, getattr(pmod, tiny))
    g = torch.Generator().manual_seed(28)
    f32 = torch.float32
    zcfg = replace(TINY_UNET_CONFIG, in_channels=8, num_heads=8, context_dim=768)
    for kind, ucfg in (("svd", pvideo.TINY_VIDEO_UNET_CONFIG), ("zero123", zcfg)):
        for suffix, proj in (("", True), ("_bare", False)):
            write_safetensors(chip_smoke.video_flat(kind, ucfg, pcv.TINY_VISION_CONFIG,
                                                    pvae.TINY_VAE_CONFIG, g, f32,
                                                    projection=proj),
                              tmp_path / f"{kind}{suffix}.safetensors")
    for stage in ("c", "b"):
        cfg = getattr(pcascade, f"TINY_CASCADE_{stage.upper()}_CONFIG")
        write_safetensors(chip_smoke.cascade_flat(stage, cfg, g, f32),
                          tmp_path / f"stage_{stage}.safetensors")
    return tmp_path


def executors(spec, d):
    jwf, pwf = graphs(spec)
    return (je.PromptExecutor(jwf, model_dirs=(str(d),)),
            pe.PromptExecutor(pwf, model_dirs=(str(d),), device="cpu"))


def load(spec, d, loaders):
    """Both executors' loader outputs of ``spec`` (run alone)."""
    jex, pex = executors([r for r in spec if r[0] in loaders], d)
    return jex.execute().outputs, pex.execute().outputs


def lifted(clip_vision: dict) -> dict:
    """JAX's loaded tower with its projection beside ``vision_model``, as the
    port's loader lifts it."""
    params = {k: dict(v) if k == "vision_model" else v
              for k, v in clip_vision["params"].items()}
    params["visual_projection"] = params["vision_model"].pop("visual_projection")
    return {**clip_vision, "params": params}


def with_repeat_mappers(model: dict) -> dict:
    return {**model, "params": {"down_repeat_mappers": {}, "up_repeat_mappers": {},
                                **model["params"]}}


def run_graph(spec, d, jax_cache, port_cache, monkeypatch, seeds, jit=True, scales=None,
              skip=()):
    """Both executors over ``spec`` with the loaders' outputs in their caches,
    JAX's draws handed in; every node's output compared but the tests'
    own and ``skip``'s, the nodes of ``scales`` ({node: s}) in units of s.
    ``jit=False`` runs JAX's op by op. Returns (JAX outputs, port
    outputs)."""
    import contextlib

    import jax

    jex, pex = executors(spec, d)
    jex._cache.update(jax_cache)
    pex._cache.update(port_cache)
    jax_noise(monkeypatch, set(seeds))
    with contextlib.nullcontext() if jit else jax.disable_jit():
        jo = jex.execute().outputs
    po = pex.execute().outputs
    scales = scales or {}
    for nid in po:
        if nid not in port_cache and nid not in skip and not spec_type(
                spec, nid).startswith("_"):
            s_ = scales.get(nid, 1.0)
            same(po[nid][0]["samples"] / s_ if s_ != 1.0 else po[nid],
                 jo[nid][0]["samples"] / s_ if s_ != 1.0 else jo[nid], UNET_TOL, f"node {nid}")
    return jo, po


def spec_type(spec, nid):
    return next(r[1] for r in spec if r[0] == nid)


def with_model_node(spec, user: int, row) -> list:
    """``spec`` with ``row`` (a node taking the MODEL link) put between node
    ``user``'s model input and its source."""
    nid, ntype, widgets, _ = row
    out = []
    for r in spec:
        if r[0] == user:
            out.append((nid, ntype, widgets, {"model": r[3]["model"]}))
            r = (r[0], r[1], r[2], {**r[3], "model": (nid, 0)})
        out.append(r)
    return out


def check_video_loader(jo, po, kind: str) -> None:
    """The loader's three outputs leaf for leaf: the UNet and the VAE in
    bf16, the tower in f32 (the port's projection lifted); the schedule."""
    (jm, jcv_, jv_), (pm, pcv_, pv_) = jo, po
    same_tree_bits(pm["params"], jm["params"], torch.bfloat16)
    same_tree_bits(pv_["params"], jv_["params"], torch.bfloat16)
    same_tree_bits(pcv_["params"], lifted(jcv_)["params"], torch.float32)
    assert type(pm["unet"]).__name__ == type(jm["unet"]).__name__ == (
        "VideoUNetModel" if kind == "svd" else "UNetModel")
    assert type(pm["sampling"]).__name__ == type(jm["sampling"]).__name__
    assert pm["sampling"].prediction == jm["sampling"].prediction == (
        "v" if kind == "svd" else "eps")
    if kind == "zero123":
        same(pm["cc_projection"], jm["cc_projection"], dict(atol=0, rtol=0))


@pytest.mark.parametrize("edm_node", [False, True], ids=["loader_sampling", "edm_node"])
def test_svd_graph_matches_jax(monkeypatch, video_files, edm_node):
    """A tiny SVD file: the loader's outputs leaf for leaf; JAX's
    conditioning raises on its loaded tower (the projection it leaves
    inside); then, JAX's tower lifted, 3 frames at 24x32 through
    SVD_img2vid_Conditioning (the init image's embed, its latent as
    c_concat, zeros for the negative, the ADM vector), the EDM sampling
    (the loader's, or ModelSamplingContinuousEDM's 700 / 0.002) and the
    KSampler's frame groups (CFG's batch of 6 rows in two groups of 3, the
    per-frame cfg ramp, 0.25 log sigma as the UNet's timestep), and the
    decode: every output within UNET_TOL."""
    from chip_smoke import VIDEO_SEED, svd_rows

    spec = [(9, "_Const", ["image"], {})] + svd_rows("svd.safetensors", W, H, 3, steps=2,
                                                       init=(9, 0))
    if edm_node:
        spec = with_model_node(spec, 4, (7, "ModelSamplingContinuousEDM",
                                         ["v_prediction", 700.0, 0.002], None))
    jo, po = load(spec, video_files, (1,))
    check_video_loader(jo[1], po[1], "svd")
    jex, _ = executors(spec, video_files)
    jex._cache[1] = jo[1]
    with pytest.raises(je.NodeExecutionError, match="visual_projection"):
        jex.execute()
    jm, jcv_, jv_ = jo[1]
    jo, po = run_graph(spec, video_files, {1: widened((jm, lifted(jcv_), jv_))},
                       {1: widened(po[1])}, monkeypatch, (VIDEO_SEED,))
    assert tuple(po[3][2]["samples"].shape) == (3, H // 2, W // 2, 4)
    assert tuple(po[6][0].shape) == (3, H, W, 3) and torch.isfinite(po[6][0]).all()
    assert float((po[6][0][0] - po[6][0][-1]).abs().max()) > 1e-3  # the frames differ


def test_zero123_graph_from_file_matches_jax(monkeypatch, video_files):
    """A tiny Stable Zero123 file through ImageOnlyCheckpointLoader's stills
    branch (the UNet with 8 input channels, the default schedule, the
    file's cc_projection and its tower at cond_stage_model.model.visual.)
    -> StableZero123_Conditioning -> KSampler (cc_projection on both
    contexts) -> VAEDecode: every output within UNET_TOL, JAX's tower
    lifted."""
    spec = [(1, "ImageOnlyCheckpointLoader", ["zero123.safetensors"], {}),
            (9, "_Const", ["image"], {}),
            (3, "StableZero123_Conditioning", [W, H, 2, 10.0, 30.0],
             {"clip_vision": (1, 1), "init_image": (9, 0), "vae": (1, 2)}),
            (5, "KSampler", [31, "fixed", 2, 2.5, "euler", "normal", 1.0],
             {"model": (1, 0), "positive": (3, 0), "negative": (3, 1), "latent_image": (3, 2)}),
            (6, "VAEDecode", [], {"samples": (5, 0), "vae": (1, 2)})]
    jo, po = load(spec, video_files, (1,))
    check_video_loader(jo[1], po[1], "zero123")
    jm, jcv_, jv_ = jo[1]
    jo, po = run_graph(spec, video_files, {1: widened((jm, lifted(jcv_), jv_))},
                       {1: widened(po[1])}, monkeypatch, (31,))
    assert tuple(po[6][0].shape) == (2, H, W, 3) and torch.isfinite(po[6][0]).all()


def test_open_clip_tower_raises_at_the_encode_in_both(tmp_path, video_files):
    """An SVD file whose tower is in open_clip's layout (conv1,
    transformer.resblocks, proj) loads in both packages and raises at the
    conditioning's encode in both: neither converts the layout (ROADMAP
    queue 3)."""
    from stable_renderer_tpu_torch.models.weights import read_safetensors, write_safetensors

    flat = {k: v for k, v in read_safetensors(video_files / "svd_bare.safetensors").items()
            if ".open_clip." not in k}
    prefix = "conditioner.embedders.0.open_clip.model.visual."
    g = torch.Generator().manual_seed(3)
    for k, shape in (("conv1.weight", (32, 3, 14, 14)), ("class_embedding", (32,)),
                     ("positional_embedding", (5, 32)), ("ln_pre.weight", (32,)),
                     ("transformer.resblocks.0.attn.in_proj_weight", (96, 32)),
                     ("ln_post.weight", (32,)), ("proj", (32, 32))):
        flat[prefix + k] = torch.randn(shape, generator=g)
    write_safetensors(flat, tmp_path / "svd_open_clip.safetensors")
    spec = [(9, "_Const", ["image"], {}),
            (1, "ImageOnlyCheckpointLoader", ["svd_open_clip.safetensors"], {}),
            (3, "SVD_img2vid_Conditioning", [W, H, 2, 127, 6, 0.0],
             {"clip_vision": (1, 1), "init_image": (9, 0), "vae": (1, 2)})]
    for mod, ex in zip((je, pe), executors(spec, tmp_path)):
        with pytest.raises(mod.NodeExecutionError, match="embeddings") as ei:
            ex.execute()
        assert ei.value.details["node_id"] == 3


@pytest.mark.parametrize("shift_node", [False, True], ids=["loader_sampling", "shift_node"])
def test_cascade_graph_matches_jax(monkeypatch, video_files, shift_node):
    """Tiny Stage C and Stage B files: each loader's output leaf for leaf
    (bf16, the stage and its shift); JAX's KSampler raises on Stage C's
    loaded tree (no repeat mappers); then, the subtree added for JAX, the
    graph at 256x256 (a 4x4 Stage C latent, a 64x64 Stage B latent): Stage
    C over the two conditionings at cfg 2 (the Cascade t of each sigma),
    StableCascade_StageB_Conditioning, Stage B at cfg 1.1 with the prior as
    the effnet input (zeros on the uncond rows): every output within
    UNET_TOL."""
    from chip_smoke import VIDEO_SEED, cascade_rows

    spec = [(1, "_Const", ["cascade_cond", "cascade_uncond"], {})] + cascade_rows(
        256, 64, (1, 0), (1, 1), steps=(2, 2), cfgs=(2.0, 1.1))
    if shift_node:
        spec = with_model_node(spec, 14, (17, "ModelSamplingStableCascade", [2.0], None))
    jo, po = load(spec, video_files, (11, 12))
    for nid, shift in ((11, 2.0), (12, 1.0)):
        (jm,), (pm,) = jo[nid], po[nid]
        same_tree_bits(pm["params"], jm["params"], torch.bfloat16)
        assert type(pm["unet"]).__name__ == type(jm["unet"]).__name__ == (
            "CascadeStageC" if nid == 11 else "CascadeStageB")
        assert pm["sampling"].shift == jm["sampling"].shift == shift
    jex, _ = executors(spec, video_files)
    jex._cache.update({11: jo[11], 12: jo[12]})
    with pytest.raises(je.NodeExecutionError, match="repeat_mappers"):
        jex.execute()
    jcache = {n: widened((with_repeat_mappers(jo[n][0]),)) for n in (11, 12)}
    # JAX op by op: XLA's whole-program CPU build of a tiny stage lands 3e-4
    # (relative) from JAX's own op-by-op result and from the port, which
    # agree within 3.5e-6 (tests/test_torch_cascade.py); at Cascade's sigma
    # of ~100 that is 0.05 on the Stage C latent. The two samplers' latents
    # are compared in units of their schedule's largest sigma (99.99: alpha
    # clipped at 1e-4), the scale of the noise they start from: the same
    # ops' f32 rounding scales with it (measured: 3.9e-4 apart at |ref| up
    # to 450, 8.7e-7 of the largest)
    sigma_max = float(po[11][0]["sampling"].sigma_max)
    jo, po = run_graph(spec, video_files, jcache, {n: widened(po[n]) for n in (11, 12)},
                       monkeypatch, (VIDEO_SEED, VIDEO_SEED + 1), jit=False,
                       scales={14: sigma_max, 16: sigma_max}, skip=(17,))
    if shift_node:  # the model passes through (JAX's with the added subtrees)
        (jm,), (pm,) = jo[17], po[17]
        assert pm["sampling"].shift == jm["sampling"].shift == 2.0
        np.testing.assert_array_equal(pm["sampling"].sigmas, jm["sampling"].sigmas)
        assert pm["params"] is po[11][0]["params"]
    assert tuple(po[14][0]["samples"].shape) == (1, 4, 4, 16)
    out = po[16][0]["samples"]
    assert tuple(out.shape) == (1, 64, 64, 4) and torch.isfinite(out).all()


def test_stage_c_lite_file_takes_stage_c_config_in_both(video_files, monkeypatch):
    """CascadeStageLoader takes STAGE_C_CONFIG for every file with
    clip_txt_mapper, as JAX's (ROADMAP queue 3): a smaller Stage C's file
    (the tiny one, 1 block a level, here under a STAGE_C_CONFIG of 2 blocks
    a level, as a lite file under the full config) loads behind the larger
    config in both packages, and its evaluation raises KeyError in both at
    the first block the file lacks."""
    from dataclasses import replace

    import jax.numpy as jnp

    import stable_renderer_tpu.models.cascade as jcascade

    import stable_renderer_tpu_torch.models.cascade as pcascade

    for mod in (jcascade, pcascade):
        monkeypatch.setattr(mod, "STAGE_C_CONFIG", replace(
            mod.TINY_CASCADE_C_CONFIG, blocks_down=(2, 2), blocks_up=(2, 2)))
    jo, po = load([(11, "CascadeStageLoader", ["stage_c.safetensors"], {})], video_files, (11,))
    (jm,), (pm,) = jo[11], po[11]
    assert pm["unet"].config.blocks_down == jm["unet"].config.blocks_down == (2, 2)
    x, t, ctx = (RNG.standard_normal(s_).astype(np.float32) for s_ in ((1, 4, 4, 16), (1,),
                                                                      (1, 5, 48)))
    with pytest.raises(KeyError, match="'3'"):
        pm["unet"].apply(pm["params"], *(torch.from_numpy(a).to(torch.bfloat16)
                                         for a in (x, t, ctx)))
    with pytest.raises(KeyError, match="'3'"):
        jm["unet"].apply(with_repeat_mappers(jm)["params"],
                         *(jnp.asarray(a, jnp.bfloat16) for a in (x, t, ctx)))
