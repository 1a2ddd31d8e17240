"""SD2, SDXL, the SDXL refiner and the x4 upscaler's layout in the port,
against the JAX package, on the CPU at tiny widths: the OpenCLIP text towers
and their weighted encoders, the ADM vectors, the general UNet layout
(per-level and per-block depths, disabled self-attention, the class table),
the layout detection and the family rule, ``from_checkpoint`` on tiny files
of each family written here, and one tiny SDXL ``frame_step``.

Inputs are numpy-seeded; the port's random inits are handed to JAX; the
sampler's draws are JAX's, handed to the port. f32 throughout: the bars are
those of tests/test_torch_frame.py (atol = rtol = 2e-4, summation order
only); trees loaded from files are compared bit for bit.

The families' text towers are full-width configs in both packages'
``from_checkpoint``; the tests set them to small ones by module name (as
tests/test_torch_checkpoint_pipeline.py does for SD1.x), at the widths the
family rule reads from the UNet's context: 1024 for SD2 and x4, 2048 = L +
G for SDXL, 1280 for the refiner.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from chip_smoke import FAMILY_TOWERS, write_family_file
from chip_smoke import family_configs as _family_configs

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)
SIZE = 64
RNG_SEED = 16


def jcfg(jcls, pcfg, **kw):
    """The JAX config dataclass ``jcls`` with the port config's fields."""
    names = {f.name for f in dataclasses.fields(jcls)}
    return jcls(**{**{f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)
                      if f.name in names}, **kw})


def as_jax(tree):
    if isinstance(tree, dict):
        return {k: as_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.float().numpy())


def jit(fn, *static, **static_kw):
    """``fn`` with its leading model arguments and keyword options bound,
    jitted (eager JAX runs an op at a time and is slow here)."""
    return jax.jit(lambda *a, **k: fn(*static, *a, **static_kw, **k))


def close(mine, ref, tol=TOL, what=""):
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32),
                               err_msg=what, **tol)


def bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    else:
        x = np.asarray(x)
        x = x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x
    return x.tobytes()


def ids_batch(vocab: int, b: int, c: int, length: int = 77, seed: int = 0, custom: int = 0):
    """(B, C, L) int32 ids as the tokenizer lays them out: BOS, a body of
    random ids (``custom`` of them negative textual-inversion slots), EOS,
    EOS padding; and (B, C, L) f32 weights around 1."""
    rng = np.random.default_rng(seed)
    bos, eos = 49406 % vocab, 49407 % vocab
    ids = np.full((b, c, length), eos, np.int32)
    ids[:, :, 0] = bos
    for bi in range(b):
        for ci in range(c):
            n = int(rng.integers(3, 12))
            body = rng.integers(1, vocab - 2, size=n)
            body[body == eos] = 1
            body[body == bos] = 2
            ids[bi, ci, 1:1 + n] = body
            if custom and ci == 0:
                ids[bi, ci, 1:1 + custom] = -np.arange(1, custom + 1)
    weights = rng.uniform(0.7, 1.3, size=ids.shape).astype(np.float32)
    return ids, weights


# --- the text towers ---------------------------------------------------------------


@pytest.mark.parametrize("tower", ["g", "h"])
def test_openclip_towers_match_jax(tower):
    """OpenCLIPTextModel's hidden state at clip skip -1 and -2 and its
    pooled projection (EOS at 407 in the tiny vocab, negative ids clamped),
    and SD2ClipH's conditioning (the penultimate state, ``ln_final``
    applied, and without) and pooled output, through the weighted encoder
    SD2 conditions with."""
    import stable_renderer_tpu.models.clip as jclip

    import stable_renderer_tpu_torch.models.clip as pclip

    pcfg = pclip.TINY_CLIP_G_CONFIG if tower == "g" else pclip.TINY_CLIP_H_CONFIG
    model = pclip.OpenCLIPTextModel(pcfg)
    params = model.init(torch.Generator().manual_seed(1))
    jmodel = jclip.OpenCLIPTextModel(jcfg(jclip.OpenCLIPConfig, pcfg))
    jparams = as_jax(params)
    ids, weights = ids_batch(pcfg.vocab_size, 3, 1, custom=2)
    tokens = ids[:, 0]
    for skip in (-1, -2):
        hidden, pooled = model.apply(params, torch.from_numpy(tokens), clip_skip=skip)
        jhidden, jpooled = jit(jmodel.apply, clip_skip=skip)(jparams, jnp.asarray(tokens))
        close(hidden, jhidden, what=f"hidden {skip}")
        close(pooled, jpooled, what=f"pooled {skip}")
    assert pooled.shape == (3, pcfg.projection_dim)
    h2, jh2 = pclip.SD2ClipH(pcfg), jclip.SD2ClipH(jcfg(jclip.OpenCLIPConfig, pcfg))
    assert dataclasses.asdict(h2.config) == dataclasses.asdict(jh2.config)
    for final_norm in (True, False):
        close(h2.apply(params, torch.from_numpy(tokens), final_norm=final_norm),
              jit(jh2.apply, final_norm=final_norm)(jparams, jnp.asarray(tokens)))
    ctx, pooled = pclip.encode_token_weights_batch(h2, params, torch.from_numpy(ids),
                                                   torch.from_numpy(weights))
    jctx, jpooled = jit(jclip.encode_token_weights_batch, jh2)(jparams, jnp.asarray(ids),
                                                              jnp.asarray(weights))
    close(ctx, jctx)
    close(pooled, jpooled)


def _towers():
    """Tiny CLIP-L (64 wide) and CLIP-G of both packages, the port's inits."""
    import stable_renderer_tpu.models.clip as jclip

    import stable_renderer_tpu_torch.models.clip as pclip

    g = torch.Generator().manual_seed(2)
    lcfg, gcfg = pclip.TINY_CLIP_CONFIG, pclip.TINY_CLIP_G_CONFIG
    clip_l, clip_g = pclip.CLIPTextModel(lcfg), pclip.OpenCLIPTextModel(gcfg)
    pl, pg = clip_l.init(g), clip_g.init(g)
    return ((clip_l, clip_g, pl, pg),
            (jclip.CLIPTextModel(jcfg(jclip.CLIPConfig, lcfg)),
             jclip.OpenCLIPTextModel(jcfg(jclip.OpenCLIPConfig, gcfg)), as_jax(pl), as_jax(pg)))


@pytest.mark.parametrize("chunks", [1, 2])
def test_weighted_dual_and_g_encoders_match_jax(chunks):
    """encode_token_weights_batch_xl (CLIP-L without the final norm beside
    CLIP-G, textual-inversion vectors in the L tower, G ids padded with 0
    after the first EOS) and encode_token_weights_batch_g (the refiner's G
    alone), over 2 prompts of ``chunks`` weighted chunks; clip_g_pad_ids and
    SDXLClip."""
    import stable_renderer_tpu.models.clip as jclip

    import stable_renderer_tpu_torch.models.clip as pclip

    (cl, cg, pl, pg), (jl, jg, jpl, jpg) = _towers()
    ids, weights = ids_batch(1000, 2, chunks, seed=chunks, custom=2)
    custom = np.random.default_rng(3).standard_normal((2, 64)).astype(np.float32)
    ti, tw, tc = (torch.from_numpy(a) for a in (ids, weights, custom))
    ctx, pooled = pclip.encode_token_weights_batch_xl(cl, cg, pl, pg, ti, tw, custom_embeds=tc)
    jctx, jpooled = jit(jclip.encode_token_weights_batch_xl, jl, jg)(
        jpl, jpg, jnp.asarray(ids), jnp.asarray(weights), custom_embeds=jnp.asarray(custom))
    assert ctx.shape == (2, chunks * 77, 128) and pooled.shape == (2, 32)
    close(ctx, jctx)
    close(pooled, jpooled)
    ctx, pooled = pclip.encode_token_weights_batch_g(cg, pg, ti, tw)
    jctx, jpooled = jit(jclip.encode_token_weights_batch_g, jg)(jpg, jnp.asarray(ids),
                                                               jnp.asarray(weights))
    close(ctx, jctx)
    close(pooled, jpooled)
    flat = ids.reshape(-1, 77)
    assert np.array_equal(pclip.clip_g_pad_ids(torch.from_numpy(flat), 407).numpy(),
                          np.asarray(jclip.clip_g_pad_ids(jnp.asarray(flat), 407)))
    both = pclip.SDXLClip(cl, cg).apply(pl, pg, torch.from_numpy(np.maximum(flat, 0)))
    jboth = jax.jit(jclip.SDXLClip(jl, jg).apply)(jpl, jpg, jnp.asarray(np.maximum(flat, 0)))
    close(both[0], jboth[0])
    close(both[1], jboth[1])


@pytest.mark.parametrize("kind", ["base", "refiner"])
def test_adm_vectors_match_jax(kind):
    """sdxl_adm_vector (2816 wide: pooled + 6 Fourier rows) and
    sdxl_refiner_adm_vector (2560 wide: pooled + 5, the aesthetic score).
    The pooled columns are equal; the Fourier rows take sin and cos of f32
    arguments up to 1344, whose rounding the f32 bar covers."""
    import stable_renderer_tpu.models.sdxl as jsdxl

    import stable_renderer_tpu_torch.models.sdxl as psdxl

    pooled = np.random.default_rng(4).standard_normal((3, 1280)).astype(np.float32)
    if kind == "base":
        kw = dict(original_size=(768, 1344), crop=(16, 8), target_size=(1024, 960))
        got = psdxl.sdxl_adm_vector(torch.from_numpy(pooled), **kw)
        ref = jsdxl.sdxl_adm_vector(jnp.asarray(pooled), **kw)
        assert got.shape == (3, 2816)
    else:
        kw = dict(original_size=(896, 1152), crop=(0, 32), aesthetic_score=2.5)
        got = psdxl.sdxl_refiner_adm_vector(torch.from_numpy(pooled), **kw)
        ref = jsdxl.sdxl_refiner_adm_vector(jnp.asarray(pooled), **kw)
        assert got.shape == (3, 2560)
    close(got, ref)  # cos and sin of f32 arguments up to ~1.3e3


def test_tokenizer_public_names_match_jax():
    """Tokenizer.encode_batch (the tiny hash tokenizer and the full vocab)
    and SDTokenizer.untokenize, which names the port's own vocab copy."""
    from stable_renderer_tpu.models.clip import CLIPConfig as JCfg, Tokenizer as JTok
    from stable_renderer_tpu.models.tokenizer import SDTokenizer as JSD

    from stable_renderer_tpu_torch.models import tokenizer as ptok
    from stable_renderer_tpu_torch.models.clip import CLIPConfig, Tokenizer

    texts = ["a red ball", "a (shiny:1.3) blue cube, on a table"]
    for vocab in (1000, 49408):
        got = Tokenizer(CLIPConfig(vocab_size=vocab)).encode_batch(texts)
        assert got.dtype == np.int32 and got.shape == (2, 77)
        assert np.array_equal(got, JTok(JCfg(vocab_size=vocab)).encode_batch(texts))
    pairs = ptok.SDTokenizer().tokenize_with_weights(texts[1])[0]
    assert ptok.SDTokenizer().untokenize(pairs) == JSD().untokenize(pairs)
    assert ptok.ASSET_DIR.endswith("stable_renderer_tpu_torch/assets/clip_tokenizer")


# --- the UNet ------------------------------------------------------------------------


def _layouts():
    from stable_renderer_tpu_torch.models.unet import TINY_SDXL_UNET_CONFIG, UNetConfig

    return {
        "sdxl": TINY_SDXL_UNET_CONFIG,
        # SDXL's per-level depths at tiny widths: no attention at level 0
        "sdxl_levels": replace(TINY_SDXL_UNET_CONFIG, channel_mult=(1, 2, 2),
                               attention_levels=(1, 2), transformer_depth_per_level=(0, 2, 3),
                               head_dim=16),
        "x4": UNetConfig(in_channels=7, model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                         transformer_depth_blocks=(1, 1), transformer_depth_blocks_out=(1,) * 4,
                         transformer_depth_middle=1, context_dim=48, head_dim=16,
                         disable_self_attn_levels=(True, False), num_classes=350),
        "ssd_like": UNetConfig(model_channels=32, channel_mult=(1, 2, 4),
                               transformer_depth_blocks=(0, 0, 1, 1, 2, 2),
                               transformer_depth_blocks_out=(0, 0, 0, 1, 1, 1, 2, 2, 2),
                               transformer_depth_middle=-1, context_dim=64, head_dim=16,
                               adm_in_channels=80),
        "koala_like": UNetConfig(model_channels=32, channel_mult=(1, 2, 4), num_res_blocks=1,
                                 num_res_blocks_per_level=(1, 1, 1),
                                 transformer_depth_blocks=(0, 1, 2),
                                 transformer_depth_blocks_out=(0, 0, 1, 1, 2, 2),
                                 transformer_depth_middle=-2, context_dim=64, head_dim=16,
                                 adm_in_channels=80),
    }


@pytest.mark.parametrize("layout", ["sdxl", "sdxl_levels", "x4", "ssd_like", "koala_like"])
def test_unet_layouts_match_jax(layout):
    """The UNet's apply over each layout (the ADM MLP or the class table,
    per-level and per-block depths, a middle block of a res block alone or
    none, self-attention disabled on a level) against JAX's on the port's
    init, whose tree has JAX's keys and shapes; the corresponder's pre hook
    sees JAX's layer indices (one a SpatialTransformer, every block of it),
    and num_transformer_layers counts the same."""
    from stable_renderer_tpu.models.unet import (
        AttnHooks as JHooks,
        UNetConfig as JConfig,
        UNetModel as JUNet,
    )
    from stable_renderer_tpu.models.weights import flatten as jflatten

    from stable_renderer_tpu_torch.models.unet import AttnHooks, UNetModel
    from stable_renderer_tpu_torch.models.weights import flatten

    pcfg = _layouts()[layout]
    unet, junet = UNetModel(pcfg), JUNet(jcfg(JConfig, pcfg))
    params = unet.init(torch.Generator().manual_seed(3))
    shapes = {k: tuple(v.shape)
              for k, v in jflatten(jax.eval_shape(junet.init, jax.random.PRNGKey(0))).items()}
    assert {k: tuple(v.shape) for k, v in flatten(params).items()} == shapes
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((2, 16, 16, pcfg.in_channels)).astype(np.float32)
    t = np.array([700.0, 30.0], np.float32)
    ctx = rng.standard_normal((2, 9, pcfg.context_dim)).astype(np.float32)
    if pcfg.num_classes:
        y = np.array([5, 300])
    else:
        y = rng.standard_normal((2, pcfg.adm_in_channels)).astype(np.float32)
    seen, jseen = [], []

    def pre(into):
        def hook(q, k, v, layer):
            into.append(layer)
            return q * 1.01, k, v
        return hook

    out = unet.apply(params, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                     y=torch.from_numpy(y), hooks=AttnHooks(pre=pre(seen)))
    ref = jax.jit(lambda p, *a: junet.apply(p, *a[:3], y=a[3], hooks=JHooks(pre=pre(jseen))))(
        as_jax(params), *(jnp.asarray(a) for a in (x, t, ctx, y)))
    close(out, ref)
    assert seen == jseen and unet.num_transformer_layers() == junet.num_transformer_layers()
    assert max(seen, default=-1) < unet.num_transformer_layers()


def test_sdxl_layer_numbering_matches_jax():
    """At SDXL's published layout (on the meta device: shapes only) both
    packages number 11 transformer layers, one a SpatialTransformer (4 in,
    1 in the middle, 6 out) over its 70 transformer blocks, and the K1 head
    split is 64 wide (10 heads at 640 channels, 20 at 1280)."""
    from stable_renderer_tpu.models.unet import SDXL_UNET_CONFIG as JSDXL, UNetModel as JUNet

    from stable_renderer_tpu_torch.models.unet import SDXL_UNET_CONFIG, UNetModel

    assert dataclasses.asdict(SDXL_UNET_CONFIG) == {
        k: v for k, v in dataclasses.asdict(JSDXL).items() if k != "dtype"}
    unet = UNetModel(SDXL_UNET_CONFIG)
    assert unet.num_transformer_layers() == JUNet(JSDXL).num_transformer_layers() == 11
    plan_in, plan_out, _ = unet.block_plan()
    assert plan_in == JUNet(JSDXL).block_plan()[0]
    blocks = sum(p[2] for p in plan_in) + SDXL_UNET_CONFIG.middle_depth() \
        + sum(p[3] for p in plan_out)
    assert blocks == 70
    assert (SDXL_UNET_CONFIG.heads_for(640), SDXL_UNET_CONFIG.heads_for(1280)) == (10, 20)
    from stable_renderer_tpu_torch.models.weights import flatten

    n = sum(v.numel() for v in flatten(unet.init(device="meta")).values())
    assert 2.5e9 < n < 2.7e9  # SDXL base's 2.57 B parameters


# --- detection ---------------------------------------------------------------------


def _flat_from(pcfg, seed=0):
    from stable_renderer_tpu_torch.models.unet import UNetModel
    from stable_renderer_tpu_torch.models.weights import flatten

    params = UNetModel(pcfg).init(torch.Generator().manual_seed(seed))
    return {f"model.diffusion_model.{k}": v for k, v in flatten(params).items()}, params


@pytest.mark.parametrize("layout", ["ssd_like", "koala_like", "x4", "sd15_tiny", "sdxl_levels"])
def test_layout_detection_round_trips(layout):
    """tests/test_model_families.py's round trips through the port: the
    detected config equals JAX's field for field (per-block depths, per-level
    res blocks, the middle layout, disable_self_attn, head_dim, ADM and class
    widths), re-initializes to the same tree, and the SD1.x preset still
    detects exactly (TINY_UNET_CONFIG at context 768: the same plan, tree
    and 8 heads)."""
    from stable_renderer_tpu.models.weights import detect_unet_config as jdetect

    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG, UNetModel
    from stable_renderer_tpu_torch.models.weights import detect_unet_config, flatten

    if layout == "sd15_tiny":  # SD1.x's context width, its 8 fixed heads
        pcfg = replace(TINY_UNET_CONFIG, context_dim=768, num_heads=8)
    else:
        pcfg = _layouts()[layout]
    flat, params = _flat_from(pcfg)
    got, ref = detect_unet_config(flat), jdetect({k: v.numpy() for k, v in flat.items()})
    assert dataclasses.asdict(got) == {k: v for k, v in dataclasses.asdict(ref).items()
                                       if k != "dtype"}
    re_init = UNetModel(got).init(device="meta")
    assert ({k: tuple(v.shape) for k, v in flatten(re_init).items()}
            == {k: tuple(v.shape) for k, v in flatten(params).items()})
    if layout == "sd15_tiny":
        assert UNetModel(got).block_plan() == UNetModel(pcfg).block_plan()
        assert got.head_dim is None and got.heads_for(64) == pcfg.heads_for(64) == 8
    if layout == "x4":
        assert got.disable_self_attn_levels == (True, False) and got.num_classes == 350


@pytest.mark.parametrize("case", ["sd2_v", "sd2_inpaint_eps", "svd"])
def test_detect_model_family_matches_jax(case):
    """detect_model_family on SD2 768-v (the out-layer statistic above 0.09)
    and a 9-channel SD2 inpaint UNet (eps whatever the statistic); an SVD
    state dict's family, its UNet config SVD's preset at the file's widths
    in both packages."""
    from stable_renderer_tpu.models.unet import SD15_UNET_CONFIG as JSD15
    from stable_renderer_tpu.models.weights import detect_model_family as jfamily

    from stable_renderer_tpu_torch.models.unet import SD15_UNET_CONFIG
    from stable_renderer_tpu_torch.models.weights import detect_model_family, detect_unet_config

    pcfg = replace(SD15_UNET_CONFIG, model_channels=32, context_dim=1024, head_dim=64,
                   in_channels=9 if case == "sd2_inpaint_eps" else 4)
    flat, _ = _flat_from(pcfg)
    key = "model.diffusion_model.output_blocks.11.1.transformer_blocks.0.norm1.bias"
    flat[key] = torch.from_numpy(np.random.default_rng(0).standard_normal(32).astype(
        np.float32) * 0.2)
    if case == "svd":
        from stable_renderer_tpu.models.weights import detect_unet_config as jdetect

        from stable_renderer_tpu_torch.models.video_unet import SVD_UNET_CONFIG

        flat["model.diffusion_model.input_blocks.1.0.time_stack.in_layers.0.weight"] = flat[key]
        cfg = detect_unet_config(flat)
        assert cfg == replace(SVD_UNET_CONFIG, in_channels=4, model_channels=32,
                              adm_in_channels=None)
        theirs = jdetect({k: v.numpy() for k, v in flat.items()})
        assert dataclasses.asdict(cfg) == {k: getattr(theirs, k) for k in dataclasses.asdict(cfg)}
    else:
        cfg = detect_unet_config(flat)
    fam = detect_model_family(flat, cfg)
    assert fam == jfamily({k: v.numpy() for k, v in flat.items()}, jcfg(type(JSD15), cfg))
    assert fam["family"] == {"sd2_v": "sd2", "sd2_inpaint_eps": "sd2", "svd": "svd"}[case]
    assert fam["prediction"] == ("eps" if case == "sd2_inpaint_eps" else "v")


# --- from_checkpoint on tiny files of each family ------------------------------------

# the tiny family files (their UNets and towers at the widths the family rule
# reads) are chip_smoke's, which phase 25d runs through the executor too
H_TEST, L_TEST, G_TEST, R_TEST = (FAMILY_TOWERS[k] for k in "hlgr")


@pytest.fixture
def tiny_families(monkeypatch):
    """Both packages' full-width tower and VAE configs set to the test
    files' by module name; returns a function that sets the CLIP-L config
    (the tokenizer's, and SDXL's L tower) for a kind."""
    import stable_renderer_tpu.engine.pipeline as jp
    import stable_renderer_tpu.models.clip as jclip
    import stable_renderer_tpu.models.vae as jvae

    import stable_renderer_tpu_torch.engine.pipeline as tp
    from stable_renderer_tpu_torch.models.clip import TINY_CLIP_CONFIG, OpenCLIPConfig
    from stable_renderer_tpu_torch.models.vae import TINY_VAE_CONFIG

    jtiny_vae = jcfg(jvae.VAEConfig, TINY_VAE_CONFIG)
    monkeypatch.setattr(jp, "SD15_VAE_CONFIG", jtiny_vae)
    monkeypatch.setattr(tp, "SD15_VAE_CONFIG", TINY_VAE_CONFIG)
    monkeypatch.setattr(jvae, "SDXL_VAE_CONFIG", replace(jtiny_vae, scale_factor=0.13025))
    monkeypatch.setattr(tp, "SDXL_VAE_CONFIG", replace(TINY_VAE_CONFIG, scale_factor=0.13025))
    j_h = jclip.SD2ClipH
    monkeypatch.setattr(jclip, "SD2ClipH", lambda: j_h(jclip.OpenCLIPConfig(**H_TEST)))
    monkeypatch.setattr(tp, "SD2_CLIP_H_CONFIG", OpenCLIPConfig(**H_TEST))

    def for_kind(kind):
        ucfg, lcfg, gcfg = _family_configs(kind)
        lcfg = lcfg or TINY_CLIP_CONFIG
        monkeypatch.setattr(jp, "SD15_CLIP_CONFIG", jcfg(jclip.CLIPConfig, lcfg))
        monkeypatch.setattr(tp, "SD15_CLIP_CONFIG", lcfg)
        if kind in ("sdxl", "refiner"):
            monkeypatch.setattr(jclip, "SDXL_CLIP_G_CONFIG", jcfg(jclip.OpenCLIPConfig, gcfg))
            monkeypatch.setattr(tp, "SDXL_CLIP_G_CONFIG", gcfg)

    return for_kind


def _same_tree(mine, ref, dtype):
    from stable_renderer_tpu.models.weights import flatten as jflatten

    from stable_renderer_tpu_torch.models.weights import flatten

    mine, ref = flatten(mine), jflatten(ref)
    assert sorted(mine) == sorted(ref)
    for k, v in mine.items():
        assert v.dtype == dtype and bits(v) == bits(ref[k]), k


@pytest.mark.parametrize("kind", ["sd2", "x4", "sdxl", "refiner"])
def test_from_checkpoint_families_match_jax(tmp_path, tiny_families, kind):
    """A tiny file of each family through both packages' from_checkpoint:
    the detected UNet config, the family, prediction (SD2 768-v and the x4
    v; the x4 betas 1e-4 -> 2e-2), the towers (SD2ClipH; SDXL's L + G at
    embedders 0 and 1; the refiner's G alone at embedders 0) and the VAE
    scale (SDXL's 0.13025) agree; every leaf equals JAX's bit for bit (UNet
    bf16, VAE and towers f32); the conditioning and the ADM vectors of one
    prompt at 64x64 agree within the f32 bar."""
    from stable_renderer_tpu.data.sprite import EnvPrompt as JEnv
    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.data.sprite import EnvPrompt
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    tiny_families(kind)
    path = tmp_path / f"{kind}.safetensors"
    write_family_file(kind, path)
    jpipe = JPipe.from_checkpoint(str(path), JConfig(sampler="euler"))
    pipe = DiffusionPipeline.from_checkpoint(str(path), RenderConfig(sampler="euler"),
                                             device="cpu")
    ref = dataclasses.asdict(jpipe.unet.config)
    ref.pop("dtype")
    assert dataclasses.asdict(pipe.unet.config) == ref
    want = {"sd2": ("sd2", "v"), "x4": ("sd-x4-upscaler", "v"), "sdxl": ("sdxl", "eps"),
            "refiner": ("sdxl-refiner", "eps")}[kind]
    assert (pipe.model_family, pipe.model_sampling.prediction) == want
    assert (jpipe.model_family, jpipe.model_sampling.prediction) == want
    assert pipe.noise_aug_dim is jpipe.noise_aug_dim is None
    assert (pipe.model_sampling.beta_start, pipe.model_sampling.beta_end) == (
        jpipe.model_sampling.beta_start, jpipe.model_sampling.beta_end) == (
        (1e-4, 2e-2) if kind == "x4" else (0.00085, 0.012))
    assert type(pipe.clip).__name__ == type(jpipe.clip).__name__
    assert pipe.vae.config.scale_factor == jpipe.vae.config.scale_factor == (
        0.13025 if kind in ("sdxl", "refiner") else 0.18215)
    assert pipe.is_sdxl == jpipe.is_sdxl and pipe._clip_g_only == jpipe._clip_g_only
    _same_tree(pipe.unet_params, jpipe.unet_params, torch.bfloat16)
    _same_tree(pipe.vae_params, jpipe.vae_params, torch.float32)
    _same_tree(pipe.clip_params, jpipe.clip_params, torch.float32)
    assert (pipe.clip_g is None) == (jpipe.clip_g is None) == (kind in ("sd2", "x4"))
    if pipe.clip_g is not None:
        _same_tree(pipe.clip_g_params, jpipe.clip_g_params, torch.float32)
    _, ctx, nctx, y, ny = pipe.prepare_conditioning({}, (EnvPrompt("a red ball"),), 1,
                                                    image_size=(SIZE, SIZE))
    jout = jpipe.prepare_conditioning({}, (JEnv("a red ball"),), 1, image_size=(SIZE, SIZE))
    assert ctx.shape[-1] == pipe.unet.config.context_dim
    for got, ref in zip((ctx, nctx, y, ny), jout[1:]):
        assert (got is None) == (ref is None)
        if ref is not None:
            close(got, ref)
    assert (y is None) == (kind in ("sd2", "x4"))
    if y is not None:
        assert y.shape == (1, pipe.unet.config.adm_in_channels)


@pytest.mark.parametrize("family", ["sdxl", "sd2"])
def test_k1_launches_a_frame_match_chip_smoke(monkeypatch, family):
    """K1's calls a frame by (BH, Lq, Lk, d), counted on the meta device at
    full width: SDXL at 1024x1024 (bf16 UNet at cfg batch 2, bf16 VAE) and SD2
    768-v at 768x768 (the loaded f32 VAE): 4 UNet evaluations, one encode,
    one decode. They are chip_smoke.XL_K1_SHAPES and SD2_K1_SHAPES, which
    phase 25 holds on the card by the counters."""
    import collections

    import chip_smoke

    from stable_renderer_tpu_torch.models.unet import (
        SD15_UNET_CONFIG,
        SDXL_UNET_CONFIG,
        UNetModel,
    )
    from stable_renderer_tpu_torch.models.vae import SD15_VAE_CONFIG, SDXL_VAE_CONFIG, VAE
    from stable_renderer_tpu_torch.ops import flash_attention as fa

    seen = collections.Counter()

    def counted(q, k, v):
        seen[(q.shape[0], q.shape[1], k.shape[1], q.shape[2])
             + (("f32",) if q.dtype == torch.float32 else ())] += 1
        return torch.empty_like(q)

    monkeypatch.setattr(fa, "flash_attention", counted)
    if family == "sdxl":
        ucfg, vcfg, size, vae_dt, want = (SDXL_UNET_CONFIG, SDXL_VAE_CONFIG, 1024, torch.bfloat16,
                                          chip_smoke.XL_K1_SHAPES)
    else:
        ucfg, vcfg, size, vae_dt, want = (replace(SD15_UNET_CONFIG, context_dim=1024, head_dim=64),
                                          SD15_VAE_CONFIG, 768, torch.float32,
                                          chip_smoke.SD2_K1_SHAPES)
    unet, vae = UNetModel(ucfg), VAE(vcfg)
    up = unet.init(device="meta", dtype=torch.bfloat16)
    vp = vae.init(device="meta", dtype=vae_dt)

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, device="meta", dtype=dtype)

    lat = size // 8
    y = None if ucfg.adm_in_channels is None else meta(2, ucfg.adm_in_channels)
    with torch.no_grad():
        unet.apply(up, meta(2, lat, lat, 4), meta(2, dtype=torch.float32),
                   meta(2, 77, ucfg.context_dim), y=y)
        frame = collections.Counter({k: 4 * n for k, n in seen.items()})
        seen.clear()
        vae.encode(vp, meta(1, size, size, 3, dtype=vae_dt))
        vae.decode(vp, meta(1, lat, lat, 4, dtype=vae_dt))
    frame.update(seen)
    assert dict(frame) == want
    assert sum(frame.values()) == 42
