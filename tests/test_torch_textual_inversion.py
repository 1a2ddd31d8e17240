"""Textual inversion in the port (models/tokenizer.py ``load_embed`` and the
``embedding:name`` words, the negative ids of ``Tokenizer``'s weighted batch,
``CLIPTextModel.apply(custom_embeds=...)``) against the JAX package, on the
CPU. The tokenizers use the full CLIP vocab (the port's own BPE, JAX's
transformers one); the text tower is narrow (64 wide, 2 layers), f32.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)  # f32: summation order only
WIDTH = 64


def _write_embeddings(d) -> dict:
    """Embedding files of every format ``load_embed`` reads, in ``d``;
    returns {name: the vectors it should load, or None}."""
    from stable_renderer_tpu_torch.models.weights import write_safetensors

    rng = np.random.default_rng(0)

    def vecs(n, w=WIDTH):
        return (rng.standard_normal((n, w)) * 0.5).astype(np.float32)

    want = {}
    want["shiny"] = v = vecs(2)
    write_safetensors({"emb_params": torch.from_numpy(v)}, d / "shiny.safetensors")
    want["star"] = v = vecs(3)
    torch.save({"string_to_param": {"*": torch.from_numpy(v)}, "name": "star", "step": 10},
               d / "star.pt")
    want["raw"] = v = vecs(1)
    torch.save(torch.from_numpy(v), d / "raw.pt")
    want["towers"] = v = vecs(2)
    torch.save({"clip_l": torch.from_numpy(v), "clip_g": torch.from_numpy(vecs(2, 1280))},
               d / "towers.bin")
    want["sized"] = v = vecs(2)
    write_safetensors({"a": torch.from_numpy(vecs(2, 1280)), "b": torch.from_numpy(v)},
                      d / "sized.safetensors")
    want["half"] = v = vecs(2).astype(np.float16).astype(np.float32)
    write_safetensors({"emb_params": torch.from_numpy(v).half()}, d / "half.safetensors")
    want["one"] = v = vecs(1)[0]
    write_safetensors({"emb_params": torch.from_numpy(v)}, d / "one.safetensors")
    write_safetensors({"emb_params": torch.from_numpy(vecs(2, 32))}, d / "narrow.safetensors")
    want["narrow"] = None  # another width: ignored
    (d / "broken.pt").write_bytes(b"not a torch file")
    want["broken"] = None
    want["absent"] = None
    want["../shiny"] = None  # outside the directory
    return want


@pytest.mark.parametrize("name", ["shiny", "star", "raw", "towers", "sized", "half", "one",
                                  "narrow", "broken", "absent", "../shiny"])
def test_load_embed_formats_match_jax(tmp_path, name):
    """Each format (safetensors ``emb_params``, per-tower keys picked by
    ``embed_key`` or by width, ``.pt`` with ``string_to_param`` or a raw
    tensor, ``.bin``, F16, a 1-D vector) loads the same f32 (n, width)
    vectors as JAX's ``load_embed``; another width, a corrupt file, a
    missing name and a name outside the directory load nothing."""
    from stable_renderer_tpu.models.tokenizer import load_embed as j_load_embed

    from stable_renderer_tpu_torch.models.tokenizer import load_embed

    (tmp_path / "emb").mkdir()
    want = _write_embeddings(tmp_path / "emb")[name]
    out = load_embed(name, str(tmp_path / "emb"), WIDTH, "clip_l")
    ref = j_load_embed(name, str(tmp_path / "emb"), WIDTH, "clip_l")
    if want is None:
        assert out is None and ref is None
        return
    want = want.reshape(-1, WIDTH)
    assert out.dtype == np.float32 and out.shape == want.shape
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, ref)


PROMPTS = [
    "a (shiny:1.3) ball embedding:shiny, on a table",
    "embedding:star (red ((glossy))) sphere embedding:missing",
    " ".join(["word"] * 73) + " embedding:star embedding:shiny (tail:0.8) " + " ".join(
        ["more"] * 10),
    "",
    "embedding:towers,",
]


@functools.lru_cache(maxsize=None)
def _config():
    from stable_renderer_tpu_torch.models.clip import CLIPConfig

    return CLIPConfig(hidden_size=WIDTH, num_layers=2, num_heads=2, intermediate_size=128)


def _tokenizers(emb_dir):
    from stable_renderer_tpu.models.clip import CLIPConfig as JConfig, Tokenizer as JTokenizer

    from stable_renderer_tpu_torch.models.clip import Tokenizer

    c = _config()
    jc = JConfig(hidden_size=c.hidden_size, num_layers=c.num_layers, num_heads=c.num_heads,
                 intermediate_size=c.intermediate_size)
    return (JTokenizer(jc, embedding_directory=emb_dir),
            Tokenizer(c, embedding_directory=emb_dir))


def test_weighted_batch_ids_weights_and_vectors_match_jax(tmp_path):
    """Prompts mixing weights, embeddings (one missing, one followed by a
    comma, two past the first chunk) and more than 75 tokens: the ids
    (negative ids -(k+1) where the vectors sit), weights and the custom
    table of the padded batch equal JAX's."""
    (tmp_path / "emb").mkdir()
    _write_embeddings(tmp_path / "emb")
    jtok, tok = _tokenizers(str(tmp_path / "emb"))
    ids, weights, custom = tok.tokenize_weighted_batch(PROMPTS)
    jids, jweights, jcustom = jtok.tokenize_weighted_batch(PROMPTS)
    assert ids.shape == jids.shape == (len(PROMPTS), 2, 77)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(weights, jweights)
    np.testing.assert_array_equal(custom, jcustom)
    assert custom.shape == (2 + 3 + 3 + 2 + 2, WIDTH)
    # prompt 2's vectors sit past the first chunk, -(k+1) into the whole table
    assert (ids[2, 1] < 0).sum() == 5 and (ids[:, 0] < 0).sum() == 2 + 3 + 2
    assert not tok.tokenize_weighted_batch(["a plain prompt"])[2]


def test_clip_apply_with_custom_embeds_matches_jax(tmp_path):
    """``CLIPTextModel.apply`` with the batch's custom table, and the
    weighted multi-chunk encoding through ``encode_token_weights_batch``,
    against JAX's on the same params (the port's init, seed 0)."""
    from stable_renderer_tpu.models.clip import (
        CLIPTextModel as JCLIP,
        encode_token_weights_batch as j_encode,
    )

    from stable_renderer_tpu_torch.models.clip import CLIPTextModel, encode_token_weights_batch

    (tmp_path / "emb").mkdir()
    _write_embeddings(tmp_path / "emb")
    jtok, tok = _tokenizers(str(tmp_path / "emb"))
    ids, weights, custom = tok.tokenize_weighted_batch(PROMPTS)
    model = CLIPTextModel(_config())
    params = model.init(torch.Generator().manual_seed(0))
    jparams = {"text_model": _jnp(params["text_model"])}
    jmodel = JCLIP(jtok.config)
    flat = torch.from_numpy(ids.reshape(-1, 77))
    out = model.apply(params, flat, custom_embeds=torch.from_numpy(custom))
    ref = jmodel.apply(jparams, jnp.asarray(ids.reshape(-1, 77)), custom_embeds=jnp.asarray(custom))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    plain = model.apply(params, torch.clamp(flat, min=0))
    assert float((out - plain).abs().max()) > 1e-2  # the vectors moved the output
    for skip in (-1, -2):
        ctx, pooled = encode_token_weights_batch(
            model, params, torch.from_numpy(ids), torch.from_numpy(weights),
            custom_embeds=torch.from_numpy(custom), clip_skip=skip)
        jctx, jpooled = j_encode(jmodel, jparams, jnp.asarray(ids), jnp.asarray(weights),
                                 custom_embeds=jnp.asarray(custom), clip_skip=skip)
        np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), **TOL)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), **TOL)


def _jnp(tree):
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def test_pipeline_encodes_an_embedding_like_jax(tmp_path):
    """``DiffusionPipeline.encode_prompts`` with a tokenizer that reads the
    embedding directory: the conditioning of "a shiny ball embedding:shiny"
    (and a negative) equals the JAX pipeline's on the same CLIP params."""
    from test_torch_frame import _port_pipeline

    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.models.clip import CLIPTextModel as JCLIP
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig

    from stable_renderer_tpu_torch.models.clip import CLIPTextModel
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    (tmp_path / "emb").mkdir()
    _write_embeddings(tmp_path / "emb")
    jtok, tok = _tokenizers(str(tmp_path / "emb"))
    params = CLIPTextModel(_config()).init(torch.Generator().manual_seed(1))
    jpipe = JPipe.from_random(JConfig(), tiny=True, seed=0)
    jpipe.clip, jpipe.tokenizer = JCLIP(jtok.config), jtok
    jpipe.clip_params = {"text_model": _jnp(params["text_model"])}
    pipe = _port_pipeline(jpipe, RenderConfig())
    pipe.clip, pipe.tokenizer, pipe.clip_params = CLIPTextModel(_config()), tok, params
    prompts, negatives = ["a shiny ball embedding:shiny"], ["embedding:star, blurry"]
    ctx, nctx = pipe.encode_prompts(prompts, negatives)
    jctx, jnctx = jpipe.encode_prompts(prompts, negatives)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_allclose(nctx.numpy(), np.asarray(jnctx), **TOL)
    plain = pipe.encode_prompts(["a shiny ball shiny"], negatives)[0]
    assert float((ctx - plain).abs().max()) > 1e-2
