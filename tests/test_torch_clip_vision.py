"""The port's models/clip_vision.py against the JAX package's, on the CPU at
the tiny config (2 layers, 64 wide, 28x28 images of 2x2 patches).

The same parameters (JAX's init handed across by ``params_from_numpy``, or a
written file both packages read) and the same numpy-seeded images go
through both towers. The resize of ``clip_preprocess`` (``jax.image.resize``
"cubic": Keys' cubic, a = -0.5, antialiased when shrinking) is held at a
shrink, a non-square input and an upscale within RESIZE_TOL; the quantized
pixels then agree exactly, except where a resized value lies within
RESIZE_TOL of a rounding boundary (half an 8-bit step), where the two sums'
last bits may round either way. The tower's three outputs agree within TOL
(f32, summation order only).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stable_renderer_tpu.models.clip_vision as jcv
import stable_renderer_tpu_torch.models.clip_vision as pcv
from stable_renderer_tpu_torch.convert import params_from_numpy

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)   # f32 tower: summation order only
RESIZE_TOL = 1e-5                  # f32 resize: the weights' sums, in another order
RNG = np.random.default_rng(17)


def jax_tower(cfg=None, seed=0):
    """(JAX model, JAX params, port model, port params) of one config, the
    port's params JAX's handed across."""
    cfg = cfg or jcv.TINY_VISION_CONFIG
    jm = jcv.CLIPVisionModel(cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    pm = pcv.CLIPVisionModel(pcv.CLIPVisionConfig(**cfg.__dict__))
    return jm, jp, pm, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def assert_output(out, ref, tol=TOL):
    assert isinstance(out, pcv.VisionOutput)
    for name in pcv.VisionOutput._fields:
        a, b = getattr(out, name), np.asarray(getattr(ref, name))
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **tol)


def test_configs_are_jax_s():
    for name in ("VITL_CONFIG", "VITH_CONFIG", "VITG_CONFIG", "TINY_VISION_CONFIG"):
        assert getattr(pcv, name).__dict__ == getattr(jcv, name).__dict__, name
    assert pcv._CLIP_MEAN == jcv._CLIP_MEAN and pcv._CLIP_STD == jcv._CLIP_STD


@pytest.mark.parametrize("hw, out_hw", [
    ((512, 512), (224, 224)),   # shrink (antialiased)
    ((100, 160), (28, 45)),     # non-square shrink
    ((37, 53), (224, 320)),     # non-square upscale
    ((16, 24), (28, 42)),       # upscale
])
def test_resize_cubic_matches_jax(hw, out_hw):
    x = RNG.uniform(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out_hw, 3), "cubic"))
    got = pcv.resize_cubic(torch.from_numpy(x), *out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


@pytest.mark.parametrize("hw, size", [((512, 512), 224), ((100, 160), 28), ((16, 24), 28),
                                      ((28, 28), 28)])
def test_clip_preprocess_matches_jax(hw, size):
    """A shrink, a non-square input, an upscale and no resize: the quantized,
    normalized pixels equal JAX's except at rounding boundaries."""
    x = RNG.uniform(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jcv.clip_preprocess(jnp.asarray(x), size))
    got = pcv.clip_preprocess(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape == (2, size, size, 3)
    resized = x
    if hw != (size, size):
        scale = size / min(hw)
        nh, nw = round(scale * hw[0]), round(scale * hw[1])
        top, left = (nh - size) // 2, (nw - size) // 2
        resized = np.asarray(jax.image.resize(jnp.asarray(x), (2, nh, nw, 3), "cubic"))[
            :, top:top + size, left:left + size]
    frac = np.abs((np.clip(resized * 255.0, 0, 255) % 1.0) - 0.5)
    boundary = frac < RESIZE_TOL * 255.0
    np.testing.assert_allclose(got[~boundary], want[~boundary], atol=1e-6, rtol=0)
    assert boundary.mean() < 4 * 255.0 * RESIZE_TOL  # the window's share, about 2 * 255 * tol


def test_vision_output_matches_jax():
    """apply on preprocessed pixels and encode_image on a raw non-square
    image: last hidden state, penultimate and image embeds within TOL."""
    jm, jp, pm, pp = jax_tower()
    pix = RNG.standard_normal((2, 28, 28, 3)).astype(np.float32)
    assert_output(pm.apply(pp, torch.from_numpy(pix)),
                  jax.jit(jm.apply)(jp, jnp.asarray(pix)))
    img = RNG.uniform(size=(2, 28, 40, 3)).astype(np.float32)
    out = pm.encode_image(pp, torch.from_numpy(img))
    assert_output(out, jax.jit(jm.encode_image)(jp, jnp.asarray(img)))
    assert out.image_embeds.shape == (2, 32) and out.last_hidden_state.shape == (2, 5, 64)
    assert not torch.allclose(out.last_hidden_state, out.penultimate_hidden_states)


def test_tower_computes_in_the_input_dtype():
    """bf16 weights under an f32 image compute in f32, as JAX's; a bf16
    image computes in bf16."""
    from stable_renderer_tpu_torch.models.weights import tree_to

    _, _, pm, pp = jax_tower()
    bf = tree_to(pp, "cpu", torch.bfloat16)
    img = torch.from_numpy(RNG.uniform(size=(1, 28, 28, 3)).astype(np.float32))
    assert pm.encode_image(bf, img).image_embeds.dtype == torch.float32
    pix = pcv.clip_preprocess(img, 28).to(torch.bfloat16)
    assert pm.apply(bf, pix).image_embeds.dtype == torch.bfloat16


@pytest.mark.parametrize("depth, want", [(48, "VITG_CONFIG"), (32, "VITH_CONFIG"),
                                         (24, "VITL_CONFIG"), (12, None)])
def test_detect_vision_config_like_jax(depth, want):
    keys = [f"vision_model.encoder.layers.{i}.layer_norm1.weight" for i in range(depth)]
    got, ref = pcv.detect_vision_config(keys), jcv.detect_vision_config(keys)
    assert (got is None) == (ref is None) == (want is None)
    if want:
        assert got is getattr(pcv, want) and got.__dict__ == ref.__dict__


def test_load_clip_vision_from_a_written_file(tmp_path):
    """A transformers-layout file at ViT-L's depth (narrow widths) loads in
    both packages to the same config and leaves, and encodes alike."""
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    cfg = pcv.CLIPVisionConfig(hidden_size=32, num_layers=24, num_heads=2,
                               intermediate_size=64, image_size=28, patch_size=14,
                               projection_dim=16)
    tree = pcv.CLIPVisionModel(cfg).init(torch.Generator().manual_seed(3))
    write_safetensors(flatten(tree), tmp_path / "vision.safetensors")
    pm, pp = pcv.load_clip_vision(str(tmp_path / "vision.safetensors"), device="cpu")
    jm, jp = jcv.load_clip_vision(str(tmp_path / "vision.safetensors"))
    assert pm.config is pcv.VITL_CONFIG and jm.config is jcv.VITL_CONFIG
    assert flatten(pp).keys() == flatten(tree).keys()
    for k, v in flatten(pp).items():
        assert torch.equal(v, flatten(tree)[k]), k
    # the file's widths under ViT-L's config: encode at the file's own
    # config to compare the loaded leaves
    pm, jm = pcv.CLIPVisionModel(cfg), jcv.CLIPVisionModel(jcv.CLIPVisionConfig(**cfg.__dict__))
    img = RNG.uniform(size=(1, 28, 28, 3)).astype(np.float32)
    assert_output(pm.encode_image(pp, torch.from_numpy(img)),
                  jax.jit(jm.encode_image)(jp, jnp.asarray(img)))


def test_load_clip_vision_rejects_other_files(tmp_path):
    from stable_renderer_tpu_torch.models.weights import write_safetensors

    write_safetensors({"foo.weight": torch.zeros(2)}, tmp_path / "x.safetensors")
    with pytest.raises(ValueError, match="not a recognized CLIP vision checkpoint"):
        pcv.load_clip_vision(str(tmp_path / "x.safetensors"), device="cpu")
