"""The port's checkpoint reading and detection (models/weights.py,
models/diffusers_convert.py) against the safetensors library and the JAX
package, on the CPU.

Tensors are compared bit for bit: reading and re-nesting copy no value.
Detection runs on flat dicts of zero-stride ``np.broadcast_to`` views with
the SD1.5, SD2, SDXL and inpaint UNets' keys and shapes (from
``jax.eval_shape`` of the JAX package's ``init``), so no full-width array is
allocated.
"""

from __future__ import annotations

import json
import os
from dataclasses import replace

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": ml_dtypes.bfloat16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
    "BOOL": np.bool_,
}


def _array(dtype, shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return np.asarray(rng.random(shape) > 0.5)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.asarray(rng.integers(max(info.min, -1000), min(info.max, 1000), shape), dtype)
    return np.asarray(rng.standard_normal(shape) * 3, dtype)


def _bits(x) -> bytes:
    """The raw little-endian bytes of a tensor or array."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    return np.ascontiguousarray(x).tobytes()


# --- the safetensors reader and writer --------------------------------------------


@pytest.mark.parametrize("name", sorted(_DTYPES))
def test_read_safetensors_matches_the_library_and_jax(tmp_path, name):
    """Every dtype the reader takes, written by ``safetensors.numpy``: the
    port's tensors carry the library's bytes, shape and dtype, as JAX's
    ``load_state_dict`` reads them; scalars and empty tensors too; the
    header's metadata is passed over."""
    from safetensors import safe_open
    from safetensors.numpy import save_file

    from stable_renderer_tpu.models.weights import load_state_dict as j_load

    from stable_renderer_tpu_torch.models.weights import _ST_DTYPES, read_safetensors

    dt = _DTYPES[name]
    arrays = {"a.weight": _array(dt, (3, 5, 2)), "b": _array(dt, (7,), seed=1),
              "scalar": _array(dt, (), seed=2), "empty": np.zeros((0, 4), dt)}
    path = tmp_path / "x.safetensors"
    save_file(arrays, str(path), metadata={"format": "pt", "note": name})
    out = read_safetensors(path)
    ref = j_load(path)
    with safe_open(str(path), framework="np") as f:
        lib = {k: f.get_tensor(k) for k in f.keys()}
    assert sorted(out) == sorted(arrays) == sorted(lib) == sorted(ref)
    for k, a in arrays.items():
        assert out[k].dtype == _ST_DTYPES[name][0], k
        assert tuple(out[k].shape) == a.shape == lib[k].shape == ref[k].shape, k
        assert _bits(out[k]) == _bits(a) == _bits(lib[k]) == _bits(ref[k]), k


def _corrupt(tmp_path, case: str):
    """A safetensors file broken in one way."""
    good = {"x": {"dtype": "F32", "shape": [2, 2], "data_offsets": [0, 16]},
            "y": {"dtype": "F16", "shape": [4], "data_offsets": [16, 24]}}
    header, body = dict(good), bytes(24)
    if case == "overlap":
        header["y"] = {"dtype": "F16", "shape": [4], "data_offsets": [8, 16]}
    elif case == "past_the_buffer":
        header["y"] = {"dtype": "F16", "shape": [8], "data_offsets": [16, 32]}
    elif case == "wrong_length":
        header["y"] = {"dtype": "F16", "shape": [3], "data_offsets": [16, 24]}
    elif case == "unknown_dtype":
        header["y"] = {"dtype": "C64", "shape": [1], "data_offsets": [16, 24]}
    elif case == "malformed_entry":
        header["y"] = {"dtype": "F16", "shape": [4]}
    raw = json.dumps(header).encode()
    if case == "not_json":
        raw = b"{not json" + bytes(7)
    n = len(raw) if case != "header_past_the_file" else 10 ** 6
    path = tmp_path / f"{case}.safetensors"
    path.write_bytes(n.to_bytes(8, "little") + raw + (b"" if case == "truncated" else body)
                     if case != "too_short" else b"\x01\x02")
    return path


@pytest.mark.parametrize("case", ["overlap", "past_the_buffer", "wrong_length", "unknown_dtype",
                                  "malformed_entry", "not_json", "header_past_the_file",
                                  "truncated", "too_short"])
def test_read_safetensors_rejects_corrupt_files(tmp_path, case):
    """A corrupt header, offsets that overlap or run past the buffer, or a
    span that does not hold its shape's bytes raise ValueError before any
    tensor is made; the uncorrupted file reads."""
    from stable_renderer_tpu_torch.models.weights import read_safetensors

    with pytest.raises(ValueError):
        read_safetensors(_corrupt(tmp_path, case))
    assert sorted(read_safetensors(_corrupt(tmp_path, "good"))) == ["x", "y"]


def test_write_safetensors_round_trips(tmp_path):
    """The port's writer, given torch tensors (bf16 included) and numpy
    arrays, writes files the library and JAX's reader read back bit for
    bit; offsets are aligned; the port reads its own
    files back; non-writable input raises."""
    from safetensors import safe_open

    from stable_renderer_tpu.models.weights import load_state_dict as j_load

    from stable_renderer_tpu_torch.models.weights import read_safetensors, write_safetensors

    tensors = {f"t.{name}": torch.from_numpy(_array(dt, (3, 4), seed=i).view(np.int16))
               .view(torch.bfloat16) if name == "BF16" else torch.from_numpy(_array(dt, (3, 4),
                                                                                    seed=i))
               for i, (name, dt) in enumerate(_DTYPES.items())}
    tensors["np.f16"] = _array(np.float16, (5,), seed=20)
    tensors["np.bf16"] = _array(ml_dtypes.bfloat16, (2, 3), seed=21)
    tensors["view"] = torch.arange(12, dtype=torch.float32).reshape(3, 4).t()  # not contiguous
    path = tmp_path / "w.safetensors"
    size = write_safetensors(tensors, path)
    assert size == os.path.getsize(path)
    with safe_open(str(path), framework="np") as f:
        lib = {k: f.get_tensor(k) for k in f.keys()}
    ref, back = j_load(path), read_safetensors(path)
    n = int.from_bytes(path.read_bytes()[:8], "little")
    header = json.loads(path.read_bytes()[8:8 + n])
    for k, t in tensors.items():
        want = _bits(t.contiguous() if isinstance(t, torch.Tensor) else t)
        assert _bits(lib[k]) == _bits(ref[k]) == _bits(back[k]) == want, k
        begin = header[k]["data_offsets"][0]
        assert (8 + n + begin) % np.dtype(lib[k].dtype).itemsize == 0, k
    with pytest.raises(ValueError, match="not writable"):
        write_safetensors({"c": torch.zeros(2, dtype=torch.complex64)}, tmp_path / "c.safetensors")


def test_ckpt_loads_like_jax(tmp_path):
    """A torch ``.ckpt`` with a ``state_dict`` entry and non-tensor entries:
    both packages read the same tensors (torch.load(weights_only=True))."""
    from stable_renderer_tpu.models.weights import load_state_dict as j_load

    from stable_renderer_tpu_torch.models.weights import load_state_dict

    sd = {"model.diffusion_model.a.weight": torch.randn(4, 3),
          "first_stage_model.b": torch.randn(5).half(),
          "cond_stage_model.transformer.text_model.embeddings.position_ids": torch.arange(77)[None]}
    path = tmp_path / "m.ckpt"
    torch.save({"state_dict": sd, "global_step": 7, "epoch": 1}, path)
    out, ref = load_state_dict(path), j_load(path)
    assert sorted(out) == sorted(ref) == sorted(sd)
    for k in sd:
        assert out[k].dtype == sd[k].dtype and torch.equal(out[k], sd[k]), k
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)
    torch.save(sd, tmp_path / "bare.pt")  # no state_dict wrapper
    assert sorted(load_state_dict(tmp_path / "bare.pt")) == sorted(sd)


# --- detection ------------------------------------------------------------------------


def _shape_flat(jcfg, prefix="model.diffusion_model."):
    """A JAX UNet config's checkpoint keys and shapes as zero-stride f16 views."""
    from stable_renderer_tpu.models.unet import UNetModel as JUNet
    from stable_renderer_tpu.models.weights import flatten as j_flatten

    tree = jax.eval_shape(lambda: JUNet(jcfg).init(jax.random.PRNGKey(0)))
    zero = np.zeros((), np.float16)
    return {prefix + k: np.broadcast_to(zero, v.shape) for k, v in j_flatten(tree).items()}


def _cases():
    from stable_renderer_tpu.models.unet import (
        SD15_UNET_CONFIG as JSD15,
        SDXL_UNET_CONFIG as JSDXL,
        TINY_UNET_CONFIG as JTINY,
    )

    sd2 = replace(JSD15, context_dim=1024, head_dim=64)
    return {
        "sd15": (JSD15, None),
        "sd1_tiny": (replace(JTINY, context_dim=768, num_heads=8), None),
        "sd2_eps": (sd2, 0.01),
        "sd2_v": (sd2, 0.2),
        "sdxl": (JSDXL, None),
        "sd15_inpaint": (replace(JSD15, in_channels=9), None),
    }


_FIELDS = ("in_channels", "model_channels", "channel_mult", "num_res_blocks",
           "num_res_blocks_per_level", "transformer_depth_blocks", "transformer_depth_blocks_out",
           "transformer_depth_middle", "disable_self_attn_levels", "context_dim", "head_dim",
           "adm_in_channels", "num_classes")


@pytest.mark.parametrize("case", ["sd15", "sd1_tiny", "sd2_eps", "sd2_v", "sdxl", "sd15_inpaint"])
def test_detection_matches_jax(case):
    """``detect_unet_layout`` reads every field JAX's ``detect_unet_config``
    reads, and ``detect_model_family`` gives JAX's family and prediction
    (the SD2 out-layer statistic decides eps or v). SD1.x dicts map to the
    port's ``UNetConfig``, the 9-channel inpaint UNet included (its
    ``in_channels`` JAX's); SD2 and SDXL raise naming ROADMAP 1.11."""
    from stable_renderer_tpu.models.weights import (
        detect_model_family as j_family,
        detect_unet_config as j_detect,
    )

    from stable_renderer_tpu_torch.models.unet import SD15_UNET_CONFIG, UNetConfig
    from stable_renderer_tpu_torch.models.weights import (
        detect_model_family,
        detect_unet_config,
        detect_unet_layout,
    )

    jcfg, norm_std = _cases()[case]
    flat = _shape_flat(jcfg)
    if norm_std is not None:  # the SD2 eps-vs-v statistic reads real values
        key = "model.diffusion_model.output_blocks.11.1.transformer_blocks.0.norm1.bias"
        flat[key] = (np.random.default_rng(0).standard_normal(flat[key].shape)
                     * norm_std).astype(np.float16)
    ref = j_detect(flat)
    layout = detect_unet_layout(flat)
    for name in _FIELDS:
        assert getattr(layout, name) == getattr(ref, name), name
    fam = detect_model_family(flat, layout)
    assert fam == j_family(flat, ref)
    if case == "sd15":
        assert detect_unet_config(flat) == SD15_UNET_CONFIG
    elif case == "sd1_tiny":
        assert detect_unet_config(flat) == UNetConfig(
            model_channels=32, num_res_blocks=1, channel_mult=(1, 2), attention_levels=(0, 1),
            num_heads=8, context_dim=768)
    elif case == "sd15_inpaint":
        assert fam == {"family": "sd1", "prediction": "eps", "noise_aug_dim": None}
        got = detect_unet_config(flat)
        assert got == replace(SD15_UNET_CONFIG, in_channels=9)
        assert got.in_channels == ref.in_channels == 9
    else:
        assert fam["family"] == {"sd2_eps": "sd2", "sd2_v": "sd2", "sdxl": "sdxl"}[case]
        assert fam["prediction"] == ("v" if case == "sd2_v" else "eps")
        with pytest.raises(NotImplementedError, match="ROADMAP 1.11"):
            detect_unet_config(flat)


def test_split_checkpoint_consumes_every_key():
    """A full SD1.5 checkpoint's keys (the UNet's, VAE's and CLIP's, as
    zero-stride views) split into three trees that hold every key once, each
    with the keys and shapes of the port's model's ``init`` (on the meta
    device); ``load_checkpoint_flat`` detects SD1.5."""
    from stable_renderer_tpu.models.unet import SD15_UNET_CONFIG as JSD15

    from stable_renderer_tpu_torch.models.clip import SD15_CLIP_CONFIG, CLIPTextModel
    from stable_renderer_tpu_torch.models.unet import SD15_UNET_CONFIG, UNetModel
    from stable_renderer_tpu_torch.models.vae import SD15_VAE_CONFIG, VAE
    from stable_renderer_tpu_torch.models.weights import flatten, load_checkpoint_flat

    models = {"first_stage_model.": VAE(SD15_VAE_CONFIG).init(device="meta"),
              "cond_stage_model.transformer.": CLIPTextModel(SD15_CLIP_CONFIG).init(
                  device="meta")}
    flat = _shape_flat(JSD15)
    zero = np.zeros((), np.float16)
    for prefix, tree in models.items():
        flat.update({prefix + k: np.broadcast_to(zero, v.shape) for k, v in flatten(tree).items()})
    unet, vae, clip, cfg, family = load_checkpoint_flat(flat, "<shapes>")
    assert cfg == SD15_UNET_CONFIG and family == {"family": "sd1", "prediction": "eps",
                                                  "noise_aug_dim": None}
    trees = {"model.diffusion_model.": unet, "first_stage_model.": vae,
             "cond_stage_model.transformer.": clip}
    assert sum(len(flatten(t)) for t in trees.values()) == len(flat)
    models["model.diffusion_model."] = UNetModel(SD15_UNET_CONFIG).init(device="meta")
    for prefix, tree in trees.items():
        want = {k: tuple(v.shape) for k, v in flatten(models[prefix]).items()}
        assert {k: tuple(v.shape) for k, v in flatten(tree).items()} == want, prefix


# --- diffusers folders --------------------------------------------------------------


def _to_diffusers_unet(key: str) -> str:
    """An ldm UNet key in diffusers' names: the JAX package's tables read
    backwards (the folder a diffusers export of the same UNet would hold)."""
    from stable_renderer_tpu.models.diffusers_convert import (
        UNET_MAP,
        UNET_MAP_LAYER,
        UNET_MAP_RESNET,
    )

    for sd, hf in UNET_MAP:
        if key == sd:
            return hf
    for sd, hf in UNET_MAP_LAYER:
        if key.startswith(sd):
            key = hf + key[len(sd):]
            break
    if "resnets" in key:
        for sd, hf in UNET_MAP_RESNET:
            key = key.replace(sd, hf)
    return key


def _to_diffusers_vae(key: str, value: np.ndarray):
    from stable_renderer_tpu.models.diffusers_convert import VAE_MAP

    for sd, hf in VAE_MAP:
        key = key.replace(sd, hf)
    if "attentions" in key:
        head, leaf = key.rsplit(".", 2)[0], ".".join(key.rsplit(".", 2)[1:])
        name, kind = leaf.split(".")
        name = {"norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v",
                "proj_out": "to_out.0"}[name]
        if kind == "weight" and value.ndim == 4:
            value = value.reshape(value.shape[:2])  # 1x1 conv -> linear
        key = f"{head}.{name}.{kind}"
    return key, value


def test_load_diffusers_folder_matches_jax(tmp_path):
    """A small SD1.x-topology model (4 levels x 2 res blocks, 32 channels)
    exported as a diffusers folder (unet/, vae/, text_encoder/): both
    packages convert it to the same ldm flat dict, bit for bit, and the
    keys and values are the model's own; ``load_checkpoint`` of the folder
    detects its UNet."""
    from stable_renderer_tpu.models.diffusers_convert import load_diffusers_folder as j_folder

    from stable_renderer_tpu_torch.models.clip import TINY_CLIP_CONFIG, CLIPTextModel
    from stable_renderer_tpu_torch.models.diffusers_convert import load_diffusers_folder
    from stable_renderer_tpu_torch.models.unet import UNetConfig, UNetModel
    from stable_renderer_tpu_torch.models.vae import VAE, VAEConfig
    from stable_renderer_tpu_torch.models.weights import flatten, load_checkpoint, write_safetensors

    ucfg = UNetConfig(model_channels=32, channel_mult=(1, 2, 4, 4), num_heads=8)
    g = torch.Generator().manual_seed(0)
    ldm = {
        "model.diffusion_model.": flatten(UNetModel(ucfg).init(g, dtype=torch.float16)),
        "first_stage_model.": flatten(VAE(VAEConfig(ch=32)).init(g, dtype=torch.float16)),
        "cond_stage_model.transformer.": flatten(CLIPTextModel(TINY_CLIP_CONFIG).init(g)),
    }
    unet = {_to_diffusers_unet(k): v for k, v in ldm["model.diffusion_model."].items()}
    vae = dict(_to_diffusers_vae(k, v) for k, v in ldm["first_stage_model."].items())
    for sub, tensors, name in (("unet", unet, "diffusion_pytorch_model.safetensors"),
                               ("vae", vae, "diffusion_pytorch_model.safetensors"),
                               ("text_encoder", ldm["cond_stage_model.transformer."],
                                "model.safetensors")):
        (tmp_path / sub).mkdir()
        write_safetensors(tensors, tmp_path / sub / name)
    out, ref = load_diffusers_folder(str(tmp_path)), j_folder(str(tmp_path))
    want = {p + k: v for p, tree in ldm.items() for k, v in tree.items()}
    assert sorted(out) == sorted(ref) == sorted(want)
    for k, v in want.items():
        assert tuple(out[k].shape) == tuple(ref[k].shape) == tuple(v.shape), k
        assert _bits(out[k]) == _bits(ref[k]) == _bits(v.contiguous()), k
    assert load_checkpoint(str(tmp_path))[3] == ucfg


# --- TAESD files -----------------------------------------------------------------------


def test_taesd_load_round_trips_like_jax(tmp_path):
    """TAESD trees written as the official files (an encoder .safetensors by
    the port's writer, a decoder .pth by torch.save) load back equal, in
    both packages; a path left out gives an empty tree."""
    from stable_renderer_tpu.models.taesd import TAESD as JTAESD

    from stable_renderer_tpu_torch.models.taesd import TAESD
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    params = TAESD().init(torch.Generator().manual_seed(3))
    enc, dec = tmp_path / "taesd_encoder.safetensors", tmp_path / "taesd_decoder.pth"
    write_safetensors(flatten(params["encoder"]), enc)
    torch.save(flatten(params["decoder"]), dec)
    out, ref = TAESD.load(str(enc), str(dec)), JTAESD.load(str(enc), str(dec))
    for part in ("encoder", "decoder"):
        want, got, jgot = flatten(params[part]), flatten(out[part]), flatten(ref[part])
        assert sorted(got) == sorted(jgot) == sorted(want), part
        for k, v in want.items():
            assert torch.equal(got[k], v), k
            np.testing.assert_array_equal(jgot[k], v.numpy(), err_msg=k)
    assert TAESD.load(decoder_path=str(dec))["encoder"] == {}
