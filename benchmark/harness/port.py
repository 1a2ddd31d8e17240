"""The system under test: the port's pipeline and engine, built from a
configuration file, the benchmark's weight trees and a workload's render
block. Only this module and the drivers import the port."""

from __future__ import annotations


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def render_config(render: dict, seed: int):
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kv = render.get("stream_kv_layers")
    return RenderConfig(
        prompt=render.get("prompt", ""), negative_prompt=render.get("negative_prompt", ""),
        steps=int(render["steps"]), cfg_scale=float(render["cfg_scale"]),
        sampler=render["sampler"], scheduler=render["scheduler"],
        denoise=float(render["denoise"]), clip_skip=int(render.get("clip_skip", -1)),
        seed=int(seed), stream_pipeline=bool(render.get("stream", False)),
        stream_kv_layers=None if kv is None else tuple(kv), int8_conv=False,
    )


def pipeline(config: dict, weights: dict, render: dict, seed: int, device):
    """A DiffusionPipeline over ``weights`` (the trees themselves, in the
    configuration's types), calibrated to int8 when the render asks."""
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.models.clip import (
        CLIPConfig,
        CLIPTextModel,
        OpenCLIPConfig,
        OpenCLIPTextModel,
        Tokenizer,
    )
    from stable_renderer_tpu_torch.models.sampling import ModelSampling
    from stable_renderer_tpu_torch.models.unet import UNetConfig, UNetModel
    from stable_renderer_tpu_torch.models.vae import VAE, VAEConfig

    ccfg = CLIPConfig(**_tuples(config["clip"]))
    clip_g = None
    if config.get("clip_g"):
        clip_g = OpenCLIPTextModel(OpenCLIPConfig(**_tuples(config["clip_g"])))
    pipe = DiffusionPipeline(
        unet=UNetModel(UNetConfig(**_tuples(config["unet"]))),
        vae=VAE(VAEConfig(**_tuples(config["vae"]))), clip=CLIPTextModel(ccfg),
        tokenizer=Tokenizer(ccfg), unet_params=weights["unet"], vae_params=weights["vae"],
        clip_params=weights["clip"], config=render_config(render, seed),
        model_sampling=ModelSampling(prediction=render.get("prediction", "lcm")),
        device=device, clip_g=clip_g, clip_g_params=weights.get("clip_g"),
        model_family=config["family"],
    )
    if render.get("int8_conv"):
        pipe.quantize_convs(tuple(render["size"]))
    return pipe


def corresponder(spec: dict):
    from stable_renderer_tpu_torch.ops.correspondence import (
        DefaultCorresponder,
        OverlapCorresponder,
    )

    kinds = {"overlap": OverlapCorresponder, "default": DefaultCorresponder}
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in spec.items() if k != "kind"}
    return kinds[spec["kind"]](**fields)


def build_scene(scene: dict, render_mode: str = "normal", corrmap=None) -> None:
    """The workload's scene as GameObjects of the port's engine: a camera,
    and a sphere an object with its sprite, material and turn."""
    from stable_renderer_tpu_torch.data.sprite import Sprite
    from stable_renderer_tpu_torch.engine import (
        AutoRotation,
        Camera,
        GameObject,
        Mesh,
        MeshRenderer,
        SpriteInfo,
    )
    from stable_renderer_tpu_torch.engine.controls import EqualIntervalRotation
    from stable_renderer_tpu_torch.engine.material import Material

    c = scene["camera"]
    cam = GameObject("camera")
    cam.addComponent(Camera, fov=c["fov"], near=c["near"], far=c["far"]).env_prompt.prompt = \
        c.get("prompt", "")
    cam.transform.position = c["position"]
    cam.transform.lookAt(c["target"])
    for i, o in enumerate(scene["objects"]):
        go = GameObject(f"object{i}")
        go.addComponent(SpriteInfo, sprite=Sprite(spriteID=int(o["sprite_id"]),
                                                  prompt=o.get("prompt", "")))
        mesh = Mesh.Sphere(float(o["radius"]), int(o["segments"]))
        if render_mode == "bake":
            from stable_renderer_tpu_torch.engine.renderers import CorrMapRenderer

            r = go.addComponent(CorrMapRenderer, mesh=mesh, corrmaps=[corrmap])
            for m in r.materials:
                m.materialID = int(o["material_id"])
            go.addComponent(EqualIntervalRotation, axis=o["axis"], angle_deg=o["deg_per_turn"],
                            interval=int(o.get("interval", 1)))
        else:
            mat = Material.DefaultOpaqueMaterial()
            mat.materialID = int(o["material_id"])
            go.addComponent(MeshRenderer, mesh=mesh, materials=[mat])
            go.addComponent(AutoRotation, axis=o["axis"], speed_deg=o["deg_per_turn"])
