from stable_renderer_tpu_torch.models.clip import CLIPTextModel, Tokenizer
from stable_renderer_tpu_torch.models.unet import AttnHooks, UNetConfig, UNetModel
from stable_renderer_tpu_torch.models.vae import VAE, VAEConfig

__all__ = ["AttnHooks", "CLIPTextModel", "Tokenizer", "UNetConfig", "UNetModel", "VAE",
           "VAEConfig"]
