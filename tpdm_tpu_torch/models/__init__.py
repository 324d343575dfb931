"""Models of the port: the SD3 MMDiT, the SD1.5 / SDXL UNet, the Time
Prediction Module and the VAEs; the text towers in ``models.clip_text``
and ``models.t5``; LoRA adapters in ``models.lora``."""

from tpdm_tpu_torch.models.lora import apply_lora, init_lora, lora_param_count
from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from tpdm_tpu_torch.models.tpm import TimePredictor, reshape_tokens_to_2d
from tpdm_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from tpdm_tpu_torch.models.vae import VAE, VAEConfig
