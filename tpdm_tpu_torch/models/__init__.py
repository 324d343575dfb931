"""Models of the port: the SD3 MMDiT, the Time Prediction Module and the
SD3 VAE decoder."""

from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from tpdm_tpu_torch.models.tpm import TimePredictor, reshape_tokens_to_2d
from tpdm_tpu_torch.models.vae import VAE, VAEConfig
