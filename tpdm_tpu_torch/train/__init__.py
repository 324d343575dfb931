"""Training of the port: RLOO/PPO of the TPM over a frozen backbone, its
config, checkpoints and builders, and the agents of every family: SD3
(``TPDMAgent``), SD1.5, SDXL (base, refiner and the joint ensemble) and
FLUX."""

from tpdm_tpu_torch.train.config import RLOOConfig
from tpdm_tpu_torch.train.rloo import (
    RLOOTrainer,
    TPDMAgent,
    TPMOptimizer,
    compute_advantages,
    compute_beta_kl_penalty,
    discounted_rewards,
    grpo_advantages,
    ppo_loss,
    rloo_advantages,
)
from tpdm_tpu_torch.train.flux_agent import FluxAgent
from tpdm_tpu_torch.train.sd15_agent import SD15Agent
from tpdm_tpu_torch.train.sdxl_agent import (
    EnsembleSampleOutput,
    SDXLAgent,
    SDXLEnsembleAgent,
    SDXLRefinerAgent,
)
