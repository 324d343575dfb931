"""Training of the port: RLOO/PPO of the TPM over a frozen SD3 backbone,
its config, checkpoints and builders; the SD1.5 agent in
``train.sd15_agent``."""

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
from tpdm_tpu_torch.train.sd15_agent import SD15Agent
