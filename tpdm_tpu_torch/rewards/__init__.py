"""Reward models of the port: ImageReward (BLIP ViT-L + BERT-med with
cross-attention + an MLP head)."""

from tpdm_tpu_torch.rewards.bert import BertMedConfig, BertMedModel
from tpdm_tpu_torch.rewards.image_reward import ImageRewardModel, ImageRewardNet, RewardMLP
from tpdm_tpu_torch.rewards.vit import ViT, ViTConfig
