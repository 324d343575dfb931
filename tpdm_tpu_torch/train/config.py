"""Training configuration.

The port's own copy of ``tpdm_tpu/train/config.py`` (which holds no JAX):
the reference's ``CustomRLOOConfig`` plus the trl ``RLOOConfig`` fields
the trainer consumes, with the reference's batch-size algebra in
``derive_batch_sizes``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class RLOOConfig:
    # --- experiment ---
    exp_name: str = "tpdm_rloo"
    seed: int = 42
    output_dir: str = "output"

    # --- episodes / epochs ---
    total_episodes: Optional[int] = None
    num_train_epochs: float = 1.0

    # --- batch algebra (trl names) ---
    per_device_train_batch_size: int = 2
    gradient_accumulation_steps: int = 1
    num_mini_batches: int = 1
    rloo_k: int = 2
    num_ppo_epochs: int = 1
    world_size: int = 1  # number of data-parallel replicas

    # --- optimization (paper recipe: launch_sd3_train.sh:16-40) ---
    learning_rate: float = 1e-6
    adam_beta1: float = 0.9
    adam_beta2: float = 0.99
    adam_epsilon: float = 1e-5
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "constant"  # constant|constant_with_warmup|linear|cosine
    warmup_steps: int = 0

    # --- RLOO / PPO ---
    cliprange: float = 0.2
    kl_coef: float = 0.05
    gamma: float = 0.90
    mean_kl: bool = False
    # Advantage estimator over the rloo_k repeats of each prompt:
    #   "rloo": leave-one-out baseline (the reference, rloo_trainer.py:453-461)
    #   "grpo": group-normalized (r - mean) / (std + eps) — DeepSeekMath-style
    #           group-relative policy optimization; beyond-reference option
    #           useful when rloo_k is small and reward scales drift.
    advantage_estimator: str = "rloo"
    # EMA of the trainable TPM policy (0 = disabled). When enabled the
    # trainer keeps an exponential moving average of the TPM's parameters,
    # updated once per update; callbacks receive the EMA weights and
    # checkpoints carry them (ema.pt) — beyond the reference, which evals
    # the live policy.
    ema_decay: float = 0.0

    # --- policy (CustomRLOOConfig custom fields) ---
    init_alpha: float = 1.5
    init_beta: float = 0.5
    # Collapse guard (beyond-reference; see models/tpm.py param_cap): bound
    # the TPM's alpha/beta at epsilon + tpm_param_cap so a policy that
    # collapses to the 1-step optimum saturates finitely instead of blowing
    # past fp32 at the ratio-clamp boundary and NaN-skipping every
    # subsequent update. None = reference exp() parity. Only consulted when
    # the agent builds its default TPM.
    tpm_param_cap: Optional[float] = None
    # Alarm when the NaN-skip fraction over the last `skip_alarm_window`
    # logged updates exceeds `skip_alarm_threshold`: a collapsed run skips
    # forever behind the finite-guard, which otherwise looks like healthy
    # training (metric: policy/skip_rate; a WARNING log fires).
    skip_alarm_window: int = 8
    skip_alarm_threshold: float = 0.5
    relative: bool = True
    prediction_type: str = "alpha_beta"
    max_inference_steps: int = 28
    min_sigma: float = 0.01  # RLOO wrapper default (modeling_sd3_pnt.py:734)
    guidance_scale: Optional[float] = 7.0
    # Latent integrator for the rollout loop: "euler" (the reference's
    # rule) or "ab2" (two-step Adams–Bashforth at one model evaluation a
    # step); the replays are the same for both
    solver: str = "euler"

    # --- activation-cache placement during PPO replay ---
    # The rollout's replay cache (h_cache/temb_cache, ~25 MB a sample a step
    # in bf16) dominates training memory. "none": the cache stays on the
    # card, the only mode ported. "host" (a device->host copy after the
    # rollout, micro-batch slices shipped back per PPO step) waits for
    # ROADMAP queue 1, item 9(c); the JAX package's "xla" (pinned-host XLA
    # out_shardings) is a TPU workaround with no CUDA counterpart.
    # RLOOTrainer raises on both.
    offload_cache: str = "none"

    # --- bookkeeping ---
    logging_steps: int = 1
    save_steps: int = 0  # 0 = disabled
    # Keep at most this many checkpoint-N dirs (oldest pruned after each
    # save); None = keep all. HF-flag-name parity: the reference inherits
    # save_total_limit from TrainingArguments and rotates via
    # Trainer._rotate_checkpoints.
    save_total_limit: Optional[int] = None
    eval_steps: int = 0  # 0 = disabled
    # "none"; "tensorboard" waits for the callbacks (ROADMAP queue 1, item 9(b))
    report_to: str = "none"

    # ------------------------------------------------------------------
    def derive_batch_sizes(self, train_dataset_len: int) -> dict:
        """Reference batch algebra (rloo_trainer.py:112-138)."""
        local_batch_size = (
            self.per_device_train_batch_size
            * self.gradient_accumulation_steps
            * self.num_mini_batches
        )
        batch_size = local_batch_size * self.world_size
        total_episodes = self.total_episodes
        if total_episodes is None:
            total_episodes = int(self.num_train_epochs * train_dataset_len)

        def exact_div(a, b, what):
            if a % b != 0:
                raise ValueError(f"{what}: {a} not divisible by {b}")
            return a // b

        local_dataloader_batch_size = exact_div(
            local_batch_size, self.rloo_k, "local_batch_size/rloo_k"
        )
        return dict(
            local_batch_size=local_batch_size,
            micro_batch_size=self.per_device_train_batch_size * self.world_size,
            batch_size=batch_size,
            mini_batch_size=exact_div(
                batch_size, self.num_mini_batches, "batch_size/num_mini_batches"
            ),
            local_mini_batch_size=exact_div(
                local_batch_size,
                self.num_mini_batches,
                "local_batch_size/num_mini_batches",
            ),
            num_total_batches=math.ceil(total_episodes / batch_size),
            local_dataloader_batch_size=local_dataloader_batch_size,
            # global prompts per update
            dataloader_batch_size=local_dataloader_batch_size * self.world_size,
            total_episodes=total_episodes,
        )
