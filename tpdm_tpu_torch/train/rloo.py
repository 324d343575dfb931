"""RLOO/PPO training of the Time Prediction Module.

Counterpart of ``tpdm_tpu/train/rloo.py`` on one card:

- Experience collection is the adaptive rollout (``pipeline/sampler.py``,
  no grad): the frozen MMDiT with K1 at every joint attention, the TPM
  drawing each step's ratio, and (in the cached replay mode) each step's
  ``(h_combined, temb)`` kept on the card.
- The PPO epochs re-run only the TPM over those activations
  (``replay_logprobs``) under autograd; the backbone never needs a
  gradient, so no kernel needs a backward. In the recompute mode the frozen
  backbone re-runs on the recorded chain under ``torch.no_grad()`` first.
- The optimizer reproduces the JAX trainer's optax chain: gradients clipped
  by their global norm, then Adam with a learning rate set by hand each
  step from the ported schedules, inside ``optax.MultiSteps`` (the mean of
  the micro-step gradients is applied once per accumulation boundary). A
  micro-step whose loss or gradient is not finite is skipped whole: the
  parameters, Adam's moments and count, and the accumulator stay as they
  were.

- ``offload_cache="host"`` moves the rollout's time-major caches to host
  memory (pinned) right after the rollout; each PPO micro-step slices them
  there and moves only its slice back to the card.

The trainer takes any agent of the protocol (sample, replay, logprobs,
kl_divergence, init_tpm_params): ``TPDMAgent`` here, ``SD15Agent``,
``SDXLAgent``, ``FluxAgent`` and ``SDXLEnsembleAgent``, whose TPM is an
``nn.ModuleDict`` of two heads that one Adam step updates together. The
command-line entry point is ``tpdm_tpu_torch/train/main.py``. Not ported
yet: data parallelism (DDP over NCCL; ROADMAP queue 1, item 9(d)).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import math
import os
import signal
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpdm_tpu_torch.models.lora import call_merged
from tpdm_tpu_torch.models.tpm import TimePredictor
from tpdm_tpu_torch.ops.beta import beta_entropy, beta_kl
from tpdm_tpu_torch.ops.schedules import get_ref_beta
from tpdm_tpu_torch.pipeline.denoise import make_cfg_denoise_fn
from tpdm_tpu_torch.pipeline.sampler import (
    INVALID_LOGPROB,
    SampleOutput,
    SamplerConfig,
    adaptive_sample,
    check_adaptive_solver,
    replay_logprobs,
    replay_step_logprob,
)
from tpdm_tpu_torch.train import checkpoint as ckpt
from tpdm_tpu_torch.train.callbacks import TensorBoardCallback
from tpdm_tpu_torch.train.config import RLOOConfig

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# RL math
# ---------------------------------------------------------------------------


def discounted_rewards(
    scores: torch.Tensor, last_valid_index: torch.Tensor, gamma: float
) -> torch.Tensor:
    """Step-count-discounted reward sum_{i=0..L} r gamma^(L-i) / (L+1), L =
    last_valid_index, by the geometric series (1 - gamma^(L+1)) / (1 - gamma)."""
    L = last_valid_index.to(torch.float32)
    if gamma == 1.0:
        geo = L + 1.0
    else:
        geo = (1.0 - gamma ** (L + 1.0)) / (1.0 - gamma)
    return scores * geo / (L + 1.0)


def compute_beta_kl_penalty(
    alphas: torch.Tensor,  # (b, T)
    betas: torch.Tensor,
    sigmas: torch.Tensor,  # (b, T) recorded sigma_next
    prob_masks: torch.Tensor,  # (b, T) bool
    relative: bool = True,
) -> torch.Tensor:
    """Per-step KL(policy Beta || reference Beta), 0 where masked. The
    reference Beta is anchored at each step's input sigma (the recorded
    chain shifted right, 1.0 first); the non-relative variant uses the fixed
    Beta(1.4, 11.2)."""
    input_sigmas = F.pad(sigmas[:, :-1], (1, 0), value=1.0)
    if relative:
        ref_a, ref_b = get_ref_beta(input_sigmas)
    else:
        ref_a = torch.full_like(alphas, 1.4)
        ref_b = torch.full_like(betas, 11.2)
    kl = beta_kl(alphas, betas, ref_a, ref_b)
    return torch.where(prob_masks, torch.zeros_like(kl), kl)


def rloo_advantages(rlhf_reward: torch.Tensor, rloo_k: int) -> torch.Tensor:
    """Leave-one-out advantages over tile-grouped repeats: reshape(k, -1)
    puts the copies of a prompt in one column."""
    r = rlhf_reward.reshape(rloo_k, -1)
    baseline = (r.sum(dim=0) - r) / (rloo_k - 1)
    return (r - baseline).reshape(-1)


def grpo_advantages(rlhf_reward: torch.Tensor, rloo_k: int, eps: float = 1e-4) -> torch.Tensor:
    """Group-normalised advantages (r - group mean) / (group std + eps) over
    the rloo_k repeats of each prompt (population std, as jnp.std)."""
    r = rlhf_reward.reshape(rloo_k, -1)
    mean = r.mean(dim=0)
    std = r.std(dim=0, unbiased=False)
    return ((r - mean) / (std + eps)).reshape(-1)


def compute_advantages(
    rlhf_reward: torch.Tensor, rloo_k: int, estimator: str = "rloo"
) -> torch.Tensor:
    if estimator == "rloo":
        return rloo_advantages(rlhf_reward, rloo_k)
    if estimator == "grpo":
        return grpo_advantages(rlhf_reward, rloo_k)
    raise ValueError(f"unknown advantage_estimator: {estimator}")


def ppo_loss(
    new_logprobs: torch.Tensor,  # (b, T)
    old_logprobs: torch.Tensor,  # (b, T)
    advantages: torch.Tensor,  # (b,)
    cliprange: float,
):
    """Clipped policy-gradient loss over the summed per-episode log-probs.
    Masked steps carry INVALID_LOGPROB in both and cancel. Returns (loss,
    stats) with approxkl, clipfrac and the per-step ratio mean."""
    diff = new_logprobs.sum(dim=1) - old_logprobs.sum(dim=1)
    ratio = torch.exp(diff)
    pg1 = -advantages * ratio
    pg2 = -advantages * torch.clamp(ratio, 1.0 - cliprange, 1.0 + cliprange)
    loss = torch.maximum(pg1, pg2).mean()
    stats = {
        "approxkl": 0.5 * (diff**2).mean(),
        "clipfrac": (pg2 > pg1).to(torch.float32).mean(),
        "ratio_mean": torch.exp(new_logprobs - old_logprobs).mean(),
    }
    return loss, stats


def rloo_repeat(batch: dict, rloo_k: int) -> dict:
    """Tile every tensor and list field k times along the batch axis."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.repeat((rloo_k,) + (1,) * (v.dim() - 1))
        elif isinstance(v, list):
            out[k] = v * rloo_k
        else:
            out[k] = v
    return out


# the SDXL ensemble's refiner keeps caches of its own (its UNet's channel
# widths differ from the base's: ``train/sdxl_agent.py:EnsembleSampleOutput``)
_TIME_MAJOR_FIELDS = ("h_cache", "temb_cache", "history_latents", "refiner_h_cache",
                      "refiner_temb_cache")
_SCALAR_FIELDS = ("num_steps",)


def _rows(v: torch.Tensor, inds, axis: int = 0) -> torch.Tensor:
    return v.index_select(axis, torch.as_tensor(np.asarray(inds), device=v.device))


def subset_inputs(data: dict, inds) -> dict:
    """Micro-batch view of the collated batch: tensors indexed along the
    batch axis, lists fancy-indexed, anything else as it is."""
    inds = np.asarray(inds)
    out = {}
    for k, v in data.items():
        if isinstance(v, torch.Tensor):
            out[k] = _rows(v, inds)
        elif isinstance(v, list):
            out[k] = [v[int(i)] for i in inds]
        else:
            out[k] = v
    return out


def _host_rows_to(v: torch.Tensor, inds, device: torch.device) -> torch.Tensor:
    """``v[:, inds]`` of a time-major cache in host memory, on ``device``:
    one copy a (step, sample) block, each contiguous on both sides, so a
    pinned cache goes to the card by DMA without a gather on the host."""
    out = torch.empty((v.shape[0], len(inds)) + v.shape[2:], dtype=v.dtype, device=device)
    for j, i in enumerate(np.asarray(inds).tolist()):
        for step in range(v.shape[0]):
            out[step, j].copy_(v[step, i], non_blocking=True)
    return out


def subset_outputs(outputs: SampleOutput, inds) -> SampleOutput:
    """Micro-batch view of a rollout: the time-major caches are indexed on
    axis 1, ``num_steps`` passes through. A cache offloaded to the host
    (``offload_outputs_to_host``) is sliced there, and only the slice moves
    to the rollout's device (that of its ``last_valid_index``, a field of
    every family's output)."""
    values = {}
    device = outputs.last_valid_index.device
    for name, value in outputs._asdict().items():
        if value is None or name in _SCALAR_FIELDS:
            values[name] = value
        elif name in _TIME_MAJOR_FIELDS and value.device != device:
            values[name] = _host_rows_to(value, inds, device)
        else:
            values[name] = _rows(value, inds, 1 if name in _TIME_MAJOR_FIELDS else 0)
    return type(outputs)(**values)


def offload_outputs_to_host(outputs: SampleOutput) -> SampleOutput:
    """The rollout with its time-major caches in host memory (pinned when
    they come from a CUDA card, so the micro-batch slices copy back at full
    rate); the caller's dropping the old record frees their device memory
    before the reward's decode allocates. The other fields stay where they
    are."""
    values = {}
    for name, value in outputs._asdict().items():
        if name in _TIME_MAJOR_FIELDS and value is not None and value.device.type != "cpu":
            host = torch.empty(value.shape, dtype=value.dtype, device="cpu",
                               pin_memory=value.is_cuda)
            values[name] = host.copy_(value)
        else:
            values[name] = value
    return type(outputs)(**values)


# ---------------------------------------------------------------------------
# Agent
# ---------------------------------------------------------------------------


class TPDMAgent:
    """Frozen MMDiT + trainable TPM + the adaptive sampler.

    The RL protocol of ``tpdm_tpu/train/rloo.py:TPDMAgent`` (sample,
    replay, logprobs, kl_divergence) over a TPM ``nn.Module`` that the
    caller passes in. The MMDiT is frozen here (``requires_grad_(False)``)
    and the rollouts and replays run it under ``torch.no_grad()``: a frozen
    backbone keeps no activations for autograd. The LoRA trainers
    (``train/draft.py``, ``dpo.py``, ``distill.py``) differentiate through
    it by the hooks ``backbone_params`` and ``denoise_builder``: merged
    weights that require grad stand in for the frozen ones.

    Args:
        mmdit: the denoiser, on its device and dtype (bf16 on the card).
        config: RLOOConfig.
        tpm: a factory that returns a fresh TPM module, which
            ``init_tpm_params`` then initialises; None builds the SD3 TPM
            from ``config`` (128 conv channels, ``init_alpha``/``init_beta``,
            ``tpm_param_cap``), with fp32 parameters that compute in the
            MMDiT's dtype.
        tpm_start: a state dict of that TPM (a pretrained one) that
            ``init_tpm_params`` loads in place of drawn weights.
        replay_mode: "cached" keeps (h_combined, temb) of every step (25 MB
            a sample a step at 1024 px in bf16) and replays the TPM alone;
            "recompute" keeps the latents of every step and re-runs the
            frozen backbone on the recorded chain before the TPM.

    ``config.solver`` ("euler" or "ab2") is the rollout's integrator. Both
    replays are solver-agnostic: the cached one rebuilds the ratios from
    the recorded sigmas, the recompute one re-runs the backbone on the
    recorded latents.
    """

    def __init__(
        self,
        mmdit: nn.Module,
        config: RLOOConfig,
        tpm: Optional[Callable[[], nn.Module]] = None,
        replay_mode: str = "cached",
        tpm_start: Optional[dict] = None,
    ):
        if replay_mode not in ("cached", "recompute"):
            raise ValueError(replay_mode)
        check_adaptive_solver(config.solver)
        self.replay_mode = replay_mode
        self.tpm_start = tpm_start
        self.mmdit = mmdit.requires_grad_(False)
        self.config = config
        mcfg = mmdit.config
        self.token_grid = mcfg.sample_size // mcfg.patch_size
        self.patch_size = mcfg.patch_size
        param = next(p for p in mmdit.parameters() if p.is_floating_point())
        self.device, self.dtype = param.device, param.dtype
        self.tpm_factory = tpm or (lambda: TimePredictor(
            conv_out_channels=128,
            in_channels=2 * mcfg.inner_dim,
            temb_dim=mcfg.inner_dim,
            init_alpha=config.init_alpha,
            init_beta=config.init_beta,
            param_cap=config.tpm_param_cap,
            dtype=self.dtype,
        ))
        self.sampler_cfg = SamplerConfig(
            max_inference_steps=config.max_inference_steps,
            min_sigma=config.min_sigma,
            relative=config.relative,
            prediction_type=config.prediction_type,
            predict=False,
            cache_activations=(replay_mode == "cached"),
            keep_history=(replay_mode == "recompute"),
            solver=config.solver,
        )
        self.needs_inputs_for_replay = replay_mode == "recompute"

    def init_tpm_params(self, generator: torch.Generator) -> nn.Module:
        """A fresh TPM on the MMDiT's device, its weights drawn from
        ``generator`` (on that device): N(0, 0.02²), zero biases, the head's
        bias (init_alpha, init_beta); or, given ``tpm_start``, a copy of
        those weights."""
        with torch.device(self.device):
            tpm = self.tpm_factory()
        if self.tpm_start is not None:
            tpm.load_state_dict(self.tpm_start)
            return tpm
        return tpm.init_weights(generator)

    def prepare_latents(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        mcfg = self.mmdit.config
        shape = (batch_size, mcfg.in_channels, mcfg.sample_size, mcfg.sample_size)
        return torch.randn(shape, generator=generator, device=self.device, dtype=self.dtype)

    # -- the hooks of the trainers that differentiate through the backbone --
    @property
    def backbone_params(self) -> nn.Module:
        """The frozen MMDiT, whose dense layers LoRA factors target."""
        return self.mmdit

    def denoise_builder(self, params: Optional[dict], batch: dict):
        """``denoise_fn(latents, sigma) -> (velocity, temb, h_combined)``,
        CFG-doubled as the rollout's, for ``batch``'s embeds, over the
        MMDiT with ``params`` (``models/lora.py:merge_lora``'s tensors)
        standing in for its weights of the same names on every call (None:
        its own weights). Differentiable where grad mode is on; the latents
        are cast to the MMDiT's dtype."""
        mmdit = self.mmdit
        apply = mmdit if params is None else (
            lambda *a: call_merged(mmdit, params, mmdit, *a))
        denoise = self._denoise_fn(batch, apply)
        return lambda latents, sigma: denoise(latents.to(self.dtype), sigma)

    def _denoise_fn(self, batch: dict, apply: Optional[Callable] = None):
        if "prompt_embeds" not in batch:
            raise ValueError(
                f"batch has no 'prompt_embeds' (keys: {sorted(batch)}). The trainer "
                "consumes CFG-ready embeds: precompute them in the collator, e.g. "
                "with train.builders.make_prompt_encoder")
        pe, pp = batch["prompt_embeds"], batch["pooled_prompt_embeds"]
        if self.config.guidance_scale is not None:
            pe = torch.cat([batch["negative_prompt_embeds"], pe])
            pp = torch.cat([batch["negative_pooled_prompt_embeds"], pp])
        as_dev = lambda t: torch.as_tensor(t, device=self.device).to(self.dtype)
        return make_cfg_denoise_fn(apply or self.mmdit, as_dev(pe), as_dev(pp),
                                   self.config.guidance_scale, self.token_grid,
                                   self.patch_size)

    @torch.no_grad()
    def sample(
        self,
        tpm: nn.Module,
        batch: dict,
        generator: torch.Generator,
        predict: bool = False,
        sampler_cfg: Optional[SamplerConfig] = None,
    ) -> SampleOutput:
        """Rollout of ``batch`` (CFG-ready embeds (b, ...) and, with
        guidance, their negatives; optional ``latents``). ``generator`` draws
        the initial latents, then the Beta ratios."""
        denoise_fn = self._denoise_fn(batch)
        latents = batch.get("latents")
        if latents is None:
            latents = self.prepare_latents(generator, batch["prompt_embeds"].shape[0])
        scfg = sampler_cfg or dataclasses.replace(self.sampler_cfg, predict=predict)
        return adaptive_sample(denoise_fn, tpm, latents, generator, scfg)

    def _replay_recompute(self, tpm: nn.Module, outputs: SampleOutput, inputs: dict):
        """Regenerate (h_combined, temb) by re-running the frozen backbone
        on the recorded chain (no grad), then score the recorded actions
        with the TPM (grad). Steps at which every sample was already done
        are masked whatever the TPM says, so the backbone skips them."""
        denoise_fn = self._denoise_fn(inputs)
        cfg = self.sampler_cfg
        # latents BEFORE step j: the initial noise for j = 0, history[j - 1] after
        lat_before = torch.cat([outputs.init_noise_latents[None], outputs.history_latents[:-1]])
        sig_before = F.pad(outputs.sigmas[:, :-1], (1, 0), value=1.0).T  # (T, b)
        sig_next = outputs.sigmas.T
        active = (sig_before >= cfg.min_sigma).any(dim=1).tolist()
        logprobs = []
        for step, sigma in enumerate(sig_before):
            if not active[step]:
                logprobs.append(torch.full_like(sigma, INVALID_LOGPROB))
                continue
            lat = lat_before[step]
            with torch.no_grad():
                _, temb, h = denoise_fn(lat, sigma.to(lat.dtype))
            logprobs.append(replay_step_logprob(tpm(h, temb), sigma, sig_next[step], cfg))
        return torch.stack(logprobs, dim=1)

    def replay(self, tpm: nn.Module, outputs: SampleOutput, inputs: Optional[dict] = None):
        """Log-probs (b, T) of the rollout's actions under ``tpm``,
        differentiable with respect to it when grad mode is on."""
        if self.replay_mode == "recompute":
            if inputs is None:
                raise ValueError("recompute replay needs the batch inputs")
            return self._replay_recompute(tpm, outputs, inputs)
        return replay_logprobs(tpm, outputs.h_cache, outputs.temb_cache, outputs.sigmas,
                               self.sampler_cfg)

    @torch.no_grad()
    def logprobs(self, tpm: nn.Module, outputs: SampleOutput, inputs: Optional[dict] = None):
        return self.replay(tpm, outputs, inputs)

    def kl_divergence(self, outputs: SampleOutput) -> torch.Tensor:
        return compute_beta_kl_penalty(outputs.alphas, outputs.betas, outputs.sigmas,
                                       outputs.prob_masks, relative=self.config.relative)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def _make_base_lr_schedule(cfg: RLOOConfig, num_total_batches: int) -> Callable[[int], float]:
    """The learning rate at a trainer update, as optax's schedules give it."""
    total_steps = max(1, num_total_batches)
    lr = cfg.learning_rate
    kind = cfg.lr_scheduler_type
    if kind == "constant":
        return lambda count: lr
    if kind == "constant_with_warmup":
        warmup = max(1, cfg.warmup_steps)
        return lambda count: lr * min(max(count, 0) / warmup, 1.0)
    if kind == "linear":
        return lambda count: lr * (1.0 - min(max(count, 0) / total_steps, 1.0))
    if kind == "cosine":
        return lambda count: lr * 0.5 * (1.0 + math.cos(math.pi * min(count, total_steps)
                                                         / total_steps))
    raise ValueError(f"unknown lr_scheduler_type: {kind}")


def _make_lr_schedule(cfg: RLOOConfig, num_total_batches: int) -> Callable[[int], float]:
    """The learning rate at an optimizer step: Adam's count mapped back to
    trainer updates (num_ppo_epochs x num_mini_batches steps an update)."""
    base = _make_base_lr_schedule(cfg, num_total_batches)
    inner = max(1, cfg.num_ppo_epochs * cfg.num_mini_batches)
    return lambda count: base(count // inner)


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class TPMOptimizer:
    """``optax.MultiSteps(chain(clip_by_global_norm(max_norm), adam(schedule)),
    every_k)`` on a module's parameters.

    ``update(grads)`` folds one micro-step's gradients into the running mean
    of the accumulation window; at its k-th call the mean is clipped
    (``g * max_norm / max(norm, max_norm)``), the learning rate is set from
    ``schedule(count)`` and ``torch.optim.Adam`` (the same bias-corrected
    update as optax's adam, eps outside the square root) steps once.
    ``count`` is Adam's step count. ``every_k`` (by default
    ``cfg.gradient_accumulation_steps``) is the accumulation window; the
    LoRA trainers (``train/draft.py``) take 1, with a config that carries
    only the learning rate, Adam's constants and ``max_grad_norm``.
    """

    def __init__(self, params: Iterable[torch.Tensor], cfg: RLOOConfig,
                 schedule: Callable[[int], float], every_k: Optional[int] = None):
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=cfg.learning_rate,
                                     betas=(cfg.adam_beta1, cfg.adam_beta2),
                                     eps=cfg.adam_epsilon)
        self.max_norm = cfg.max_grad_norm
        self.every_k = cfg.gradient_accumulation_steps if every_k is None else every_k
        self.schedule = schedule
        self.count = 0
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads) -> bool:
        """Accumulate ``grads`` (one per parameter); returns True when the
        parameters moved."""
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (self.mini_step + 1))
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        scale = self.max_norm / torch.clamp(_global_norm(self.acc), min=self.max_norm)
        for p, a in zip(self.params, self.acc):
            p.grad = a * scale
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        for p, a in zip(self.params, self.acc):
            p.grad = None
            a.zero_()
        self.count += 1
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": [a.clone() for a in self.acc]}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for a, saved in zip(self.acc, state["acc"]):
            a.copy_(saved)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


def _default_collate(rows: list[dict]) -> dict:
    out: dict = {}
    for k in rows[0]:
        vals = [r[k] for r in rows]
        if isinstance(vals[0], (np.ndarray, torch.Tensor)):
            out[k] = torch.stack([torch.as_tensor(v) for v in vals])
        else:
            out[k] = vals
    return out


class RLOOTrainer:
    """Drives rollout -> reward -> advantages -> PPO epochs, logging metrics.

    Args:
        config: RLOOConfig.
        agent: TPDMAgent or a family agent (an object with its protocol;
            ``needs_inputs_for_replay`` True makes the PPO replay take the
            micro-batch's inputs).
        reward_fn: (prompts, outputs) -> (scores, last_image_scores), each
            (b,) (tensors or arrays); the trainer applies the step discount.
        dataset: a sequence of rows; ``collate_fn`` turns a list of rows into
            the batch the agent samples from.
        callbacks: objects with ``on_step_end(trainer, update, metrics,
            eval_state)``, ``eval_state`` the TPM's state dict (the EMA's when
            ``ema_decay`` is set).
    """

    def __init__(
        self,
        config: RLOOConfig,
        agent: TPDMAgent,
        reward_fn: Callable,
        dataset,
        collate_fn: Optional[Callable] = None,
        callbacks: Iterable = (),
    ):
        if config.world_size != 1:
            raise NotImplementedError(
                f"world_size={config.world_size}: data parallelism (DDP over NCCL) is not "
                "ported to tpdm_tpu_torch yet (ROADMAP queue 1, item 9(d))")
        if config.offload_cache not in ("none", "host"):
            raise ValueError(
                f"offload_cache={config.offload_cache!r}: the port takes 'none' or 'host' "
                "('xla' is the JAX package's pinned-host XLA offload, a TPU workaround with "
                "no CUDA counterpart)")
        if config.ema_decay and not 0.0 < config.ema_decay < 1.0:
            raise ValueError(f"ema_decay={config.ema_decay} must be in (0, 1)")
        self.config = config
        self.agent = agent
        self.reward_fn = reward_fn
        self.dataset = dataset
        self.collate_fn = collate_fn or _default_collate
        self.callbacks = list(callbacks)
        if config.report_to == "tensorboard":
            self.callbacks.append(TensorBoardCallback(os.path.join(config.output_dir, "tb")))
        elif config.report_to != "none":
            raise ValueError(
                f"report_to={config.report_to!r} (none|tensorboard; wandb attaches through "
                "EvalVisualizationCallback when the wandb package is importable)")
        self.sizes = config.derive_batch_sizes(len(dataset))
        self.metrics_history: list[dict] = []
        # the rolling NaN-skip fraction (policy/skip_rate): a collapsed
        # policy skips every update behind the finite guard, and would
        # otherwise log like a healthy one
        self._skip_window = collections.deque(maxlen=max(int(config.skip_alarm_window), 1))
        self._lr_schedule = _make_lr_schedule(config, self.sizes["num_total_batches"])
        # metrics report the learning rate in trainer-update counts
        self._schedule = _make_base_lr_schedule(config, self.sizes["num_total_batches"])
        self.ema_params: Optional[dict] = None
        self.global_step = 0
        self.updates_this_run = 0
        self.episode = 0
        self._stop_requested = False
        self.stopped_early = False

    def make_optimizer(self, tpm: nn.Module) -> TPMOptimizer:
        return TPMOptimizer(tpm.parameters(), self.config, self._lr_schedule)

    def _ema_update(self, tpm: nn.Module) -> None:
        d = self.config.ema_decay
        with torch.no_grad():
            for name, p in tpm.state_dict().items():
                self.ema_params[name].mul_(d).add_(p, alpha=1.0 - d)

    def request_stop(self) -> None:
        """Stop after the current update, with a checkpoint. Only sets a
        flag, so it is safe in a signal handler; ``train`` installs it for
        SIGTERM and SIGINT."""
        self._stop_requested = True

    def _loader(self, rng: np.random.Generator) -> Iterator[dict]:
        bsz = self.sizes["dataloader_batch_size"]
        n = len(self.dataset)
        if bsz > n:
            raise ValueError(
                f"dataset ({n} rows) smaller than the derived dataloader batch ({bsz} = "
                "local_batch_size/rloo_k); add data or shrink the batch configuration")
        while True:
            order = rng.permutation(n)
            for start in range(0, n - bsz + 1, bsz):
                yield self.collate_fn([self.dataset[int(i)] for i in order[start : start + bsz]])

    # -- the PPO micro-step -------------------------------------------------
    def _train_step_impl(self, tpm: nn.Module, optimizer: TPMOptimizer,
                         outputs: SampleOutput, advantages: torch.Tensor,
                         inputs: Optional[dict] = None) -> dict:
        """One micro-batch: replay under autograd, the clipped loss, its
        gradient, and the optimizer's update unless the loss or the
        gradient's norm is not finite. Returns the step's stats as floats."""
        params = list(tpm.parameters())
        with torch.enable_grad():
            new_lp = self.agent.replay(tpm, outputs, inputs=inputs)
            loss, stats = ppo_loss(new_lp, outputs.logprobs, advantages, self.config.cliprange)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        grad_norm = _global_norm(grads)
        finite = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if finite:
            optimizer.update(grads)
        out = {k: v.item() for k, v in stats.items()}
        out["loss"] = loss.item()
        out["grad_norm"] = float(grad_norm)
        out["skipped"] = 0.0 if finite else 1.0
        # entropy over every (alpha, beta) entry, and the mean unmasked step count
        out["entropy"] = float(beta_entropy(outputs.alphas, outputs.betas).mean())
        out["steps"] = float((~outputs.prob_masks).sum()) / outputs.prob_masks.shape[0]
        return out

    # -- main loop ----------------------------------------------------------
    def train(
        self,
        tpm: Optional[nn.Module] = None,
        resume_state: Optional[dict] = None,
        resume_from_checkpoint=None,
    ):
        """Run training; returns (tpm, optimizer), the TPM trained in place.

        ``tpm`` None builds and initialises the agent's TPM from the
        rollout generator (seeded ``config.seed``, on the agent's device).
        ``resume_from_checkpoint``: True (the latest in output_dir) or a
        checkpoint path; ``resume_state`` a dict that ``restore_checkpoint``
        returned.
        """
        cfg = self.config
        generator = torch.Generator(device=self.agent.device).manual_seed(cfg.seed)
        np_rng = np.random.default_rng(cfg.seed)
        if tpm is None:
            tpm = self.agent.init_tpm_params(generator)
        optimizer = self.make_optimizer(tpm)

        if resume_from_checkpoint is not None and resume_state is None:
            path = resume_from_checkpoint
            if path is True:
                path = ckpt.latest_checkpoint(cfg.output_dir)
                if path is None:
                    raise ValueError(f"no checkpoint found in {cfg.output_dir}")
            resume_state = ckpt.restore_checkpoint(path)
            logger.info("resumed from %s (update %d)", path, resume_state["update"])

        start_update = 1
        if resume_state is not None:
            tpm.load_state_dict(resume_state["tpm"])
            optimizer.load_state_dict(resume_state["optimizer"])
            start_update = int(resume_state["update"]) + 1
            self.episode = int(resume_state.get("episode", 0))
            self.global_step = int(resume_state["update"])
            if "np_rng_state" in resume_state:
                np_rng.bit_generator.state = resume_state["np_rng_state"]
            if resume_state.get("generator_state") is not None:
                generator.set_state(resume_state["generator_state"])
        if cfg.ema_decay:
            ema = None if resume_state is None else resume_state.get("ema")
            source = tpm.state_dict() if ema is None else ema
            self.ema_params = {k: v.detach().clone().to(self.agent.device)
                               for k, v in source.items()}

        # SIGTERM / SIGINT -> checkpoint and stop after the current update
        # (handlers go in only from the main thread)
        prev_handlers: dict = {}
        if threading.current_thread() is threading.main_thread():
            def _on_signal(signum, frame):
                logger.warning("signal %d: will checkpoint and stop after the current "
                               "update", signum)
                self.request_stop()

            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _on_signal)
        try:
            self._train_loop(tpm, optimizer, self._loader(np_rng), np_rng, generator,
                             start_update, time.time())
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            for cb in self.callbacks:
                close = getattr(cb, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # cleanup must not mask a training error
                        logger.exception("callback close() raised")
        return tpm, optimizer

    def _train_loop(self, tpm, optimizer, loader, np_rng, generator, start_update,
                    start_time):
        cfg = self.config
        sizes = self.sizes
        # only TPDMAgent's recompute mode re-runs the backbone on the inputs
        replay_inputs = getattr(self.agent, "needs_inputs_for_replay", False)
        for update in range(start_update, sizes["num_total_batches"] + 1):
            self.episode += sizes["batch_size"]
            data = rloo_repeat(next(loader), cfg.rloo_k)

            # ---- experience collection (no grad) ----
            outputs = self.agent.sample(tpm, data, generator)
            if cfg.offload_cache == "host":
                outputs = offload_outputs_to_host(outputs)
            scores, last_image_scores = self.reward_fn(data.get("prompt"), outputs)
            dev = outputs.last_valid_index.device
            scores = discounted_rewards(torch.as_tensor(scores, device=dev).to(torch.float32),
                                        outputs.last_valid_index, cfg.gamma)
            kl = self.agent.kl_divergence(outputs)
            kl_reduced = kl.mean(dim=1) if cfg.mean_kl else kl.sum(dim=1)
            non_score_reward = -cfg.kl_coef * kl_reduced
            rlhf_reward = scores + non_score_reward
            advantages = compute_advantages(rlhf_reward, cfg.rloo_k, cfg.advantage_estimator)

            # ---- PPO epochs over the same rollout ----
            stats_acc: list[dict] = []
            for _ in range(cfg.num_ppo_epochs):
                b_inds = np_rng.permutation(sizes["batch_size"])
                for mb_start in range(0, sizes["batch_size"], sizes["mini_batch_size"]):
                    mb_inds = b_inds[mb_start : mb_start + sizes["mini_batch_size"]]
                    for mi_start in range(0, len(mb_inds), sizes["micro_batch_size"]):
                        inds = mb_inds[mi_start : mi_start + sizes["micro_batch_size"]]
                        mb_inputs = subset_inputs(data, inds) if replay_inputs else None
                        stats_acc.append(self._train_step_impl(
                            tpm, optimizer, subset_outputs(outputs, inds),
                            _rows(advantages, inds), mb_inputs))
            del outputs

            # ---- metrics (the JAX trainer's names) ----
            agg = {k: float(np.mean([s[k] for s in stats_acc])) for k in stats_acc[0]}
            ratios = np.array([s["ratio_mean"] for s in stats_acc])
            metrics = {
                "eps": int(self.episode / max(time.time() - start_time, 1e-9)),
                "objective/kl": float(kl_reduced.mean()),
                "objective/non_score_reward": float(non_score_reward.mean()),
                "objective/rlhf_reward": float(rlhf_reward.mean()),
                "objective/scores": float(scores.mean()),
                "objective/last_image_scores": float(
                    torch.as_tensor(last_image_scores).float().mean()),
                "policy/approxkl_avg": agg["approxkl"],
                "policy/clipfrac_avg": agg["clipfrac"],
                "policy/steps_avg": agg["steps"],
                "policy/grad_norm_avg": agg["grad_norm"],
                "loss/policy_avg": agg["loss"],
                "policy/entropy_avg": agg["entropy"],
                "val/ratio": float(ratios.mean()),
                "val/ratio_var": float(ratios.var()),
                "val/num_skipped": agg["skipped"],
                "lr": float(self._schedule(self.global_step)),
                "episode": self.episode,
            }
            self._skip_window.append(agg["skipped"])
            skip_rate = float(np.mean(self._skip_window))
            metrics["policy/skip_rate"] = skip_rate
            if (len(self._skip_window) == self._skip_window.maxlen
                    and skip_rate > cfg.skip_alarm_threshold):
                logger.warning(
                    "policy collapse suspected: %.0f%% of the last %d updates were "
                    "NaN/Inf-skipped (skip_rate %.2f > %.2f) — training has effectively "
                    "stopped; consider tpm_param_cap or a lower learning rate",
                    100 * skip_rate, self._skip_window.maxlen, skip_rate,
                    cfg.skip_alarm_threshold)
            if self.ema_params is not None:
                self._ema_update(tpm)
            self.global_step += 1
            self.updates_this_run += 1
            if cfg.logging_steps and update % cfg.logging_steps == 0:
                logger.info("update %d: %s", update, metrics)
                self.metrics_history.append(metrics)
                self._append_metrics_jsonl(update, metrics)

            eval_state = self.ema_params if self.ema_params is not None else tpm.state_dict()
            for cb in self.callbacks:
                cb.on_step_end(self, update, metrics, eval_state)

            saved_this_update = bool(cfg.save_steps) and update % cfg.save_steps == 0
            if saved_this_update:
                self._save(update, tpm, optimizer, np_rng, generator)
            if self._stop_requested:
                if not saved_this_update:
                    self._save(update, tpm, optimizer, np_rng, generator)
                self.stopped_early = True
                logger.warning("graceful stop: checkpoint saved at update %d/%d", update,
                               sizes["num_total_batches"])
                break

        if cfg.save_steps and not self.stopped_early:
            self._save(sizes["num_total_batches"], tpm, optimizer, np_rng, generator)

    def _append_metrics_jsonl(self, update, metrics):
        """output_dir/metrics.jsonl, one JSON object per logged update, for
        runs that already use output_dir (checkpoints or eval)."""
        if not (self.config.save_steps or self.config.eval_steps):
            return
        try:
            os.makedirs(self.config.output_dir, exist_ok=True)
            with open(os.path.join(self.config.output_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps({"update": update, **metrics}) + "\n")
        except OSError as e:  # metrics must never kill training
            logger.warning("metrics.jsonl write failed: %s", e)

    def _save(self, update, tpm, optimizer, np_rng, generator):
        path = ckpt.save_checkpoint(
            self.config.output_dir, update, tpm.state_dict(), optimizer.state_dict(),
            episode=self.episode, np_rng_state=np_rng.bit_generator.state,
            generator_state=generator.get_state(), ema=self.ema_params)
        logger.info("saved checkpoint %s", path)
        pruned = ckpt.rotate_checkpoints(self.config.output_dir, self.config.save_total_limit)
        if pruned:
            logger.info("save_total_limit=%s: pruned %s", self.config.save_total_limit, pruned)
