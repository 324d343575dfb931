"""Reward-gradient fine-tuning of the backbone through LoRA (DRaFT-K /
ReFL), and the LoRA files that every adapter trainer writes.

Counterpart of ``tpdm_tpu/train/draft.py``. ``DraftTrainer`` runs the
deterministic fixed-schedule sampler (Euler over the uniform sigma ladder
1 -> 0 in ``num_steps`` steps), keeps only the LAST ``k_backprop`` steps,
the decode and the reward differentiable (the prefix runs under
``torch.no_grad()`` and is detached at the cut, so the memory is K steps',
not T's), and ascends d(reward)/d(LoRA factors). The backbone's own
weights never change and never receive a gradient: the factors are merged
for each update by ``models/lora.py:merge_lora`` and stand in for the
weights through ``call_merged``. Gradients reach the backbone through K1's
backward and the VAE's mid block through K2's (``ops/attention.py``).

The optimiser is the JAX trainer's optax chain, ``clip_by_global_norm``
then ``adam(b1, b2, eps)`` at a constant learning rate, as
``train/rloo.py:TPMOptimizer`` (one micro-step an update). An update whose
loss or gradient norm is not finite is skipped whole: the factors and
Adam's state stay as they were (JAX selects the old trees).

The agent brings the hooks ``backbone_params`` (the frozen module the
factors target), ``denoise_builder(params, batch)`` (params: None for the
backbone's own weights, or ``merge_lora``'s tensors) and
``prepare_latents``; ``TPDMAgent`` has them. An agent with a
``draft_step_builder`` (the eps-prediction families) rolls out its own
ladder; the port's SD1.5 and SDXL agents still refuse theirs (ROADMAP
queue 1, item 9(e)).

The LoRA file format is the JAX package's: a flat safetensors file of
``"<Flax kernel path>|a"`` and ``"|b"`` fp32 2-D factors
(``params/transformer_blocks_0/attn/to_q/kernel|a``), read and written by
the port's own ``utils/safetensors.py``. In memory the factors are the
port's LoRA dict, keyed by module name (``models/lora.py``); the keys are
mapped by ``utils/convert.py:lora_key_from_jax`` / ``lora_key_to_jax``. A
file written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpdm_tpu_torch.models.lora import init_lora, lora_param_count, merge_lora
from tpdm_tpu_torch.ops.flow_euler import flow_euler_step
from tpdm_tpu_torch.utils import safetensors
from tpdm_tpu_torch.utils.convert import lora_key_from_jax, lora_key_to_jax

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DraftConfig:
    seed: int = 42
    output_dir: str = "output"
    total_updates: int = 10
    batch_size: int = 2
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.99
    adam_epsilon: float = 1e-5
    max_grad_norm: float = 1.0
    # rank-r factors on every dense layer of the backbone
    lora_rank: int = 4
    lora_scale: float = 1.0
    # the uniform sigma ladder 1 -> 0 over num_steps Euler steps
    num_steps: int = 28
    # DRaFT-K: how many FINAL denoise steps stay differentiable
    k_backprop: int = 1
    logging_steps: int = 1
    save_steps: int = 0
    # keep at most this many lora-N.safetensors (None: all)
    save_total_limit: Optional[int] = None


def uniform_sigmas(num_steps: int) -> torch.Tensor:
    """The flow ladder 1 -> 0 in ``num_steps`` equal steps, fp32, equal to
    ``jnp.linspace(1.0, 0.0, num_steps + 1, dtype=float32)`` to the bit:
    1 + i * (-1 / T) rounded at each operation, the last 0
    (``torch.linspace`` rounds otherwise)."""
    i = torch.arange(num_steps + 1, dtype=torch.float32)
    sigmas = 1.0 + i * torch.tensor(-1.0 / num_steps, dtype=torch.float32)
    sigmas[-1] = 0.0
    return sigmas


def lora_leaves(lora: dict) -> list:
    """The factors of ``lora`` in a fixed order (sorted keys, a then b)."""
    return [lora[k][w] for k in sorted(lora) for w in ("a", "b")]


def trainable_lora(lora: dict) -> dict:
    """A copy of ``lora`` whose factors are fp32 leaves that require grad."""
    return {k: {w: torch.as_tensor(f[w]).detach().float().clone().requires_grad_(True)
                for w in ("a", "b")} for k, f in lora.items()}


def lora_optimizer(lora: dict, config):
    """``clip_by_global_norm(max_grad_norm)`` then Adam at a constant
    learning rate, over ``lora``'s factors: ``TPMOptimizer`` with one
    micro-step an update."""
    from tpdm_tpu_torch.train.rloo import TPMOptimizer

    return TPMOptimizer(lora_leaves(lora), config, lambda count: config.learning_rate, every_k=1)


def value_and_grad(loss_fn: Callable, lora: dict):
    """(loss, aux, grads, grad_norm, finite): ``loss_fn()`` -> (loss, aux)
    under autograd, the gradient of each factor (zero where the loss does
    not reach it), their global norm, and whether loss and norm are
    finite."""
    leaves = lora_leaves(lora)
    with torch.enable_grad():
        loss, aux = loss_fn()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    grad_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    finite = bool(torch.isfinite(loss.detach()) & torch.isfinite(grad_norm))
    return loss.detach(), aux, grads, grad_norm, finite


class DraftTrainer:
    """Maximise a differentiable reward over LoRA factors.

    Args:
        config: DraftConfig.
        agent: an agent with the draft hooks (``backbone_params``,
            ``denoise_builder``, ``prepare_latents``): ``TPDMAgent``.
        reward_apply: (images, batch) -> (b,) DIFFERENTIABLE scores, where
            ``images`` is what ``decode_fn`` returns: for ImageReward,
            ``build_image_reward_grad_apply``.
        decode_fn: final latents -> images, differentiable (e.g.
            ``models/vae.py:make_fast_decode``); None: the reward reads the
            latents (toy runs).
        dataset / collate_fn: prompt rows -> a CFG-ready embed batch, as
            for ``RLOOTrainer``.
        callbacks: objects with ``on_step_end(trainer, update, metrics,
            lora)``.
    """

    def __init__(self, config: DraftConfig, agent, reward_apply: Callable, dataset,
                 collate_fn: Optional[Callable] = None, decode_fn: Optional[Callable] = None,
                 callbacks: Iterable = ()):
        if not 1 <= config.k_backprop <= config.num_steps:
            raise ValueError(f"k_backprop must be in [1, num_steps], got "
                             f"{config.k_backprop} vs {config.num_steps}")
        check_hooks(agent, "reward-gradient fine-tuning")
        from tpdm_tpu_torch.train.rloo import _default_collate

        self.config = config
        self.agent = agent
        self.reward_apply = reward_apply
        self.dataset = dataset
        self.collate_fn = collate_fn or _default_collate
        self.decode_fn = decode_fn or (lambda z: z)
        self.callbacks = list(callbacks)
        # the uniform flow ladder sigma_i = 1 - i/T, sigma_T = 0
        self.sigmas = uniform_sigmas(config.num_steps)
        self.metrics_history: list[dict] = []
        self.global_step = 0
        self.updates_this_run = 0

    # -- the differentiable sampling chain ----------------------------------
    def _final_latents(self, merged: Optional[dict], latents: torch.Tensor, batch: dict):
        """The fixed-ladder rollout from ``latents`` with ``merged`` weights
        (None: the backbone's own): the first T - K steps without grad, cut
        by ``.detach()``, the last K under autograd."""
        cfg = self.config
        denoise = self.agent.denoise_builder(merged, batch)
        b, dev = latents.shape[0], latents.device
        fam_step = getattr(self.agent, "draft_step_builder", None)
        if fam_step is not None:
            fam_step = fam_step(cfg.num_steps)

            def step(lat, i):
                return fam_step(denoise, lat, i, terminal=(i == cfg.num_steps - 1))
        else:
            def step(lat, i):
                sigma = torch.full((b,), float(self.sigmas[i]), device=dev)
                sigma_next = torch.full((b,), float(self.sigmas[i + 1]), device=dev)
                return flow_euler_step(denoise(lat, sigma)[0], sigma_next, sigma, lat)

        T, K = cfg.num_steps, cfg.k_backprop
        if T > K:
            with torch.no_grad():
                for i in range(T - K):
                    latents = step(latents, i)
            # DRaFT-K truncation: the prefix contributes no gradient
            latents = latents.detach()
        for i in range(T - K, T):
            latents = step(latents, i)
        return latents

    def _loss(self, lora: dict, latents: torch.Tensor, batch: dict):
        """(-mean reward, mean reward) of the rollout from ``latents`` with
        ``lora`` merged, differentiable with respect to the factors."""
        merged = merge_lora(self.agent.backbone_params, lora, scale=self.config.lora_scale)
        images = self.decode_fn(self._final_latents(merged, latents, batch))
        r = self.reward_apply(images, batch)
        return -r.mean(), r.mean().detach()

    def _update(self, lora: dict, optimizer, latents: torch.Tensor, batch: dict) -> dict:
        """One update of ``lora`` (in place, by ``optimizer``) from
        ``latents``: returns loss, reward, grad_norm, skipped."""
        loss, reward, grads, grad_norm, finite = value_and_grad(
            lambda: self._loss(lora, latents, batch), lora)
        if finite:  # the NaN guard: a non-finite update leaves factors and Adam as they were
            optimizer.update(grads)
        return {"loss": loss, "reward": reward, "grad_norm": grad_norm,
                "skipped": float(not finite)}

    # -- loop -----------------------------------------------------------------
    def train(self, lora: Optional[dict] = None):
        """``total_updates`` updates; returns (lora, optimizer). The
        factors start from ``lora`` (copied) or from ``init_lora`` drawn by
        a ``torch.Generator`` on the agent's device seeded with
        ``config.seed``, which then draws each update's latents; the rows
        are drawn by numpy's generator at the same seed."""
        cfg = self.config
        gen = torch.Generator(device=self.agent.device).manual_seed(cfg.seed)
        np_rng = np.random.default_rng(cfg.seed)
        if lora is None:
            lora = init_lora(self.agent.backbone_params, cfg.lora_rank, gen)
        lora = trainable_lora(lora)
        logger.info("draft: %d LoRA params over %d layers, K=%d/%d steps differentiable",
                    lora_param_count(lora), len(lora), cfg.k_backprop, cfg.num_steps)
        optimizer = lora_optimizer(lora, cfg)
        t0 = time.time()
        for update in range(1, cfg.total_updates + 1):
            batch = draw_batch(self.dataset, self.collate_fn, np_rng, cfg.batch_size)
            latents = self.agent.prepare_latents(gen, cfg.batch_size)
            stats = self._update(lora, optimizer, latents, batch)
            metrics = {
                "draft/reward": float(stats["reward"]),
                "draft/loss": float(stats["loss"]),
                "draft/grad_norm": float(stats["grad_norm"]),
                "draft/num_skipped": stats["skipped"],
                "lr": cfg.learning_rate,
                "eps": int(update * cfg.batch_size / max(time.time() - t0, 1e-9)),
            }
            end_update(self, update, metrics, lora)
        finish_saves(self, lora)
        return lora, optimizer

    def save_lora(self, update: int, lora: dict) -> str:
        return save_rotating_lora(self.config.output_dir, update, lora,
                                  self.config.save_total_limit)


# -- what the three adapter trainers share ------------------------------------


def check_hooks(agent, what: str) -> None:
    if not (hasattr(agent, "backbone_params") and hasattr(agent, "denoise_builder")):
        raise TypeError(
            f"{type(agent).__name__} does not expose the draft hooks (backbone_params / "
            f"denoise_builder): {what} needs a frozen backbone to LoRA-merge and a "
            "differentiable denoise chain (TPDMAgent)")


def draw_batch(dataset, collate_fn, np_rng, batch_size: int) -> dict:
    rows = [dataset[int(i)] for i in np_rng.choice(len(dataset), batch_size, replace=False)]
    return collate_fn(rows)


def end_update(trainer, update: int, metrics: dict, lora: dict) -> None:
    """Counters, logging, callbacks and the periodic LoRA save of one
    update."""
    cfg = trainer.config
    trainer.global_step = update
    trainer.updates_this_run = update
    if cfg.logging_steps and update % cfg.logging_steps == 0:
        logger.info("%s update %d: %s", type(trainer).__name__, update, metrics)
        trainer.metrics_history.append(metrics)
    for cb in trainer.callbacks:
        cb.on_step_end(trainer, update, metrics, lora)
    if cfg.save_steps and update % cfg.save_steps == 0:
        trainer.save_lora(update, lora)


def finish_saves(trainer, lora: dict) -> None:
    cfg = trainer.config
    if cfg.save_steps and cfg.total_updates % cfg.save_steps != 0:
        trainer.save_lora(cfg.total_updates, lora)


# -- the differentiable ImageReward --------------------------------------------


_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_cubic(x: torch.Tensor, size: int) -> torch.Tensor:
    """(b, c, H, W) -> (b, c, size, size), differentiable: the port of
    ``jax.image.resize(method="cubic")``, Keys' cubic at a = -0.5 whose
    kernel widens by the scale when it shrinks (antialiased), weights
    renormalised over the taps inside the image. ``F.interpolate``'s
    antialiased bicubic is that filter (its plain bicubic is a = -0.75 and
    not antialiased)."""
    return F.interpolate(x, size=(size, size), mode="bicubic", align_corners=False,
                         antialias=True)


def build_image_reward_grad_apply(model, image_size: Optional[int] = None) -> Callable:
    """reward_apply for DraftTrainer over an ``ImageRewardModel``: decoded
    fp32 images in [-1, 1] (NCHW) -> [0, 1] -> the differentiable cubic
    resize to the reward's resolution -> CLIP normalisation ->
    ``score_grad``. The batch carries "reward_ids" (b, n) WordPiece ids
    (and, optionally, "reward_mask")."""
    size = image_size or model.image_size

    def reward_apply(images, batch):
        dev = model.device
        x = torch.clamp(images.float() / 2 + 0.5, 0.0, 1.0).to(dev)
        x = resize_cubic(x, size)
        mean = torch.tensor(_CLIP_MEAN, device=dev).reshape(1, 3, 1, 1)
        std = torch.tensor(_CLIP_STD, device=dev).reshape(1, 3, 1, 1)
        return model.score_grad((x - mean) / std, batch["reward_ids"], batch.get("reward_mask"))

    return reward_apply


# -- LoRA files -------------------------------------------------------------------


def save_lora(path: str, lora: dict) -> None:
    """Write the port's LoRA dict as flat ``"<Flax path>|a"`` / ``"|b"``
    fp32 factors."""
    flat = {}
    for name, fac in lora.items():
        key = lora_key_to_jax(name)
        for which in ("a", "b"):
            flat[f"{key}|{which}"] = fac[which].detach().float().cpu()
    safetensors.save_file(flat, path)


def load_lora(path: str) -> dict:
    """The inverse of ``save_lora``: the port's LoRA dict of fp32 CPU
    tensors. A file that is not a LoRA file (a TPM or model checkpoint), or
    whose factors are incomplete or mismatched, raises rather than merge
    nothing."""
    lora: dict = {}
    for key, value in safetensors.load_file(path).items():
        flax_path, sep, which = key.rpartition("|")
        if not sep or which not in ("a", "b") or value.dim() != 2:
            raise ValueError(f"{path} is not a LoRA file: key {key!r} is not "
                             "'<kernel-path>|a' / '|b' with a 2-D factor")
        try:
            name = lora_key_from_jax(flax_path)
        except ValueError as e:
            raise ValueError(f"{path} is not a LoRA file: {e}") from None
        lora.setdefault(name, {})[which] = value.float()
    for name, fac in lora.items():
        if set(fac) != {"a", "b"} or fac["a"].shape[1] != fac["b"].shape[0]:
            raise ValueError(f"{path}: incomplete/mismatched factors for {name!r} (have "
                             f"{sorted(fac)}, shapes {[tuple(v.shape) for v in fac.values()]})")
    return lora


def save_rotating_lora(output_dir: str, update: int, lora: dict,
                       save_total_limit: Optional[int]) -> str:
    """Write ``lora-<update>.safetensors`` into ``output_dir`` and remove
    the oldest such files beyond ``save_total_limit``. Returns the path."""
    path = os.path.join(output_dir, f"lora-{update}.safetensors")
    os.makedirs(output_dir, exist_ok=True)
    save_lora(path, lora)
    logger.info("saved %s", path)
    if save_total_limit and save_total_limit >= 1:
        found = []
        for name in os.listdir(output_dir):
            m = re.fullmatch(r"lora-(\d+)\.safetensors", name)
            if m:
                found.append((int(m.group(1)), name))
        found.sort()
        for _, name in found[: max(0, len(found) - save_total_limit)]:
            os.remove(os.path.join(output_dir, name))
            logger.info("save_total_limit=%d: pruned %s", save_total_limit, name)
    return path
