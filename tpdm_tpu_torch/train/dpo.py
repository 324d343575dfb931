"""Diffusion-DPO: preference-pair fine-tuning of the backbone through LoRA.

Counterpart of ``tpdm_tpu/train/dpo.py``. Given (preferred, rejected)
latent pairs per prompt, minimise the Diffusion-DPO objective in its
flow-matching form

    L = -E log sigmoid( -beta [ (err_theta^w - err_ref^w)
                              - (err_theta^l - err_ref^l) ] )

where err is each sample's velocity MSE at a drawn noise level: x_sigma =
(1 - sigma) x0 + sigma eps, target eps - x0. The policy is base + LoRA
(``models/lora.py:merge_lora``) and the reference the base weights alone,
run under ``torch.no_grad()``: no second copy of the backbone. The two
halves of a pair share one noise draw and one sigma (one denoise over
[w; l], embeds doubled). No reward model: the pair ordering is the
supervision. An eps-prediction agent's ``forward_noising`` maps the draw
to its own forward process; the port's SD1.5 and SDXL agents still refuse
it (ROADMAP queue 1, item 9(e)).

The optimiser and the NaN guard are ``train/draft.py``'s. Batches carry
the pair as "latents_w" / "latents_l" (model-space (b, c, h, w)) or as
uint8 "images_w" / "images_l" with an ``encode_fn`` (e.g. the VAE encoder,
run without grad).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpdm_tpu_torch.models.lora import init_lora, lora_param_count, merge_lora
from tpdm_tpu_torch.train.draft import (
    check_hooks,
    draw_batch,
    end_update,
    finish_saves,
    lora_optimizer,
    save_rotating_lora,
    trainable_lora,
    value_and_grad,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DPOConfig:
    seed: int = 42
    output_dir: str = "output"
    total_updates: int = 10
    batch_size: int = 2  # preference PAIRS per update (2x forwards each)
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.99
    adam_epsilon: float = 1e-5
    max_grad_norm: float = 1.0
    lora_rank: int = 4
    lora_scale: float = 1.0
    # inverse temperature on the err difference (O(1e2) on toy velocity MSE)
    beta: float = 500.0
    # noise level per pair: "logit_normal" (sigma = sigmoid(N(mean, std)))
    # or "uniform" on (sigma_min, 1)
    timestep_sampling: str = "logit_normal"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    sigma_min: float = 0.02
    logging_steps: int = 1
    save_steps: int = 0
    save_total_limit: Optional[int] = None


def _tensors(batch: dict, skip=()) -> dict:
    return {k: v for k, v in batch.items()
            if isinstance(v, torch.Tensor) and not k.startswith(skip)}


class DPOTrainer:
    """Preference-pair LoRA fine-tuning over a frozen flow backbone.

    Args:
        config: DPOConfig.
        agent: an agent with the draft hooks (``TPDMAgent``); the DPO
            runs usually give it ``guidance_scale=None`` (no CFG doubling).
        dataset / collate_fn: rows -> a batch with the prompt embeds the
            agent's ``denoise_builder`` reads and the pair.
        encode_fn: uint8 images -> model-space latents, for batches that
            carry images.
        callbacks: objects with ``on_step_end(trainer, update, metrics,
            lora)``.
    """

    def __init__(self, config: DPOConfig, agent, dataset, collate_fn: Optional[Callable] = None,
                 encode_fn: Optional[Callable] = None, callbacks: Iterable = ()):
        check_hooks(agent, "Diffusion-DPO")
        if config.timestep_sampling not in ("logit_normal", "uniform"):
            raise ValueError(f"unknown timestep_sampling {config.timestep_sampling!r}")
        from tpdm_tpu_torch.train.rloo import _default_collate

        self.config = config
        self.agent = agent
        self.dataset = dataset
        self.encode_fn = encode_fn
        self.collate_fn = collate_fn or _default_collate
        self.callbacks = list(callbacks)
        self.metrics_history: list[dict] = []
        self.global_step = 0
        self.updates_this_run = 0

    # -- loss ---------------------------------------------------------------
    def _pair_errs(self, params, x_sigma, t_arg, target, batch2: dict, b: int):
        """Each half's denoising MSE at the drawn noise level, (b,) each."""
        v = self.agent.denoise_builder(params, batch2)(x_sigma, t_arg)[0]
        err = ((v.float() - target) ** 2).mean(dim=tuple(range(1, v.dim())))
        return err[:b], err[b:]

    def _update(self, lora: dict, optimizer, lat_w, lat_l, eps, sigma, batch: dict) -> dict:
        """One update of ``lora`` from the pair latents, the shared noise
        ``eps`` (b, ...) and noise levels ``sigma`` (b,)."""
        cfg = self.config
        base = self.agent.backbone_params
        b = lat_w.shape[0]
        x0 = torch.cat([lat_w, lat_l]).float()
        noise = torch.cat([eps, eps]).float()
        sigma2 = torch.cat([sigma, sigma])
        fwd = getattr(self.agent, "forward_noising", None)
        if fwd is not None:
            x_sigma, t_arg, target = fwd(x0, noise, sigma2)
            x_sigma = x_sigma.to(lat_w.dtype)
        else:
            sb = sigma2.reshape((-1,) + (1,) * (x0.dim() - 1))
            x_sigma = ((1.0 - sb) * x0 + sb * noise).to(lat_w.dtype)
            target = noise - x0  # the flow-matching velocity target
            t_arg = sigma2
        batch2 = {k: (torch.cat([v, v]) if v.shape[:1] == (b,) else v)
                  for k, v in _tensors(batch).items()}
        with torch.no_grad():
            ref_w, ref_l = self._pair_errs(None, x_sigma, t_arg, target, batch2, b)

        def loss_fn():
            merged = merge_lora(base, lora, scale=cfg.lora_scale)
            ew, el = self._pair_errs(merged, x_sigma, t_arg, target, batch2, b)
            margin = -cfg.beta * ((ew - ref_w) - (el - ref_l))
            loss = -F.logsigmoid(margin).mean()
            acc = (margin > 0).float().mean()
            return loss, [t.detach() for t in (margin.mean(), ew.mean(), el.mean(), acc)]

        loss, (margin, ew, el, acc), grads, grad_norm, finite = value_and_grad(loss_fn, lora)
        if finite:  # the NaN guard
            optimizer.update(grads)
        return {"loss": loss, "margin": margin, "implicit_acc": acc, "err_w": ew, "err_l": el,
                "grad_norm": grad_norm, "skipped": float(not finite)}

    # -- data ---------------------------------------------------------------
    def _pair_latents(self, batch: dict):
        dev = self.agent.device
        if "latents_w" in batch and "latents_l" in batch:
            return (torch.as_tensor(batch["latents_w"], device=dev),
                    torch.as_tensor(batch["latents_l"], device=dev))
        if "images_w" in batch and "images_l" in batch:
            if self.encode_fn is None:
                raise ValueError("batch carries images_w/images_l but no encode_fn was given")
            with torch.no_grad():
                return self.encode_fn(batch["images_w"]), self.encode_fn(batch["images_l"])
        raise ValueError(f"DPO batch needs latents_w/latents_l or images_w/images_l; got "
                         f"{sorted(batch)}")

    def _draw_sigma(self, generator: torch.Generator, b: int) -> torch.Tensor:
        cfg = self.config
        dev = generator.device
        if cfg.timestep_sampling == "logit_normal":
            u = torch.randn((b,), generator=generator, device=dev)
            s = torch.sigmoid(cfg.logit_mean + cfg.logit_std * u)
        else:
            u = torch.rand((b,), generator=generator, device=dev)
            s = cfg.sigma_min + (1.0 - cfg.sigma_min) * u
        return torch.clamp(s, cfg.sigma_min, 1.0)

    # -- loop ---------------------------------------------------------------
    def train(self, lora: Optional[dict] = None):
        """``total_updates`` updates; returns (lora, optimizer). One
        ``torch.Generator`` on the agent's device seeded with
        ``config.seed`` draws the initial factors, then each update's noise
        and sigmas; numpy's generator at the seed draws the rows."""
        cfg = self.config
        gen = torch.Generator(device=self.agent.device).manual_seed(cfg.seed)
        np_rng = np.random.default_rng(cfg.seed)
        if lora is None:
            lora = init_lora(self.agent.backbone_params, cfg.lora_rank, gen)
        lora = trainable_lora(lora)
        logger.info("dpo: %d LoRA params over %d layers, beta=%.1f, %s timesteps",
                    lora_param_count(lora), len(lora), cfg.beta, cfg.timestep_sampling)
        optimizer = lora_optimizer(lora, cfg)
        t0 = time.time()
        for update in range(1, cfg.total_updates + 1):
            batch = draw_batch(self.dataset, self.collate_fn, np_rng, cfg.batch_size)
            lat_w, lat_l = self._pair_latents(batch)
            eps = torch.randn(lat_w.shape, generator=gen, device=lat_w.device)
            sigma = self._draw_sigma(gen, lat_w.shape[0])
            stats = self._update(lora, optimizer, lat_w, lat_l, eps, sigma,
                                 _tensors(batch, ("latents_", "images_")))
            metrics = {f"dpo/{k}": float(stats[k]) for k in
                       ("loss", "margin", "implicit_acc", "err_w", "err_l", "grad_norm")}
            metrics.update({"dpo/num_skipped": stats["skipped"], "lr": cfg.learning_rate,
                            "eps": int(update * cfg.batch_size / max(time.time() - t0, 1e-9))})
            end_update(self, update, metrics, lora)
        finish_saves(self, lora)
        return lora, optimizer

    def save_lora(self, update: int, lora: dict) -> str:
        return save_rotating_lora(self.config.output_dir, update, lora,
                                  self.config.save_total_limit)
