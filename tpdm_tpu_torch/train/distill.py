"""Consistency distillation of the frozen backbone into few-step LoRA.

Counterpart of ``tpdm_tpu/train/distill.py`` (LCM-LoRA-style latent
consistency distillation, pseudo-Huber loss): learn LoRA factors such that
the merged student maps any point of the teacher's probability-flow ODE
trajectory to its endpoint, for 1-4 step sampling.

Objective, in the rectified-flow regime (SD3): over the sigma ladder
s_0 = 1 > ... > s_N = 0 and a level i per sample,
  x_hi = (1 - s_i) x0 + s_i eps                      (forward noising)
  x_lo = one teacher Euler step of x_hi, s_i -> s_{i+k} (frozen base)
  f(x, s) = x - s v(x, s)                            (x0-prediction head)
  loss = pseudo-huber( f_student(x_hi, s_i) - f_ema(x_lo, s_{i+k}) )
with f_ema an EMA of the student's factors (the consistency target). The
teacher and the target run under ``torch.no_grad()``; only the student
carries a gradient. The eps-prediction regime (SD1.5 / SDXL agents, which
carry a ``draft_step_builder``) is not ported: ``make_regime`` refuses it
(ROADMAP queue 1, item 9(e)).

The optimiser and the NaN guard are ``train/draft.py``'s; the EMA moves
after every update, skipped or not, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from tpdm_tpu_torch.models.lora import init_lora, lora_param_count, merge_lora
from tpdm_tpu_torch.ops.flow_euler import flow_euler_step
from tpdm_tpu_torch.pipeline.pipeline import not_ported
from tpdm_tpu_torch.train.draft import (
    check_hooks,
    draw_batch,
    end_update,
    finish_saves,
    lora_leaves,
    lora_optimizer,
    save_rotating_lora,
    trainable_lora,
    uniform_sigmas,
    value_and_grad,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DistillConfig:
    seed: int = 42
    output_dir: str = "output"
    total_updates: int = 10
    batch_size: int = 2
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.99
    adam_epsilon: float = 1e-5
    max_grad_norm: float = 1.0
    lora_rank: int = 8
    lora_scale: float = 1.0
    # the teacher ladder's N
    num_ladder_steps: int = 28
    # LCM skip-step k: ladder cells the teacher integrates a pair
    skip_steps: int = 1
    # EMA decay of the consistency target
    ema_decay: float = 0.95
    # pseudo-Huber c: loss = sqrt(mse + c^2) - c
    huber_c: float = 0.001
    logging_steps: int = 1
    save_steps: int = 0
    save_total_limit: Optional[int] = None


def _bshape(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return a.reshape((-1,) + (1,) * (ref.dim() - 1))


def make_regime(agent, num_ladder_steps: int) -> dict:
    """The three primitives of consistency distillation for ``agent``:
    noise_to(x0, eps, i), x0_pred(denoise_fn, x, i) and
    teacher_step(denoise_fn, x, i, j), with levels i (b,) int from 0 (pure
    noise) to N (clean), and n_levels = N. The flow regime only."""
    if getattr(agent, "draft_step_builder", None) is not None:
        raise not_ported("consistency distillation in the eps-prediction regime "
                         "(SD1.5 / SDXL)", "9(e)")
    sig = uniform_sigmas(num_ladder_steps)

    def level(i: torch.Tensor) -> torch.Tensor:
        return sig.to(i.device)[i]

    def noise_to(x0, eps, i):
        s = _bshape(level(i), x0)
        return ((1.0 - s) * x0.float() + s * eps.float()).to(x0.dtype)

    def x0_pred(denoise_fn, x, i):
        s = level(i)
        v = denoise_fn(x, s)[0].float()
        return x.float() - _bshape(s, x) * v

    def teacher_step(denoise_fn, x, i, j):
        s, s_next = level(i), level(j)
        return flow_euler_step(denoise_fn(x, s)[0], s_next, s, x)

    return dict(noise_to=noise_to, x0_pred=x0_pred, teacher_step=teacher_step,
                n_levels=num_ladder_steps)


def make_few_step_sampler(agent, num_ladder_steps: int, levels) -> Callable:
    """The consistency few-step sampler of a distilled student.

    ``levels``: strictly increasing ladder indices from 0 (pure noise), e.g.
    (0,) for one step, (0, 14) for two on a 28 ladder. Each round predicts
    x0 with the consistency head, then re-noises it to the next level with
    fresh noise. Returns ``sample_fn(student_params, batch, eps,
    generator=None, renoise=None)`` -> x0-space latents; student_params
    are ``merge_lora``'s tensors (None: the base). The fresh noise comes
    from ``generator`` (whole-batch draws) or ``renoise``, a (len(levels) -
    1, b, ...) stack, exactly one of them when there are several levels."""
    levels = tuple(int(lv) for lv in levels)
    if not levels or levels[0] != 0 or list(levels) != sorted(set(levels)):
        raise ValueError(f"levels must be strictly increasing and start at 0: {levels}")
    if any(not 0 <= lv < num_ladder_steps for lv in levels):
        raise ValueError(f"levels must lie in [0, {num_ladder_steps}): {levels}")

    @torch.no_grad()
    def sample_fn(student_params, batch, eps, generator=None, renoise=None):
        if len(levels) > 1 and (generator is None) == (renoise is None):
            raise ValueError("multi-level sampling needs exactly one of generator / renoise")
        regime = make_regime(agent, num_ladder_steps)
        denoise = agent.denoise_builder(student_params, batch)
        b = eps.shape[0]
        zeros = torch.zeros((b,), dtype=torch.long, device=eps.device)
        x0 = regime["x0_pred"](denoise, regime["noise_to"](torch.zeros_like(eps), eps, zeros),
                               zeros)
        for r, lv in enumerate(levels[1:]):
            if renoise is not None:
                fresh = renoise[r].to(eps.dtype)
            else:
                fresh = torch.randn(eps.shape, generator=generator, device=eps.device,
                                    dtype=eps.dtype)
            i = torch.full((b,), lv, dtype=torch.long, device=eps.device)
            x0 = regime["x0_pred"](denoise, regime["noise_to"](x0.to(eps.dtype), fresh, i), i)
        return x0

    return sample_fn


class DistillTrainer:
    """Distil the frozen backbone into few-step LoRA factors.

    Args:
        config: DistillConfig.
        agent: an agent with the draft hooks (``TPDMAgent``); its guidance
            is baked into ``denoise_builder``, so the student learns the
            guided x0 map at the agent's scale.
        latents_fn: (generator, batch_size, batch) -> clean x0 latents;
            None draws ``agent.prepare_latents`` (noise-shaped, for runs of
            the plumbing).
        dataset / collate_fn: prompt rows -> a CFG-ready embed batch.
        callbacks: objects with ``on_step_end(trainer, update, metrics,
            lora)``.
    """

    def __init__(self, config: DistillConfig, agent, dataset, collate_fn: Optional[Callable] = None,
                 latents_fn: Optional[Callable] = None, callbacks: Iterable = ()):
        check_hooks(agent, "consistency distillation")
        if not 1 <= config.skip_steps < config.num_ladder_steps:
            raise ValueError(f"skip_steps must be in [1, num_ladder_steps): got "
                             f"{config.skip_steps} of {config.num_ladder_steps}")
        from tpdm_tpu_torch.train.rloo import _default_collate

        self.config = config
        self.agent = agent
        self.dataset = dataset
        self.collate_fn = collate_fn or _default_collate
        self.latents_fn = latents_fn or (lambda gen, b, batch: agent.prepare_latents(gen, b))
        self.callbacks = list(callbacks)
        self.regime = make_regime(agent, config.num_ladder_steps)
        self.metrics_history: list[dict] = []
        self.global_step = 0
        self.updates_this_run = 0

    def _loss(self, lora: dict, ema: dict, x0, eps, idx, batch: dict):
        cfg, R, agent = self.config, self.regime, self.agent
        base = agent.backbone_params
        x_hi = R["noise_to"](x0, eps, idx)
        with torch.no_grad():
            x_lo = R["teacher_step"](agent.denoise_builder(None, batch), x_hi, idx,
                                     idx + cfg.skip_steps)
            target = agent.denoise_builder(merge_lora(base, ema, scale=cfg.lora_scale), batch)
            f_target = R["x0_pred"](target, x_lo, idx + cfg.skip_steps)
        student = agent.denoise_builder(merge_lora(base, lora, scale=cfg.lora_scale), batch)
        d = (R["x0_pred"](student, x_hi, idx) - f_target).float()
        mse = (d * d).mean(dim=tuple(range(1, d.dim())))
        c = cfg.huber_c
        return (torch.sqrt(mse + c * c) - c).mean(), mse.mean().detach()

    def _update(self, lora: dict, ema: dict, optimizer, x0, eps, idx, batch: dict) -> dict:
        """One update of ``lora`` (by ``optimizer``) and of ``ema``, in
        place, from clean latents ``x0``, noise ``eps`` and levels ``idx``."""
        loss, mse, grads, grad_norm, finite = value_and_grad(
            lambda: self._loss(lora, ema, x0, eps, idx, batch), lora)
        if finite:  # the NaN guard
            optimizer.update(grads)
        mu = self.config.ema_decay
        with torch.no_grad():
            for e, p in zip(lora_leaves(ema), lora_leaves(lora)):
                e.copy_(mu * e + (1.0 - mu) * p)
        return {"loss": loss, "mse": mse, "grad_norm": grad_norm, "skipped": float(not finite)}

    def train(self, lora: Optional[dict] = None):
        """``total_updates`` updates; returns (lora, ema, optimizer). One
        ``torch.Generator`` on the agent's device seeded with
        ``config.seed`` draws the initial factors, then each update's x0
        (through ``latents_fn``), noise and levels."""
        cfg = self.config
        gen = torch.Generator(device=self.agent.device).manual_seed(cfg.seed)
        np_rng = np.random.default_rng(cfg.seed)
        if lora is None:
            lora = init_lora(self.agent.backbone_params, cfg.lora_rank, gen)
        lora = trainable_lora(lora)
        ema = {k: {w: t.detach().clone() for w, t in f.items()} for k, f in lora.items()}
        logger.info("distill: %d LoRA params over %d layers, ladder N=%d skip=%d",
                    lora_param_count(lora), len(lora), cfg.num_ladder_steps, cfg.skip_steps)
        optimizer = lora_optimizer(lora, cfg)
        t0 = time.time()
        for update in range(1, cfg.total_updates + 1):
            batch = draw_batch(self.dataset, self.collate_fn, np_rng, cfg.batch_size)
            x0 = self.latents_fn(gen, cfg.batch_size, batch)
            eps = torch.randn(x0.shape, generator=gen, device=x0.device, dtype=x0.dtype)
            idx = torch.randint(0, cfg.num_ladder_steps - cfg.skip_steps + 1, (cfg.batch_size,),
                                generator=gen, device=x0.device)
            stats = self._update(lora, ema, optimizer, x0, eps, idx, batch)
            metrics = {"distill/loss": float(stats["loss"]), "distill/mse": float(stats["mse"]),
                       "distill/grad_norm": float(stats["grad_norm"]),
                       "distill/num_skipped": stats["skipped"], "lr": cfg.learning_rate,
                       "eps": int(update * cfg.batch_size / max(time.time() - t0, 1e-9))}
            end_update(self, update, metrics, lora)
        finish_saves(self, lora)
        return lora, ema, optimizer

    def save_lora(self, update: int, lora: dict) -> str:
        return save_rotating_lora(self.config.output_dir, update, lora,
                                  self.config.save_total_limit)
