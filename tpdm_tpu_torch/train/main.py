"""Training from the command line: the port's counterpart of
``main_train.py``.

    python -m tpdm_tpu_torch.train.main --cpu \\
        --model_config configs/torch/models/toy_agent.yaml \\
        --reward_model_config configs/torch/models/toy_reward.yaml \\
        --train_dataset configs/torch/datasets/jsonl_prompts.yaml \\
        --total_episodes 16 --per_device_train_batch_size 4 --rloo_k 2 \\
        --max_inference_steps 3 --save_steps 2 --output_dir /tmp/tpdm_out

The flags name component YAMLs (agent, reward, dataset, collator), which
``utils/instantiate.py`` builds, and set every ``RLOOConfig`` field. An
agent YAML with ``_partial_: true`` names a builder that ``main`` calls with
``config`` and ``device``: "cuda" (which raises without a card) unless
``--cpu`` is given. Without ``--data_collator`` the batches are embedded
by ``train.builders.make_prompt_encoder(agent)``. ``--eval_steps`` adds an
``EvalVisualizationCallback`` over the dataset's first 10 rows (it writes
images when the agent carries a ``decode_fn``: final latents -> images in
[-1, 1]); ``--report_to tensorboard`` streams the metrics to
``output_dir/tb``; ``--profile_updates N`` traces N updates into
``output_dir/profile``. ``main(argv)`` runs in-process and returns the
trainer.

``--trainer`` picks the algorithm: rloo (the TPM's schedule policy), draft
(reward-gradient LoRA, ``train/draft.py``; the reward YAML builds a
differentiable ``reward_apply(final latents, batch)``, e.g.
``configs/torch/models/toy_draft_reward.yaml``), dpo (Diffusion-DPO,
``train/dpo.py``; no reward model: the dataset's rows carry
``latents_w`` / ``latents_l``, e.g.
``configs/torch/datasets/toy_preference_pairs.yaml``) and distill
(consistency distillation, ``train/distill.py``; no reward model). They
share the RLOO flags where the concepts meet (seed, learning rate, Adam,
clipping, batch size, ``max_inference_steps`` as the ladder's length,
logging and saving) and add ``--lora_rank``, ``--lora_scale``,
``--k_backprop``, ``--draft_updates`` (updates of draft, dpo and distill),
``--dpo_beta``, ``--dpo_timestep_sampling``, ``--distill_skip`` and
``--distill_ema``.

Not ported yet, and refused: several processes and the mesh
(``--multihost``, ``--mesh_shape``, ROADMAP queue 1 item 9(d)) and the
heartbeat watchdog (``--watchdog_*``, item 14). The JAX compile cache has
no counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import logging
import os
from typing import Iterable, Optional, Sequence

import torch

from tpdm_tpu_torch.train.config import RLOOConfig

logger = logging.getLogger("tpdm_tpu_torch.train.main")

_TRUE = ("1", "true", "yes")


def _optional(kind):
    """A flag of an Optional field: "none" is None, anything else ``kind``."""
    return lambda s: None if s.lower() == "none" else kind(s)


def _config_flag_type(field: dataclasses.Field):
    if field.type == "bool" or isinstance(field.default, bool):
        return lambda s: s.lower() in _TRUE
    if field.default is None:
        return _optional({"Optional[int]": int, "Optional[float]": float}[field.type])
    return type(field.default)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpdm_tpu_torch.train.main",
        description="RLOO training of the TPM (tpdm_tpu_torch)")
    p.add_argument("--model_config", required=True, help="agent component yaml")
    p.add_argument("--reward_model_config", default=None,
                   help="reward yaml (rloo and draft; dpo and distill take none)")
    p.add_argument("--train_dataset", required=True, help="dataset yaml")
    p.add_argument("--data_collator", default=None, help="collator yaml")
    p.add_argument("--resume_from_checkpoint", default=None,
                   help="'true' for the latest in output_dir, 'false'/'none' for a fresh "
                        "run, or a checkpoint path")
    p.add_argument("--cpu", action="store_true",
                   help="build and train on the CPU; the default device is cuda")
    p.add_argument("--profile_updates", type=int, default=0,
                   help="trace this many updates with torch.profiler into "
                        "output_dir/profile (a Chrome trace); recording starts when "
                        "--profile_start completes")
    p.add_argument("--profile_start", type=int, default=1,
                   help="update whose completion starts the trace window")
    p.add_argument("--trainer", choices=["rloo", "draft", "dpo", "distill"], default="rloo",
                   help="rloo = the TPM's schedule policy; draft = reward-gradient LoRA "
                        "(a differentiable reward YAML); dpo = Diffusion-DPO over "
                        "latents_w/latents_l rows (no reward); distill = consistency "
                        "distillation (no reward)")
    p.add_argument("--lora_rank", type=int, default=4)
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--k_backprop", type=int, default=1,
                   help="DRaFT-K: how many final denoise steps backprop")
    p.add_argument("--draft_updates", type=int, default=10,
                   help="LoRA updates of --trainer draft, dpo and distill")
    p.add_argument("--dpo_beta", type=float, default=500.0,
                   help="DPO inverse temperature on the err difference")
    p.add_argument("--dpo_timestep_sampling", choices=["logit_normal", "uniform"],
                   default="logit_normal")
    p.add_argument("--distill_skip", type=int, default=1,
                   help="LCM skip-k: ladder cells the teacher integrates a pair")
    p.add_argument("--distill_ema", type=float, default=0.95,
                   help="EMA decay of the consistency target")
    # accepted for main_train.py's command lines, refused until ported
    p.add_argument("--multihost", action="store_true", help="not ported (item 9(d))")
    p.add_argument("--mesh_shape", default=None, help="not ported (item 9(d))")
    p.add_argument("--watchdog_coordinator", default=None, help="not ported (item 14)")
    p.add_argument("--watchdog_timeout", type=float, default=30.0, help="not ported (item 14)")
    p.add_argument("--watchdog_stall_timeout", type=float, default=None,
                   help="not ported (item 14)")
    p.add_argument("--watchdog_hard_exit", type=float, default=300.0,
                   help="not ported (item 14)")
    for f in dataclasses.fields(RLOOConfig):
        p.add_argument(f"--{f.name}", type=_config_flag_type(f), default=f.default)
    return p


def _refuse_unported(args, parser: argparse.ArgumentParser) -> None:
    if args.multihost or args.mesh_shape:
        raise NotImplementedError(
            "--multihost / --mesh_shape: data parallelism is not ported to tpdm_tpu_torch "
            "yet (ROADMAP queue 1, item 9(d))")
    watchdog = [a for a in ("watchdog_coordinator", "watchdog_timeout",
                            "watchdog_stall_timeout", "watchdog_hard_exit")
                if getattr(args, a) != parser.get_default(a)]
    if watchdog:
        raise NotImplementedError(
            f"--{watchdog[0]}: the heartbeat watchdog is not ported to tpdm_tpu_torch yet "
            "(ROADMAP queue 1, item 14)")


def _resume_arg(value: Optional[str]):
    """'true' -> the latest checkpoint, 'false' / 'none' / '' -> a fresh
    run, anything else a checkpoint path."""
    if value is None or value.lower() in ("false", "none", ""):
        return None
    return True if value.lower() == "true" else value


def _lora_config(cls, args, config: RLOOConfig, **kw):
    """A LoRA trainer's config from the RLOO flags they share and ``kw``."""
    return cls(seed=config.seed, output_dir=config.output_dir, total_updates=args.draft_updates,
               batch_size=config.per_device_train_batch_size,
               learning_rate=config.learning_rate, adam_beta1=config.adam_beta1,
               adam_beta2=config.adam_beta2, adam_epsilon=config.adam_epsilon,
               max_grad_norm=config.max_grad_norm, lora_rank=args.lora_rank,
               lora_scale=args.lora_scale, logging_steps=config.logging_steps,
               save_steps=config.save_steps, **kw)


def _run_lora_trainer(args, config: RLOOConfig, agent, reward_fn, dataset, collate_fn,
                      callbacks: list):
    """--trainer draft | dpo | distill: build the trainer, train, close
    the callbacks; returns the trainer."""
    if args.trainer == "draft":
        from tpdm_tpu_torch.train.draft import DraftConfig, DraftTrainer

        cfg = _lora_config(DraftConfig, args, config, num_steps=config.max_inference_steps,
                           k_backprop=args.k_backprop)
        trainer = DraftTrainer(cfg, agent, reward_fn, dataset, collate_fn=collate_fn,
                               callbacks=callbacks)
    elif args.trainer == "dpo":
        from tpdm_tpu_torch.train.dpo import DPOConfig, DPOTrainer

        def dpo_collate(rows):
            # the pair arrays ride along with the prompt embedding
            batch = collate_fn(rows)
            for k in ("latents_w", "latents_l", "images_w", "images_l"):
                if k in rows[0]:
                    batch[k] = torch.stack([torch.as_tensor(r[k]) for r in rows])
            return batch

        cfg = _lora_config(DPOConfig, args, config, beta=args.dpo_beta,
                           timestep_sampling=args.dpo_timestep_sampling,
                           save_total_limit=config.save_total_limit)
        trainer = DPOTrainer(cfg, agent, dataset, collate_fn=dpo_collate, callbacks=callbacks)
    else:
        from tpdm_tpu_torch.train.distill import DistillConfig, DistillTrainer

        cfg = _lora_config(DistillConfig, args, config,
                           num_ladder_steps=config.max_inference_steps,
                           skip_steps=args.distill_skip, ema_decay=args.distill_ema)
        trainer = DistillTrainer(cfg, agent, dataset, collate_fn=collate_fn,
                                 callbacks=callbacks)
    trainer.train()
    for cb in callbacks:
        close = getattr(cb, "close", None)
        if close is not None:
            close()
    last = trainer.metrics_history[-1] if trainer.metrics_history else {}
    logger.info("%s training done: %d updates, last metrics %s", args.trainer,
                trainer.global_step, last)
    return trainer


def main(argv: Optional[Sequence[str]] = None, callbacks: Iterable = ()):
    """Parse ``argv`` (``sys.argv[1:]`` when None), build the components,
    train, and return the trainer. ``callbacks`` (for in-process callers)
    run first at each update, before the profiler's and the eval's."""
    from tpdm_tpu_torch.train.builders import make_prompt_encoder
    from tpdm_tpu_torch.train.callbacks import (
        EvalVisualizationCallback,
        ProfilerCallback,
        TensorBoardCallback,
    )
    from tpdm_tpu_torch.train.rloo import RLOOTrainer
    from tpdm_tpu_torch.utils.debug import setup_debug_from_env
    from tpdm_tpu_torch.utils.instantiate import instantiate_file

    parser = build_parser()
    args = parser.parse_args(argv)
    _refuse_unported(args, parser)
    setup_debug_from_env()
    config = RLOOConfig(**{f.name: getattr(args, f.name) for f in dataclasses.fields(RLOOConfig)})
    device = "cpu" if args.cpu else "cuda"

    agent_builder = instantiate_file(args.model_config)
    agent = (agent_builder(config=config, device=device)
             if isinstance(agent_builder, functools.partial) else agent_builder)
    if args.trainer in ("rloo", "draft") and not args.reward_model_config:
        raise SystemExit(f"--trainer {args.trainer} requires --reward_model_config")
    reward_fn = (instantiate_file(args.reward_model_config)
                 if args.trainer in ("rloo", "draft") else None)
    if args.reward_model_config and reward_fn is None:
        logger.info("--trainer %s ignores --reward_model_config", args.trainer)
    dataset = instantiate_file(args.train_dataset)
    if args.data_collator is not None:
        collate_fn = instantiate_file(args.data_collator)
    else:
        # toy and random-weight agents embed prompts deterministically; real
        # agents get embeds from a preprocessing stage or text encoders
        collate_fn = make_prompt_encoder(agent)

    callbacks = list(callbacks)
    if args.trainer != "rloo":
        if config.report_to == "tensorboard":
            callbacks.append(TensorBoardCallback(os.path.join(config.output_dir, "tb")))
        if args.profile_updates:
            callbacks.append(ProfilerCallback(os.path.join(config.output_dir, "profile"),
                                              start=args.profile_start,
                                              count=args.profile_updates))
        return _run_lora_trainer(args, config, agent, reward_fn, dataset, collate_fn, callbacks)
    if args.profile_updates:
        # before the eval: the window closes ahead of the eval of its last update
        callbacks.append(ProfilerCallback(os.path.join(config.output_dir, "profile"),
                                          start=args.profile_start, count=args.profile_updates))
    if config.eval_steps:
        eval_rows = [dataset[i] for i in range(min(10, len(dataset)))]
        callbacks.append(EvalVisualizationCallback(
            collate_fn(eval_rows), output_dir=os.path.join(config.output_dir, "eval"),
            reward_fn=reward_fn, eval_steps=config.eval_steps,
            decode_fn=getattr(agent, "decode_fn", None)))

    trainer = RLOOTrainer(config, agent, reward_fn, dataset, collate_fn=collate_fn,
                          callbacks=callbacks)
    trainer.train(resume_from_checkpoint=_resume_arg(args.resume_from_checkpoint))
    logger.info("training done: %d updates", trainer.global_step)
    for m in trainer.metrics_history[-3:]:
        logger.info("metrics: %s", m)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()
