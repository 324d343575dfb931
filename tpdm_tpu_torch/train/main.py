"""RLOO training from the command line: the port's counterpart of the
RLOO path of ``main_train.py``.

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

Not ported yet, and refused: the other trainers (``--trainer
draft|dpo|distill``, ROADMAP queue 1 item 9(e)), several processes and
the mesh (``--multihost``, ``--mesh_shape``, item 9(d)) and the heartbeat
watchdog (``--watchdog_*``, item 14). The JAX compile cache has no
counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import logging
import os
from typing import Iterable, Optional, Sequence

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
    p.add_argument("--reward_model_config", required=True, help="reward yaml")
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
                   help="only rloo is ported")
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
    if args.trainer != "rloo":
        raise NotImplementedError(
            f"--trainer {args.trainer}: only rloo is ported to tpdm_tpu_torch; the "
            "trainers that differentiate through the backbone wait for ROADMAP queue 1, "
            "item 9(e)")
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


def main(argv: Optional[Sequence[str]] = None, callbacks: Iterable = ()):
    """Parse ``argv`` (``sys.argv[1:]`` when None), build the components,
    train, and return the trainer. ``callbacks`` (for in-process callers)
    run first at each update, before the profiler's and the eval's."""
    from tpdm_tpu_torch.train.builders import make_prompt_encoder
    from tpdm_tpu_torch.train.callbacks import EvalVisualizationCallback, ProfilerCallback
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
    reward_fn = instantiate_file(args.reward_model_config)
    dataset = instantiate_file(args.train_dataset)
    if args.data_collator is not None:
        collate_fn = instantiate_file(args.data_collator)
    else:
        # toy and random-weight agents embed prompts deterministically; real
        # agents get embeds from a preprocessing stage or text encoders
        collate_fn = make_prompt_encoder(agent)

    callbacks = list(callbacks)
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
