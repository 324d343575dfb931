"""Training callbacks: periodic eval with schedule visualisations,
TensorBoard, a profiler window and a wall-clock budget.

The port's counterparts of ``tpdm_tpu/train/callbacks.py``. Each has
``on_step_end(trainer, update, metrics, eval_state)``, ``eval_state``
being the TPM's state dict (the EMA's when ``ema_decay`` is set), and may
have ``close()``, which ``RLOOTrainer.train`` calls on exit.

Not ported yet: the eval's multi-process sharding (``shard_eval_batch``,
``_gather_trim``), ROADMAP queue 1 item 9(d). With more than one
torch.distributed rank the eval raises.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from tpdm_tpu_torch.parallel.mesh import process_count, process_index
from tpdm_tpu_torch.utils.image import postprocess_images, write_png

logger = logging.getLogger(__name__)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class EvalVisualizationCallback:
    """Every ``eval_steps`` updates, a deterministic rollout (``predict=True``,
    no activation cache) of a fixed eval batch at ``max_inference_steps``,
    with the policy of ``eval_state``; its initial latents come from
    ``torch.Generator(device).manual_seed(update)`` (JAX: ``PRNGKey(update)``).

    Each eval appends a record to ``history``: sigmas, alphas, betas, masks
    and nfe (numpy, batch-major), rewards when ``reward_fn`` is given, and
    the eval's wall seconds. Into ``output_dir`` go the sigma / alpha / beta
    / concentration curves (where matplotlib imports) and, with
    ``decode_fn`` (final latents -> images in [-1, 1]), the images side by
    side as one PNG. wandb gets the eval when it imports and a run is active.

    Args:
        eval_batch: the collated batch (embeds, optional "latents" and
            "prompt" strings for the reward).
        reward_fn: optional (prompts, outputs) -> (scores, _) scorer.
        eval_steps: cadence in updates; 0 disables.
        max_inference_steps: the eval's step budget, 40 as in the JAX package.
        sigma_filter: the curves show only steps with sigma above this.
    """

    def __init__(
        self,
        eval_batch: dict,
        output_dir: str,
        reward_fn=None,
        eval_steps: int = 50,
        max_inference_steps: int = 40,
        sigma_filter: float = 0.01,
        save_images: bool = True,
        decode_fn=None,
    ):
        self.eval_batch = eval_batch
        self.output_dir = output_dir
        self.reward_fn = reward_fn
        self.eval_steps = eval_steps
        self.max_inference_steps = max_inference_steps
        self.sigma_filter = sigma_filter
        self.save_images = save_images
        self.decode_fn = decode_fn
        self.history: list[dict] = []
        self._tpm = None  # built on the first eval, then loaded with each eval_state

    def _eval_tpm(self, agent, eval_state):
        if self._tpm is None:
            with torch.device(agent.device):
                self._tpm = agent.tpm_factory()
        self._tpm.load_state_dict(eval_state)
        return self._tpm

    def on_step_end(self, trainer, update: int, metrics: dict, eval_state):
        if not self.eval_steps or update % self.eval_steps != 0:
            return
        if process_count() > 1:
            raise NotImplementedError(
                "the eval over several torch.distributed ranks (shard_eval_batch and the "
                "gather to rank 0) is not ported to tpdm_tpu_torch yet (ROADMAP queue 1, "
                "item 9(d))")
        start = time.perf_counter()
        agent = trainer.agent
        eval_cfg = dataclasses.replace(agent.sampler_cfg, predict=True, cache_activations=False,
                                       max_inference_steps=self.max_inference_steps)
        generator = torch.Generator(device=agent.device).manual_seed(update)
        outputs = agent.sample(self._eval_tpm(agent, eval_state), self.eval_batch, generator,
                               sampler_cfg=eval_cfg)
        record = {
            "update": update,
            "sigmas": _host(outputs.sigmas),
            "alphas": _host(outputs.alphas),
            "betas": _host(outputs.betas),
            "masks": _host(outputs.prob_masks),
            "nfe": _host(outputs.last_valid_index) + 1,
        }
        if self.reward_fn is not None:
            scores, _ = self.reward_fn(self.eval_batch.get("prompt"), outputs)
            record["rewards"] = _host(scores)
        imgs = None
        if self.save_images and self.decode_fn is not None:
            with torch.no_grad():
                imgs = postprocess_images(self.decode_fn(outputs.final_latents))
        del outputs
        os.makedirs(self.output_dir, exist_ok=True)
        self._plot(record)
        if imgs is not None:
            self._save_images(update, imgs)
        record["seconds"] = time.perf_counter() - start
        self.history.append(record)
        logger.info(
            "eval @ update %d: mean NFE %.2f%s (%.1f s)",
            update,
            float(record["nfe"].mean()),
            (
                f", mean reward {float(record['rewards'].mean()):.3f}"
                if "rewards" in record
                else ""
            ),
            record["seconds"],
        )
        self._maybe_wandb(record, imgs=imgs, prompts=self.eval_batch.get("prompt"))

    # -- internals -------------------------------------------------------
    def _plot(self, rec: dict):
        try:
            import matplotlib
        except ImportError:
            logger.debug("matplotlib is not installed: no eval curves")
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        b = rec["sigmas"].shape[0]
        fig, axes = plt.subplots(1, 4, figsize=(18, 4))
        for i in range(b):
            sig = rec["sigmas"][i]
            keep = sig > self.sigma_filter
            steps = np.arange(len(sig))[keep]
            axes[0].plot(steps, sig[keep], alpha=0.7)
            axes[1].plot(steps, rec["alphas"][i][keep], alpha=0.7)
            axes[2].plot(steps, rec["betas"][i][keep], alpha=0.7)
            axes[3].plot(
                steps,
                (rec["alphas"][i] + rec["betas"][i])[keep],
                alpha=0.7,
            )
        for ax, title in zip(axes, ("sigma", "alpha", "beta", "concentration")):
            ax.set_title(title)
            ax.set_xlabel("step")
        fig.tight_layout()
        out = os.path.join(self.output_dir, f"eval_curves_{rec['update']}.png")
        fig.savefig(out)
        plt.close(fig)

    def _save_images(self, update: int, imgs):
        strip = np.concatenate(list(np.asarray(imgs)), axis=1)
        write_png(os.path.join(self.output_dir, f"eval_images_{update}.png"), strip)

    def _plot_prompt(self, rec: dict, i: int):
        """One prompt's sigma/alpha/beta/concentration figure."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        sig = rec["sigmas"][i]
        keep = sig > self.sigma_filter
        steps = np.arange(len(sig))[keep]
        fig, axes = plt.subplots(1, 4, figsize=(14, 3))
        series = (
            sig[keep],
            rec["alphas"][i][keep],
            rec["betas"][i][keep],
            (rec["alphas"][i] + rec["betas"][i])[keep],
        )
        for ax, ys, title in zip(
            axes, series, ("sigma", "alpha", "beta", "concentration")
        ):
            ax.plot(steps, ys, marker="o", markersize=3)
            ax.set_title(title)
            ax.set_xlabel("step")
        fig.tight_layout()
        return fig

    def _maybe_wandb(self, rec: dict, imgs=None, prompts=None):
        """Scalars, the NFE histogram, per-prompt schedule figures (where
        matplotlib imports) and the image strip, to an active wandb run."""
        try:
            import wandb
        except ImportError:
            return
        if wandb.run is None:
            return
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            plt = None

        payload = {"eval/mean_nfe": float(rec["nfe"].mean())}
        if "rewards" in rec:
            payload["eval/mean_reward"] = float(rec["rewards"].mean())
        payload["eval/nfe_hist"] = wandb.Histogram(
            np.asarray(rec["nfe"]).tolist()
        )
        for i in range(rec["sigmas"].shape[0] if plt is not None else 0):
            label = (
                prompts[i][:60] if prompts is not None and i < len(prompts)
                else f"prompt_{i}"
            )
            caption = f"{label} | nfe={int(rec['nfe'][i])}"
            if "rewards" in rec:
                caption += f" | reward={float(rec['rewards'][i]):.3f}"
            fig = self._plot_prompt(rec, i)
            payload[f"eval/curves/{i}"] = wandb.Image(fig, caption=caption)
            plt.close(fig)
        if imgs is not None:
            strip = np.concatenate(list(np.asarray(imgs)), axis=1)
            payload["eval/images"] = wandb.Image(strip)
        wandb.log(payload, step=rec["update"])


class TensorBoardCallback:
    """Stream every update's scalar metrics to a TensorBoard event file
    (``utils/tb_writer.py``, no tensorboard install needed to write).
    Process 0 only; the writer opens at the first update. A failed write
    is logged, never raised."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._writer = None

    def _get_writer(self):
        if self._writer is None:
            from tpdm_tpu_torch.utils.tb_writer import EventWriter

            self._writer = EventWriter(self.logdir)
        return self._writer

    def on_step_end(self, trainer, update: int, metrics: dict, eval_state):
        if process_index() != 0:
            return
        try:
            w = self._get_writer()
            w.add_scalars(update, metrics)
            w.flush()
        except OSError as e:  # observability must never kill training
            logger.warning("tensorboard event write failed: %s", e)

    def close(self):
        if self._writer is not None:
            self._writer.close()


class ProfilerCallback:
    """A ``torch.profiler`` trace of a window of training updates.

    Recording starts when update ``start`` completes and stops when update
    ``start + count`` completes, so the first update's set-up stays out;
    what runs between (the callbacks listed after this one at update
    ``start``, the updates, the checkpoint writes) is in the window. The
    trace records the CPU and, when the agent runs on a CUDA card, its
    kernels, and is written as a Chrome trace (``trace_path``) into
    ``log_dir``.
    """

    def __init__(self, log_dir: str, start: int = 1, count: int = 1):
        self.log_dir = log_dir
        self.start = start
        self.count = count
        self.trace_path = None
        self._prof = None
        self._first = self._last = None
        self._done = False

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def on_step_end(self, trainer, update: int, metrics: dict, eval_state):
        from torch.profiler import ProfilerActivity, profile

        if self._done:
            return
        self._last = update
        if not self._active and update >= self.start:
            activities = [ProfilerActivity.CPU]
            if trainer.agent.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._first = update + 1
            logger.info(
                "profiler: tracing updates %d..%d into %s",
                update + 1, update + self.count, self.log_dir,
            )
        elif self._active and update >= self.start + self.count:
            self._stop()

    def _stop(self):
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.log_dir, f"trace_updates_{self._first}-{self._last}.pt.trace.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self._done = True
        logger.info("profiler: trace written to %s", self.trace_path)

    def close(self):
        """Stop a still-open window (an early stop, or a run shorter than
        the window); warn when the window never opened."""
        if self._active:
            self._stop()
        elif not self._done:
            logger.warning(
                "profiler: window never opened (start=%d is past the "
                "run's last update); no trace written to %s",
                self.start, self.log_dir,
            )


class TimeBudgetCallback:
    """Stop training gracefully before a wall-clock budget expires: once
    the budget less ``margin_seconds`` (room for the last update and its
    checkpoint) is spent, ``trainer.request_stop()``, so the run
    checkpoints itself resumably instead of being killed mid-update."""

    def __init__(self, budget_seconds: float, margin_seconds: float = 60.0):
        self.deadline = time.monotonic() + budget_seconds - margin_seconds
        self._fired = False

    def on_step_end(self, trainer, update: int, metrics: dict, eval_state):
        if not self._fired and time.monotonic() >= self.deadline:
            self._fired = True
            logger.info(
                "wall-clock budget reached at update %d: requesting stop",
                update,
            )
            trainer.request_stop()
