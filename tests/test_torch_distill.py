"""tpdm_tpu_torch's DistillTrainer (LCM-LoRA consistency distillation)
against the JAX package's.

JAX draws x0, the noise and the ladder levels with its own keys, so the
update step (``_update``) runs on both sides with the same numpy inputs,
on the JAX LoRA trainers' toy world (``_torch_parity.lora_world``) with
``tests/test_distill.py:_flow_world``'s trainer (ladder 4, skip 1, EMA
0.5) and noisy JAX adapters for the student and the EMA target: loss,
MSE, the gradient norm, every updated factor and every EMA factor at fp32
rtol 1e-4 / atol 1e-5 (atol scaled by the largest magnitude). The JAX
step compiles once, and so does JAX's few-step sampler on the same
renoise stack. The port's ``train()``, the refusals (the eps regime,
``skip_steps``) and ``train.main --trainer distill`` run on the port
alone.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import close, close_lora, jax_arrays, lora_world, noisy_jax_lora, t
from tpdm_tpu.models.lora import apply_lora as jax_apply_lora
from tpdm_tpu.train.distill import DistillConfig as JDistillConfig
from tpdm_tpu.train.distill import DistillTrainer as JDistillTrainer
from tpdm_tpu.train.distill import make_few_step_sampler as jax_few_step_sampler
from tpdm_tpu_torch.models.lora import merge_lora
from tpdm_tpu_torch.pipeline.pipeline import not_ported
from tpdm_tpu_torch.train.distill import (
    DistillConfig,
    DistillTrainer,
    make_few_step_sampler,
    make_regime,
)
from tpdm_tpu_torch.train.draft import lora_optimizer, trainable_lora
from tpdm_tpu_torch.utils.convert import lora_from_jax

# tests/test_distill.py:_flow_world's trainer
CFG = dict(total_updates=6, batch_size=2, learning_rate=5e-3, lora_rank=2, num_ladder_steps=4,
           skip_steps=1, ema_decay=0.5, logging_steps=1)


@pytest.fixture(scope="module")
def world():
    jagent, agent, rows = lora_world()
    jlora, jema = (noisy_jax_lora(jagent.mmdit_params, seed=s) for s in (7, 8))
    jtrainer = JDistillTrainer(JDistillConfig(**CFG), jagent, rows)
    arrays = jax_arrays(jtrainer.collate_fn(rows[:2]))
    rng = np.random.default_rng(9)
    x0 = rng.standard_normal((2, 16, 8, 8)).astype(np.float32) * 0.5
    eps = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    idx = np.array([0, 2], np.int32)
    new_lora, new_ema, _, stats = jtrainer._update_jit(
        jlora, jema, jtrainer.tx.init(jlora), x0, eps, idx, arrays)
    return dict(jagent=jagent, agent=agent, rows=rows, arrays=arrays, jlora=jlora, jema=jema,
                x0=x0, eps=eps, idx=idx, new_lora=new_lora, new_ema=new_ema, stats=stats)


def _trainer(world, **kw):
    return DistillTrainer(DistillConfig(**{**CFG, **kw}), world["agent"], world["rows"])


def test_update_matches_jax(world):
    trainer = _trainer(world)
    lora = trainable_lora(lora_from_jax(world["jlora"]))
    ema = {k: {w: v.clone() for w, v in f.items()} for k, f in
           lora_from_jax(world["jema"]).items()}
    stats = trainer._update(lora, ema, lora_optimizer(lora, trainer.config), t(world["x0"]),
                            t(world["eps"]), t(world["idx"]).long(),
                            trainer.collate_fn(world["rows"][:2]))
    ref = world["stats"]
    for k in ("loss", "mse", "grad_norm"):
        close(stats[k], np.asarray(ref[k]))
    assert stats["skipped"] == float(ref["skipped"]) == 0.0
    close_lora(lora, world["new_lora"])
    close_lora(ema, world["new_ema"])


def test_few_step_sampler_matches_jax(world):
    """Two levels (0, 2) of the consistency sampler on the merged student,
    the re-noise from one numpy stack on both sides."""
    rng = np.random.default_rng(10)
    eps = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    renoise = rng.standard_normal((1, 2, 16, 8, 8)).astype(np.float32)
    jagent = world["jagent"]
    merged = jax_apply_lora(jagent.mmdit_params, world["jlora"])
    sample = jax_few_step_sampler(jagent, 4, (0, 2))
    ref = jax.jit(lambda p, e, r: sample(p, world["arrays"], e, renoise=r))(merged, eps, renoise)
    agent = world["agent"]
    student = merge_lora(agent.backbone_params, lora_from_jax(world["jlora"]))
    batch = _trainer(world).collate_fn(world["rows"][:2])
    got = make_few_step_sampler(agent, 4, (0, 2))(student, batch, t(eps), renoise=t(renoise))
    close(got, np.asarray(ref))
    with pytest.raises(ValueError, match="exactly one"):
        make_few_step_sampler(agent, 4, (0, 2))(None, batch, t(eps))
    with pytest.raises(ValueError, match="strictly increasing"):
        make_few_step_sampler(agent, 4, (1, 2))


def test_train_moves_the_student_and_its_target(world):
    """The port's loop: finite loss, the EMA target moved from the factors'
    start, the base weights unchanged."""
    agent = world["agent"]
    before = [p.detach().clone() for p in agent.mmdit.parameters()]
    trainer = _trainer(world, total_updates=2)
    lora, ema, opt = trainer.train()
    assert opt.count == 2 and all(np.isfinite(list(m.values())).all()
                                  for m in trainer.metrics_history)
    assert any(f["b"].abs().max() > 0 for f in ema.values())
    assert all(torch.equal(a, b) for a, b in zip(before, agent.mmdit.parameters()))


def test_refusals(world):
    class EpsAgent:  # an eps-prediction agent: it carries draft_step_builder
        backbone_params = denoise_builder = None

        def draft_step_builder(self, num_steps):
            raise not_ported("draft_step_builder", "9(e)")

    with pytest.raises(NotImplementedError, match=r"item 9\(e\)"):
        make_regime(EpsAgent(), 4)
    with pytest.raises(ValueError, match="skip_steps"):
        _trainer(world, skip_steps=4)


def test_cli_distill_runs_one_update(tmp_path, monkeypatch):
    from tpdm_tpu_torch.train import main

    monkeypatch.chdir(__import__("pathlib").Path(__file__).resolve().parents[1])
    trainer = main.main([
        "--cpu", "--trainer", "distill", "--model_config", "configs/torch/models/toy_agent.yaml",
        "--train_dataset", "configs/torch/datasets/jsonl_prompts.yaml",
        "--per_device_train_batch_size", "2", "--max_inference_steps", "4",
        "--draft_updates", "1", "--distill_skip", "2", "--distill_ema", "0.9",
        "--output_dir", str(tmp_path)])
    assert isinstance(trainer, DistillTrainer) and trainer.global_step == 1
    assert trainer.config.skip_steps == 2 and trainer.config.ema_decay == 0.9
    assert trainer.metrics_history[0]["distill/num_skipped"] == 0.0
