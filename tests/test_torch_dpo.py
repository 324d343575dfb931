"""tpdm_tpu_torch's DPOTrainer (Diffusion-DPO LoRA) against the JAX
package's.

JAX draws the shared noise and the noise levels with its own keys, so the
update step (``_update``) runs on both sides with the same numpy pair
latents, noise and sigmas, on the JAX LoRA trainers' toy world
(``_torch_parity.lora_world``) with ``tests/test_dpo.py:_dpo_world``'s
trainer and ``_pair_dataset``'s rows (copied here: smooth preferred,
noisy rejected latents) and a noisy JAX adapter: loss, margin, implicit
accuracy, both errors, the gradient norm and every updated factor at fp32
rtol 1e-4 / atol 1e-5 (atol scaled by the largest magnitude). The JAX step
compiles once. The port's ``train()`` (both timestep draws), the margin at
a fresh adapter, the NaN guard, the images path through ``encode_fn``, the
preference datasets and ``train.main --trainer dpo`` run on the port
alone.
"""

import json

import numpy as np
import pytest
import torch

from _torch_parity import (
    close,
    close_lora,
    jax_arrays,
    lora_world,
    noisy_jax_lora,
    state_checksum,
)
from tpdm_tpu.data.datasets import SyntheticPreferencePairs as JSyntheticPreferencePairs
from tpdm_tpu.train.dpo import DPOConfig as JDPOConfig
from tpdm_tpu.train.dpo import DPOTrainer as JDPOTrainer
from tpdm_tpu_torch.data.datasets import PreferencePairDataset, SyntheticPreferencePairs
from tpdm_tpu_torch.train.dpo import DPOConfig, DPOTrainer
from tpdm_tpu_torch.train.draft import lora_optimizer, trainable_lora
from tpdm_tpu_torch.utils.convert import lora_from_jax

# tests/test_dpo.py:_dpo_world's trainer
CFG = dict(total_updates=6, batch_size=2, learning_rate=5e-3, lora_rank=2, beta=100.0,
           logging_steps=1)


def _pair_rows(rows, seed=0, nan_w=False):
    """``tests/test_dpo.py:_pair_dataset``'s latents on the world's prompt
    rows."""
    rng = np.random.default_rng(seed)
    out = []
    for row in rows:
        w = rng.normal(size=(16, 8, 8)).astype(np.float32) * 0.1
        if nan_w:
            w[0, 0, 0] = np.nan
        out.append({**row, "latents_w": w,
                    "latents_l": rng.normal(size=(16, 8, 8)).astype(np.float32) * 1.5})
    return out


@pytest.fixture(scope="module")
def world():
    """One JAX DPO update from numpy pairs, noise and sigmas on a noisy
    adapter (compiled once) and the port's world."""
    jagent, agent, rows = lora_world()
    rows = _pair_rows(rows)
    jlora = noisy_jax_lora(jagent.mmdit_params, seed=5)
    jtrainer = JDPOTrainer(JDPOConfig(**CFG), jagent, rows)
    batch = jtrainer.collate_fn(rows[:2])
    arrays = {k: v for k, v in jax_arrays(batch).items() if not k.startswith("latents_")}
    rng = np.random.default_rng(6)
    eps = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    sigma = np.array([0.3, 0.85], np.float32)
    new_lora, _, stats = jtrainer._update_jit(
        jlora, jtrainer.tx.init(jlora), np.asarray(batch["latents_w"]),
        np.asarray(batch["latents_l"]), eps, sigma, arrays)
    return dict(agent=agent, rows=rows, jlora=jlora, eps=eps, sigma=sigma,
                new_lora=new_lora, stats=stats)


def _trainer(world, rows=None, **kw):
    return DPOTrainer(DPOConfig(**{**CFG, **kw}), world["agent"], rows or world["rows"])


def test_update_matches_jax(world):
    trainer = _trainer(world)
    lora = trainable_lora(lora_from_jax(world["jlora"]))
    batch = trainer.collate_fn(world["rows"][:2])
    stats = trainer._update(lora, lora_optimizer(lora, trainer.config), batch["latents_w"],
                            batch["latents_l"], torch.from_numpy(world["eps"]),
                            torch.from_numpy(world["sigma"]), batch)
    ref = world["stats"]
    for k in ("loss", "margin", "implicit_acc", "err_w", "err_l", "grad_norm"):
        close(stats[k], np.asarray(ref[k]))
    assert stats["skipped"] == float(ref["skipped"]) == 0.0
    close_lora(lora, world["new_lora"])


@pytest.mark.parametrize("sampling", ["logit_normal", "uniform"])
def test_train_from_a_fresh_adapter(world, sampling):
    """Update 1 runs at the fresh adapter (merged = base): margin 0, loss
    log 2; the base weights stay the same to the bit; the b factors move."""
    before = state_checksum(world["agent"].mmdit)
    trainer = _trainer(world, total_updates=2, timestep_sampling=sampling)
    lora, _ = trainer.train()
    first = trainer.metrics_history[0]
    assert abs(first["dpo/margin"]) < 1e-6
    np.testing.assert_allclose(first["dpo/loss"], np.log(2.0), rtol=1e-6)
    assert all(m["dpo/num_skipped"] == 0.0 for m in trainer.metrics_history)
    assert any(f["b"].abs().max() > 0 for f in lora.values())
    assert all(torch.equal(a, b) for a, b in zip(before, state_checksum(world["agent"].mmdit)))


def test_sigma_draws_stay_in_range(world):
    for sampling in ("logit_normal", "uniform"):
        trainer = _trainer(world, timestep_sampling=sampling, sigma_min=0.3)
        s = trainer._draw_sigma(torch.Generator().manual_seed(0), 256)
        assert s.min() >= 0.3 and s.max() <= 1.0 and s.std() > 0.05
    with pytest.raises(ValueError, match="timestep_sampling"):
        _trainer(world, timestep_sampling="cosine")


def test_nan_guard_skips_the_update(world):
    rows = _pair_rows(world["rows"], nan_w=True)
    trainer = _trainer(world, rows=rows, total_updates=1, batch_size=4)
    lora, opt = trainer.train()
    assert trainer.metrics_history[0]["dpo/num_skipped"] == 1.0 and opt.count == 0
    assert all(not f["b"].any() for f in lora.values())


def test_images_go_through_encode_fn(world):
    """A batch of uint8 pairs is encoded (without grad) before the update;
    a batch with neither form is refused."""
    seen = []

    def encode(images):
        seen.append(torch.is_grad_enabled())
        return torch.as_tensor(images).float().mean(-1)[:, None].expand(-1, 16, -1, -1) / 255

    prompts = [{k: v for k, v in r.items() if not k.startswith("latents_")}
               for r in world["rows"]]
    rows = [{**r, "images_w": np.full((8, 8, 3), 10, np.uint8),
             "images_l": np.full((8, 8, 3), 200, np.uint8)} for r in prompts]
    trainer = DPOTrainer(DPOConfig(**{**CFG, "total_updates": 1}), world["agent"], rows,
                         encode_fn=encode)
    trainer.train()
    assert seen == [False, False]
    with pytest.raises(ValueError, match="latents_w/latents_l or images_w/images_l"):
        _trainer(world, rows=prompts, total_updates=1).train()


def test_preference_datasets(tmp_path):
    """SyntheticPreferencePairs draws JAX's rows to the bit;
    PreferencePairDataset reads a manifest of .npy latents."""
    ours, ref = SyntheticPreferencePairs(n=3, size=4), JSyntheticPreferencePairs(n=3, size=4)
    for a, b in zip(ours.rows, ref.rows):
        assert a["prompt"] == b["prompt"]
        assert np.array_equal(a["latents_w"], b["latents_w"])
        assert np.array_equal(a["latents_l"], b["latents_l"])
    np.save(tmp_path / "w.npy", ours[0]["latents_w"])
    np.save(tmp_path / "l.npy", ours[0]["latents_l"])
    (tmp_path / "pairs.jsonl").write_text(json.dumps(
        {"prompt": "p", "latents_w": "w.npy", "latents_l": "l.npy"}) + "\n")
    row = PreferencePairDataset(str(tmp_path / "pairs.jsonl"))[0]
    assert np.array_equal(row["latents_w"], ours[0]["latents_w"])
    (tmp_path / "bad.jsonl").write_text(json.dumps({"prompt": "p"}) + "\n")
    with pytest.raises(ValueError, match="latents_w/latents_l or image_w/image_l"):
        PreferencePairDataset(str(tmp_path / "bad.jsonl"))


def test_cli_dpo_runs_one_update(tmp_path, monkeypatch):
    from tpdm_tpu_torch.train import main

    monkeypatch.chdir(__import__("pathlib").Path(__file__).resolve().parents[1])
    trainer = main.main([
        "--cpu", "--trainer", "dpo", "--model_config", "configs/torch/models/toy_agent.yaml",
        "--train_dataset", "configs/torch/datasets/toy_preference_pairs.yaml",
        "--per_device_train_batch_size", "2", "--draft_updates", "1", "--dpo_beta", "100",
        "--dpo_timestep_sampling", "uniform", "--output_dir", str(tmp_path)])
    assert isinstance(trainer, DPOTrainer) and trainer.global_step == 1
    m = trainer.metrics_history[0]
    assert np.isfinite(list(m.values())).all() and m["dpo/num_skipped"] == 0.0
