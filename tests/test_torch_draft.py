"""tpdm_tpu_torch's DraftTrainer (DRaFT-K reward-gradient LoRA) against the
JAX package's.

JAX draws its latents with its own keys, so the update step (``_update``)
runs on both sides with the same numpy latents, on the JAX LoRA trainers'
toy world (``_torch_parity.lora_world``, the configuration of
``tests/test_draft.py:_draft_world``) and a noisy JAX adapter carried
across by ``utils/convert.py:lora_from_jax``: the loss, the reward, the
gradient norm and every updated factor at fp32 rtol 1e-4 / atol 1e-5
(atol scaled by the largest magnitude, ``_torch_parity.close``). The JAX
step compiles once (module fixture). The port's own ``train()`` (its
``torch.Generator`` draws), the base weights, the NaN guard, the
``k_backprop`` refusal, the rotating LoRA files (read back by JAX's
``load_lora``), the differentiable ImageReward builder and ``train.main
--trainer draft`` run on the port alone.
"""

import jax.numpy as jnp
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
from tpdm_tpu.train.draft import DraftConfig as JDraftConfig
from tpdm_tpu.train.draft import DraftTrainer as JDraftTrainer
from tpdm_tpu.train.draft import load_lora as jax_load_lora
from tpdm_tpu_torch.train.draft import (
    DraftConfig,
    DraftTrainer,
    lora_optimizer,
    trainable_lora,
    uniform_sigmas,
)
from tpdm_tpu_torch.utils.convert import lora_from_jax

# tests/test_draft.py:_draft_world's trainer
CFG = dict(total_updates=5, batch_size=2, learning_rate=5e-3, lora_rank=2, num_steps=3,
           k_backprop=1, logging_steps=1)


def _mean_reward(images, batch):
    return images.mean(dim=(1, 2, 3))


@pytest.fixture(scope="module")
def world():
    """One JAX DRaFT update from numpy latents on a noisy adapter (compiled
    once) and the port's world."""
    jagent, agent, rows = lora_world()
    jlora = noisy_jax_lora(jagent.mmdit_params, seed=3)
    jtrainer = JDraftTrainer(JDraftConfig(**CFG), jagent,
                             lambda imgs, batch: jnp.mean(imgs, axis=(1, 2, 3)), rows)
    arrays = jax_arrays(jtrainer.collate_fn(rows[:2]))
    latents = np.random.default_rng(4).standard_normal((2, 16, 8, 8)).astype(np.float32)
    new_lora, _, stats = jtrainer._update_jit(jlora, jtrainer.tx.init(jlora), latents, arrays)
    return dict(agent=agent, rows=rows, jlora=jlora, latents=latents, new_lora=new_lora,
                stats=stats, sigmas=np.asarray(jtrainer.sigmas))


def _trainer(world, **kw):
    return DraftTrainer(DraftConfig(**{**CFG, **kw}), world["agent"], _mean_reward,
                        world["rows"])


def test_sigma_ladder_is_jax_linspace(world):
    assert np.array_equal(uniform_sigmas(3).numpy(), world["sigmas"])
    assert np.array_equal(uniform_sigmas(28).numpy(),
                          np.asarray(jnp.linspace(1.0, 0.0, 29, dtype=jnp.float32)))


def test_update_matches_jax(world):
    """Loss, reward, gradient norm and the Adam-updated factors of one
    update (K = 1 of 3 steps differentiable) against JAX's."""
    trainer = _trainer(world)
    lora = trainable_lora(lora_from_jax(world["jlora"]))
    batch = trainer.collate_fn(world["rows"][:2])
    stats = trainer._update(lora, lora_optimizer(lora, trainer.config),
                            torch.from_numpy(world["latents"]), batch)
    ref = world["stats"]
    for k in ("loss", "reward", "grad_norm"):
        close(stats[k], np.asarray(ref[k]))
    assert stats["skipped"] == float(ref["skipped"]) == 0.0
    close_lora(lora, world["new_lora"])


def test_train_moves_only_the_adapter(world):
    """The port's loop: finite metrics, no update skipped, every b factor
    moved from zero by at most 1.5 x lr x updates, the base weights the same
    to the bit; the same seed gives the same factors (torch.Generator
    draws of the factors and the latents)."""
    agent = world["agent"]
    before = state_checksum(agent.mmdit)
    trainer = _trainer(world, total_updates=2)
    lora, optimizer = trainer.train()
    assert len(trainer.metrics_history) == 2 and optimizer.count == 2
    for m in trainer.metrics_history:
        assert np.isfinite(list(m.values())).all() and m["draft/num_skipped"] == 0.0
    moved = [f["b"].abs().max().item() for f in lora.values()]
    assert max(moved) > 0 and max(moved) <= 1.5 * CFG["learning_rate"] * 2
    assert all(torch.equal(a, b) for a, b in zip(before, state_checksum(agent.mmdit)))
    again, _ = _trainer(world, total_updates=2).train()
    assert all(torch.equal(lora[k][w], again[k][w]) for k in lora for w in ("a", "b"))


def test_full_chain_backprop(world):
    """K = T = 3: every step differentiable."""
    trainer = _trainer(world, k_backprop=3, num_steps=3, total_updates=1)
    trainer.train()
    assert np.isfinite(list(trainer.metrics_history[-1].values())).all()


def test_nan_guard_skips_the_update(world):
    """A non-finite reward: the update is skipped, the factors and Adam's
    state stay as they were."""
    trainer = DraftTrainer(DraftConfig(**CFG), world["agent"],
                           lambda imgs, batch: imgs.mean(dim=(1, 2, 3)) * float("nan"),
                           world["rows"])
    lora = trainable_lora(lora_from_jax(world["jlora"]))
    start = {k: {w: t.detach().clone() for w, t in f.items()} for k, f in lora.items()}
    opt = lora_optimizer(lora, trainer.config)
    stats = trainer._update(lora, opt, torch.from_numpy(world["latents"]),
                            trainer.collate_fn(world["rows"][:2]))
    assert stats["skipped"] == 1.0 and opt.count == 0 and not opt.adam.state
    assert all(torch.equal(lora[k][w], start[k][w]) for k in lora for w in ("a", "b"))


@pytest.mark.parametrize("k", [0, 4])
def test_k_backprop_outside_the_ladder_is_refused(world, k):
    with pytest.raises(ValueError, match="k_backprop"):
        _trainer(world, k_backprop=k)


def test_lora_files_rotate_and_load_in_jax(world, tmp_path):
    """save_steps 1, save_total_limit 2 over 3 updates keeps lora-2 and
    lora-3; JAX's ``load_lora`` reads them with the factors of the run."""
    trainer = _trainer(world, total_updates=3, save_steps=1, save_total_limit=2,
                       output_dir=str(tmp_path))
    lora, _ = trainer.train()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["lora-2.safetensors",
                                                         "lora-3.safetensors"]
    close_lora(lora, jax_load_lora(str(tmp_path / "lora-3.safetensors")), rtol=0, atol=0)


def test_image_reward_grad_fn_decodes_and_scores(world):
    """``build_image_reward_grad_fn`` on a toy VAE and ImageReward: the
    score of the decoded latents is ``build_image_reward_grad_apply``'s on
    ``make_fast_decode``'s images, and the gradient reaches the latents."""
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig, make_fast_decode
    from tpdm_tpu_torch.rewards import BertMedConfig, ImageRewardModel, ViTConfig
    from tpdm_tpu_torch.train.builders import build_image_reward_grad_fn
    from tpdm_tpu_torch.train.draft import build_image_reward_grad_apply

    g = torch.Generator().manual_seed(0)
    vae = VAE(VAEConfig.toy(latent_channels=16)).init_weights(g, 0.2).eval()
    model = ImageRewardModel.create(vit_config=ViTConfig.toy(),
                                    bert_config=BertMedConfig.toy(), device="cpu")
    tokenize = lambda texts, **kw: {"input_ids": np.array([[1, 5, 9, 2]] * len(texts)),
                                    "attention_mask": np.ones((len(texts), 4), np.int64)}
    fn = build_image_reward_grad_fn(vae, model, tokenize, device="cpu")
    z = torch.from_numpy(world["latents"]).requires_grad_()
    got = fn(z, {"prompt": ["a", "b"]})
    want = build_image_reward_grad_apply(model)(make_fast_decode(vae)(z),
                                                {"reward_ids": np.array([[1, 5, 9, 2]] * 2)})
    assert torch.equal(got, want)
    got.sum().backward()
    assert torch.isfinite(z.grad).all() and z.grad.abs().sum() > 0


def test_cli_draft_runs_one_update(tmp_path, monkeypatch):
    from tpdm_tpu_torch.train import main

    monkeypatch.chdir(__import__("pathlib").Path(__file__).resolve().parents[1])
    trainer = main.main([
        "--cpu", "--trainer", "draft", "--model_config", "configs/torch/models/toy_agent.yaml",
        "--reward_model_config", "configs/torch/models/toy_draft_reward.yaml",
        "--train_dataset", "configs/torch/datasets/jsonl_prompts.yaml",
        "--per_device_train_batch_size", "2", "--max_inference_steps", "3",
        "--draft_updates", "1", "--save_steps", "1", "--output_dir", str(tmp_path)])
    assert isinstance(trainer, DraftTrainer) and trainer.global_step == 1
    assert trainer.metrics_history[0]["draft/num_skipped"] == 0.0
    assert (tmp_path / "lora-1.safetensors").exists()
