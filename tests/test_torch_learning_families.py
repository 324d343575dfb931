"""The port's trainer must learn over every family's agent, not just the
SD3 one's: the torch counterparts of ``tests/test_learning_families.py``
(SD1.5, SDXL, FLUX) and ``tests/test_ensemble_training.py::
test_ensemble_learns_fewer_total_steps`` (the SDXL base + refiner
ensemble), on the CPU, without JAX.

A constant positive score with gamma < 1 makes the step discount favour
shorter schedules, so rollout -> discount -> leave-one-out advantage ->
TPM-only replay -> clipped PG -> Adam must drive ``policy/steps_avg`` down
and ``objective/rlhf_reward`` up. Each world is the JAX test's: its toy
backbone (weights drawn by the port's ``init_weights``), a 4-channel TPM
at its head bias, rloo_k 4, 2 PPO epochs, lr 3e-3, gamma 0.7, CFG off, 16
updates, and its thresholds.
"""

import numpy as np
import pytest
import torch

from tpdm_tpu_torch.models.flux import Flux, FluxConfig
from tpdm_tpu_torch.models.tpm import TimePredictor
from tpdm_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from tpdm_tpu_torch.train import (
    FluxAgent,
    RLOOConfig,
    RLOOTrainer,
    SD15Agent,
    SDXLAgent,
    SDXLEnsembleAgent,
    SDXLRefinerAgent,
)

# one intra-op thread a test process, as tests/_torch_parity.py sets it
# (that module imports JAX, which this file does not)
torch.set_num_threads(1)

N_TXT, NUM_UPDATES, RLOO_K = 5, 16, 4


def _config(**kw):
    return RLOOConfig(**{**dict(
        seed=0, per_device_train_batch_size=RLOO_K, rloo_k=RLOO_K, num_ppo_epochs=2,
        max_inference_steps=6, total_episodes=RLOO_K * NUM_UPDATES, learning_rate=3e-3,
        gamma=0.7, kl_coef=0.0, guidance_scale=None, logging_steps=1), **kw})


def _const_reward(prompts, outputs):
    ones = torch.ones(outputs.final_latents.shape[0])
    return ones, ones


def _tpm(config, in_channels, temb_dim):
    return lambda: TimePredictor(conv_out_channels=4, in_channels=in_channels,
                                 temb_dim=temb_dim, init_alpha=config.init_alpha,
                                 init_beta=config.init_beta)


def _unet(cfg, seed):
    return UNetSD15(cfg).init_weights(torch.Generator().manual_seed(seed)).eval()


def _unet_agent(cls, cfg, config, seed, **kw):
    ch = cfg.block_out_channels[0]
    return cls(_unet(cfg, seed), config, tpm=_tpm(config, 2 * ch, ch), guidance_scale=1.0, **kw)


def _rows(widths, seed=0):
    """Four rows of N(0, 1) embeds, ``widths`` name -> the row's shape."""
    rng = np.random.default_rng(seed)
    return [{"prompt": f"p{i}", **{k: rng.normal(size=shape).astype(np.float32)
                                   for k, shape in widths.items()}} for i in range(4)]


def _unet_widths(cfg, prefix=""):
    widths = {f"{prefix}prompt_embeds": (N_TXT, cfg.cross_attention_dim)}
    if cfg.addition_embed:
        widths[f"{prefix}pooled_prompt_embeds"] = (cfg.addition_pooled_dim,)
    return widths


def _integer_t_world(family):
    # init ratio mean 2/3: the mean path crosses min_time 150 at step ~5 of
    # 6, which leaves downward headroom and sampling variance
    config = _config(init_alpha=2.0, init_beta=1.0)
    cls, cfg = (SD15Agent, UNetConfig.toy()) if family == "sd15" else (SDXLAgent,
                                                                      UNetConfig.toy_xl())
    agent = _unet_agent(cls, cfg, config, 1, min_time=150)
    return RLOOTrainer(config, agent, _const_reward, _rows(_unet_widths(cfg)))


def _flux_world():
    fcfg = FluxConfig.toy()
    # sigma_6 of the mode path stays above min_sigma, so the untrained
    # policy runs about all 6 steps
    config = _config(min_sigma=0.3, init_alpha=2.5, init_beta=0.7)
    flux = Flux(fcfg).init_weights(torch.Generator().manual_seed(1)).eval()
    agent = FluxAgent(flux, config, tpm=_tpm(config, 2 * fcfg.hidden_size, fcfg.hidden_size),
                      latent_size=8, latent_channels=4)
    return RLOOTrainer(config, agent, _const_reward,
                       _rows({"prompt_embeds": (N_TXT, fcfg.txt_dim),
                              "pooled_prompt_embeds": (fcfg.vec_dim,)}))


def _ensemble_world():
    config = _config(max_inference_steps=4, init_alpha=2.0, init_beta=1.0)
    xcfg, rcfg = UNetConfig.toy_xl(), UNetConfig.toy_refiner()
    base = _unet_agent(SDXLAgent, xcfg, config, 1)
    refiner = _unet_agent(SDXLRefinerAgent, rcfg, config, 2, min_time=150)
    agent = SDXLEnsembleAgent(base, refiner, denoising_end=0.5)
    return RLOOTrainer(config, agent, _const_reward,
                       _rows({**_unet_widths(xcfg), **_unet_widths(rcfg, "refiner_")}))


def _assert_learns(trainer, min_drop):
    trainer.train()
    hist = trainer.metrics_history
    assert len(hist) == NUM_UPDATES

    def window(key, lo, hi):
        return float(np.mean([m[key] for m in hist[lo:hi]]))

    steps_first = window("policy/steps_avg", 0, 4)
    steps_last = window("policy/steps_avg", -4, None)
    reward_first = window("objective/rlhf_reward", 0, 4)
    reward_last = window("objective/rlhf_reward", -4, None)
    assert steps_last < steps_first - min_drop, (steps_first, steps_last)
    assert reward_last > reward_first + 0.02, (reward_first, reward_last)
    assert all(m["val/num_skipped"] == 0.0 for m in hist)


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_integer_t_families_learn_fewer_steps(family):
    _assert_learns(_integer_t_world(family), 1.0)


def test_flux_learns_fewer_steps():
    _assert_learns(_flux_world(), 1.0)


def test_ensemble_learns_fewer_total_steps():
    """The total (base + refiner) NFE falls: the joint objective that the
    single-expert families cannot express."""
    trainer = _ensemble_world()
    _assert_learns(trainer, 1.0)
    assert all(m["objective/kl"] == 0.0 for m in trainer.metrics_history)
