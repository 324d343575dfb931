"""The port's trainer must LEARN, not just run: the torch counterparts of
``tests/test_learning.py``'s directional tests, on the CPU.

With a constant positive score and gamma < 1 the step discount favours
shorter schedules, so a working rollout -> discount -> leave-one-out
advantage -> TPM-only replay -> clipped PG -> Adam loop must drive
``policy/steps_avg`` down and ``objective/rlhf_reward`` up. The world is
``test_learning.py``'s ``_build_world`` (toy MMDiT, a 4-channel TPM at
init (2.5, 0.7), rloo_k 4, 6 steps, min_sigma 0.3, lr 3e-3, gamma 0.7) on
the port's toy agent, with the JAX test's thresholds. The mesh-sharded case
waits for data parallelism (ROADMAP queue 1, item 9(d)).
"""

import numpy as np
import torch

import _torch_parity  # noqa: F401 (one torch thread a test process)

from tpdm_tpu_torch.train import RLOOConfig, RLOOTrainer
from tpdm_tpu_torch.train.builders import build_toy_agent


def _build_world(num_updates: int, seed: int = 0, solver: str = "euler", **kw):
    rloo_k, n_txt = 4, 5
    config = RLOOConfig(
        seed=seed, per_device_train_batch_size=rloo_k, rloo_k=rloo_k, num_ppo_epochs=2,
        max_inference_steps=6, min_sigma=0.3, total_episodes=rloo_k * num_updates,
        learning_rate=3e-3, gamma=0.7, kl_coef=0.0,
        init_alpha=2.5,  # Beta mode ~0.86 -> the untrained policy always
        init_beta=0.7,  # uses all 6 steps (sigma_6 ~ 0.40 > min_sigma)
        guidance_scale=7.0, logging_steps=1, solver=solver, **kw)
    agent = build_toy_agent(config, seed=1, device="cpu")
    mcfg = agent.mmdit.config
    rng = np.random.default_rng(seed)
    dataset = [{
        "prompt": f"toy prompt {i}",
        "prompt_embeds": rng.normal(size=(n_txt, mcfg.joint_attention_dim)).astype(np.float32),
        "pooled_prompt_embeds": rng.normal(size=(mcfg.pooled_projection_dim,)).astype(np.float32),
        "negative_prompt_embeds": np.zeros((n_txt, mcfg.joint_attention_dim), np.float32),
        "negative_pooled_prompt_embeds": np.zeros((mcfg.pooled_projection_dim,), np.float32),
    } for i in range(4)]

    def reward_fn(prompts, outputs):
        ones = torch.ones(outputs.sigmas.shape[0])
        return ones, ones

    return RLOOTrainer(config, agent, reward_fn, dataset)


def _window(hist, key, lo, hi):
    return float(np.mean([m[key] for m in hist[lo:hi]]))


def test_rloo_reduces_steps_and_raises_reward():
    trainer = _build_world(num_updates=24)
    trainer.train()
    hist = trainer.metrics_history
    assert len(hist) == 24
    steps_first = _window(hist, "policy/steps_avg", 0, 6)
    steps_last = _window(hist, "policy/steps_avg", -6, None)
    reward_first = _window(hist, "objective/rlhf_reward", 0, 6)
    reward_last = _window(hist, "objective/rlhf_reward", -6, None)
    assert steps_first > 4.5, steps_first
    assert steps_last < steps_first - 1.0, (steps_first, steps_last)
    assert reward_last > reward_first + 0.05, (reward_first, reward_last)
    assert all(m["val/num_skipped"] == 0.0 for m in hist)
    assert all(0.2 < m["val/ratio"] < 5.0 for m in hist)


def test_rloo_learns_under_ab2_integrator():
    trainer = _build_world(num_updates=16, solver="ab2")
    assert trainer.agent.sampler_cfg.solver == "ab2"
    trainer.train()
    hist = trainer.metrics_history
    steps_first = _window(hist, "policy/steps_avg", 0, 5)
    steps_last = _window(hist, "policy/steps_avg", -5, None)
    assert steps_first > 4.5, steps_first
    assert steps_last < steps_first - 0.8, (steps_first, steps_last)
    assert all(m["val/num_skipped"] == 0.0 for m in hist)


def test_host_offload_learns_identically(monkeypatch):
    """offload_cache="host": the same run, its caches sliced from host
    copies (moved back to the rollout's device a micro-batch at a time),
    gives the "none" run's metrics exactly."""
    from tpdm_tpu_torch.train import rloo

    moved = []
    offload = rloo.offload_outputs_to_host

    def counted(outputs):
        out = offload(outputs)
        moved.append(out.h_cache is not None and out.h_cache.device.type == "cpu")
        return out

    monkeypatch.setattr(rloo, "offload_outputs_to_host", counted)
    runs = {}
    for mode in ("none", "host"):
        trainer = _build_world(num_updates=6, offload_cache=mode)
        trainer.train()
        runs[mode] = trainer.metrics_history
    assert moved == [True] * 6
    strip = lambda hist: [{k: v for k, v in m.items() if k != "eps"} for m in hist]
    assert strip(runs["host"]) == strip(runs["none"])


def test_host_slices_copy_block_by_block():
    """The micro-batch slice of a host cache, copied one (step, sample)
    block at a time, equals the gathered slice."""
    from tpdm_tpu_torch.train import rloo

    v = torch.randn(5, 4, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    for inds in ([2, 0], [3], [0, 1, 2, 3]):
        got = rloo._host_rows_to(v, np.array(inds), torch.device("cpu"))
        assert torch.equal(got, v[:, inds])
