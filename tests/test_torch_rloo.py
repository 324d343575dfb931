"""tpdm_tpu_torch's RLOO training against the JAX package's.

The RL math on the same arrays; ``replay_logprobs`` and its gradient; the
trainers' PPO micro-step on one rollout of the JAX toy agent, converted:
loss, gradient norm, stats, the gradient of every TPM parameter and the
Adam update (without and with gradient accumulation); then the port's own
toy trainer end to end (the Beta draws of the two packages differ, so
whole runs are compared by their invariants, as ``tests/test_rloo.py``
holds the JAX trainer).

JAX compiles the toy TPM's replay slowly on the CPU (its adaptive pool
unrolls 256 bins), so the module compiles it once: the rollout is drawn
with ``predict=True`` (the Beta mode) and the JAX trainer's step runs with
gradient accumulation, whose first micro-step leaves that step's gradient
in ``MultiStepsState.acc_grads``; the update without accumulation applies
JAX's own optax chain to it.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import close, random_variables, t
from tpdm_tpu.models import MMDiT as JMMDiT, MMDiTConfig as JMMDiTConfig
from tpdm_tpu.models import TimePredictor as JTimePredictor
from tpdm_tpu.ops.schedules import get_ref_beta as jax_get_ref_beta
from tpdm_tpu.pipeline.sampler import SamplerConfig as JSamplerConfig
from tpdm_tpu.pipeline.sampler import replay_logprobs as jax_replay_logprobs
from tpdm_tpu.train import RLOOConfig as JRLOOConfig
from tpdm_tpu.train import RLOOTrainer as JRLOOTrainer
from tpdm_tpu.train import TPDMAgent as JTPDMAgent
from tpdm_tpu.train import rloo as jrloo
from tpdm_tpu_torch.models.tpm import TimePredictor
from tpdm_tpu_torch.ops.schedules import get_ref_beta
from tpdm_tpu_torch.pipeline.sampler import SampleOutput, SamplerConfig, replay_logprobs
from tpdm_tpu_torch.train import RLOOConfig, RLOOTrainer, rloo
from tpdm_tpu_torch.train import checkpoint as ckpt
from tpdm_tpu_torch.train.builders import (
    build_toy_agent,
    build_toy_reward,
    make_prompt_encoder,
)
from tpdm_tpu_torch.utils.convert import tpm_from_jax

T_ROLL = 5
N_TXT = 5
LR = 1e-3
# the Adam update of every parameter within this share of lr of JAX's
ADAM_TOL = 1e-2


# ---------------------------------------------------------------------------
# RL math
# ---------------------------------------------------------------------------

def _math_inputs(seed=0, b=6, T=4):
    rng = np.random.default_rng(seed)
    sigmas = np.sort(rng.uniform(0.05, 0.9, (b, T)).astype(np.float32))[:, ::-1].copy()
    masks = np.zeros((b, T), bool)
    masks[1, 3] = masks[4, 2:] = True
    return dict(
        scores=rng.standard_normal(b).astype(np.float32),
        lvi=np.array([0, 3, 9, 2, 1, 5], np.int32)[:b],
        alphas=rng.uniform(1.5, 6.0, (b, T)).astype(np.float32),
        betas=rng.uniform(1.5, 6.0, (b, T)).astype(np.float32),
        sigmas=sigmas, masks=masks,
        new_lp=rng.normal(0, 0.3, (b, T)).astype(np.float32),
        old_lp=rng.normal(0, 0.3, (b, T)).astype(np.float32),
        adv=rng.standard_normal(b).astype(np.float32),
    )


@pytest.mark.parametrize("gamma", [0.9, 1.0])
def test_discounted_rewards_match_jax(gamma):
    x = _math_inputs()
    close(rloo.discounted_rewards(t(x["scores"]), t(x["lvi"]), gamma),
          jrloo.discounted_rewards(x["scores"], x["lvi"], gamma))


@pytest.mark.parametrize("relative", [True, False])
def test_kl_penalty_matches_jax(relative):
    x = _math_inputs(1)
    ours = rloo.compute_beta_kl_penalty(t(x["alphas"]), t(x["betas"]), t(x["sigmas"]),
                                        t(x["masks"]), relative)
    close(ours, jrloo.compute_beta_kl_penalty(x["alphas"], x["betas"], x["sigmas"],
                                              x["masks"], relative))
    assert (ours[t(x["masks"])] == 0).all()


def test_get_ref_beta_matches_jax():
    s = np.linspace(0.001, 1.0, 50, dtype=np.float32)
    for ours, ref in zip(get_ref_beta(t(s), 28), jax_get_ref_beta(s, 28)):
        close(ours, ref)


@pytest.mark.parametrize("estimator,k", [("rloo", 2), ("rloo", 3), ("grpo", 2), ("grpo", 3)])
def test_advantages_match_jax(estimator, k):
    r = np.random.default_rng(k).standard_normal(4 * k).astype(np.float32)
    close(rloo.compute_advantages(t(r), k, estimator), jrloo.compute_advantages(r, k, estimator))


def test_unknown_advantage_estimator_raises():
    with pytest.raises(ValueError, match="advantage_estimator"):
        rloo.compute_advantages(torch.zeros(4), 2, "ppo")


@pytest.mark.parametrize("scale", [0.01, 1.0])  # 1.0: ratios far enough from 1 to clip
def test_ppo_loss_and_stats_match_jax(scale):
    x = _math_inputs(2)
    new = x["old_lp"] + scale * x["new_lp"]
    loss, stats = rloo.ppo_loss(t(new), t(x["old_lp"]), t(x["adv"]), 0.2)
    jloss, jstats = jrloo.ppo_loss(new, x["old_lp"], x["adv"], 0.2)
    close(loss, jloss)
    assert stats.keys() == jstats.keys()
    for k in stats:
        close(stats[k], jstats[k])
    if scale == 1.0:
        assert 0 < float(stats["clipfrac"]) < 1


def test_repeat_and_subsets_match_jax():
    rng = np.random.default_rng(3)
    batch = {"prompt": ["a", "b"], "x": rng.standard_normal((2, 3)).astype(np.float32),
             "n": 7}
    ours = rloo.rloo_repeat({**batch, "x": t(batch["x"])}, 3)
    ref = jrloo.rloo_repeat(batch, 3)
    assert ours["prompt"] == ref["prompt"] and ours["n"] == 7
    close(ours["x"], ref["x"])
    inds = np.array([4, 1])
    sub = rloo.subset_inputs(ours, inds)
    assert sub["prompt"] == jrloo.subset_inputs(ref, inds)["prompt"]
    close(sub["x"], jrloo.subset_inputs(ref, inds)["x"])
    T, b = 3, 6
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)
    fields = dict(init_noise_latents=arr(b, 2, 2, 2), final_latents=arr(b, 2, 2, 2),
                  sigmas=arr(b, T), logprobs=arr(b, T), prob_masks=arr(b, T) > 0,
                  alphas=arr(b, T), betas=arr(b, T), num_steps=2,
                  last_valid_index=np.arange(b, dtype=np.int32), h_cache=arr(T, b, 4, 2, 2),
                  temb_cache=arr(T, b, 3), history_latents=None)
    from tpdm_tpu.pipeline.sampler import SampleOutput as JSampleOutput

    jsub = jrloo.subset_outputs(JSampleOutput(**fields), inds)
    tsub = rloo.subset_outputs(SampleOutput(**{
        k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in fields.items()}), inds)
    for name in SampleOutput._fields:
        a, r = getattr(tsub, name), getattr(jsub, name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))
        else:
            assert a == r


@pytest.mark.parametrize("kind", ["constant", "constant_with_warmup", "linear", "cosine"])
def test_lr_schedules_match_optax(kind):
    kw = dict(learning_rate=1e-3, lr_scheduler_type=kind, warmup_steps=3, num_ppo_epochs=2,
              num_mini_batches=2)
    ours = rloo._make_lr_schedule(RLOOConfig(**kw), 7)
    ref = jrloo._make_lr_schedule(JRLOOConfig(**kw), 7)
    np.testing.assert_allclose([ours(c) for c in range(40)], [float(ref(c)) for c in range(40)],
                               rtol=1e-6, atol=1e-12)


def test_derive_batch_sizes_match_jax():
    kw = dict(per_device_train_batch_size=2, gradient_accumulation_steps=2, rloo_k=2,
              num_mini_batches=1, total_episodes=8)
    assert RLOOConfig(**kw).derive_batch_sizes(32) == JRLOOConfig(**kw).derive_batch_sizes(32)


# ---------------------------------------------------------------------------
# replay_logprobs and its gradient, on a linear policy head
# ---------------------------------------------------------------------------

def _jax_head(h, temb, w, bias, mode_conc):
    z = jnp.concatenate([h.mean(axis=(2, 3)), temb], axis=1) @ w + bias
    if mode_conc:  # a mode in (0, 1) and a concentration above 2
        return jnp.stack([jax.nn.sigmoid(z[:, 0]), jnp.exp(z[:, 1]) + 2.0], axis=1)
    return jnp.exp(z) + 1.0


def _torch_head(h, temb, w, bias, mode_conc):
    z = torch.cat([h.mean(dim=(2, 3)), temb], dim=1) @ w + bias
    if mode_conc:
        return torch.stack([torch.sigmoid(z[:, 0]), torch.exp(z[:, 1]) + 2.0], dim=1)
    return torch.exp(z) + 1.0


@pytest.mark.parametrize("cfg_kw,init_sigma", [
    (dict(), None),
    (dict(relative=False, prediction_type="mode_concentration"), None),
    (dict(), [1.0, 0.6, 0.3]),
])
def test_replay_logprobs_and_grad_match_jax(cfg_kw, init_sigma):
    """Sample 1 is done after its third step and samples 0 and 2 have
    trailing unexecuted steps (sigma == 0): the masked branch must not put
    a NaN into the gradient."""
    rng = np.random.default_rng(4)
    T, b, c, d = 6, 3, 5, 4
    h = rng.standard_normal((T, b, c, 3, 3)).astype(np.float32)
    temb = rng.standard_normal((T, b, d)).astype(np.float32)
    sig = np.array([[0.5, 0.2, 0.05, 0.0, 0.0, 0.0],
                    [0.6, 0.3, 0.005, 0.002, 0.001, 0.0005],
                    [0.7, 0.004, 0.0, 0.0, 0.0, 0.0]], np.float32)
    if init_sigma is not None:
        sig = sig * np.array(init_sigma, np.float32)[:, None]
    w = 0.3 * rng.standard_normal((c + d, 2)).astype(np.float32)
    bias = np.array([0.5, 1.0], np.float32)
    mode_conc = cfg_kw.get("prediction_type") == "mode_concentration"
    weights = rng.standard_normal((b, T)).astype(np.float32)
    jcfg = JSamplerConfig(max_inference_steps=T, min_sigma=0.01, **cfg_kw)
    s0 = None if init_sigma is None else np.array(init_sigma, np.float32)

    def jloss(params):
        lp = jax_replay_logprobs(lambda a, e: _jax_head(a, e, *params, mode_conc), h, temb, sig,
                                 jcfg, init_sigma=s0)
        return jnp.sum(weights * lp), lp

    (_, jlp), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        (jnp.asarray(w), jnp.asarray(bias)))
    tw, tb = t(w).requires_grad_(), t(bias).requires_grad_()
    lp = replay_logprobs(lambda a, e: _torch_head(a, e, tw, tb, mode_conc), t(h), t(temb), t(sig),
                         SamplerConfig(max_inference_steps=T, min_sigma=0.01, **cfg_kw),
                         init_sigma=None if s0 is None else t(s0))
    close(lp.detach(), jlp)
    assert (lp.detach().numpy()[np.asarray(jlp) == 1.0] == 1.0).all()
    gw, gb = torch.autograd.grad((t(weights) * lp).sum(), (tw, tb))
    assert torch.isfinite(gw).all() and torch.isfinite(gb).all()
    close(gw, jgrad[0])
    close(gb, jgrad[1])


# ---------------------------------------------------------------------------
# The trainers' PPO micro-step on one JAX rollout
# ---------------------------------------------------------------------------

def _jax_config(gas):
    return JRLOOConfig(per_device_train_batch_size=2, gradient_accumulation_steps=gas, rloo_k=2,
                       max_inference_steps=T_ROLL, total_episodes=8, kl_coef=0.01,
                       learning_rate=LR, guidance_scale=7.0, init_alpha=0.5, init_beta=2.0)


def _torch_config(gas):
    return RLOOConfig(**{f.name: getattr(_jax_config(gas), f.name)
                         for f in dataclasses.fields(RLOOConfig)})


@pytest.fixture(scope="module")
def jax_rollout():
    """The JAX toy agent's rollout of 2 prompts x 2 (the mode policy, so
    every sample stops after a few of its T_ROLL steps), the JAX
    trainer's two micro-steps on it with gradient accumulation 2, and the
    port's copies of the TPM and the rollout."""
    cfg_m = JMMDiTConfig.toy()
    model = JMMDiT(cfg_m)
    # parameters drawn, not initialised: the inits' compiles would take
    # seconds each
    mparams = random_variables(
        model.init, 1,
        jnp.ones((2, cfg_m.in_channels, cfg_m.sample_size, cfg_m.sample_size)),
        jnp.ones((2,)), jnp.ones((2, N_TXT, cfg_m.joint_attention_dim)),
        jnp.ones((2, cfg_m.pooled_projection_dim)))
    jcfg = _jax_config(2)
    tpm_kw = dict(conv_out_channels=4, in_channels=2 * cfg_m.inner_dim, temb_dim=cfg_m.inner_dim,
                  init_alpha=jcfg.init_alpha, init_beta=jcfg.init_beta)
    agent = JTPDMAgent(model, mparams, jcfg, tpm=JTimePredictor(**tpm_kw))
    rng = np.random.default_rng(5)
    dataset = [{
        "prompt_embeds": rng.normal(size=(N_TXT, cfg_m.joint_attention_dim)).astype(np.float32),
        "pooled_prompt_embeds": rng.normal(size=(cfg_m.pooled_projection_dim,)).astype(np.float32),
        "negative_prompt_embeds": np.zeros((N_TXT, cfg_m.joint_attention_dim), np.float32),
        "negative_pooled_prompt_embeds": np.zeros((cfg_m.pooled_projection_dim,), np.float32),
    } for _ in range(4)]
    trainer = JRLOOTrainer(jcfg, agent, lambda p, o: None, dataset)
    # the TPM's kernels N(0, 0.02²) and its head's bias as its own init
    # draws and sets them: the initial policy
    p0 = random_variables(agent.init_tpm_params, 7, kernel_std=0.02)
    p0["params"]["fc2"]["bias"] = np.array([jcfg.init_alpha, jcfg.init_beta], np.float32)
    data = jrloo.rloo_repeat(jrloo._default_collate(dataset[:2]), 2)
    out = agent.sample(p0, data, jax.random.PRNGKey(3), predict=True)
    adv = np.array([0.7, -0.4, 1.1, -0.9], np.float32)
    opt0 = jax.jit(trainer.tx.init)(p0)
    p1, opt1, st1 = trainer._train_step(p0, opt0, jrloo.subset_outputs(out, np.array([0, 1])),
                                        jnp.asarray(adv[:2]), None)
    p2, _, st2 = trainer._train_step(p1, opt1, jrloo.subset_outputs(out, np.array([2, 3])),
                                     jnp.asarray(adv[2:]), None)
    g1 = opt1.acc_grads  # the first micro-step's (finite) gradient
    # without accumulation the JAX step applies its optax chain to g1 at once
    tx1 = JRLOOTrainer(_jax_config(1), agent, lambda p, o: None, dataset).tx
    p1_gas1 = jax.jit(lambda g, p: optax.apply_updates(p, tx1.update(g, tx1.init(p), p)[0]))(
        g1, p0)

    tpm = TimePredictor(**tpm_kw)
    tpm.load_state_dict(tpm_from_jax(jax.device_get(p0)))
    outputs = SampleOutput(**{name: (value if value is None or name == "num_steps" else t(value))
                              for name, value in out._asdict().items()})
    outputs = outputs._replace(num_steps=int(out.num_steps))
    sd = lambda tree: tpm_from_jax(jax.device_get(tree))
    return dict(tpm=tpm, out=outputs, adv=adv, jout=out, st=(st1, st2), grad=sd(g1),
                p0=sd(p0), p2=sd(p2), p1_gas1=sd(p1_gas1))


def _port_trainer(gas):
    cfg = _torch_config(gas)
    agent = build_toy_agent(cfg, device="cpu")
    return RLOOTrainer(cfg, agent, build_toy_reward(), [{"prompt": f"p{i}"} for i in range(4)])


def _fresh_tpm(world):
    tpm = TimePredictor(conv_out_channels=4, in_channels=world["tpm"].conv1.in_channels,
                        temb_dim=world["tpm"].norm1.linear.in_features)
    tpm.load_state_dict(world["tpm"].state_dict())
    return tpm


def _close_update(tpm, ref):
    for name, p in tpm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=0, atol=ADAM_TOL * LR,
                                   err_msg=name)


def test_rollout_has_trailing_masked_steps(jax_rollout):
    out = jax_rollout["out"]
    assert 1 <= out.num_steps < T_ROLL
    assert out.prob_masks[:, -1].all() and (out.sigmas[:, -1] == 0).all()


def test_replay_of_the_rollout_matches_its_logprobs(jax_rollout):
    """Epoch 0: the port's replay of the JAX rollout with the rollout's TPM
    gives the rollout's log-probs."""
    out, tpm = jax_rollout["out"], jax_rollout["tpm"]
    with torch.no_grad():
        lp = replay_logprobs(tpm, out.h_cache, out.temb_cache, out.sigmas,
                             SamplerConfig(max_inference_steps=T_ROLL, min_sigma=0.01))
    close(lp, jax_rollout["jout"].logprobs)


def test_micro_step_matches_jax(jax_rollout):
    """The first micro-step with accumulation 2: the same loss, gradient norm
    and stats, the gradient of every TPM parameter (through the replay, with
    its trailing masked steps) within the fp32 bound, and no update yet."""
    trainer = _port_trainer(2)
    tpm = _fresh_tpm(jax_rollout)
    opt = trainer.make_optimizer(tpm)
    out, adv = jax_rollout["out"], jax_rollout["adv"]
    st = trainer._train_step_impl(tpm, opt, rloo.subset_outputs(out, [0, 1]), t(adv[:2]))
    ref = jax_rollout["st"][0]
    assert st.keys() == ref.keys()
    for k in st:
        close(np.float32(st[k]), ref[k])
    assert st["skipped"] == 0.0 and st["grad_norm"] > 0
    names = [n for n, _ in tpm.named_parameters()]
    for name, g in zip(names, opt.acc):
        assert torch.isfinite(g).all(), name
        close(g, jax_rollout["grad"][name])
    for name, p in tpm.state_dict().items():  # before the boundary nothing moves
        np.testing.assert_array_equal(p.numpy(), jax_rollout["p0"][name].numpy())
    assert opt.count == 0 and opt.mini_step == 1


def test_adam_update_matches_jax(jax_rollout):
    trainer = _port_trainer(1)
    tpm = _fresh_tpm(jax_rollout)
    opt = trainer.make_optimizer(tpm)
    out, adv = jax_rollout["out"], jax_rollout["adv"]
    trainer._train_step_impl(tpm, opt, rloo.subset_outputs(out, [0, 1]), t(adv[:2]))
    assert opt.count == 1
    _close_update(tpm, jax_rollout["p1_gas1"])
    moved = max((tpm.state_dict()[n] - p).abs().max().item()
                for n, p in jax_rollout["p0"].items())
    assert LR / 2 < moved <= 1.5 * LR


def test_adam_update_with_accumulation_matches_jax(jax_rollout):
    trainer = _port_trainer(2)
    tpm = _fresh_tpm(jax_rollout)
    opt = trainer.make_optimizer(tpm)
    out, adv = jax_rollout["out"], jax_rollout["adv"]
    for inds in ([0, 1], [2, 3]):
        st = trainer._train_step_impl(tpm, opt, rloo.subset_outputs(out, inds), t(adv[inds]))
    for k in st:
        close(np.float32(st[k]), jax_rollout["st"][1][k])
    assert opt.count == 1 and opt.mini_step == 0
    _close_update(tpm, jax_rollout["p2"])


# ---------------------------------------------------------------------------
# The port's toy trainer end to end
# ---------------------------------------------------------------------------

def _toy(reward="latent", replay_mode="cached", **kw):
    """The port's counterpart of tests/test_rloo.py's toy world: 2 prompts
    x rloo_k 2 a micro-batch, 3 steps, 3 updates."""
    cfg = RLOOConfig(**{**dict(per_device_train_batch_size=4, rloo_k=2, max_inference_steps=3,
                               total_episodes=12, kl_coef=0.01, learning_rate=LR,
                               guidance_scale=7.0), **kw})
    agent = build_toy_agent(cfg, device="cpu")
    if replay_mode == "recompute":
        agent = rloo.TPDMAgent(agent.mmdit, cfg, tpm=agent.tpm_factory, replay_mode=replay_mode)
    if reward == "nan":
        reward_fn = lambda prompts, outputs: (torch.full((4,), float("nan")),) * 2
    else:
        reward_fn = build_toy_reward()
    rows = [{"prompt": f"The image shows prompt {i}"} for i in range(4)]
    return cfg, agent, reward_fn, rows, make_prompt_encoder(agent, n_txt=N_TXT)


def _train(reward="latent", replay_mode="cached", **kw):
    cfg, agent, reward_fn, rows, collate = _toy(reward, replay_mode, **kw)
    trainer = RLOOTrainer(cfg, agent, reward_fn, rows, collate_fn=collate)
    tpm0 = agent.init_tpm_params(torch.Generator().manual_seed(7))
    p0 = {k: v.clone() for k, v in tpm0.state_dict().items()}
    tpm, opt = trainer.train(tpm=tpm0)
    moved = max((tpm.state_dict()[k] - v).abs().max().item() for k, v in p0.items())
    return trainer, tpm, opt, moved


@pytest.mark.parametrize("replay_mode", ["cached", "recompute"])
def test_three_updates_train(replay_mode):
    trainer, tpm, opt, moved = _train(replay_mode=replay_mode)
    assert len(trainer.metrics_history) == 3
    for m in trainer.metrics_history:
        for k, v in m.items():
            assert np.isfinite(v), (k, v)
        assert m["val/num_skipped"] == 0.0
    # epoch 0 replays the rollout's own policy: the ratio starts at one
    assert abs(trainer.metrics_history[0]["val/ratio"] - 1.0) < 1e-2
    assert 0 < moved <= 1.5 * LR * 3 and opt.count == 3
    assert trainer.episode == 12


def test_nan_reward_skips_the_update():
    trainer, tpm, opt, moved = _train(reward="nan")
    assert trainer.metrics_history[-1]["val/num_skipped"] == 1.0
    assert trainer.metrics_history[-1]["policy/skip_rate"] == 1.0
    assert moved == 0.0
    assert opt.count == 0 and opt.mini_step == 0 and not opt.adam.state


def test_recompute_replay_equals_cached_replay():
    cfg, agent, _, rows, collate = _toy()
    rec = rloo.TPDMAgent(agent.mmdit, cfg, tpm=agent.tpm_factory, replay_mode="recompute")
    tpm = agent.init_tpm_params(torch.Generator().manual_seed(3))
    batch = rloo.rloo_repeat(collate(rows[:2]), 2)
    out_c = agent.sample(tpm, batch, torch.Generator().manual_seed(4))
    out_r = rec.sample(tpm, batch, torch.Generator().manual_seed(4))
    close(out_r.sigmas, out_c.sigmas.numpy())
    assert out_r.h_cache is None and out_c.history_latents is None
    lp_c = agent.logprobs(tpm, out_c)
    lp_r = rec.logprobs(tpm, out_r, inputs=batch)
    close(lp_r, lp_c.numpy())
    close(lp_r, out_r.logprobs.numpy())  # and the rollout's own


def test_grpo_trains():
    trainer, _, _, moved = _train(advantage_estimator="grpo")
    assert all(np.isfinite(v) for v in trainer.metrics_history[-1].values())
    assert moved > 0


def test_gradient_accumulation_steps_at_the_boundary_only():
    trainer, _, opt, moved = _train(per_device_train_batch_size=2,
                                    gradient_accumulation_steps=2)
    assert opt.count == 3 and opt.mini_step == 0 and moved > 0
    assert len(trainer.metrics_history) == 3


def test_ema_step():
    cfg, agent, reward_fn, rows, collate = _toy(ema_decay=0.75)
    trainer = RLOOTrainer(cfg, agent, reward_fn, rows, collate_fn=collate)
    tpm = agent.init_tpm_params(torch.Generator().manual_seed(0))
    trainer.ema_params = {k: torch.full_like(v, 2.0) for k, v in tpm.state_dict().items()}
    trainer._ema_update(tpm)
    for k, v in tpm.state_dict().items():
        torch.testing.assert_close(trainer.ema_params[k], 0.75 * 2.0 + 0.25 * v)


def test_checkpoint_resume_state_equals_saved(tmp_path):
    cfg_kw = dict(save_steps=3, ema_decay=0.5, output_dir=str(tmp_path))
    trainer, tpm, opt, _ = _train(**cfg_kw)
    path = ckpt.latest_checkpoint(str(tmp_path))
    assert path.endswith("checkpoint-3")
    state = ckpt.restore_checkpoint(path)
    assert state["update"] == 3 and state["episode"] == 12
    for k, v in tpm.state_dict().items():
        torch.testing.assert_close(state["tpm"][k], v, rtol=0, atol=0)
        torch.testing.assert_close(state["ema"][k], trainer.ema_params[k], rtol=0, atol=0)
    saved, live = state["optimizer"], opt.state_dict()
    assert saved["count"] == live["count"] == 3 and saved["mini_step"] == live["mini_step"]
    for i, s in live["adam"]["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(saved["adam"]["state"][i][k], v, rtol=0, atol=0)
    rows = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[-1])
    assert rows["update"] == 3
    # resuming a 4-update run runs update 4 alone, from the saved state
    cfg, agent, reward_fn, data, collate = _toy(total_episodes=16, **cfg_kw)
    resumed = RLOOTrainer(cfg, agent, reward_fn, data, collate_fn=collate)
    tpm2, opt2 = resumed.train(resume_from_checkpoint=True)
    assert len(resumed.metrics_history) == 1 and resumed.episode == 16
    assert opt2.count == 4 and resumed.global_step == 4
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("checkpoint-4")


def test_save_total_limit_rotation(tmp_path):
    (tmp_path / "tmp-checkpoint-9").mkdir()  # debris of a save that was cut
    trainer, *_ = _train(save_steps=1, save_total_limit=2, output_dir=str(tmp_path))
    names = sorted(p.name for p in tmp_path.iterdir() if "checkpoint" in p.name)
    assert names == ["checkpoint-2", "checkpoint-3"]
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["update"] for r in rows] == [1, 2, 3]
    assert all("policy/steps_avg" in r and "val/ratio" in r for r in rows)


def test_options_not_ported_raise():
    cfg, agent, reward_fn, rows, collate = _toy()
    for kw, err in ((dict(offload_cache="host"), NotImplementedError),
                    (dict(offload_cache="xla"), ValueError),
                    (dict(world_size=2), NotImplementedError),
                    (dict(report_to="tensorboard"), NotImplementedError)):
        with pytest.raises(err, match="ROADMAP|CUDA counterpart"):
            RLOOTrainer(dataclasses.replace(cfg, **kw), agent, reward_fn, rows)
    with pytest.raises(ValueError, match="'euler' or 'ab2'"):
        rloo.TPDMAgent(agent.mmdit, dataclasses.replace(cfg, solver="heun"))


def test_tpm_bf16_compute_on_fp32_weights_equals_bf16_weights():
    """The compute dtype: fp32 parameters computing in bf16 give the bf16
    module's output bit for bit (serving does not change), and an Adam step
    at lr 1e-6 moves the fp32 parameters where bf16 ones would round it
    away."""
    kw = dict(conv_out_channels=4, in_channels=8, temb_dim=6)
    ref = TimePredictor(**kw).init_weights(torch.Generator().manual_seed(0))
    mixed = TimePredictor(**kw, dtype=torch.bfloat16)
    mixed.load_state_dict(ref.state_dict())
    low = TimePredictor(**kw, dtype=torch.bfloat16).to(torch.bfloat16)
    low.load_state_dict(ref.state_dict())
    rng = np.random.default_rng(0)
    x = t(rng.standard_normal((2, 8, 8, 8)).astype(np.float32)).to(torch.bfloat16)
    temb = t(rng.standard_normal((2, 6)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        torch.testing.assert_close(mixed(x, temb), low(x, temb), rtol=0, atol=0)
    bias = mixed.fc2.bias
    step = torch.tensor([1e-6, 1e-6])
    assert (bias.detach() + step != bias.detach()).all()
    assert (bias.detach().bfloat16() + step.bfloat16() == bias.detach().bfloat16()).all()
