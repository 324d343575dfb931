"""The adaptive loop's new options in tpdm_tpu_torch against the JAX
package: AB2, the Δ-cache (``cache_interval`` and ``cache_tau``), the
guidance window (crossed mid-run), the cache × window composition with its
promote branch, and ``generate(return_full_process_images=True)``, on the
same toy weights and seeded inputs; plus the loop's one host read a step,
``generate``'s validation, and the port's toy trainer: its AB2 rollout and
the callbacks that ``train`` closes. The sampler-level cases run a small
closed-form TPM (the same formula on both sides), so each JAX loop
compiles in about a second; ``generate`` runs the toy TPM. fp32 bound:
rtol 1e-4 / atol 1e-5 scaled by the output's magnitude
(``_torch_parity.close``); images within one uint8 level on fewer than
1 % of pixels."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, drawn_models, t
from tpdm_tpu.pipeline import denoise as jd
from tpdm_tpu.pipeline import sampler as js
from tpdm_tpu.pipeline.pipeline import TPDMPipeline as JTPDMPipeline
from tpdm_tpu_torch.pipeline import denoise as td
from tpdm_tpu_torch.pipeline import sampler as ts
from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline
from tpdm_tpu_torch.train import RLOOConfig, RLOOTrainer, rloo
from tpdm_tpu_torch.train.builders import build_toy_agent, build_toy_reward, make_prompt_encoder

B, N_CTX, GS, T, MIN_SIGMA = 2, 6, 7.0, 6, 0.25
# the closed-form TPM's mode ratio is ~2/3, so sigma runs 1, 0.67, 0.44,
# 0.30, 0.20 and the loop stops after 4 of its 6 steps
WINDOW = (0.4, 0.9)  # crossed: out at 1.0, in at 0.67 and 0.44, out at 0.30


def _jax_tpm(h, temb):
    return jnp.stack([3.0 + 0.1 * jnp.tanh(jnp.mean(h, axis=(1, 2, 3))),
                      2.0 + 0.1 * jnp.tanh(jnp.mean(temb, axis=1))], axis=1)


def _torch_tpm(h, temb):
    return torch.stack([3.0 + 0.1 * torch.tanh(h.mean(dim=(1, 2, 3))),
                        2.0 + 0.1 * torch.tanh(temb.mean(dim=1))], dim=1)


@pytest.fixture(scope="module")
def world():
    models = drawn_models(3, cache_front_blocks=1)
    c = models["mmdit"][0].config
    rng = np.random.default_rng(31)
    x = dict(
        pe=rng.standard_normal((B, N_CTX, c.joint_attention_dim), np.float32),
        pp=rng.standard_normal((B, c.pooled_projection_dim), np.float32),
        npe=rng.standard_normal((B, N_CTX, c.joint_attention_dim), np.float32),
        npp=rng.standard_normal((B, c.pooled_projection_dim), np.float32),
        lat=rng.standard_normal((B, c.in_channels, c.sample_size, c.sample_size), np.float32),
        gs=np.array([7.0, 4.0], np.float32),
    )
    x["pe2"] = np.concatenate([x["npe"], x["pe"]])
    x["pp2"] = np.concatenate([x["npp"], x["pp"]])
    return models, x


def _cfg(**kw):
    common = dict(max_inference_steps=T, min_sigma=MIN_SIGMA, predict=True,
                  cache_activations=True, keep_history=True)
    return js.SamplerConfig(**common, **kw), ts.SamplerConfig(**common, **kw)


def _builders(models, x, cache, window):
    """(JAX args, torch args) of adaptive_sample: ``denoise_fn`` and
    ``cached`` built as the pipelines build them; the torch side logs
    (mode, rows) of every forward in ``calls``."""
    jm, mvars, tm = models["mmdit"]
    c = jm.config
    grid, p = c.sample_size // c.patch_size, c.patch_size
    calls = []

    def tapply(mode=None):
        def run(lat, tt, pe, pp, d=None):
            calls.append((mode, lat.shape[0]))
            if mode is None:
                return tm(lat, tt, pe, pp)
            return tm(lat, tt, pe, pp, delta=d, cache_mode=mode)

        return run

    japply = lambda mode: (lambda lat, tt, pe, pp, d: jm.apply(mvars, lat, tt, pe, pp, delta=d,
                                                                 cache_mode=mode))
    jplain = lambda *a: jm.apply(mvars, *a)
    pe, pp, gs = x["pe2"], x["pp2"], x["gs"]
    tpe, tpp, tgs = t(pe), t(pp), t(gs)
    if cache is None:
        if window is None:
            return ((jd.make_cfg_denoise_fn(jplain, pe, pp, gs, grid, p), None),
                    (td.make_cfg_denoise_fn(tapply(), tpe, tpp, tgs, grid, p), None), calls)
        return ((jd.make_cfg_interval_denoise_fn(jplain, pe, pp, gs, window, grid, p), None),
                (td.make_cfg_interval_denoise_fn(tapply(), tpe, tpp, tgs, window, grid, p), None),
                calls)
    d0 = np.zeros((2 * B, grid * grid, c.inner_dim), np.float32)
    interval, tau = cache
    if window is None:
        jpair = jd.make_cfg_denoise_cached_fns(japply("record"), japply("reuse"), pe, pp, gs,
                                               grid, p)
        tpair = td.make_cfg_denoise_cached_fns(tapply("record"), tapply("reuse"), tpe, tpp, tgs,
                                               grid, p)
        jd0, td0 = d0, t(d0)
    else:
        jpair = jd.make_cfg_interval_denoise_cached_fns(
            japply("record"), japply("reuse"), pe, pp, gs, window, grid, p)
        tpair = td.make_cfg_interval_denoise_cached_fns(
            tapply("record"), tapply("reuse"), tpe, tpp, tgs, window, grid, p)
        jd0, td0 = jd.interval_cached_init_delta(d0), td.interval_cached_init_delta(t(d0))
    jcached = js.CachedDenoise(*jpair, jd0, js.cache_reuse_schedule(T, interval), tau=tau)
    tcached = ts.CachedDenoise(*tpair, td0, ts.cache_reuse_schedule(T, interval), tau=tau)
    return (None, jcached), (None, tcached), calls


def _run_both(world, cache=None, window=None, **cfg_kw):
    models, x = world
    jcfg, tcfg = _cfg(guidance_interval=window, **cfg_kw)
    (jden, jcached), (tden, tcached), calls = _builders(models, x, cache, window)
    ref = jax.jit(lambda lat: js.adaptive_sample(
        jden, _jax_tpm, lat, jax.random.PRNGKey(0), jcfg, cached=jcached))(x["lat"])
    out = ts.adaptive_sample(tden, _torch_tpm, t(x["lat"]), None, tcfg, cached=tcached)
    n = out.num_steps
    assert n == int(ref.num_steps) and 2 <= n < T  # the loop stopped itself
    np.testing.assert_array_equal(out.prob_masks.numpy(), np.asarray(ref.prob_masks))
    for name in ("sigmas", "alphas", "betas", "logprobs", "final_latents"):
        close(getattr(out, name), getattr(ref, name))
    for name in ("h_cache", "temb_cache", "history_latents"):
        close(getattr(out, name)[:n], np.asarray(getattr(ref, name))[:n])
    return out, calls


@pytest.mark.parametrize("cache", [(2, None), (0, 0.5)], ids=["interval", "tau"])
def test_adaptive_cached_matches_jax(world, cache):
    """cache_interval 2, and the input-aware rule at a tau that the toy
    trajectory crosses, with the same reuse decisions as JAX's (its
    results match only if they do)."""
    out, calls = _run_both(world, cache=cache)
    modes = [m for m, _ in calls]
    assert modes[0] == "record" and "reuse" in modes and "record" in modes[1:]
    if cache[0] == 2:
        assert modes == ["record", "reuse"] * (out.num_steps // 2) + ["record"] * (out.num_steps % 2)


def test_adaptive_window_and_ab2_match_jax(world):
    """AB2 with the window, which the loop crosses both ways: conditional
    only at sigma 1, guided at ~0.67 and ~0.44, conditional only again at
    ~0.30."""
    out, calls = _run_both(world, window=WINDOW, solver="ab2")
    assert [rows for _, rows in calls] == [B, 2 * B, 2 * B, B][: out.num_steps]
    for solver in ("heun", "midpoint"):
        with pytest.raises(ValueError, match="fixed-schedule only"):
            ts.adaptive_sample(None, _torch_tpm, t(world[1]["lat"]), None,
                               ts.SamplerConfig(solver=solver, predict=True))


def test_adaptive_cache_window_composition_matches_jax(world):
    """cache_interval 2 inside the window: cond full at sigma 1, then a
    reuse step entering the window over a stale uncond cache is promoted to
    a guided full forward, a guided full forward, a cond-only reuse."""
    out, calls = _run_both(world, cache=(2, None), window=WINDOW)
    assert calls == [("record", B), ("record", 2 * B), ("record", 2 * B), ("reuse", B)]


def test_adaptive_one_host_read_a_step(world, monkeypatch):
    """With the window, the input-aware cache and AB2 on, the loop reads
    the device once a step: every value its decisions need comes back in
    the all-done flag's transfer. Each read method of a tensor is counted
    between the step's forwards (the first step's window decision is taken
    on the host before the first forward)."""
    models, x = world
    _, tcfg = _cfg(guidance_interval=WINDOW, solver="ab2")
    _, (_, tcached), _ = _builders(models, x, (0, 0.5), WINDOW)
    reads, marks = [0], []

    def counted(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            reads[0] += 1
            return orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, read)

    for name in ("item", "tolist", "__bool__", "__float__", "__int__", "numpy", "cpu"):
        counted(name)

    def marked(fn):
        def run(*a):
            marks.append(reads[0])
            return fn(*a)

        return run

    tcached = tcached._replace(full_fn=marked(tcached.full_fn), reuse_fn=marked(tcached.reuse_fn))
    out = ts.adaptive_sample(None, _torch_tpm, t(x["lat"]), None, tcfg, cached=tcached)
    monkeypatch.undo()
    marks.append(reads[0])
    assert len(marks) == out.num_steps + 1 >= 4
    assert np.diff(marks).tolist() == [1] * out.num_steps


@pytest.fixture(scope="module")
def pipes(world):
    models, _ = world
    (jm, mvars, tm), (jt, tvars, tt), (jv, vvars, tv) = (
        models["mmdit"], models["tpm"], models["vae"])
    return (JTPDMPipeline(jm, mvars, jt, tvars, jv, vvars, min_sigma=MIN_SIGMA),
            TPDMPipeline(tm, tt, tv, min_sigma=MIN_SIGMA))


def test_generate_options_and_history_match_jax(world, pipes):
    """generate with AB2, the window and the history images together,
    against JAX's generate (the cache's wiring: generate_fixed's test)."""
    _, x = world
    jpipe, tpipe = pipes
    kw = dict(max_inference_steps=T, guidance_scale=x["gs"], predict=True, solver="ab2",
              guidance_interval=WINDOW, return_full_process_images=True)
    ref = jpipe.generate(x["pe"], x["pp"], x["npe"], x["npp"], latents=x["lat"], **kw)
    out = tpipe.generate(t(x["pe"]), t(x["pp"]), t(x["npe"]), t(x["npp"]),
                         latents=t(x["lat"]), **kw)
    n = out.num_steps
    assert n == ref.num_steps and 2 <= n < T
    np.testing.assert_array_equal(out.prob_masks, ref.prob_masks)
    close(out.sigmas, ref.sigmas)
    assert out.history_images.dtype == np.uint8
    assert out.history_images.shape == ref.history_images.shape == (n,) + out.images.shape
    for ours, theirs in ((out.images, ref.images), (out.history_images, ref.history_images)):
        diff = np.abs(ours.astype(np.int16) - theirs.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_generate_validation(world, pipes):
    _, x = world
    tpipe = pipes[1]
    args = (t(x["pe"]), t(x["pp"]), t(x["npe"]), t(x["npp"]))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpipe.generate(*args, cache_interval=2, cache_tau=0.1)
    with pytest.raises(ValueError, match="requires classifier-free"):
        tpipe.generate(*args[:2], guidance_scale=None, guidance_interval=(0.2, 0.8))
    with pytest.raises(ValueError, match="fixed-schedule only"):
        tpipe.generate(*args, latents=t(x["lat"]), solver="midpoint")
    grouped = types.SimpleNamespace(
        config=dataclasses.replace(tpipe.mmdit.config, seq_group=types.SimpleNamespace()),
        parameters=tpipe.mmdit.parameters)
    for kw in (dict(cache_interval=2), dict(cache_tau=0.1), dict(guidance_interval=(0.2, 0.8))):
        with pytest.raises(NotImplementedError, match=r"item 14\(g\)"):
            TPDMPipeline(grouped, tpipe.tpm).generate(*args, latents=t(x["lat"]), **kw)


def _toy_trainer(**kw):
    """The port's toy trainer world (tests/test_torch_rloo.py's): 2 prompts
    x rloo_k 2, 3 steps, one update."""
    cfg = RLOOConfig(per_device_train_batch_size=4, rloo_k=2, max_inference_steps=3,
                     total_episodes=4, learning_rate=1e-3, guidance_scale=7.0, **kw)
    agent = build_toy_agent(cfg, device="cpu")
    rows = [{"prompt": f"The image shows prompt {i}"} for i in range(4)]
    return cfg, agent, rows, make_prompt_encoder(agent, n_txt=5)


def test_ab2_rollout_is_adaptive_sample_with_ab2():
    """The trainer's rollout with solver "ab2" is adaptive_sample's AB2 loop
    on the agent's denoiser, bit for bit, and differs from the Euler
    rollout; the recompute replay (the backbone re-run on the recorded
    latents) still reproduces the cached replay's log-probs."""
    cfg, agent, rows, collate = _toy_trainer(solver="ab2")
    assert agent.sampler_cfg.solver == "ab2"
    tpm = agent.init_tpm_params(torch.Generator().manual_seed(3))
    batch = rloo.rloo_repeat(collate(rows[:2]), 2)
    out = agent.sample(tpm, batch, torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    ref = ts.adaptive_sample(agent._denoise_fn(batch), tpm, agent.prepare_latents(gen, 4), gen,
                             agent.sampler_cfg)
    for name in ("sigmas", "logprobs", "final_latents", "h_cache", "temb_cache"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name), rtol=0, atol=0)
    euler = rloo.TPDMAgent(agent.mmdit, dataclasses.replace(cfg, solver="euler"),
                           tpm=agent.tpm_factory)
    assert not torch.equal(euler.sample(tpm, batch, torch.Generator().manual_seed(4))
                           .final_latents, out.final_latents)
    rec = rloo.TPDMAgent(agent.mmdit, cfg, tpm=agent.tpm_factory, replay_mode="recompute")
    out_r = rec.sample(tpm, batch, torch.Generator().manual_seed(4))
    close(rec.logprobs(tpm, out_r, inputs=batch), agent.logprobs(tpm, out).numpy())


class _ClosingCallback:
    def __init__(self, close_raises=False):
        self.closed, self.close_raises = 0, close_raises

    def on_step_end(self, trainer, update, metrics, eval_state):
        pass

    def close(self):
        self.closed += 1
        if self.close_raises:
            raise RuntimeError("close failed")


@pytest.mark.parametrize("loop_raises", [False, True], ids=["normal", "loop_raises"])
def test_train_closes_every_callback(loop_raises, caplog):
    """train's finally closes each callback once, on a normal end and when
    the loop raises; a close() that raises is logged and masks nothing."""
    cfg, agent, rows, collate = _toy_trainer()
    reward_fn = build_toy_reward()
    if loop_raises:
        def reward_fn(prompts, outputs):
            raise RuntimeError("reward failed")
    callbacks = [_ClosingCallback(close_raises=True), _ClosingCallback()]
    trainer = RLOOTrainer(cfg, agent, reward_fn, rows, collate_fn=collate, callbacks=callbacks)
    tpm = agent.init_tpm_params(torch.Generator().manual_seed(7))
    if loop_raises:
        with pytest.raises(RuntimeError, match="reward failed"):
            trainer.train(tpm=tpm)
    else:
        trainer.train(tpm=tpm)
        assert len(trainer.metrics_history) == 1
    assert [cb.closed for cb in callbacks] == [1, 1]
    assert "callback close() raised" in caplog.text
