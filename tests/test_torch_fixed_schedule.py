"""The fixed-schedule baseline of tpdm_tpu_torch against the JAX package:
the sigma ladder, the Heun and AB2 updates, the MMDiT's Δ-cache forward,
each fixed solver, the cached and input-aware cached samplers, the
guidance window and its composition with the cache, and
``TPDMPipeline.generate_fixed`` end to end, on the same toy weights and
seeded inputs. fp32 bound: rtol 1e-4 / atol 1e-5 scaled by the output's
magnitude (``_torch_parity.close``); images within one uint8 level on
fewer than 1 % of pixels. Every JAX sampler runs under one ``jax.jit``."""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, drawn_models, t
from tpdm_tpu.ops.flow_solver import flow_ab2_step as jax_ab2, flow_heun_combine as jax_heun
from tpdm_tpu.ops.schedules import uniform_flow_sigmas as jax_uniform_flow_sigmas
from tpdm_tpu.pipeline import denoise as jd
from tpdm_tpu.pipeline import sampler as js
from tpdm_tpu.pipeline.pipeline import TPDMPipeline as JTPDMPipeline
from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from tpdm_tpu_torch.ops import flow_ab2_step, flow_heun_combine
from tpdm_tpu_torch.ops.schedules import uniform_flow_sigmas
from tpdm_tpu_torch.pipeline import denoise as td
from tpdm_tpu_torch.pipeline import sampler as ts
from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline

B, N_CTX, GS, T = 2, 6, 7.0, 3


@pytest.fixture(scope="module")
def world():
    models = drawn_models(0, tpm=False, cache_front_blocks=1)
    jm, mvars, tm = models["mmdit"]
    c = jm.config
    rng = np.random.default_rng(21)
    x = dict(
        pe=rng.standard_normal((B, N_CTX, c.joint_attention_dim), np.float32),
        pp=rng.standard_normal((B, c.pooled_projection_dim), np.float32),
        npe=rng.standard_normal((B, N_CTX, c.joint_attention_dim), np.float32),
        npp=rng.standard_normal((B, c.pooled_projection_dim), np.float32),
        lat=rng.standard_normal((B, c.in_channels, c.sample_size, c.sample_size), np.float32),
    )
    x["pe2"] = np.concatenate([x["npe"], x["pe"]])  # [negative; positive]
    x["pp2"] = np.concatenate([x["npp"], x["pp"]])
    return models, x


def _jax_apply(models):
    jm, mvars, _ = models["mmdit"]
    plain = lambda *a: jm.apply(mvars, *a)
    mode = lambda m: (lambda lat, tt, pe, pp, d: jm.apply(mvars, lat, tt, pe, pp, delta=d,
                                                             cache_mode=m))
    return plain, mode("record"), mode("reuse")


def _torch_apply(models, calls=None):
    """The port's plain, record and reuse apply fns; ``calls`` collects
    (mode, rows) of every forward."""
    tm = models["mmdit"][2]

    def mode(m):
        def run(lat, tt, pe, pp, d):
            if calls is not None:
                calls.append((m, lat.shape[0]))
            return tm(lat, tt, pe, pp, delta=d, cache_mode=m)

        return run

    return tm, mode("record"), mode("reuse")


def _zero_delta(models, rows):
    c = models["mmdit"][0].config
    return np.zeros((rows, (c.sample_size // c.patch_size) ** 2, c.inner_dim), np.float32)


def _counting(fn, calls):
    def run(*a):
        calls.append(1)
        return fn(*a)

    return run


@pytest.mark.parametrize("num_steps", [1, 2, 3, 4, 28, 50])
def test_uniform_flow_sigmas_equal_jax(num_steps):
    ours = uniform_flow_sigmas(num_steps)
    assert ours.dtype == torch.float32 and ours.device.type == "cpu"
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_uniform_flow_sigmas(num_steps)))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_flow_solver_updates_match_jax(dtype):
    """Heun's corrector and AB2 with per-sample sigmas; sample 0 has h_prev
    = 0 (AB2's first step: Euler, no division by zero)."""
    rng = np.random.default_rng(3)
    v0, v1, x = (rng.standard_normal((3, 4, 5, 5), np.float32) for _ in range(3))
    sigma = np.array([0.8, 0.6, 0.3], np.float32)
    sigma_next = np.array([0.7, 0.45, 0.0], np.float32)
    sigma_prev = np.array([0.8, 0.7, 0.5], np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ja = [jnp.asarray(a, jdt) for a in (v0, v1, x)]
    ta = [t(a).to(tdt) for a in (v0, v1, x)]
    ref_h = jax_heun(ja[0], ja[1], sigma_next, sigma, ja[2])
    out_h = flow_heun_combine(ta[0], ta[1], t(sigma_next), t(sigma), ta[2])
    ref_a = jax_ab2(ja[0], ja[1], sigma_next, sigma, sigma_prev, ja[2])
    out_a = flow_ab2_step(ta[0], ta[1], t(sigma_next), t(sigma), t(sigma_prev), ta[2])
    for out, ref in ((out_h, ref_h), (out_a, ref_a)):
        assert out.dtype == tdt
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
    euler = x[0] + (sigma_next[0] - sigma[0]) * v0[0]
    close(out_a[0].float(), euler if dtype == np.float32 else np.asarray(ref_a[0], np.float32))


def test_cache_mode_matches_jax(world):
    """"record" (every block, Δ over the back block) and "reuse" (the front
    block only, with a seeded Δ of the recorded one's scale)."""
    models, x = world
    jm, mvars, tm = models["mmdit"]
    lat, pe, pp = x["lat"], x["pe"], x["pp"]
    tt = np.array([1000.0, 420.0], np.float32)
    other = np.random.default_rng(5).standard_normal(_zero_delta(models, B).shape, np.float32)

    @jax.jit
    def ref_fn(lat, tt, pe, pp, other):
        return (jm.apply(mvars, lat, tt, pe, pp, cache_mode="record"),
                jm.apply(mvars, lat, tt, pe, pp, delta=other, cache_mode="reuse"))

    rec_ref, reuse_ref = ref_fn(lat, tt, pe, pp, other)
    with torch.no_grad():
        rec = tm(t(lat), t(tt), t(pe), t(pp), cache_mode="record")
        reuse = tm(t(lat), t(tt), t(pe), t(pp), delta=t(other), cache_mode="reuse")
        plain = tm(t(lat), t(tt), t(pe), t(pp))
    assert len(rec) == len(reuse) == 5 and len(plain) == 4
    for ours, ref in zip(rec + reuse, tuple(rec_ref) + tuple(reuse_ref)):
        close(ours, ref)
    for a, b in zip(plain, rec):  # record changes nothing of the plain forward
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cache_mode_refusals():
    tm = MMDiT(MMDiTConfig.toy(cache_front_blocks=2))
    c = tm.config
    args = (torch.zeros(1, c.in_channels, 8, 8), torch.ones(1),
            torch.zeros(1, 3, c.joint_attention_dim), torch.zeros(1, c.pooled_projection_dim))
    with pytest.raises(ValueError, match="cache_front_blocks"):
        tm(*args, cache_mode="record")
    tm = MMDiT(MMDiTConfig.toy(cache_front_blocks=1))
    with pytest.raises(ValueError, match="needs a delta"):
        tm(*args, cache_mode="reuse")
    with pytest.raises(ValueError, match="cache_mode"):
        tm(*args, cache_mode="replay")
    grouped = MMDiT(MMDiTConfig.toy(cache_front_blocks=1, seq_group=types.SimpleNamespace()))
    with pytest.raises(NotImplementedError, match=r"item 14\(g\)"):
        grouped(*args, cache_mode="record")


@pytest.fixture(scope="module")
def jax_solvers(world):
    """JAX's fixed run with each solver, all four in one jit."""
    models, x = world
    jplain, _, _ = _jax_apply(models)
    jvfn = jd.make_cfg_velocity_fn(jplain, x["pe2"], x["pp2"], GS)
    runs = jax.jit(lambda lat: [js.fixed_schedule_sample_solver(
        jvfn, lat, jax_uniform_flow_sigmas(T), solver) for solver in js.FLOW_SOLVERS])(x["lat"])
    return dict(zip(js.FLOW_SOLVERS, runs))


@pytest.mark.parametrize("solver", ["euler", "heun", "midpoint", "ab2"])
def test_fixed_solvers_match_jax(world, jax_solvers, solver):
    models, x = world
    tplain, _, _ = _torch_apply(models)
    ref = jax_solvers[solver]
    calls = []
    tvfn = _counting(td.make_cfg_velocity_fn(tplain, t(x["pe2"]), t(x["pp2"]), GS), calls)
    out = ts.fixed_schedule_sample_solver(tvfn, t(x["lat"]), uniform_flow_sigmas(T), solver)
    close(out, ref)
    assert len(calls) == ts.solver_nfe(T, solver) == js.solver_nfe(T, solver)
    with pytest.raises(ValueError, match="unknown flow solver"):
        ts.fixed_schedule_sample_solver(tvfn, t(x["lat"]), uniform_flow_sigmas(T), "rk4")


def _jax_branch_log(full_fn, reuse_fn, log):
    """JAX's full / reuse fns, each noting its branch as it runs."""

    def tag(fn, name):
        def run(*a):
            jax.debug.callback(lambda: log.append(name), ordered=True)
            return fn(*a)

        return run

    return tag(full_fn, "full"), tag(reuse_fn, "reuse")


@pytest.mark.parametrize("policy", ["interval", "tau"])
def test_fixed_cached_matches_jax(world, policy):
    """cache_interval 2 (full, reuse, full, reuse) and the input-aware rule
    at a tau that the toy trajectory crosses: the same reuse decisions and
    full-forward count as JAX's."""
    models, x = world
    steps, tau = 4, 0.7
    _, jrec, jreu = _jax_apply(models)
    jfull, jreuse = jd.make_cfg_velocity_cached_fns(jrec, jreu, x["pe2"], x["pp2"], GS)
    jlog = []
    jfull, jreuse = _jax_branch_log(jfull, jreuse, jlog)
    d0 = _zero_delta(models, 2 * B)
    sig = jax_uniform_flow_sigmas(steps)
    if policy == "interval":
        ref = jax.jit(lambda lat: js.fixed_schedule_sample_cached(
            jfull, jreuse, lat, sig, d0, js.cache_reuse_schedule(steps, 2)))(x["lat"])
    else:
        ref, ref_n = jax.jit(lambda lat: js.fixed_schedule_sample_autocached(
            jfull, jreuse, lat, sig, d0, tau))(x["lat"])
    jax.effects_barrier()

    calls = []
    _, trec, treu = _torch_apply(models, calls)
    tfull, treuse = td.make_cfg_velocity_cached_fns(trec, treu, t(x["pe2"]), t(x["pp2"]), GS)
    if policy == "interval":
        out = ts.fixed_schedule_sample_cached(tfull, treuse, t(x["lat"]), uniform_flow_sigmas(steps),
                                              t(d0), ts.cache_reuse_schedule(steps, 2))
    else:
        out, n_full = ts.fixed_schedule_sample_autocached(
            tfull, treuse, t(x["lat"]), uniform_flow_sigmas(steps), t(d0), tau)
        assert n_full == int(ref_n)
    close(out, ref)
    ours = ["full" if mode == "record" else "reuse" for mode, _ in calls]
    assert ours == jlog
    assert "full" in ours[1:] and "reuse" in ours  # the rule made both choices
    np.testing.assert_array_equal(ts.cache_reuse_schedule(5, 2), js.cache_reuse_schedule(5, 2))
    assert ts.cache_reuse_schedule(3, 1) == [False] * 3


def test_fixed_window_matches_jax(world):
    """The window (0.5, 0.9) over the 3-step ladder (1.0, 0.750, 0.003):
    cond-only, guided, cond-only, so the run enters and leaves it."""
    models, x = world
    window = (0.5, 0.9)
    jplain, _, _ = _jax_apply(models)
    jvfn = jd.make_cfg_interval_velocity_fn(jplain, x["pe2"], x["pp2"], GS, window)
    ref = jax.jit(lambda lat: js.fixed_schedule_sample(
        jvfn, lat, jax_uniform_flow_sigmas(T)))(x["lat"])
    tm = models["mmdit"][2]
    rows = []
    tvfn = td.make_cfg_interval_velocity_fn(
        lambda lat, *a: (rows.append(lat.shape[0]), tm(lat, *a))[1],
        t(x["pe2"]), t(x["pp2"]), GS, window)
    out = ts.fixed_schedule_sample(tvfn, t(x["lat"]), uniform_flow_sigmas(T), window)
    close(out, ref)
    assert rows == [B, 2 * B, B]
    with pytest.raises(ValueError, match="requires CFG"):
        td.make_cfg_interval_velocity_fn(tm, t(x["pe"]), t(x["pp"]), None, window)


def test_fixed_cache_window_composition_matches_jax(world):
    """The ladder (1.0, 0.900, 0.750, 0.500, 0.003), window (0.4, 0.95) and
    cache_interval 2 walk every branch: cond full, a reuse step entering
    the window over a stale uncond cache (promoted to a guided full
    forward), guided full, guided reuse, cond full."""
    models, x = world
    steps, window = 5, (0.4, 0.95)
    _, jrec, jreu = _jax_apply(models)
    jfull, jreuse = jd.make_cfg_interval_velocity_cached_fns(
        jrec, jreu, x["pe2"], x["pp2"], GS, window)
    d0 = _zero_delta(models, 2 * B)
    ref = jax.jit(lambda lat: js.fixed_schedule_sample_cached(
        jfull, jreuse, lat, jax_uniform_flow_sigmas(steps), jd.interval_cached_init_delta(d0),
        js.cache_reuse_schedule(steps, 2)))(x["lat"])
    calls = []
    _, trec, treu = _torch_apply(models, calls)
    tfull, treuse = td.make_cfg_interval_velocity_cached_fns(
        trec, treu, t(x["pe2"]), t(x["pp2"]), GS, window)
    init = td.interval_cached_init_delta(t(d0))
    out = ts.fixed_schedule_sample_cached(tfull, treuse, t(x["lat"]), uniform_flow_sigmas(steps),
                                          init, ts.cache_reuse_schedule(steps, 2), window)
    close(out, ref)
    assert calls == [("record", B), ("record", 2 * B), ("record", 2 * B), ("reuse", 2 * B),
                     ("record", B)]
    assert not init["uncond_valid"] and bool(init["d"].eq(0).all())  # the caller's Δ untouched


@pytest.fixture(scope="module")
def pipes(world):
    models, _ = world
    jm, mvars, tm = models["mmdit"]
    jv, vvars, tv = models["vae"]
    return (JTPDMPipeline(jm, mvars, None, None, jv, vvars),
            TPDMPipeline(tm, None, tv))


def test_generate_fixed_matches_jax(world, pipes):
    _, x = world
    jpipe, tpipe = pipes
    ref = jpipe.generate_fixed(x["pe"], x["pp"], x["npe"], x["npp"], num_steps=T,
                               guidance_scale=GS, latents=x["lat"])
    out = tpipe.generate_fixed(t(x["pe"]), t(x["pp"]), t(x["npe"]), t(x["npp"]), num_steps=T,
                               guidance_scale=GS, latents=t(x["lat"]))
    assert out.dtype == np.uint8 and out.shape == ref.shape == (B, 16, 16, 3)
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    # without a VAE: the raw latents, float32 even from a bf16 model
    bf16 = copy.deepcopy(tpipe.mmdit).to(torch.bfloat16)
    raw = TPDMPipeline(bf16, None).generate_fixed(
        t(x["pe"]), t(x["pp"]), guidance_scale=None, num_steps=2, seed=4)
    assert raw.dtype == np.float32 and raw.shape == x["lat"].shape and np.isfinite(raw).all()


def test_generate_fixed_validation(world, pipes):
    _, x = world
    tpipe = pipes[1]
    args = (t(x["pe"]), t(x["pp"]), t(x["npe"]), t(x["npp"]))
    for kw, match in ((dict(solver="rk4"), "unknown solver"),
                      (dict(solver="heun", cache_interval=2), "second-order"),
                      (dict(solver="ab2", cache_tau=0.1), "second-order"),
                      (dict(cache_interval=2, cache_tau=0.1), "mutually exclusive"),
                      (dict(guidance_interval=(0.2, 0.8), guidance_scale=None),
                       "requires classifier-free")):
        with pytest.raises(ValueError, match=match):
            tpipe.generate_fixed(*args, num_steps=2, **kw)
    with pytest.raises(ValueError, match="negative_prompt_embeds"):
        tpipe.generate_fixed(*args[:2], num_steps=2)
    grouped = types.SimpleNamespace(
        config=dataclasses.replace(tpipe.mmdit.config, seq_group=types.SimpleNamespace()),
        parameters=tpipe.mmdit.parameters)
    with pytest.raises(NotImplementedError, match=r"item 14\(g\)"):
        TPDMPipeline(grouped, None).generate_fixed(*args, num_steps=2)
