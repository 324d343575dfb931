"""The SD1.5 modules of tpdm_tpu_torch against the JAX package, on the CPU.

Covers the DPM-Solver++ math (``ops/dpm_solver.py``, the cases of
``tests/test_sd15.py::TestDPMSolverMath`` and the SDE forms), the UNet
(``models/unet_sd15.py`` at ``toy()`` and ``toy_xl()``, plain and through
DeepCache's record and reuse, the weights carried by
``utils/convert.py:unet_sd15_from_jax``), the integer-t loop
(``pipeline/sd15_sampler.py`` with the denoise builders of
``train/sd15_agent.py``) and the diffusers-layout converters.

The loop's cases run a closed-form denoiser and TPM (the same formulas on
both sides), so each JAX loop compiles in about a second; the toy UNet
runs through the loop in ``test_torch_sd15_serving.py``. Integer
timesteps, masks, step counts and last valid indices must equal JAX's
exactly; floats are held to the fp32 bound, rtol 1e-4 / atol 1e-5 scaled
by the output's magnitude (``_torch_parity.close``). The sigma table is
fp32 on both sides and agrees within 1e-5 relative: XLA rounds its
linspace and cumprod in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, random_variables, t
from tpdm_tpu.models.unet_sd15 import UNetConfig as JUNetConfig, UNetSD15 as JUNetSD15
from tpdm_tpu.ops import dpm_solver as jdpm
from tpdm_tpu.pipeline import sampler as jsampler
from tpdm_tpu.pipeline import sd15_sampler as jsd15
from tpdm_tpu.pipeline.denoise import interval_cached_init_delta as j_interval_init
from tpdm_tpu.train import sd15_agent as jagent
from tpdm_tpu.utils.convert import (
    convert_unet_sd15 as j_convert_unet_sd15,
    export_unet_sd15 as j_export_unet_sd15,
)
from tpdm_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15, deepcache_feature_shape
from tpdm_tpu_torch.ops import dpm_solver as tdpm
from tpdm_tpu_torch.pipeline import sampler as tsampler
from tpdm_tpu_torch.pipeline import sd15_sampler as tsd15
from tpdm_tpu_torch.pipeline.denoise import interval_cached_init_delta as t_interval_init
from tpdm_tpu_torch.train import sd15_agent as tagent
from tpdm_tpu_torch.utils.convert import (
    convert_unet_sd15,
    export_unet_sd15,
    unet_sd15_from_jax,
)

RNG = np.random.default_rng


# ---------------------------------------------------------------- DPM math


def test_sigma_table_matches_jax():
    close(tdpm.ddpm_sigmas_from_betas(), jdpm.ddpm_sigmas_from_betas(), rtol=1e-5, atol=0)
    close(tdpm.ddpm_sigmas_from_betas(schedule="linear"),
          jdpm.ddpm_sigmas_from_betas(schedule="linear"), rtol=1e-5, atol=0)
    assert tdpm.ddpm_sigmas_from_betas().dtype == torch.float32


def test_sigma_of_timestep_matches_jax():
    table = np.asarray(jdpm.ddpm_sigmas_from_betas())
    ts_ = np.array([0.0, 10.0, 10.25, 498.5, 998.9, 999.0, 1200.0, -3.0], np.float32)
    close(tdpm.sigma_of_timestep(t(table), t(ts_)), jdpm.sigma_of_timestep(table, ts_))


def test_epsilon_to_x0_matches_jax():
    rng = RNG(0)
    sample, eps = (rng.standard_normal((3, 2, 4, 4), np.float32) for _ in range(2))
    sigma = rng.uniform(0.1, 10, 3).astype(np.float32)
    close(tdpm.epsilon_to_x0(t(eps), t(sample), t(sigma)),
          jdpm.epsilon_to_x0(eps, sample, sigma))
    a, s = tdpm.sigma_to_alpha_sigma_t(t(sigma))
    ja, js_ = jdpm.sigma_to_alpha_sigma_t(sigma)
    close(a, ja)
    close(s, js_)


@pytest.mark.parametrize("sde", [False, True])
def test_first_order_update_matches_jax(sde):
    rng = RNG(1)
    x0, sample, noise = (rng.standard_normal((2, 2, 4, 4), np.float32) for _ in range(3))
    sigma_t = rng.uniform(0.1, 1.0, 2).astype(np.float32)
    sigma_s = sigma_t + rng.uniform(0.5, 2.0, 2).astype(np.float32)
    ours = tdpm.dpm_first_order_update(t(x0), t(sample), t(sigma_t), t(sigma_s),
                                       noise=t(noise), sde=sde)
    close(ours, jdpm.dpm_first_order_update(x0, sample, sigma_t, sigma_s, noise=noise, sde=sde))


@pytest.mark.parametrize("sde", [False, True])
@pytest.mark.parametrize("solver_type", ["midpoint", "heun"])
def test_second_order_update_matches_jax(solver_type, sde):
    rng = RNG(2)
    m0, m1, sample, noise = (rng.standard_normal((2, 2, 4, 4), np.float32) for _ in range(4))
    sigma_t = rng.uniform(0.1, 0.5, 2).astype(np.float32)
    sigma_s0 = sigma_t + rng.uniform(0.2, 1.0, 2).astype(np.float32)
    sigma_s1 = sigma_s0 + rng.uniform(0.2, 1.0, 2).astype(np.float32)
    ours = tdpm.dpm_second_order_update(t(m0), t(m1), t(sample), t(sigma_t), t(sigma_s0),
                                        t(sigma_s1), noise=t(noise), solver_type=solver_type,
                                        sde=sde)
    ref = jdpm.dpm_second_order_update(m0, m1, sample, sigma_t, sigma_s0, sigma_s1, noise=noise,
                                       solver_type=solver_type, sde=sde)
    close(ours, ref)


# ---------------------------------------------------------------- the UNet

UNET_B, N_TXT = 2, 7


def _unet_inputs(cfg):
    rng = RNG(11)
    s = cfg.sample_size
    x = dict(lat=rng.standard_normal((UNET_B, 4, s, s), np.float32),
             t=np.array([999.0, 420.5], np.float32),
             t2=np.array([310.0, 12.0], np.float32),
             ctx=rng.standard_normal((UNET_B, N_TXT, cfg.cross_attention_dim), np.float32))
    if cfg.addition_embed:
        x["ac"] = {"text_embeds": rng.standard_normal((UNET_B, cfg.addition_pooled_dim),
                                                      np.float32),
                   "time_ids": np.array([[512, 512, 0, 0, 512, 512][:cfg.num_time_ids],
                                         [768, 640, 16, 8, 1024, 1024][:cfg.num_time_ids]],
                                        np.float32)}
    return x


@pytest.fixture(scope="module", params=["toy", "toy_xl"])
def unet_pair(request):
    """(JAX UNet, its drawn variables, the port's copy, inputs, JAX's plain,
    record and reuse outputs) of one toy config, JAX run once in one jit."""
    name = request.param
    jcfg = getattr(JUNetConfig, name)()
    ju = JUNetSD15(jcfg)
    x = _unet_inputs(jcfg)
    init_args = [jnp.zeros((1, 4, jcfg.sample_size, jcfg.sample_size)), jnp.ones((1,)),
                 jnp.zeros((1, N_TXT, jcfg.cross_attention_dim))]
    if jcfg.addition_embed:
        init_args.append({k: jnp.asarray(v[:1]) for k, v in x["ac"].items()})
    variables = random_variables(ju.init, 5, *init_args)
    tu = UNetSD15(getattr(UNetConfig, name)())
    tu.load_state_dict(unet_sd15_from_jax(variables))

    @jax.jit
    def run(p, lat, t_, t2, ctx, ac):
        plain = ju.apply(p, lat, t_, ctx, ac)
        rec = ju.apply(p, lat, t_, ctx, ac, cache_mode="record")
        reuse = ju.apply(p, lat, t2, ctx, ac, cache=rec[4], cache_mode="reuse")
        return plain, rec, reuse

    ref = jax.device_get(run(variables, x["lat"], x["t"], x["t2"], x["ctx"], x.get("ac")))
    return ju, variables, tu.eval(), x, ref


def test_unet_matches_jax(unet_pair):
    _, _, tu, x, (plain, _, _) = unet_pair
    ac = None if "ac" not in x else {k: t(v) for k, v in x["ac"].items()}
    with torch.no_grad():
        ours = tu(t(x["lat"]), t(x["t"]), t(x["ctx"]), ac)
    assert len(ours) == 4
    cfg = tu.config
    assert ours[1].shape == (UNET_B, cfg.block_out_channels[0])  # the pre-MLP t_feat
    assert ours[2].shape == ours[3].shape == (UNET_B, cfg.block_out_channels[0],
                                              cfg.sample_size, cfg.sample_size)
    for a, b in zip(ours, plain):
        close(a, b)


def test_unet_deepcache_record_and_reuse_match_jax(unet_pair):
    """"record" returns the plain outputs and the boundary feature (NCHW
    here, NHWC in JAX); "reuse" at another timestep takes it in place of
    the deep subnetwork."""
    _, _, tu, x, (plain, rec, reuse) = unet_pair
    ac = None if "ac" not in x else {k: t(v) for k, v in x["ac"].items()}
    with torch.no_grad():
        r = tu(t(x["lat"]), t(x["t"]), t(x["ctx"]), ac, cache_mode="record")
        u = tu(t(x["lat"]), t(x["t2"]), t(x["ctx"]), ac, cache=r[4], cache_mode="reuse")
    cfg = tu.config
    assert tuple(r[4].shape) == deepcache_feature_shape(cfg, UNET_B)
    for ours, ref in ((r, rec), (u, reuse)):
        for a, b in zip(ours[:4], ref[:4]):
            close(a, b)
        close(ours[4], np.transpose(ref[4], (0, 3, 1, 2)))
    for a, b in zip(r[:4], plain):
        close(a, b)
    with pytest.raises(ValueError, match="needs a cache"):
        tu(t(x["lat"]), t(x["t"]), t(x["ctx"]), ac, cache_mode="reuse")


def test_unet_converters_match_jax():
    """``convert_unet_sd15`` of JAX's diffusers-layout export equals the
    port's state dict of the same weights, and ``export_unet_sd15`` gives
    JAX's export back, key for key (the SD1.5 topology, as JAX's
    converters cover; the toy at two layers a block, so that the down
    levels have shortcut and plain resnets)."""
    cfg = UNetConfig.toy(layers_per_block=2)
    ju = JUNetSD15(JUNetConfig.toy(layers_per_block=2))
    variables = random_variables(ju.init, 6, jnp.zeros((1, 4, 16, 16)), jnp.ones((1,)),
                                 jnp.zeros((1, N_TXT, cfg.cross_attention_dim)))
    tu = UNetSD15(cfg)
    tu.load_state_dict(unet_sd15_from_jax(variables))
    diffusers = j_export_unet_sd15(variables)
    ours = convert_unet_sd15(diffusers, cfg.block_out_channels, cfg.layers_per_block)
    want = tu.state_dict()
    assert sorted(ours) == sorted(want)
    for k, v in want.items():
        assert torch.equal(ours[k], v), k
    back = export_unet_sd15(want, cfg)
    assert sorted(back) == sorted(diffusers)
    for k, v in diffusers.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    # and JAX's converter of the port's export is the drawn tree
    again = unet_sd15_from_jax(j_convert_unet_sd15(
        {k: v.numpy() for k, v in back.items()}, cfg.block_out_channels, cfg.layers_per_block))
    for k, v in want.items():
        assert torch.equal(again[k], v), k


def test_unet_sd15_config_is_the_published_one():
    with torch.device("meta"):
        unet = UNetSD15(UNetConfig.sd15())
    assert sum(p.numel() for p in unet.parameters()) == 859_520_964
    head_dims = {m.proj_in.in_channels // m.block.heads
                 for m in unet.modules() if m.__class__.__name__ == "SpatialTransformer"}
    assert head_dims == {40, 80, 160}


# ---------------------------------------------------------------- the loop

B, H, CTX_D, GS = 3, 8, 6, 7.5
WINDOW = (300.0, 700.0)  # crossed: out at 999, in at ~666 and ~444, out below 300


def _j_apply(lat, tt, ctx, cache=None, mode=None):
    c = jnp.mean(ctx, axis=(1, 2))[:, None, None, None]
    s = (tt / 1000.0)[:, None, None, None]
    eps = jnp.tanh(lat * (0.5 + s)) + 0.1 * c
    if mode == "reuse":
        eps = eps + 0.3 * cache
    out = (eps, jnp.stack([jnp.cos(tt / 300.0), c[:, 0, 0, 0]], axis=1), lat * s,
           jnp.tanh(lat + c))
    if mode is None:
        return out
    return out + (cache if mode == "reuse" else jnp.tanh(lat) * (1.0 + c),)


def _t_apply(lat, tt, ctx, cache=None, mode=None):
    c = ctx.mean(dim=(1, 2))[:, None, None, None]
    s = (tt / 1000.0)[:, None, None, None]
    eps = torch.tanh(lat * (0.5 + s)) + 0.1 * c
    if mode == "reuse":
        eps = eps + 0.3 * cache
    out = (eps, torch.stack([torch.cos(tt / 300.0), c[:, 0, 0, 0]], dim=1), lat * s,
           torch.tanh(lat + c))
    if mode is None:
        return out
    return out + (cache if mode == "reuse" else torch.tanh(lat) * (1.0 + c),)


def _j_tpm(h, temb):
    return jnp.stack([3.0 + 0.1 * jnp.tanh(jnp.mean(h, axis=(1, 2, 3))),
                      2.0 + 0.1 * jnp.tanh(jnp.mean(temb, axis=1))], axis=1)


def _t_tpm(h, temb):
    return torch.stack([3.0 + 0.1 * torch.tanh(h.mean(dim=(1, 2, 3))),
                        2.0 + 0.1 * torch.tanh(temb.mean(dim=1))], dim=1)


@pytest.fixture(scope="module")
def loop_inputs():
    rng = RNG(21)
    return dict(lat=rng.standard_normal((B, 4, H, H), np.float32),
                pe=rng.standard_normal((2 * B, 5, CTX_D), np.float32) * 0.5)


def _mode(apply, mode):
    return lambda lat, tt, ctx, c: apply(lat, tt, ctx, c, mode)


def _denoisers(x, cache, window):
    """(JAX (denoise_fn, cached), the port's) from the agents' builders."""
    jpe, tpe = jnp.asarray(x["pe"]), t(x["pe"])
    T = 12
    out = []
    for mod, apply, pe, csd, sched, init_fn, zeros in (
            (jagent, _j_apply, jpe, jsampler.CachedDenoise, jsampler.cache_reuse_schedule,
             j_interval_init, lambda s: jnp.zeros(s)),
            (tagent, _t_apply, tpe, tsampler.CachedDenoise, tsampler.cache_reuse_schedule,
             t_interval_init, lambda s: torch.zeros(s))):
        if cache is None:
            fn = (mod.make_sd15_denoise_fn(apply, pe, GS) if window is None else
                  mod.make_sd15_interval_denoise_fn(apply, pe, GS, window))
            out.append((fn, None))
            continue
        interval, tau = cache
        init = zeros((2 * B, 4, H, H))
        if window is None:
            pair = mod.make_sd15_denoise_cached_fns(_mode(apply, "record"),
                                                    _mode(apply, "reuse"), pe, GS)
        else:
            pair = mod.make_sd15_interval_denoise_cached_fns(
                _mode(apply, "record"), _mode(apply, "reuse"), pe, GS, window)
            init = init_fn(init)
        out.append((None, csd(*pair, init, sched(T, interval), tau=tau)))
    return out


CASES = {
    "predict": dict(),
    "caps_init_t": dict(step_caps=[2, 6, 12], init_t=[999, 600, 5]),
    "cap_floor": dict(cfg=dict(cap_floor_time=4), step_caps=[3, 12, 12]),
    "heun_history": dict(cfg=dict(solver_type="heun", keep_history=True)),
    "deepcache": dict(cache=(2, None)),
    "cache_tau": dict(cache=(0, 0.3)),
    "window": dict(window=WINDOW),
    "window_deepcache": dict(window=WINDOW, cache=(2, None)),
}


def _run_both(x, case):
    kw = CASES[case]
    cfg_kw = dict(num_inference_steps=12, predict=True, **kw.get("cfg", {}))
    if "window" in kw:
        cfg_kw["guidance_interval"] = kw["window"]
    (jfn, jcached), (tfn, tcached) = _denoisers(x, kw.get("cache"), kw.get("window"))
    caps, init_t = kw.get("step_caps"), kw.get("init_t")

    @jax.jit
    def jrun(lat):
        return jsd15.sd15_adaptive_sample(
            jfn, _j_tpm, lat, jax.random.PRNGKey(0), jsd15.SD15SamplerConfig(**cfg_kw),
            step_caps=None if caps is None else jnp.asarray(caps, jnp.int32),
            init_t=None if init_t is None else jnp.asarray(init_t, jnp.int32), cached=jcached)

    ref = jax.device_get(jrun(x["lat"]))
    ours = tsd15.sd15_adaptive_sample(
        tfn, _t_tpm, t(x["lat"]), None, tsd15.SD15SamplerConfig(**cfg_kw),
        step_caps=None if caps is None else torch.tensor(caps),
        init_t=None if init_t is None else torch.tensor(init_t), cached=tcached)
    return ours, ref


@pytest.mark.parametrize("case", list(CASES))
def test_adaptive_sample_matches_jax(loop_inputs, case):
    ours, ref = _run_both(loop_inputs, case)
    np.testing.assert_array_equal(ours.times.numpy(), ref.times)
    np.testing.assert_array_equal(ours.prob_masks.numpy(), ref.prob_masks)
    np.testing.assert_array_equal(ours.last_valid_index.numpy(), ref.last_valid_index)
    assert ours.num_steps == int(ref.num_steps)
    assert ours.times.dtype == torch.int32
    for name in ("final_latents", "ratios", "logprobs", "alphas", "betas"):
        close(getattr(ours, name), getattr(ref, name))
    n = ours.num_steps
    close(ours.h_cache[:n], ref.h_cache[:n])
    close(ours.temb_cache[:n], ref.temb_cache[:n])
    if CASES[case].get("cfg", {}).get("keep_history"):
        close(ours.history_latents[:n], ref.history_latents[:n])
    if case == "caps_init_t":
        # the capped sample stops at step 2, the one below min_time takes no step
        assert ours.last_valid_index.tolist()[::2] == [1, -1]
        np.testing.assert_array_equal(ours.final_latents[2].numpy(), loop_inputs["lat"][2])
    if case == "window":
        assert any(lo <= tt < hi for lo, hi in [WINDOW] for tt in ours.times[0, 1:n].tolist())


def test_replay_matches_jax_and_the_rollout(loop_inputs):
    """sd15_replay_logprobs over the rollout's cache gives the rollout's
    log-probs (and JAX's), with gradients through the TPM."""
    ours, ref = _run_both(loop_inputs, "caps_init_t")
    cfg = tsd15.SD15SamplerConfig(num_inference_steps=12)
    lp = tsd15.sd15_replay_logprobs(_t_tpm, ours.h_cache, ours.temb_cache, ours.ratios,
                                    ours.prob_masks, cfg)
    close(lp, ours.logprobs)
    jlp = jsd15.sd15_replay_logprobs(_j_tpm, ref.h_cache, ref.temb_cache, ref.ratios,
                                     ref.prob_masks, jsd15.SD15SamplerConfig(12))
    close(lp, jlp)
    w = torch.tensor(0.3, requires_grad=True)
    g = tsd15.sd15_replay_logprobs(lambda h, e: _t_tpm(h * w, e), ours.h_cache,
                                   ours.temb_cache, ours.ratios, ours.prob_masks, cfg)
    torch.where(ours.prob_masks, 0.0, g).sum().backward()
    assert torch.isfinite(w.grad)


def test_window_runs_the_conditional_batch_outside(loop_inputs):
    """Outside the window a step runs one forward at batch b, inside it the
    doubled batch, decided on the host from the integer t."""
    x = loop_inputs
    sizes = []

    def apply(lat, tt, ctx):
        sizes.append(lat.shape[0])
        return _t_apply(lat, tt, ctx)

    fn = tagent.make_sd15_interval_denoise_fn(apply, t(x["pe"]), GS, WINDOW)
    out = tsd15.sd15_adaptive_sample(fn, _t_tpm, t(x["lat"]), None,
                                     tsd15.SD15SamplerConfig(12, predict=True,
                                                             guidance_interval=WINDOW))
    times = out.times.numpy()
    want = [2 * B if any(WINDOW[0] <= v < WINDOW[1] for v in times[:, i]) else B
            for i in range(out.num_steps)]
    assert sizes == want and B in sizes and 2 * B in sizes


def test_one_host_read_a_step(loop_inputs, monkeypatch):
    """With the window and the input-aware cache on, the loop reads the
    device once a step (the first step's window decision is taken from
    init_t on the host before the first forward)."""
    (_, _), (_, tcached) = _denoisers(loop_inputs, (0, 0.3), WINDOW)
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
    cfg = tsd15.SD15SamplerConfig(12, predict=True, guidance_interval=WINDOW)
    out = tsd15.sd15_adaptive_sample(None, _t_tpm, t(loop_inputs["lat"]), None, cfg,
                                     cached=tcached)
    monkeypatch.undo()
    marks.append(reads[0])
    assert len(marks) == out.num_steps + 1 >= 4
    assert np.diff(marks).tolist() == [1] * out.num_steps


def test_sampler_validation():
    lat = torch.zeros(1, 4, H, H)
    with pytest.raises(ValueError, match="cap_floor_time"):
        tsd15.sd15_adaptive_sample(None, _t_tpm, lat, None,
                                   tsd15.SD15SamplerConfig(4, cap_floor_time=10, predict=True))
    with pytest.raises(ValueError, match="generator"):
        tsd15.sd15_adaptive_sample(None, _t_tpm, lat, None, tsd15.SD15SamplerConfig(4))
    with pytest.raises(ValueError, match="CFG on"):
        tagent.make_sd15_interval_denoise_fn(_t_apply, torch.zeros(2, 1, 1), None, WINDOW)
