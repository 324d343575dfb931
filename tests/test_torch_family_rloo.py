"""RLOO training over the non-SD3 families in tpdm_tpu_torch, on the CPU.

- ``RLOOTrainer`` runs two updates over ``SD15Agent``, ``SDXLAgent`` and
  ``FluxAgent`` (toy worlds of the port alone), with the rollout's caches
  kept where they are and offloaded to the host (``offload_cache``), the
  two runs' metrics equal.
- The PPO micro-step on one JAX rollout of each family (``predict=True``,
  a real TPM), converted to the port's output type: the replay's log-probs,
  the loss, the stats, every TPM gradient and the Adam update against the
  JAX trainer's, as ``tests/test_torch_rloo.py`` holds SD3's.
- ``SDXLEnsembleAgent`` against ``tpdm_tpu.train.sdxl_agent.
  SDXLEnsembleAgent`` on the same toy weights (both experts, both TPMs):
  the handoff, the stitched rollout, the replay's gradients into both
  heads, the step-cap split and the refusals; then the port's trainer over
  it: two updates, a checkpoint of both heads, and the host offload.

One JAX world a family (module fixture, parametrised), each built as
``tests/test_torch_sdxl.py`` and ``tests/test_torch_flux.py`` build theirs:
two-level toy UNets at an 8 x 8 latent grid and the 1 + 1 block toy FLUX,
weights drawn by ``_torch_parity.random_variables``. Integer schedules,
masks, step counts and handoff times must equal JAX's exactly; floats are
held to the fp32 bound (``_torch_parity.close``).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from _torch_parity import close, random_variables, t
from tpdm_tpu.models.flux import Flux as JFlux, FluxConfig as JFluxConfig
from tpdm_tpu.models.flux import pack_latents as j_pack
from tpdm_tpu.models.tpm import TimePredictor as JTimePredictor
from tpdm_tpu.models.unet_sd15 import UNetConfig as JUNetConfig, UNetSD15 as JUNetSD15
from tpdm_tpu.pipeline.sd15_sampler import sd15_replay_logprobs as j_sd15_replay
from tpdm_tpu.train import RLOOConfig as JRLOOConfig
from tpdm_tpu.train import RLOOTrainer as JRLOOTrainer
from tpdm_tpu.train import rloo as jrloo
from tpdm_tpu.train.flux_agent import FluxAgent as JFluxAgent
from tpdm_tpu.train.sd15_agent import SD15Agent as JSD15Agent
from tpdm_tpu.train.sdxl_agent import SDXLAgent as JSDXLAgent
from tpdm_tpu.train.sdxl_agent import SDXLEnsembleAgent as JSDXLEnsembleAgent
from tpdm_tpu.train.sdxl_agent import SDXLRefinerAgent as JSDXLRefinerAgent
from tpdm_tpu_torch.models.flux import Flux, FluxConfig
from tpdm_tpu_torch.models.tpm import TimePredictor
from tpdm_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from tpdm_tpu_torch.pipeline.sampler import SampleOutput
from tpdm_tpu_torch.pipeline.sd15_sampler import SD15SampleOutput
from tpdm_tpu_torch.train import (
    EnsembleSampleOutput,
    FluxAgent,
    RLOOConfig,
    RLOOTrainer,
    SD15Agent,
    SDXLAgent,
    SDXLEnsembleAgent,
    SDXLRefinerAgent,
    rloo,
)
from tpdm_tpu_torch.train import checkpoint as ckpt
from tpdm_tpu_torch.utils import safetensors
from tpdm_tpu_torch.utils.convert import (
    export_tpm,
    flux_from_jax,
    tpm_from_jax,
    unet_sd15_from_jax,
)

T, N_TXT, LR = 5, 5, 1e-3
ADAM_TOL = 1e-2  # each parameter's Adam update within this share of lr of JAX's
HEAD_BIAS = (0.5, 2.0)  # mode ratio ~0.18: a few valid steps, then masked ones
DENOISING_END = 0.5
POOL = 12
SD15_KW = dict(block_out_channels=(8, 16), sample_size=8)
XL_KW = dict(block_out_channels=(8, 16), transformer_layers_per_block=(0, 1),
             mid_transformer_layers=1, sample_size=8, addition_pooled_dim=POOL)
REF_KW = dict(block_out_channels=(8, 16, 16), transformer_layers_per_block=(0, 1, 0),
              mid_transformer_layers=1, sample_size=8, addition_pooled_dim=POOL)
FLUX_KW = dict(depth_double=1, depth_single=1, cache_front_blocks=1)
GUIDANCE = {"sd15": 7.5, "sdxl": 5.0}


# ---------------------------------------------------------------- the worlds

def _unet_pair(name, kw, seed):
    """A JAX toy UNet, its drawn variables and the port's copy."""
    jcfg = getattr(JUNetConfig, name)(**kw)
    ju = JUNetSD15(jcfg)
    s = jcfg.sample_size
    args = [jnp.zeros((1, 4, s, s)), jnp.ones((1,)), jnp.zeros((1, 8, jcfg.cross_attention_dim))]
    if jcfg.addition_embed:
        args.append({"text_embeds": jnp.zeros((1, POOL)),
                     "time_ids": jnp.zeros((1, jcfg.num_time_ids))})
    uvars = random_variables(ju.init, seed, *args)
    tu = UNetSD15(getattr(UNetConfig, name)(**kw))
    tu.load_state_dict(unet_sd15_from_jax(uvars))
    return ju, uvars, tu.eval()


def _flux_pair(seed):
    jm = JFlux(JFluxConfig.toy(**FLUX_KW))
    tok, ids = j_pack(jnp.zeros((1, 4, 8, 8)))
    v = random_variables(jm.init, seed, tok, ids, jnp.zeros((1, N_TXT, 32)),
                         jnp.zeros((1, N_TXT, 3)), jnp.ones((1,)), jnp.zeros((1, 24)),
                         jnp.ones((1,)))
    v = jax.tree.map(np.asarray, v)
    cfg = FluxConfig.toy(**FLUX_KW)
    tm = Flux(cfg)
    tm.load_state_dict(flux_from_jax(v, cfg))
    return jm, v, tm.eval()


def _jax_config(gas=1, **kw):
    return JRLOOConfig(**{**dict(
        per_device_train_batch_size=2, gradient_accumulation_steps=gas, rloo_k=2,
        max_inference_steps=T, total_episodes=8, learning_rate=LR, kl_coef=0.0,
        init_alpha=HEAD_BIAS[0], init_beta=HEAD_BIAS[1]), **kw})


def _torch_config(jcfg):
    return RLOOConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(RLOOConfig)})


def _jax_tpm(ch, width=None):
    return JTimePredictor(conv_out_channels=4, in_channels=2 * ch, temb_dim=width or ch,
                          init_alpha=HEAD_BIAS[0], init_beta=HEAD_BIAS[1])


def _torch_tpm(ch):
    return TimePredictor(conv_out_channels=4, in_channels=2 * ch, temb_dim=ch)


def _draw_tpm(init, seed):
    """The JAX TPM's variables as its own init draws them (kernels N(0,
    0.02²), the head's bias (init_alpha, init_beta)), without compiling it."""
    p = random_variables(init, seed, kernel_std=0.02)
    p["params"]["fc2"]["bias"] = np.array(HEAD_BIAS, np.float32)
    return p


def _embeds(rng, b, widths):
    return {k: rng.normal(size=(b,) + shape).astype(np.float32) for k, shape in widths.items()}


def _unet_widths(cfg, prefix="", negatives=True):
    widths = {"prompt_embeds": (N_TXT, cfg.cross_attention_dim)}
    if cfg.addition_embed:
        widths["pooled_prompt_embeds"] = (POOL,)
    if negatives:
        widths.update({f"negative_{k}": v for k, v in list(widths.items())})
    return {prefix + k: v for k, v in widths.items()}


def _to_port(cls, out):
    """A JAX rollout record as the port's output type (numpy to CPU
    tensors, the step count an int)."""
    return cls(**{name: (int(value) if name == "num_steps" else
                         None if value is None else t(value))
                  for name, value in out._asdict().items() if name in cls._fields})


def _jax_family(family):
    """(JAX agent, the port's agent, the JAX rollout's batch rows' widths,
    TPM channels, port output type)."""
    jcfg = _jax_config()
    if family == "flux":
        jm, v, tm = _flux_pair(60)
        jag = JFluxAgent(jm, v, jcfg, tpm=_jax_tpm(48), latent_size=8, latent_channels=4)
        tag = FluxAgent(tm, _torch_config(jcfg), latent_size=8, latent_channels=4)
        return jag, tag, {"prompt_embeds": (N_TXT, 32), "pooled_prompt_embeds": (24,)}, 48, \
            SampleOutput
    name, kw, jcls, tcls = (("toy", SD15_KW, JSD15Agent, SD15Agent) if family == "sd15" else
                            ("toy_xl", XL_KW, JSDXLAgent, SDXLAgent))
    ju, uvars, tu = _unet_pair(name, kw, 61)
    gs = GUIDANCE[family]
    jag = jcls(ju, uvars, jcfg, tpm=_jax_tpm(8), guidance_scale=gs)
    tag = tcls(tu, _torch_config(jcfg), guidance_scale=gs)
    return jag, tag, _unet_widths(tu.config), 8, SD15SampleOutput


@pytest.fixture(scope="module", params=["sd15", "sdxl", "flux"])
def jax_step(request):
    """One JAX family world: the rollout of 2 prompts x 2 at the mode
    policy, the JAX trainer's two micro-steps on it with gradient
    accumulation 2 (the first one's gradient left in its accumulator), the
    update that JAX's optax chain without accumulation makes of that
    gradient, and the port's agent, TPM and rollout."""
    family = request.param
    jag, tag, widths, ch, out_cls = _jax_family(family)
    p0 = _draw_tpm(jag.init_tpm_params, 62)
    rows = _embeds(np.random.default_rng(63), 2, widths)
    data = jrloo.rloo_repeat({k: jnp.asarray(v) for k, v in rows.items()}, 2)
    data["latents"] = jnp.asarray(np.random.default_rng(64).standard_normal(
        (4, 4, 8, 8)).astype(np.float32))
    out = jag.sample(p0, data, jax.random.PRNGKey(3), predict=True)
    adv = np.array([0.7, -0.4, 1.1, -0.9], np.float32)
    dataset = [{}] * 4
    jtrainer = JRLOOTrainer(_jax_config(2), jag, lambda p, o: None, dataset)
    opt0 = jax.jit(jtrainer.tx.init)(p0)
    p1, opt1, st1 = jtrainer._train_step(p0, opt0, jrloo.subset_outputs(out, np.array([0, 1])),
                                         jnp.asarray(adv[:2]), None)
    p2, _, st2 = jtrainer._train_step(p1, opt1, jrloo.subset_outputs(out, np.array([2, 3])),
                                      jnp.asarray(adv[2:]), None)
    tx1 = JRLOOTrainer(_jax_config(1), jag, lambda p, o: None, dataset).tx
    p1_gas1 = jax.jit(lambda g, p: optax.apply_updates(p, tx1.update(g, tx1.init(p), p)[0]))(
        opt1.acc_grads, p0)
    sd = lambda tree: tpm_from_jax(jax.device_get(tree))
    jout = jax.device_get(out)
    return dict(family=family, tag=tag, ch=ch, p0=sd(p0), out=_to_port(out_cls, jout), jout=jout,
                adv=adv, st=jax.device_get((st1, st2)), grad=sd(opt1.acc_grads), p2=sd(p2),
                p1_gas1=sd(p1_gas1))


def _port_step(world, gas):
    tpm = _torch_tpm(world["ch"])
    tpm.load_state_dict(world["p0"])
    trainer = RLOOTrainer(_torch_config(_jax_config(gas)), world["tag"], lambda p, o: None,
                          [{}] * 4)
    return trainer, tpm, trainer.make_optimizer(tpm)


def _micro_step(trainer, tpm, opt, world, inds):
    out = rloo.subset_outputs(world["out"], inds)
    return trainer._train_step_impl(tpm, opt, out, t(world["adv"][inds]))


def _close_update(tpm, ref):
    for name, p in tpm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=0, atol=ADAM_TOL * LR,
                                   err_msg=name)


# ---------------------------------------------------------------- (a) the trainer over each family

def _toy_world(family, offload="none", **kw):
    """The port's own toy world of ``family``: CFG on for the UNets, 2
    prompts x rloo_k 2, T steps, 2 updates."""
    config = RLOOConfig(**{**dict(
        per_device_train_batch_size=4, rloo_k=2, max_inference_steps=T, total_episodes=8,
        learning_rate=LR, init_alpha=1.0, init_beta=0.55, offload_cache=offload, seed=3), **kw})
    g = torch.Generator().manual_seed(5)
    if family == "flux":
        fcfg = FluxConfig.toy(**FLUX_KW)
        agent = FluxAgent(Flux(fcfg).init_weights(g).eval(), config,
                          tpm=lambda: TimePredictor(conv_out_channels=4, in_channels=96,
                                                    temb_dim=48, init_alpha=1.0,
                                                    init_beta=0.55),
                          latent_size=8, latent_channels=4)
        widths = {"prompt_embeds": (N_TXT, 32), "pooled_prompt_embeds": (24,)}
    else:
        cls, cfg = ((SD15Agent, UNetConfig.toy(**SD15_KW)) if family == "sd15" else
                    (SDXLAgent, UNetConfig.toy_xl(**XL_KW)))
        agent = cls(UNetSD15(cfg).init_weights(g).eval(), config,
                    tpm=lambda: TimePredictor(conv_out_channels=4, in_channels=16, temb_dim=8,
                                              init_alpha=1.0, init_beta=0.55),
                    guidance_scale=GUIDANCE[family])
        widths = _unet_widths(cfg)
    rng = np.random.default_rng(7)
    rows = [{"prompt": f"p{i}", **{k: v[0] for k, v in _embeds(rng, 1, widths).items()}}
            for i in range(4)]
    return config, agent, rows


def _reward(prompts, outputs):
    s = torch.tanh(outputs.final_latents.float().mean(dim=(1, 2, 3)))
    return s, s


def _moved(tpm0, tpm):
    return {k: (tpm.state_dict()[k] - v).abs().max().item() for k, v in tpm0.items()}


@functools.lru_cache(maxsize=None)
def _two_updates(family, offload):
    config, agent, rows = _toy_world(family, offload)
    trainer = RLOOTrainer(config, agent, _reward, rows)
    tpm = agent.init_tpm_params(torch.Generator().manual_seed(9))
    p0 = {k: v.clone() for k, v in tpm.state_dict().items()}
    tpm, opt = trainer.train(tpm=tpm)
    return trainer.metrics_history, _moved(p0, tpm), opt.count


def _metrics_equal(a, b):
    for ma, mb in zip(a, b):
        assert ma.keys() == mb.keys()
        for k in ma:
            if k != "eps":  # episodes a second of wall time
                assert ma[k] == mb[k], (k, ma[k], mb[k])


@pytest.mark.parametrize("offload", ["none", "host"])
@pytest.mark.parametrize("family", ["sd15", "sdxl", "flux"])
def test_trainer_runs_two_updates(family, offload):
    """Two updates of the family's agent: finite metrics, no skipped step,
    two Adam steps that move the TPM; the host offload's metrics equal the
    run without it."""
    hist, moved, count = _two_updates(family, offload)
    assert len(hist) == 2 and count == 2
    for m in hist:
        assert all(np.isfinite(v) for v in m.values()), m
        assert m["val/num_skipped"] == 0.0 and m["policy/steps_avg"] >= 1
    assert abs(hist[0]["val/ratio"] - 1.0) < 1e-5
    assert 0 < max(moved.values()) <= 1.5 * LR * count
    if offload == "host":
        _metrics_equal(hist, _two_updates(family, "none")[0])


# ---------------------------------------------------------------- (b) the micro-step against JAX

def test_replay_and_micro_step_match_jax(jax_step):
    """The port's replay of the JAX rollout gives its log-probs; the first
    micro-step with accumulation 2 gives JAX's loss, stats and the gradient
    of every TPM parameter, and moves nothing yet."""
    w = jax_step
    out = w["out"]
    assert 1 <= out.num_steps <= T and bool(out.prob_masks.any())
    trainer, tpm, opt = _port_step(w, 2)
    with torch.no_grad():
        close(w["tag"].logprobs(tpm, out), w["jout"].logprobs)
    st = _micro_step(trainer, tpm, opt, w, [0, 1])
    ref = w["st"][0]
    assert st.keys() == ref.keys()
    for k in st:
        close(np.float32(st[k]), ref[k])
    assert st["skipped"] == 0.0 and st["grad_norm"] > 0
    for (name, _), g in zip(tpm.named_parameters(), opt.acc):
        close(g, w["grad"][name])
    for name, p in tpm.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), w["p0"][name].numpy())
    assert opt.count == 0 and opt.mini_step == 1


def test_adam_update_matches_jax(jax_step):
    """Without accumulation one micro-step is one Adam step, JAX's; with
    accumulation 2 the second micro-step applies the mean, JAX's too."""
    w = jax_step
    trainer, tpm, opt = _port_step(w, 1)
    _micro_step(trainer, tpm, opt, w, [0, 1])
    assert opt.count == 1
    _close_update(tpm, w["p1_gas1"])
    trainer, tpm, opt = _port_step(w, 2)
    for inds in ([0, 1], [2, 3]):
        st = _micro_step(trainer, tpm, opt, w, inds)
    for k in st:
        close(np.float32(st[k]), w["st"][1][k])
    assert opt.count == 1 and opt.mini_step == 0
    _close_update(tpm, w["p2"])


# ---------------------------------------------------------------- (c) the ensemble against JAX

ENS_T = 4


@pytest.fixture(scope="module")
def ensemble():
    """Both sides' ensembles over the same toy base and refiner (CFG 5.0,
    real TPMs drawn alike), the batch, and a caller for the JAX rollout
    that always passes step caps (one compiled loop a stage)."""
    ju, uvars, tu = _unet_pair("toy_xl", XL_KW, 70)
    jr, rvars, tr = _unet_pair("toy_refiner", REF_KW, 71)
    jcfg = _jax_config(max_inference_steps=ENS_T)
    cfg = _torch_config(jcfg)
    jens = JSDXLEnsembleAgent(
        JSDXLAgent(ju, uvars, jcfg, tpm=_jax_tpm(8), guidance_scale=5.0),
        JSDXLRefinerAgent(jr, rvars, jcfg, tpm=_jax_tpm(8), guidance_scale=5.0),
        denoising_end=DENOISING_END)
    tens = SDXLEnsembleAgent(SDXLAgent(tu, cfg, guidance_scale=5.0),
                             SDXLRefinerAgent(tr, cfg, guidance_scale=5.0),
                             denoising_end=DENOISING_END)
    jtpm = {"base": _draw_tpm(jens.base.init_tpm_params, 72),
            "refiner": _draw_tpm(jens.refiner.init_tpm_params, 73)}
    tpm = nn.ModuleDict({k: _torch_tpm(8) for k in ("base", "refiner")})
    for k, p in jtpm.items():
        tpm[k].load_state_dict(tpm_from_jax(p))
    rng = np.random.default_rng(74)
    batch = {**_embeds(rng, 4, _unet_widths(tu.config)),
             **_embeds(rng, 4, _unet_widths(tr.config, "refiner_")),
             "latents": rng.standard_normal((4, 4, 8, 8)).astype(np.float32)}
    uncapped = np.full(4, 4 * ENS_T, np.int32)

    def jax_sample(caps=uncapped):
        out = jens.sample(jtpm, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(1), predict=True, step_caps=caps)
        return jax.device_get(out)

    def port_sample(caps=None):
        return tens.sample(tpm, {k: t(v) for k, v in batch.items()}, None, predict=True,
                           step_caps=caps)

    return dict(jens=jens, tens=tens, jtpm=jtpm, tpm=tpm, jax_sample=jax_sample,
                port_sample=port_sample, ref=jax_sample())


def test_ensemble_handoff_matches_jax(ensemble):
    """The stitched integer schedule, masks, handoff t and last valid
    indices equal JAX's to the bit, the ratios at the fp32 bound (the TPM
    reads the UNets' activations, whose summation order differs from
    XLA's: the mode ratios differ from JAX's by an ulp or two); each sample
    hands off below the cutoff and its realised schedule crosses the
    cutoff once."""
    out, ref, agent = ensemble["port_sample"](), ensemble["ref"], ensemble["tens"]
    assert isinstance(out, EnsembleSampleOutput)
    for name in ("times", "prob_masks", "handoff_t", "last_valid_index"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    close(out.ratios, ref.ratios)
    assert out.num_steps == int(ref.num_steps)
    assert agent.t_cut == ensemble["jens"].t_cut == 500 and agent.base_steps == ENS_T
    assert (out.handoff_t < agent.t_cut).all()
    masks, times = out.prob_masks.numpy(), out.times.numpy()
    for i in range(4):
        base_nfe, ref_nfe = int((~masks[i, :ENS_T]).sum()), int((~masks[i, ENS_T:]).sum())
        assert base_nfe >= 1 and out.last_valid_index[i] == base_nfe + ref_nfe - 1
        realised = list(times[i, 1:base_nfe + 1]) + list(times[i, ENS_T + 2:ENS_T + 2 + ref_nfe])
        below = [x < agent.t_cut for x in realised]
        assert below == sorted(below), realised
    assert out.h_cache.shape[0] == out.refiner_h_cache.shape[0] == ENS_T


def test_ensemble_latents_logprobs_and_replay_match_jax(ensemble):
    """The refiner's final latents, the Beta parameters and log-probs at the
    fp32 bound; the replay with the rollout's TPMs gives the rollout's
    log-probs; the caches per expert; zero KL."""
    out, ref, agent, tpm = (ensemble["port_sample"](), ensemble["ref"], ensemble["tens"],
                            ensemble["tpm"])
    for name in ("final_latents", "alphas", "betas", "logprobs", "h_cache", "temb_cache",
                 "refiner_h_cache", "refiner_temb_cache"):
        close(getattr(out, name), np.asarray(getattr(ref, name)))
    lp = agent.logprobs(tpm, out)
    close(lp, ref.logprobs)
    valid = ~out.prob_masks
    close(lp[valid], out.logprobs[valid])
    assert not agent.logprobs(tpm, out).requires_grad
    assert (agent.kl_divergence(out) == 0).all()


def test_ensemble_replay_gradients_match_jax(ensemble):
    """The gradient of a weighted sum of the stitched replay into every
    parameter of both heads, against JAX's replay of each stage (one
    compiled gradient: both heads are the same TPM definition)."""
    out, ref, tpm = ensemble["port_sample"](), ensemble["ref"], ensemble["tpm"]
    weights = np.random.default_rng(75).standard_normal(out.logprobs.shape).astype(np.float32)
    valid = ~np.asarray(ref.prob_masks)
    jtpm = _jax_tpm(8)

    @jax.jit
    @jax.grad
    def jgrad(p, h, temb, ratios, masks, w):
        lp = j_sd15_replay(lambda a, e: jtpm.apply(p, a, e), h, temb, ratios, masks, None)
        return jnp.sum(jnp.where(masks, 0.0, w * lp))

    lp = ensemble["tens"].replay(tpm, out)
    loss = torch.where(t(valid), t(weights) * lp, torch.zeros_like(lp)).sum()
    names = [n for n, _ in tpm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tpm.parameters()))
    for head, cols, cache in (("base", slice(None, ENS_T), ""),
                              ("refiner", slice(ENS_T, None), "refiner_")):
        want = tpm_from_jax(jax.device_get(jgrad(
            ensemble["jtpm"][head], getattr(ref, cache + "h_cache"),
            getattr(ref, cache + "temb_cache"), ref.ratios[:, cols], ref.prob_masks[:, cols],
            weights[:, cols])))
        got = {n.split(".", 1)[1]: g for n, g in zip(names, grads) if n.startswith(head + ".")}
        assert got.keys() == want.keys()
        assert max(g.abs().max().item() for g in got.values()) > 0, head
        for k, g in got.items():
            close(g, want[k])


def test_ensemble_step_caps_split_the_total(ensemble):
    """Caps bound the total NFE with JAX's split, at least one step a
    stage; the capped rollout equals JAX's."""
    caps = np.array([2, 3, 5, 8], np.int32)
    out, ref = ensemble["port_sample"](caps), ensemble["jax_sample"](caps)
    np.testing.assert_array_equal(out.times.numpy(), np.asarray(ref.times))
    np.testing.assert_array_equal(out.prob_masks.numpy(), np.asarray(ref.prob_masks))
    masks = out.prob_masks.numpy()
    assert ((~masks).sum(axis=1) <= caps).all()
    assert ((~masks[:, :ENS_T]).sum(axis=1) >= 1).all()
    assert ((~masks[:, ENS_T:]).sum(axis=1) >= 1).all()
    base, refiner = ensemble["tens"]._split_caps(caps)
    assert base.tolist() == [1, 2, 2, 4] and refiner.tolist() == [1, 1, 3, 4]


def test_ensemble_refusals(ensemble):
    agent = ensemble["tens"]
    with pytest.raises(ValueError, match="sampler configs"):
        agent.sample(ensemble["tpm"], {}, None, sampler_cfg=agent.sampler_cfg)
    for end in (0.0, 1.0, 1.5):
        with pytest.raises(ValueError, match="denoising_end"):
            SDXLEnsembleAgent(agent.base, agent.refiner, denoising_end=end)
    small = SDXLRefinerAgent(UNetSD15(UNetConfig.toy_refiner(**{**REF_KW, "sample_size": 16})),
                             agent.config)
    with pytest.raises(ValueError, match="latent geometry"):
        SDXLEnsembleAgent(agent.base, small)
    with pytest.raises(NotImplementedError, match="item 14"):
        agent.shard(None)
    assert agent.needs_inputs_for_replay is False
    assert agent.sampler_cfg.min_time == 500 and agent.sampler_cfg.cap_floor_time == 499


# ---------------------------------------------------------------- the trainer over the ensemble

def _ensemble_trainer(ensemble, offload="none", **kw):
    base, refiner = ensemble["tens"].base, ensemble["tens"].refiner
    config = RLOOConfig(**{**dict(
        per_device_train_batch_size=4, rloo_k=2, max_inference_steps=ENS_T, total_episodes=8,
        learning_rate=LR, offload_cache=offload, seed=4), **kw})
    factory = lambda: TimePredictor(conv_out_channels=4, in_channels=16, temb_dim=8,
                                    init_alpha=HEAD_BIAS[0], init_beta=HEAD_BIAS[1])
    agent = SDXLEnsembleAgent(SDXLAgent(base.unet, config, tpm=factory, guidance_scale=5.0),
                              SDXLRefinerAgent(refiner.unet, config, tpm=factory,
                                               guidance_scale=5.0),
                              denoising_end=DENOISING_END)
    rng = np.random.default_rng(76)
    widths = {**_unet_widths(base.unet.config),
              **_unet_widths(refiner.unet.config, "refiner_")}
    rows = [{"prompt": f"p{i}", **{k: v[0] for k, v in _embeds(rng, 1, widths).items()}}
            for i in range(4)]
    return RLOOTrainer(config, agent, _reward, rows), agent


def _train_ensemble(ensemble, offload="none", **kw):
    trainer, agent = _ensemble_trainer(ensemble, offload, **kw)
    tpm = agent.init_tpm_params(torch.Generator().manual_seed(8))
    p0 = {k: v.clone() for k, v in tpm.state_dict().items()}
    tpm, opt = trainer.train(tpm=tpm)
    return trainer, tpm, opt, p0


def test_ensemble_two_updates_move_both_heads(ensemble):
    trainer, tpm, opt, p0 = _train_ensemble(ensemble)
    assert len(trainer.metrics_history) == 2 and opt.count == 2
    for m in trainer.metrics_history:
        assert all(np.isfinite(v) for v in m.values()), m
        assert m["objective/kl"] == 0.0 and m["val/num_skipped"] == 0.0
    moved = _moved(p0, tpm)
    for head in ("base", "refiner"):
        assert 0 < max(v for k, v in moved.items() if k.startswith(head + ".")) <= 3 * LR, head


def test_ensemble_host_offload_matches_no_offload(ensemble):
    """The refiner's caches are time-major fields too: sliced on axis 1, a
    micro-batch at a time, the metrics and the trained heads those of the
    run without the offload."""
    kw = dict(per_device_train_batch_size=2, gradient_accumulation_steps=2)
    a, tpm_a, _, _ = _train_ensemble(ensemble, **kw)
    b, tpm_b, _, _ = _train_ensemble(ensemble, "host", **kw)
    assert len(a.metrics_history) == 2
    _metrics_equal(a.metrics_history, b.metrics_history)
    for k, v in tpm_a.state_dict().items():
        assert torch.equal(v, tpm_b.state_dict()[k]), k
    # a micro-batch of the stitched rollout: each cache sliced on its batch axis
    out = ensemble["port_sample"]()
    sub = rloo.subset_outputs(rloo.offload_outputs_to_host(out), [3, 1])
    for name in ("h_cache", "temb_cache", "refiner_h_cache", "refiner_temb_cache"):
        assert torch.equal(getattr(sub, name), getattr(out, name)[:, [3, 1]]), name
    for name in ("times", "ratios", "handoff_t", "last_valid_index"):
        assert torch.equal(getattr(sub, name), getattr(out, name)[[3, 1]]), name


# ---------------------------------------------------------------- (d) checkpoints

def test_ensemble_checkpoint_round_trip(ensemble, tmp_path):
    """Both heads' state, their EMA and Adam's go through the resume state; each head
    has its own file in the reference layout that ``load_tpm_safetensors``
    reads back; a run resumed from update 1 runs update 2 from it. A single
    TPM's ``tpm.safetensors`` is written as before."""
    out_dir = str(tmp_path / "run")
    trainer, tpm, opt, _ = _train_ensemble(ensemble, save_steps=1, output_dir=out_dir,
                                           ema_decay=0.5)
    path = ckpt.latest_checkpoint(out_dir)
    assert path.endswith("checkpoint-2")
    names = sorted(os.listdir(path))
    assert "tpm-base.safetensors" in names and "tpm-refiner.safetensors" in names
    assert ckpt.TPM_FILE not in names
    state = ckpt.restore_checkpoint(path)
    assert state["tpm"].keys() == state["ema"].keys() == tpm.state_dict().keys()
    for k, v in tpm.state_dict().items():
        assert torch.equal(state["tpm"][k], v), k
        assert torch.equal(state["ema"][k], trainer.ema_params[k]), k
    for head in ("base", "refiner"):
        loaded = ckpt.load_tpm_safetensors(os.path.join(path, f"tpm-{head}.safetensors"))
        for k, v in tpm[head].state_dict().items():
            assert torch.equal(loaded[k], v), (head, k)
    assert state["optimizer"]["count"] == opt.count == 2
    # resuming from update 1 loads both heads and Adam's state, then runs
    # update 2 alone
    first = ckpt.restore_checkpoint(os.path.join(out_dir, "checkpoint-1"))
    resumed, agent = _ensemble_trainer(ensemble, save_steps=1,
                                       output_dir=str(tmp_path / "resumed"))
    again, opt2 = resumed.train(tpm=agent.init_tpm_params(torch.Generator().manual_seed(0)),
                                resume_from_checkpoint=os.path.join(out_dir, "checkpoint-1"))
    assert len(resumed.metrics_history) == 1 and opt2.count == 2 and resumed.global_step == 2
    moved = _moved(first["tpm"], again)
    for head in ("base", "refiner"):
        assert 0 < max(v for k, v in moved.items() if k.startswith(head + ".")) <= 1.5 * LR
    # one TimePredictor: its file byte for byte as export_tpm's write of it
    single = tpm["base"].state_dict()
    ckpt.save_checkpoint(str(tmp_path / "single"), 1, single, {})
    safetensors.save_file(export_tpm(single), str(tmp_path / "want.safetensors"))
    written = (tmp_path / "single" / "checkpoint-1" / ckpt.TPM_FILE).read_bytes()
    assert written == (tmp_path / "want.safetensors").read_bytes()
    assert sorted(os.listdir(tmp_path / "single" / "checkpoint-1")).count(ckpt.TPM_FILE) == 1
    with pytest.raises(ValueError, match="TimePredictor"):
        ckpt.tpm_heads({"base.fc1.weight": torch.zeros(1)})
