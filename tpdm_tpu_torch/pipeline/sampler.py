"""The adaptive TPDM sampling loop and the fixed-schedule samplers.

Counterpart of ``tpdm_tpu/pipeline/sampler.py``. The JAX package runs the
adaptive loop as one ``lax.while_loop``; here it is a Python ``for`` over
at most T steps. Each step runs the denoiser (CFG-combined), the TPM, a
Beta mode or draw of the decay ratio, the ratio clamp and the fp32 Euler
(or AB2) step; per-step records land in preallocated (T, b) buffers. A
sample that is done (sigma below ``min_sigma``, or past its step cap) keeps
its last valid latents and is masked in ``prob_masks``.

JAX picks the Δ-cache and guidance-window branches with ``lax.cond`` on the
device. The port runs only the chosen branch, so a reuse step really runs
only the front blocks and a conditional step one forward at batch b; each
decision is a host bool. The loop's one host read a step (the
while-loop's condition) carries the next step's decisions with the
all-done flag: the guidance window on the next sigma, and the input-aware
cache's reuse test. The fixed reuse schedule is host data, and the fixed
samplers decide the window from their host ladder, so neither reads the
device; the input-aware fixed sampler reads one flag a step.

With a sequence-parallel MMDiT every rank of the group runs this loop
together, and a rank that took one step more or less than the others would
wait forever in the ring's collectives. So each step rank 0's
(alpha, beta, ratio) are broadcast and used by every rank: the step count,
the sigmas and (since the MMDiT's outputs are gathered whole) the latents
are then the same on every rank, whatever bits the TPM or the Beta draw
give on each card.

``replay_logprobs`` recomputes the rollout's log-probs from its cached
activations with the current TPM (the PPO replay): only the TPM runs, and
it is differentiable with respect to the TPM.

The JAX loop's pinned-host XLA placement of the cache
(``offload_cache``) has no CUDA counterpart: the trainer moves the cache to
the host after the rollout (``train/rloo.py``, ``offload_cache="host"``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from tpdm_tpu_torch.ops.beta import (
    beta_log_prob,
    beta_mode,
    beta_sample,
    mode_concentration_to_alpha_beta,
)
from tpdm_tpu_torch.ops.flow_euler import flow_euler_step
from tpdm_tpu_torch.ops.flow_solver import flow_ab2_step, flow_heun_combine
from tpdm_tpu_torch.parallel.mesh import SeqGroup
from tpdm_tpu_torch.pipeline.denoise import in_window

INVALID_LOGPROB = 1.0

# denoise_fn(latents (b,c,h,w), sigma (b,)) -> (velocity, temb, h_combined)
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], tuple]
# tpm_fn(h_combined, temb) -> (b, 2) raw (param1, param2)
TpmFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Adaptive-sampler knobs (defaults = the reference's training setup).

    max_inference_steps: the step cap T. min_sigma: the stop threshold.
    epsilon: ratio clamp margin. relative: sigma_next = sigma*ratio (True)
    or sigma - ratio. prediction_type: "alpha_beta" | "mode_concentration".
    predict: Beta mode instead of a draw, and finished samples pin sigma to
    0. cache_activations: keep (h_combined, temb) per step. keep_history:
    keep per-step latents.

    cache_interval: N >= 2 refreshes the Δ-cache every N steps and reuses
    it between (0/1 off). cache_tau: > 0 reuses the Δ-cache while the
    accumulated batch-mean relative L1 change of the latents since the
    last full step stays <= cache_tau (exclusive with cache_interval).
    ``TPDMPipeline.generate`` builds ``adaptive_sample``'s ``cached`` from
    them; the loop follows ``cached``. guidance_interval: (lo, hi), CFG
    only while sigma is in [lo, hi); the denoiser must come from an
    interval builder of ``pipeline/denoise.py`` with the same window (the
    loop passes it the host decision ``guided``).
    solver: "euler" or "ab2" (two-step Adams–Bashforth at one model
    evaluation a step; the first step is Euler).
    """

    max_inference_steps: int = 28
    min_sigma: float = 0.001
    epsilon: float = 1e-3
    relative: bool = True
    prediction_type: str = "alpha_beta"
    predict: bool = False
    cache_activations: bool = True
    keep_history: bool = False
    cache_interval: int = 0
    cache_tau: float = 0.0
    guidance_interval: Optional[tuple] = None
    solver: str = "euler"


class CachedDenoise(NamedTuple):
    """The Δ-cache pair of the adaptive loop.

    full_fn / reuse_fn: ``(latents, sigma, delta[, guided]) -> (velocity,
    temb, h_combined, delta)`` (``guided`` with a guidance window), from
    ``pipeline/denoise.py``. ``reuse_steps[t]`` True: step t reuses the
    cached Δ (host bools, ``cache_reuse_schedule``). ``tau``: the
    input-aware policy (``SamplerConfig.cache_tau``) in place of
    ``reuse_steps``: reuse while the batch-mean relative L1 change of the
    latents accumulated since the last full step stays <= tau (step 0 is
    always full; a full step resets the sum).
    """

    full_fn: Callable
    reuse_fn: Callable
    init_delta: object
    reuse_steps: Sequence[bool]
    tau: Optional[float] = None


def _latent_rel_change(lat: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Batch-mean relative L1 change |x_t - x_{t-1}|_1 / |x_{t-1}|_1, in
    fp32: the input-aware cache's signal."""
    lat32, prev32 = lat.to(torch.float32), prev.to(torch.float32)
    return (lat32 - prev32).abs().mean() / (prev32.abs().mean() + 1e-8)


def cache_reuse_schedule(T: int, interval: int) -> list[bool]:
    """Reuse flags of T steps: a full forward every ``interval`` steps
    (step 0 always full), the cached Δ between; all False below 2."""
    return [interval >= 2 and i % interval != 0 for i in range(T)]


def check_adaptive_solver(solver: str) -> None:
    if solver not in ("euler", "ab2"):
        raise ValueError(
            f"adaptive sampler supports solver 'euler' or 'ab2', got {solver!r} "
            "(heun/midpoint need a second model eval per step — fixed-schedule only)")


class SampleOutput(NamedTuple):
    """Rollout record: per-step stats batch-major (b, T), caches time-major."""

    init_noise_latents: torch.Tensor  # (b, c, h, w)
    final_latents: torch.Tensor  # (b, c, h, w) after each sample's last valid step
    sigmas: torch.Tensor  # (b, T) sigma_next recorded each step
    logprobs: torch.Tensor  # (b, T), INVALID_LOGPROB where masked
    prob_masks: torch.Tensor  # (b, T) bool, True = step invalid (was done)
    alphas: torch.Tensor  # (b, T)
    betas: torch.Tensor  # (b, T)
    num_steps: int  # loop iterations executed
    last_valid_index: torch.Tensor  # (b,) int32
    h_cache: Optional[torch.Tensor]  # (T, b, 2*inner, gh, gw) or None
    temb_cache: Optional[torch.Tensor]  # (T, b, inner) or None
    history_latents: Optional[torch.Tensor]  # (T, b, c, h, w) or None


def _raw_to_alpha_beta(raw: torch.Tensor, prediction_type: str):
    p1, p2 = raw[:, 0], raw[:, 1]
    if prediction_type == "alpha_beta":
        return p1, p2
    if prediction_type == "mode_concentration":
        return mode_concentration_to_alpha_beta(p1, p2)
    raise ValueError(f"unknown prediction_type: {prediction_type}")


def _clamp_ratio(ratio: torch.Tensor, sigma: torch.Tensor, cfg: SamplerConfig):
    if cfg.relative:
        return torch.clamp(ratio, cfg.epsilon, 1.0 - cfg.epsilon)
    # absolute: clamp to [eps, sigma], then to [0, 1 - eps]
    ratio = torch.minimum(torch.clamp(ratio, min=cfg.epsilon), sigma)
    return torch.clamp(ratio, 0.0, 1.0 - cfg.epsilon)


@torch.no_grad()
def adaptive_sample(
    denoise_fn: Optional[DenoiseFn],
    tpm_fn: TpmFn,
    init_latents: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: SamplerConfig,
    step_caps: Optional[torch.Tensor] = None,
    init_sigma: Optional[torch.Tensor] = None,
    group: Optional[SeqGroup] = None,
    cached: Optional[CachedDenoise] = None,
    project_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
) -> SampleOutput:
    """Run the adaptive, self-terminating denoise loop.

    Args:
        generator: draws the Beta ratios (unused when ``cfg.predict``).
        step_caps: optional (b,) per-sample step caps; None = T for all.
        init_sigma: optional (b,) starting noise levels (default 1.0). With
            a guidance window the first step's decision is taken from it
            on the host (a CUDA tensor is copied there once).
        group: the seq group of a sequence-parallel denoiser, whose ranks
            all call this with the same arguments; rank 0's ratios are used.
        cached: the Δ-cache pair; ``denoise_fn`` is then unused (may be
            None), and each step runs full_fn or reuse_fn with Δ carried
            from step to step.
        project_fn: optional ``(latents (b,c,h,w), sigma_next (b,)) ->
            latents``, applied after each step's update and before the done
            mask keeps finished samples (inpainting re-imposes the known
            region at the new noise level).
    """
    b = init_latents.shape[0]
    T = cfg.max_inference_steps
    dtype, device = init_latents.dtype, init_latents.device
    check_adaptive_solver(cfg.solver)
    if not cfg.predict and generator is None:
        raise ValueError("drawing ratios (predict=False) needs a generator")
    caps = torch.full((b,), T, dtype=torch.int32, device=device)
    if step_caps is not None:
        caps = torch.minimum(torch.as_tensor(step_caps, device=device).to(torch.int32), caps)
    sigma = (
        torch.ones(b, dtype=torch.float32, device=device)
        if init_sigma is None
        else torch.as_tensor(init_sigma, device=device).to(torch.float32).reshape(b)
    )

    f32 = dict(dtype=torch.float32, device=device)
    sigmas = torch.zeros(T, b, **f32)
    logprobs = torch.full((T, b), INVALID_LOGPROB, **f32)
    masks = torch.ones(T, b, dtype=torch.bool, device=device)
    alphas = torch.ones(T, b, **f32)
    betas = torch.ones(T, b, **f32)
    h_cache = temb_cache = history = None
    if cfg.keep_history:
        history = torch.zeros((T,) + tuple(init_latents.shape), dtype=dtype, device=device)

    window = cfg.guidance_interval
    tau = None if cached is None else cached.tau
    ab2 = cfg.solver == "ab2"
    # the next step's host decisions: the first step's window test runs on
    # a host copy of the starting sigmas; step 0 is always a full forward
    guided, reuse = False, False
    if window is not None:
        sigma0 = (torch.ones(b) if init_sigma is None
                  else torch.as_tensor(init_sigma).to("cpu", torch.float32).reshape(b))
        guided = bool(in_window(sigma0.to(dtype), window))
    if cached is not None:
        delta = cached.init_delta
    if ab2:
        # sigma_prev starts at sigma0, so the first step has h_prev 0: Euler
        v_prev, sigma_prev = torch.zeros_like(init_latents), sigma
    if tau is not None:
        acc = torch.zeros((), **f32)

    latents = last_valid = init_latents
    bcast = (b,) + (1,) * (init_latents.dim() - 1)
    num_steps = 0
    for step in range(T):
        extra = () if window is None else (guided,)
        if cached is not None:
            if tau is None:
                reuse = cached.reuse_steps[step]
            fn = cached.reuse_fn if reuse else cached.full_fn
            velocity, temb, h_comb, delta = fn(latents, sigma.to(dtype), delta, *extra)
        else:
            velocity, temb, h_comb = denoise_fn(latents, sigma.to(dtype), *extra)
        raw = tpm_fn(h_comb, temb)
        alpha, beta = _raw_to_alpha_beta(raw.float(), cfg.prediction_type)
        ratio = beta_mode(alpha, beta) if cfg.predict else beta_sample(generator, alpha, beta)
        ratio = _clamp_ratio(ratio, sigma, cfg)
        if group is not None and group.size > 1:
            shared = torch.stack([alpha, beta, ratio.float()])
            dist.broadcast(shared, src=group.global_rank(0), group=group.group)
            alpha, beta, ratio = shared.unbind(0)

        sigma_next = sigma * ratio if cfg.relative else sigma - ratio
        logprob = beta_log_prob(alpha, beta, ratio)
        # done BEFORE this step -> the step is invalid for that sample
        done = (sigma < cfg.min_sigma) | (step >= caps)
        if cfg.predict:
            sigma_next = torch.where(done, torch.zeros_like(sigma_next), sigma_next)
        if ab2:
            new_latents = flow_ab2_step(velocity, v_prev, sigma_next, sigma, sigma_prev, latents)
            v_prev, sigma_prev = velocity, sigma
        else:
            new_latents = flow_euler_step(velocity, sigma_next, sigma, latents)
        if project_fn is not None:
            new_latents = project_fn(new_latents, sigma_next)
        last_valid = torch.where(done.reshape(bcast), last_valid, new_latents)

        sigmas[step] = sigma_next
        logprobs[step] = torch.where(done, torch.full_like(logprob, INVALID_LOGPROB), logprob)
        masks[step] = done
        alphas[step] = alpha
        betas[step] = beta
        if cfg.cache_activations:
            if h_cache is None:
                h_cache = torch.zeros((T,) + tuple(h_comb.shape), dtype=h_comb.dtype,
                                      device=device)
                temb_cache = torch.zeros((T,) + tuple(temb.shape), dtype=temb.dtype,
                                         device=device)
            h_cache[step] = h_comb
            temb_cache[step] = temb
        if history is not None:
            history[step] = new_latents

        # the next step's decisions, read with the all-done flag
        flags = [((sigma_next < cfg.min_sigma) | (step + 1 >= caps)).all()]
        if window is not None:
            flags.append(in_window(sigma_next.to(dtype), window))
        if tau is not None:
            # a full step resets the sum; a reuse step keeps integrating
            acc = (acc if reuse else torch.zeros_like(acc)) + _latent_rel_change(
                new_latents, latents)
            flags.append(acc <= tau)
        all_done, *decisions = torch.stack(flags).tolist()  # the step's one host read
        if window is not None:
            guided = decisions.pop(0)
        if tau is not None:
            reuse = decisions.pop(0)
        latents, sigma = new_latents, sigma_next
        num_steps = step + 1
        if all_done:
            break

    masks_bt = masks.T
    idx = torch.arange(T, device=device)[None, :]
    last_valid_index = torch.where(~masks_bt, idx, -1).amax(dim=1).to(torch.int32)
    return SampleOutput(
        init_noise_latents=init_latents,
        final_latents=last_valid,
        sigmas=sigmas.T,
        logprobs=logprobs.T,
        prob_masks=masks_bt,
        alphas=alphas.T,
        betas=betas.T,
        num_steps=num_steps,
        last_valid_index=last_valid_index,
        h_cache=h_cache,
        temb_cache=temb_cache,
        history_latents=history,
    )


def replay_logprobs(
    tpm_fn: TpmFn,
    h_cache: torch.Tensor,  # (T, b, 2*inner, gh, gw)
    temb_cache: torch.Tensor,  # (T, b, inner)
    fix_sigmas: torch.Tensor,  # (b, T), the rollout's recorded sigmas
    cfg: SamplerConfig,
    init_sigma: Optional[torch.Tensor] = None,  # (b,) rollout starting sigmas
) -> torch.Tensor:
    """Per-step log-probs of the recorded ratios under the current TPM.

    Counterpart of ``tpdm_tpu/pipeline/sampler.py:replay_logprobs``: the
    TPM runs on each step's cached activations and the ratio is rebuilt
    from the recorded sigma chain. Returns (b, T), INVALID_LOGPROB where a
    sample was done. Differentiable with respect to the TPM: run it with
    grad mode on. Steps after the rollout's last carry sigma == 0, which
    ``replay_step_logprob`` masks without a NaN in the gradient.
    """
    b, T = fix_sigmas.shape
    sigma = (
        torch.ones(b, dtype=torch.float32, device=fix_sigmas.device)
        if init_sigma is None
        else torch.as_tensor(init_sigma, device=fix_sigmas.device).to(torch.float32).reshape(b)
    )
    logprobs = []
    for step in range(T):
        sigma_next = fix_sigmas[:, step]
        raw = tpm_fn(h_cache[step], temb_cache[step])
        logprobs.append(replay_step_logprob(raw, sigma, sigma_next, cfg))
        sigma = sigma_next
    return torch.stack(logprobs, dim=1)


def replay_step_logprob(raw: torch.Tensor, sigma: torch.Tensor, sigma_next: torch.Tensor,
                        cfg: SamplerConfig) -> torch.Tensor:
    """(b,) log-prob of the recorded step sigma -> sigma_next under the TPM
    output ``raw``, INVALID_LOGPROB where the sample was already done. A
    done sample's sigma is made safe before the division and the log-prob,
    since ``torch.where`` alone would let a NaN of the masked branch into
    the gradient."""
    alpha, beta = _raw_to_alpha_beta(raw.float(), cfg.prediction_type)
    done = sigma < cfg.min_sigma
    safe_sigma = torch.where(done, torch.ones_like(sigma), sigma)
    ratio = sigma_next / safe_sigma if cfg.relative else sigma - sigma_next
    ratio = torch.clamp(ratio, cfg.epsilon, 1.0 - cfg.epsilon)
    ratio = torch.where(done, torch.full_like(ratio, 0.5), ratio)
    logprob = beta_log_prob(alpha, beta, ratio)
    return torch.where(done, torch.full_like(logprob, INVALID_LOGPROB), logprob)


# ---------------------------------------------------------------------------
# Fixed-schedule samplers (no TPM): the baseline the adaptive schedule is
# measured against. Each takes the (T,) descending ladder without its
# terminal zero (``ops/schedules.py:uniform_flow_sigmas``), read on the host;
# the last step goes to sigma 0. Every denoiser call takes sigma as a (b,)
# tensor in the latents' dtype, and every update runs in fp32. With
# ``guidance_interval`` the denoiser is an interval builder's, and each call
# gets the host decision ``guided`` for the sigma it is given.
# ---------------------------------------------------------------------------

FLOW_SOLVERS = ("euler", "heun", "midpoint", "ab2")


def solver_nfe(num_steps: int, solver: str) -> int:
    """Model evaluations of a fixed-schedule run: euler and ab2 T, midpoint
    2T, heun 2T - 1 (its last step, to sigma 0, is Euler)."""
    return {"euler": num_steps, "ab2": num_steps, "midpoint": 2 * num_steps,
            "heun": 2 * num_steps - 1}[solver]


class _Ladder:
    """The host ladder with its terminal 0, and per-call sigma tensors.

    ``at(i)`` is sigma_i as a (b,) fp32 tensor on the latents' device (a
    fill: no copy from the host); ``call(fn, latents, s, *args)`` runs the
    denoiser at the fp32 value ``s``, passing sigma in the latents' dtype
    and, with a window, the host decision for it.
    """

    def __init__(self, sigmas, init_latents, guidance_interval):
        sig = torch.as_tensor(sigmas).to("cpu", torch.float32)
        self.values = torch.cat([sig, sig.new_zeros(1)]).tolist()
        self.b, self.dtype = init_latents.shape[0], init_latents.dtype
        self.device = init_latents.device
        self.window = guidance_interval

    def __len__(self):
        return len(self.values) - 1

    def at(self, i: int) -> torch.Tensor:
        return self.full(self.values[i])

    def full(self, value: float) -> torch.Tensor:
        return torch.full((self.b,), value, dtype=torch.float32, device=self.device)

    def call(self, fn, latents, value: float, *args):
        extra = ()
        if self.window is not None:
            host = torch.tensor(value, dtype=torch.float32).to(self.dtype)
            extra = (bool(in_window(host, self.window)),)
        return fn(latents, self.full(value).to(self.dtype), *args, *extra)


@torch.no_grad()
def fixed_schedule_sample(denoise_fn: Callable, init_latents: torch.Tensor, sigmas,
                          guidance_interval: Optional[tuple] = None) -> torch.Tensor:
    """Fixed-schedule Euler: ``denoise_fn(latents, sigma[, guided])``
    returns the guided velocity."""
    lad = _Ladder(sigmas, init_latents, guidance_interval)
    latents = init_latents
    for i in range(len(lad)):
        velocity = lad.call(denoise_fn, latents, lad.values[i])
        latents = flow_euler_step(velocity, lad.at(i + 1), lad.at(i), latents)
    return latents


@torch.no_grad()
def fixed_schedule_sample_heun(denoise_fn: Callable, init_latents: torch.Tensor, sigmas,
                               guidance_interval: Optional[tuple] = None) -> torch.Tensor:
    """Heun (explicit trapezoid): an Euler prediction to sigma_next, the
    velocity there, the trapezoid corrector. The step to sigma 0 stays
    Euler (no evaluation at zero noise), so T steps cost 2T - 1
    evaluations."""
    lad = _Ladder(sigmas, init_latents, guidance_interval)
    latents = init_latents
    for i in range(len(lad)):
        s, s_next = lad.at(i), lad.at(i + 1)
        v0 = lad.call(denoise_fn, latents, lad.values[i])
        pred = flow_euler_step(v0, s_next, s, latents)
        if lad.values[i + 1] > 0.0:
            v1 = lad.call(denoise_fn, pred, lad.values[i + 1])
            pred = flow_heun_combine(v0, v1, s_next, s, latents)
        latents = pred
    return latents


@torch.no_grad()
def fixed_schedule_sample_midpoint(denoise_fn: Callable, init_latents: torch.Tensor, sigmas,
                                   guidance_interval: Optional[tuple] = None) -> torch.Tensor:
    """Explicit midpoint: 2T evaluations, none at sigma 0 (the last step's
    midpoint is sigma/2)."""
    lad = _Ladder(sigmas, init_latents, guidance_interval)
    latents = init_latents
    for i in range(len(lad)):
        s, s_next = lad.at(i), lad.at(i + 1)
        # the midpoint in fp32, as the JAX sampler computes it
        ends = torch.tensor(lad.values[i : i + 2], dtype=torch.float32)
        mid = (0.5 * (ends[0] + ends[1])).item()
        v0 = lad.call(denoise_fn, latents, lad.values[i])
        x_mid = flow_euler_step(v0, lad.full(mid), s, latents)
        v1 = lad.call(denoise_fn, x_mid, mid)
        latents = flow_euler_step(v1, s_next, s, latents)
    return latents


@torch.no_grad()
def fixed_schedule_sample_ab2(denoise_fn: Callable, init_latents: torch.Tensor, sigmas,
                              guidance_interval: Optional[tuple] = None) -> torch.Tensor:
    """Two-step Adams–Bashforth: second order at one evaluation a step, the
    previous velocity carried; the first step is Euler (h_prev = 0)."""
    lad = _Ladder(sigmas, init_latents, guidance_interval)
    latents, v_prev = init_latents, torch.zeros_like(init_latents)
    for i in range(len(lad)):
        v = lad.call(denoise_fn, latents, lad.values[i])
        latents = flow_ab2_step(v, v_prev, lad.at(i + 1), lad.at(i), lad.at(max(i - 1, 0)),
                                latents)
        v_prev = v.to(v_prev.dtype)
    return latents


def fixed_schedule_sample_solver(denoise_fn: Callable, init_latents: torch.Tensor, sigmas,
                                 solver: str = "euler",
                                 guidance_interval: Optional[tuple] = None) -> torch.Tensor:
    """A fixed-schedule run with the named solver (one of FLOW_SOLVERS)."""
    fns = {"euler": fixed_schedule_sample, "heun": fixed_schedule_sample_heun,
           "midpoint": fixed_schedule_sample_midpoint, "ab2": fixed_schedule_sample_ab2}
    if solver not in fns:
        raise ValueError(f"unknown flow solver {solver!r}; pick from {FLOW_SOLVERS}")
    return fns[solver](denoise_fn, init_latents, sigmas, guidance_interval)


@torch.no_grad()
def fixed_schedule_sample_cached(full_fn: Callable, reuse_fn: Callable,
                                 init_latents: torch.Tensor, sigmas, init_delta,
                                 reuse_steps: Sequence[bool],
                                 guidance_interval: Optional[tuple] = None) -> torch.Tensor:
    """Δ-cache Euler: step i runs ``reuse_fn`` where ``reuse_steps[i]``
    (host bools, ``cache_reuse_schedule``), else ``full_fn``; each is
    ``(latents, sigma, delta[, guided]) -> (velocity, delta)``."""
    lad = _Ladder(sigmas, init_latents, guidance_interval)
    latents, delta = init_latents, init_delta
    for i in range(len(lad)):
        fn = reuse_fn if reuse_steps[i] else full_fn
        velocity, delta = lad.call(fn, latents, lad.values[i], delta)
        latents = flow_euler_step(velocity, lad.at(i + 1), lad.at(i), latents)
    return latents


@torch.no_grad()
def fixed_schedule_sample_autocached(full_fn: Callable, reuse_fn: Callable,
                                     init_latents: torch.Tensor, sigmas, init_delta,
                                     tau: float, guidance_interval: Optional[tuple] = None):
    """Input-aware Δ-cache Euler: the batch-mean relative L1 change of the
    latents is summed since the last full step, and a step reuses the
    cache while the sum stays <= ``tau`` (step 0 always full; tau 0 is the
    uncached sampler). The decision is read on the host, one read a step
    from the second on. Returns ``(latents, n_full)``, n_full the full
    forwards taken."""
    lad = _Ladder(sigmas, init_latents, guidance_interval)
    latents, delta = init_latents, init_delta
    acc = torch.zeros((), dtype=torch.float32, device=init_latents.device)
    prev, n_full = init_latents, 0
    for i in range(len(lad)):
        reuse = False
        if i > 0:
            acc = acc + _latent_rel_change(latents, prev)
            reuse = bool(acc <= tau)
        if not reuse:
            acc, n_full = torch.zeros_like(acc), n_full + 1
        velocity, delta = lad.call(reuse_fn if reuse else full_fn, latents, lad.values[i], delta)
        prev, latents = latents, flow_euler_step(velocity, lad.at(i + 1), lad.at(i), latents)
    return latents, n_full
