"""SD1.5 adaptive sampler: integer-timestep TPM scheduling over DPM-Solver++.

Counterpart of ``tpdm_tpu/pipeline/sd15_sampler.py`` (the reference's
``SD15PredictNextTimeStepModel.forward`` loop):

- t starts at 999 (or each sample's ``init_t``); each step the TPM's Beta
  ratio decays it, t_next = int(t·ratio) (truncation, as torch's int-tensor
  assignment in the reference), with t_next = 0 and the sample masked once
  t < min_time;
- multistep DPM-Solver++ with per-sample sigmas from the DDPM table
  (``ops/dpm_solver.py``): sigma_s0 = sigmas[t], sigma_s1 = sigmas[t_prev],
  sigma_t = sigmas[t_next], forced to 0 on the cap step (integrate to x0);
- the first-order update on step 0, on finished samples and on the cap
  step, the second-order one elsewhere, picked per sample.

JAX runs the loop as one ``lax.while_loop``; here it is a Python loop over
at most T steps with one host read a step, as ``pipeline/sampler.py``'s
SD3 loop: the all-done flag, read with the next step's host decisions (the
guidance window on the next t, the input-aware DeepCache's reuse test).
The guidance window and the DeepCache branch run only the chosen branch;
JAX takes them with ``lax.cond`` on the device.

``sd15_replay_logprobs`` recomputes the rollout's log-probs from its
cached activations with the current TPM: only the TPM runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from tpdm_tpu_torch.ops.beta import beta_log_prob, beta_mode, beta_sample
from tpdm_tpu_torch.ops.dpm_solver import (
    ddpm_sigmas_from_betas,
    dpm_first_order_update,
    dpm_second_order_update,
    epsilon_to_x0,
)
from tpdm_tpu_torch.pipeline.denoise import in_window
from tpdm_tpu_torch.pipeline.sampler import (
    INVALID_LOGPROB,
    CachedDenoise,
    _latent_rel_change,
)


@dataclasses.dataclass(frozen=True)
class SD15SamplerConfig:
    """The SD1.5 loop's knobs (defaults = the reference's).

    num_inference_steps: the step cap T. min_time: the stop threshold in
    integer t. epsilon: the ratio clamp margin. predict: Beta mode instead
    of a draw. solver_type: "midpoint" or "heun" (DPM-Solver++(2M)).
    cache_activations / keep_history: keep (h_combined, temb) / the latents
    of each step. cap_floor_time: a capped sample's last step lands on this
    t (< min_time) instead of x0 (the SDXL ensemble's base stage).
    cache_interval: DeepCache, the deep feature refreshed every N >= 2
    steps; cache_tau > 0: the input-aware reuse policy instead (exclusive
    with cache_interval). guidance_interval: (t_lo, t_hi), CFG only while
    t is in [t_lo, t_hi); the denoiser must come from an interval builder
    of ``train/sd15_agent.py`` (the loop passes it the host decision
    ``guided``).
    """

    num_inference_steps: int = 25
    min_time: int = 10
    epsilon: float = 1e-3
    predict: bool = False
    solver_type: str = "midpoint"
    cache_activations: bool = True
    keep_history: bool = False
    cap_floor_time: Optional[int] = None
    cache_interval: int = 0
    cache_tau: float = 0.0
    guidance_interval: Optional[tuple] = None


class SD15SampleOutput(NamedTuple):
    final_latents: torch.Tensor  # (b, 4, h, w) after each sample's last valid step
    times: torch.Tensor  # (b, T+1) int32, the starting t first
    ratios: torch.Tensor  # (b, T) the policy's actions
    logprobs: torch.Tensor  # (b, T), INVALID_LOGPROB where masked
    prob_masks: torch.Tensor  # (b, T) bool, True = step invalid (was done)
    alphas: torch.Tensor
    betas: torch.Tensor
    num_steps: int  # loop iterations executed
    last_valid_index: torch.Tensor  # (b,) int32
    h_cache: Optional[torch.Tensor]  # (T, b, 2 ch0, h, w)
    temb_cache: Optional[torch.Tensor]  # (T, b, ch0)
    history_latents: Optional[torch.Tensor]  # (T, b, 4, h, w)


def _host_window(t: torch.Tensor, window) -> bool:
    lo, hi = window
    t = t.to("cpu", torch.float32)
    return bool(((t >= lo) & (t < hi)).any())


@torch.no_grad()
def sd15_adaptive_sample(
    denoise_fn: Optional[Callable],
    tpm_fn: Callable,
    init_latents: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: SD15SamplerConfig,
    step_caps: Optional[torch.Tensor] = None,
    init_t: Optional[torch.Tensor] = None,
    cached: Optional[CachedDenoise] = None,
) -> SD15SampleOutput:
    """Run the integer-t adaptive loop.

    Args:
        denoise_fn: ``(latents, t fp32 (b,)[, guided]) -> (eps, temb,
            h_combined)``; unused (may be None) with ``cached``.
        tpm_fn: ``(h_combined, temb) -> (b, 2)`` raw (alpha, beta).
        generator: draws the Beta ratios (unused with ``cfg.predict``).
        step_caps: optional (b,) per-sample caps: sample i's step
            ``caps[i] - 1`` is its last, t_next forced to 0 (or to
            ``cap_floor_time``).
        init_t: optional (b,) int starting timesteps (default 999): the
            integer-t img2img entry, with latents DDPM-noised to t0. A
            sample starting below ``min_time`` takes no valid step.
        cached: the DeepCache pair (``pipeline/sampler.py:CachedDenoise``,
            fns ``(latents, t, cache[, guided]) -> (eps, temb, h, cache)``).
    """
    b = init_latents.shape[0]
    T = cfg.num_inference_steps
    dtype, device = init_latents.dtype, init_latents.device
    if cfg.cap_floor_time is not None and cfg.cap_floor_time >= cfg.min_time:
        raise ValueError(f"cap_floor_time ({cfg.cap_floor_time}) must be < min_time "
                         f"({cfg.min_time}) or the capped sample never terminates")
    if not cfg.predict and generator is None:
        raise ValueError("drawing ratios (predict=False) needs a generator")
    table = ddpm_sigmas_from_betas(device=device)
    caps = torch.full((b,), T, dtype=torch.int32, device=device)
    if step_caps is not None:
        caps = torch.minimum(torch.as_tensor(step_caps, device=device).to(torch.int32), caps)
    t0 = (torch.full((b,), 999, dtype=torch.int32, device=device) if init_t is None
          else torch.as_tensor(init_t, device=device).to(torch.int32).reshape(b))

    f32 = dict(dtype=torch.float32, device=device)
    times = torch.zeros(T + 1, b, dtype=torch.int32, device=device)
    times[0] = t0
    ratios = torch.zeros(T, b, **f32)
    logprobs = torch.full((T, b), INVALID_LOGPROB, **f32)
    masks = torch.ones(T, b, dtype=torch.bool, device=device)
    alphas = torch.ones(T, b, **f32)
    betas = torch.ones(T, b, **f32)
    h_cache = temb_cache = history = None
    if cfg.keep_history:
        history = torch.zeros((T,) + tuple(init_latents.shape), dtype=dtype, device=device)

    window = cfg.guidance_interval
    tau = None if cached is None else cached.tau
    guided = _host_window(t0, window) if window is not None else False
    reuse = False
    if cached is not None:
        cache = cached.init_delta
    if tau is not None:
        acc = torch.zeros((), **f32)

    latents = last_valid = init_latents
    t, t_prev = t0, t0
    x0_prev = torch.zeros_like(init_latents, dtype=torch.float32)
    bcast = (b,) + (1,) * (init_latents.dim() - 1)
    num_steps = 0
    for step in range(T):
        extra = () if window is None else (guided,)
        tf = t.to(torch.float32)
        if cached is not None:
            if tau is None:
                reuse = cached.reuse_steps[step]
            fn = cached.reuse_fn if reuse else cached.full_fn
            eps, temb, h_comb, cache = fn(latents, tf, cache, *extra)
        else:
            eps, temb, h_comb = denoise_fn(latents, tf, *extra)

        raw = tpm_fn(h_comb, temb).float()
        alpha, beta = raw[:, 0], raw[:, 1]
        ratio = beta_mode(alpha, beta) if cfg.predict else beta_sample(generator, alpha, beta)
        ratio = torch.clamp(ratio, cfg.epsilon, 1.0 - cfg.epsilon)
        # torch's `t_next[i] = t[i] * ratio` into an int tensor truncates
        t_next = (tf * ratio).to(torch.int32)
        logprob = beta_log_prob(alpha, beta, ratio)
        done = t < cfg.min_time
        cap_now = step >= caps - 1
        zero = torch.zeros_like(t_next)
        if cfg.cap_floor_time is None:
            t_next = torch.where(done | cap_now, zero, t_next)
        else:
            t_next = torch.where(cap_now, torch.full_like(t_next, cfg.cap_floor_time), t_next)
            t_next = torch.where(done, zero, t_next)

        # the per-sample DPM-Solver++ step, in fp32
        lat32 = latents.float()
        sigma_s0, sigma_s1 = table[t.long()], table[t_prev.long()]
        sigma_next = table[t_next.long()]
        if cfg.cap_floor_time is None:
            # the cap step integrates to x0
            to_x0 = cap_now | (step == T - 1)
        else:
            # done samples' updates are discarded (last_valid keeps them)
            to_x0 = done
        sigma_t = torch.where(to_x0, torch.zeros_like(sigma_next), sigma_next)
        x0 = epsilon_to_x0(eps.float(), lat32, sigma_s0)
        first = dpm_first_order_update(x0, lat32, sigma_t, sigma_s0)
        second = dpm_second_order_update(x0, x0_prev, lat32, sigma_t, sigma_s0, sigma_s1,
                                         solver_type=cfg.solver_type)
        # first order on step 0 (no history), on finished samples and on the
        # cap step, where sigma_t = 0 would divide the second-order term by 0
        use_first = (t_next == 0) | (step == 0) | (step == T - 1)
        new_latents = torch.where(use_first.reshape(bcast), first, second).to(dtype)
        last_valid = torch.where(done.reshape(bcast), last_valid, new_latents)

        times[step + 1] = t_next
        ratios[step] = ratio
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
        flags = [(t_next == 0).all()]
        if window is not None:
            flags.append(in_window(t_next.float(), window))
        if tau is not None:
            acc = (acc if reuse else torch.zeros_like(acc)) + _latent_rel_change(
                new_latents, latents)
            flags.append(acc <= tau)
        all_done, *decisions = torch.stack(flags).tolist()  # the step's one host read
        if window is not None:
            guided = decisions.pop(0)
        if tau is not None:
            reuse = decisions.pop(0)
        latents, t_prev, t, x0_prev = new_latents, t, t_next, x0
        num_steps = step + 1
        if all_done:
            break

    masks_bt = masks.T
    idx = torch.arange(T, device=device)[None, :]
    last_valid_index = torch.where(~masks_bt, idx, -1).amax(dim=1).to(torch.int32)
    return SD15SampleOutput(
        final_latents=last_valid,
        times=times.T,
        ratios=ratios.T,
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


def sd15_replay_logprobs(
    tpm_fn: Callable,
    h_cache: torch.Tensor,
    temb_cache: torch.Tensor,
    ratios: torch.Tensor,  # (b, T) the recorded actions
    prob_masks: torch.Tensor,  # (b, T)
    cfg: SD15SamplerConfig,
) -> torch.Tensor:
    """(b, T) log-probs of the recorded ratios under the current TPM, from
    the cached activations (the frozen UNet's inputs are pinned, so its
    activations are the rollout's). Differentiable with respect to the TPM
    (run with grad mode on). Unexecuted steps carry ratio 0: the ratio is
    made safe before the log-prob, as ``torch.where`` alone would let the
    masked branch's NaN into the gradient."""
    out = []
    for step in range(ratios.shape[1]):
        raw = tpm_fn(h_cache[step], temb_cache[step]).float()
        mask = prob_masks[:, step]
        ratio = torch.where(mask, torch.full_like(ratios[:, step], 0.5), ratios[:, step])
        lp = beta_log_prob(raw[:, 0], raw[:, 1], ratio)
        out.append(torch.where(mask, torch.full_like(lp, INVALID_LOGPROB), lp))
    return torch.stack(out, dim=1)
