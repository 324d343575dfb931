"""The adaptive TPDM sampling loop.

Counterpart of ``tpdm_tpu/pipeline/sampler.py:adaptive_sample``. The JAX
package runs the loop as one ``lax.while_loop``; here it is a Python ``for``
over at most T steps whose only host sync is the all-done exit check, one
``.item()`` a step (the while-loop's condition). Each step runs the denoiser
(CFG-combined), the TPM, a Beta mode or draw of the decay ratio, the ratio
clamp and the fp32 Euler step; per-step records land in preallocated (T, b)
buffers. A sample that is done (sigma below ``min_sigma``, or past its step
cap) keeps its last valid latents and is masked in ``prob_masks``.

Not ported yet: the Δ-cache (``cache_interval``/``cache_tau``), the
guidance interval, AB2, the inpainting projection, the host offload,
``replay_logprobs`` and the fixed-schedule samplers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from tpdm_tpu_torch.ops.beta import (
    beta_log_prob,
    beta_mode,
    beta_sample,
    mode_concentration_to_alpha_beta,
)
from tpdm_tpu_torch.ops.flow_euler import flow_euler_step

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
    """

    max_inference_steps: int = 28
    min_sigma: float = 0.001
    epsilon: float = 1e-3
    relative: bool = True
    prediction_type: str = "alpha_beta"
    predict: bool = False
    cache_activations: bool = True
    keep_history: bool = False


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
    denoise_fn: DenoiseFn,
    tpm_fn: TpmFn,
    init_latents: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: SamplerConfig,
    step_caps: Optional[torch.Tensor] = None,
    init_sigma: Optional[torch.Tensor] = None,
) -> SampleOutput:
    """Run the adaptive, self-terminating denoise loop.

    Args:
        generator: draws the Beta ratios (unused when ``cfg.predict``).
        step_caps: optional (b,) per-sample step caps; None = T for all.
        init_sigma: optional (b,) starting noise levels (default 1.0).
    """
    b = init_latents.shape[0]
    T = cfg.max_inference_steps
    dtype, device = init_latents.dtype, init_latents.device
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

    latents = last_valid = init_latents
    bcast = (b,) + (1,) * (init_latents.dim() - 1)
    num_steps = 0
    for step in range(T):
        velocity, temb, h_comb = denoise_fn(latents, sigma.to(dtype))
        raw = tpm_fn(h_comb, temb)
        alpha, beta = _raw_to_alpha_beta(raw.float(), cfg.prediction_type)
        ratio = beta_mode(alpha, beta) if cfg.predict else beta_sample(generator, alpha, beta)
        ratio = _clamp_ratio(ratio, sigma, cfg)

        sigma_next = sigma * ratio if cfg.relative else sigma - ratio
        logprob = beta_log_prob(alpha, beta, ratio)
        # done BEFORE this step -> the step is invalid for that sample
        done = (sigma < cfg.min_sigma) | (step >= caps)
        if cfg.predict:
            sigma_next = torch.where(done, torch.zeros_like(sigma_next), sigma_next)
        new_latents = flow_euler_step(velocity, sigma_next, sigma, latents)
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

        latents, sigma = new_latents, sigma_next
        num_steps = step + 1
        all_done = ((sigma_next < cfg.min_sigma) | (step + 1 >= caps)).all()
        if all_done.item():
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
