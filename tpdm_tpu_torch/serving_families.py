"""Model-family serving runners: SD1.5, SDXL and FLUX behind the fixed-batch
engine.

Counterpart of ``tpdm_tpu/serving_families.py``'s adaptive runners (SD1.5,
the SDXL base, its base + refiner ensemble, and FLUX). A runner
``(prompts, seeds, caps) -> [{image, inference_steps, sigmas}, ...]`` is
what ``serving.BatchingEngine(runner=...)`` hands a padded batch to; the
engine keeps the queue, the coalescing window, the padding and the stats,
the runner owns tokenize, encode, sample and decode.

Request i's initial latent is ``agent.prepare_latents(torch.Generator(
device).manual_seed(seed_i), 1)``, the draw that ``agent.sample`` makes
for a batch of one with that seed's generator: the same (prompt, seed,
cap) gives the same image through the engine and a direct call at the
same batch shape. Per-request step caps are the sampler's ``step_caps``.
"""

from __future__ import annotations

from typing import Callable, Optional

import dataclasses

import numpy as np
import torch

from tpdm_tpu_torch.pipeline.pipeline import decode_latents
from tpdm_tpu_torch.pipeline.variants import _cached_scfg as _accel_scfg
from tpdm_tpu_torch.pipeline.variants import handoff_times
from tpdm_tpu_torch.utils.image import postprocess_images

__all__ = ["make_flux_runner", "make_sd15_runner", "make_sdxl_ensemble_runner",
           "make_sdxl_runner", "make_vae_decoder"]


def _per_seed_latents(agent, seeds) -> torch.Tensor:
    """Each seed's batch-1 initial latent, stacked."""
    return torch.cat([
        agent.prepare_latents(torch.Generator(device=agent.device).manual_seed(int(s)), 1)
        for s in seeds])


def make_sd15_runner(
    agent,
    tpm_params,
    encode: Callable,
    decode: Optional[Callable] = None,
    cache_interval: int = 0,
    guidance_interval=None,
    cache_tau: float = 0.0,
) -> Callable:
    """The serving runner of the SD1.5 family (the integer-t loop).

    Args:
        agent: an ``SD15Agent``.
        tpm_params: its TPM module (``init_tpm_params`` or a trained one).
        encode: ``(prompts) -> (prompt_embeds, negative_prompt_embeds)``,
            CLIP-L final hidden states; the negative is the empty prompt's.
        decode: optional ``final_latents -> uint8 (b, H, W, 3)``
            (``make_vae_decoder``); None returns the final latents.
        cache_interval, guidance_interval (t_lo, t_hi), cache_tau: the
            training-free options of ``SD15Pipeline.generate``, for every
            batch.

    Each result's ``sigmas`` holds the request's integer timesteps (the
    slot where the SD3 path puts sigmas)."""
    scfg = _accel_scfg(agent, cache_interval, guidance_interval, cache_tau)

    def runner(prompts, seeds, caps):
        pe, npe = encode(prompts)
        batch = {"prompt_embeds": pe, "negative_prompt_embeds": npe,
                 "latents": _per_seed_latents(agent, seeds)}
        # predict=True draws nothing: the generator is not used
        out = agent.sample(tpm_params, batch, None, predict=True, sampler_cfg=scfg,
                           step_caps=np.asarray(caps, np.int32))
        return _results(out, decode, len(prompts))

    return runner


def _images(out, decode):
    return (decode(out.final_latents) if decode is not None
            else out.final_latents.float().cpu().numpy())


def _results(out, decode, n: int) -> list:
    """Each request's {image, inference_steps, sigmas}: its integer
    timesteps (the slot where the SD3 path puts sigmas)."""
    images = _images(out, decode)
    times = out.times.cpu().numpy()
    lvi = out.last_valid_index.cpu().numpy()
    results = []
    for i in range(n):
        nfe = int(lvi[i]) + 1
        results.append({"image": images[i], "inference_steps": nfe,
                        "sigmas": times[i][1:nfe + 1].tolist()})
    return results


def _sdxl_batch(encoded, latents) -> dict:
    """The agent's batch of an SDXL encode ``(pe, pooled, npe, npooled)``;
    the negative pair None with CFG off."""
    pe, pooled, npe, npooled = encoded
    batch = {"prompt_embeds": pe, "pooled_prompt_embeds": pooled, "latents": latents}
    if npe is not None:
        batch.update(negative_prompt_embeds=npe, negative_pooled_prompt_embeds=npooled)
    return batch


def make_sdxl_runner(
    agent,
    tpm_params,
    encode: Callable,
    decode: Optional[Callable] = None,
    cache_interval: int = 0,
    guidance_interval=None,
    cache_tau: float = 0.0,
) -> Callable:
    """The serving runner of the SDXL family (the integer-t loop over the
    dual-CLIP context, bigG's pooled row and the agent's default time_ids).

    Args:
        agent: an ``SDXLAgent``.
        tpm_params: its TPM module.
        encode: ``(prompts) -> (prompt_embeds (b, 77, 2048), pooled (b,
            1280), negative_prompt_embeds, negative_pooled)``, the negative
            pair the empty prompt's (diffusers' CFG convention), or None
            pairs with guidance off.
        decode: optional ``final_latents -> uint8 images``.
        cache_interval, guidance_interval, cache_tau: as ``make_sd15_runner``.
    """
    scfg = _accel_scfg(agent, cache_interval, guidance_interval, cache_tau)

    def runner(prompts, seeds, caps):
        batch = _sdxl_batch(encode(prompts), _per_seed_latents(agent, seeds))
        out = agent.sample(tpm_params, batch, None, predict=True, sampler_cfg=scfg,
                           step_caps=np.asarray(caps, np.int32))
        return _results(out, decode, len(prompts))

    return runner


def make_sdxl_ensemble_runner(
    base_agent,
    base_tpm_params,
    refiner_agent,
    refiner_tpm_params,
    encode: Callable,
    encode_refiner: Callable,
    decode: Optional[Callable] = None,
    denoising_end: float = 0.8,
) -> Callable:
    """The serving runner of SDXL's base + refiner ensemble
    (``pipeline/variants.py:sdxl_ensemble_generate`` at the engine's
    boundary).

    The base samples with min_time at the denoising_end cutoff and hands
    each request's (latents, t) to the refiner's integer-t img2img entry.
    A request's cap bounds its total steps: the base takes max(1, round(cap
    x denoising_end)) of it, and at most cap - 1 (one refiner step is left
    where cap >= 2); the refiner the rest. A request that spends its base
    share hands off at the cutoff (``SD15SamplerConfig.cap_floor_time``)
    with noise left, so the refiner always runs, unlike
    ``sdxl_ensemble_generate``, whose cap integrates to x0.

    Args:
        encode: the base's dual-CLIP encode (as ``make_sdxl_runner``'s).
        encode_refiner: ``(prompts) -> (prompt_embeds (b, 77, 1280),
            pooled, negative_prompt_embeds, negative_pooled)``, bigG alone
            (``SDXLTextEncoders.encode_refiner``).
        decode: optional ``final_latents -> uint8 images`` (the experts
            share the SDXL VAE).

    Each result also holds ``base_steps``, ``refiner_steps`` and
    ``handoff_t``; its ``sigmas`` the whole integer trajectory across both
    experts."""
    if not 0.0 < denoising_end < 1.0:
        raise ValueError(f"denoising_end must be in (0, 1), got {denoising_end}")
    t_cut = int(round(999 * (1.0 - denoising_end)))
    base_scfg = dataclasses.replace(base_agent.sampler_cfg, predict=True,
                                    min_time=max(t_cut, 1), cap_floor_time=max(t_cut - 1, 0))

    def runner(prompts, seeds, caps):
        caps = np.asarray(caps, np.int32)
        base_caps = np.maximum(1, np.round(caps * denoising_end)).astype(np.int32)
        base_caps = np.minimum(base_caps, np.maximum(caps - 1, 1))
        ref_caps = np.maximum(caps - base_caps, 1)
        batch = _sdxl_batch(encode(prompts), _per_seed_latents(base_agent, seeds))
        out = base_agent.sample(base_tpm_params, batch, None, sampler_cfg=base_scfg,
                                step_caps=base_caps)
        handoff_t = handoff_times(out)
        rbatch = _sdxl_batch(encode_refiner(prompts), out.final_latents.to(refiner_agent.dtype))
        rbatch["init_t"] = torch.as_tensor(handoff_t, dtype=torch.int32,
                                           device=refiner_agent.device)
        rout = refiner_agent.sample(refiner_tpm_params, rbatch, None, predict=True,
                                    step_caps=ref_caps)
        images = _images(rout, decode)
        times, rtimes = out.times.cpu().numpy(), rout.times.cpu().numpy()
        lvi, rlvi = out.last_valid_index.cpu().numpy(), rout.last_valid_index.cpu().numpy()
        results = []
        for i in range(len(prompts)):
            base_nfe, ref_nfe = int(lvi[i]) + 1, int(rlvi[i]) + 1
            results.append({
                "image": images[i], "inference_steps": base_nfe + ref_nfe,
                "base_steps": base_nfe, "refiner_steps": ref_nfe,
                "handoff_t": int(handoff_t[i]),
                "sigmas": times[i][1:base_nfe + 1].tolist() + rtimes[i][1:ref_nfe + 1].tolist(),
            })
        return results

    return runner


def make_flux_runner(
    agent,
    tpm_params,
    encode: Callable,
    decode: Optional[Callable] = None,
    cache_interval: int = 0,
    guidance_interval=None,
    cache_tau: float = 0.0,
) -> Callable:
    """The serving runner of the FLUX family (packed tokens, embedded
    guidance, no CFG batch doubling).

    Args:
        agent: a ``FluxAgent``.
        tpm_params: its TPM module.
        encode: ``(prompts) -> (prompt_embeds (b, n, txt_dim), pooled (b,
            vec_dim))``, the T5 features and the CLIP pooled vector.
        decode: optional ``final_latents -> uint8 images``.
        cache_interval: >= 2 runs the Δ-cache; ``cache_tau`` > 0 its
            input-aware policy (exclusive with ``cache_interval``).
        guidance_interval: refused: FLUX's guidance is an embedding, with no
            unconditional branch to skip.

    Each result's ``sigmas`` holds the request's sigma after each of its
    steps."""
    if guidance_interval is not None:
        raise ValueError("guidance_interval does not apply to FLUX (embedded guidance, no CFG "
                         "batch-doubling)")
    if cache_tau and cache_interval >= 2:
        raise ValueError("cache_tau (input-aware policy) and cache_interval (fixed schedule) "
                         "are mutually exclusive")
    # serving keeps no activations for a replay
    scfg = dataclasses.replace(agent.sampler_cfg, predict=True, cache_activations=False,
                               cache_interval=cache_interval, cache_tau=cache_tau)

    def runner(prompts, seeds, caps):
        txt, pooled = encode(prompts)
        batch = {"prompt_embeds": txt, "pooled_prompt_embeds": pooled,
                 "latents": _per_seed_latents(agent, seeds)}
        out = agent.sample(tpm_params, batch, None, predict=True, sampler_cfg=scfg,
                           step_caps=np.asarray(caps, np.int32))
        images = _images(out, decode)
        sigmas = out.sigmas.cpu().numpy()
        lvi = out.last_valid_index.cpu().numpy()
        results = []
        for i in range(len(prompts)):
            nfe = int(lvi[i]) + 1
            results.append({"image": images[i], "inference_steps": nfe,
                            "sigmas": sigmas[i][:nfe].tolist()})
        return results

    return runner


def make_vae_decoder(vae) -> Callable:
    """The family runners' decode: ``latents / scaling_factor +
    shift_factor`` through the VAE, then uint8 on the host."""
    vae = vae.requires_grad_(False).eval()
    return lambda z: postprocess_images(decode_latents(vae, z))
