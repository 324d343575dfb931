"""Model-family serving runners: SD1.5 behind the fixed-batch engine.

Counterpart of ``tpdm_tpu/serving_families.py``'s SD1.5 part. A runner
``(prompts, seeds, caps) -> [{image, inference_steps, sigmas}, ...]`` is
what ``serving.BatchingEngine(runner=...)`` hands a padded batch to; the
engine keeps the queue, the coalescing window, the padding and the stats,
the runner owns tokenize, encode, sample and decode.

Request i's initial latent is ``agent.prepare_latents(torch.Generator(
device).manual_seed(seed_i), 1)``, the draw that ``agent.sample`` makes
for a batch of one with that seed's generator: the same (prompt, seed,
cap) gives the same image through the engine and a direct call at the
same batch shape. Per-request step caps are the sampler's ``step_caps``.
The SDXL and FLUX runners wait for their slices (ROADMAP queue 1,
item 12).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tpdm_tpu_torch.pipeline.pipeline import decode_latents
from tpdm_tpu_torch.pipeline.variants import _cached_scfg as _accel_scfg
from tpdm_tpu_torch.utils.image import postprocess_images

__all__ = ["make_sd15_runner", "make_vae_decoder"]


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
        images = (decode(out.final_latents) if decode is not None
                  else out.final_latents.float().cpu().numpy())
        times = out.times.cpu().numpy()
        lvi = out.last_valid_index.cpu().numpy()
        results = []
        for i in range(len(prompts)):
            nfe = int(lvi[i]) + 1
            results.append({"image": images[i], "inference_steps": nfe,
                            "sigmas": times[i][1:nfe + 1].tolist()})
        return results

    return runner


def make_vae_decoder(vae) -> Callable:
    """The family runners' decode: ``latents / scaling_factor +
    shift_factor`` through the VAE, then uint8 on the host."""
    vae = vae.requires_grad_(False).eval()
    return lambda z: postprocess_images(decode_latents(vae, z))
