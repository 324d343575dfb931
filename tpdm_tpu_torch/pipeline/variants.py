"""Generation pipelines of the other model families: SD1.5.

Counterpart of ``tpdm_tpu/pipeline/variants.py``'s SD1.5 part: adaptive
generation with the agent's rollout in predict mode, the VAE decode of
each sample's last valid latents, the realised step counts and integer
schedules, and integer-t image-to-image. The SDXL and FLUX pipelines of
that file wait for their slices (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpdm_tpu_torch.ops.dpm_solver import ddpm_sigmas_from_betas, sigma_to_alpha_sigma_t
from tpdm_tpu_torch.pipeline.pipeline import decode_latents, seed_noise
from tpdm_tpu_torch.utils.image import postprocess_images, preprocess_images


@torch.no_grad()
def encode_init_image(vae, images) -> torch.Tensor:
    """uint8 (b, H, W, 3) -> model-space latents (the posterior mean) in
    fp32 on the VAE's device: ``(mean - shift_factor) * scaling_factor``,
    the inverse of the decode's transform. The encoder runs in the VAE's
    dtype (K2 in its mid block on the card)."""
    cfg = vae.config
    device = next(vae.parameters()).device
    x = images if isinstance(images, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(images))
    mean, _ = vae.encode(preprocess_images(x.to(device)))
    return (mean.float() - cfg.shift_factor) * cfg.scaling_factor


class VariantResult(NamedTuple):
    images: np.ndarray  # (b, H, W, 3) uint8, or the final latents without a VAE
    num_steps: int
    last_valid_index: np.ndarray
    schedule: np.ndarray  # (b, T+1) integer timesteps (SD1.5)


def _ddpm_img2img_batch(vae, batch_size: int, init_image, strength, seed, dtype, device):
    """Integer-t img2img for the epsilon families: DDPM forward noising
    x_t = alpha_t x0 + sigma_t eps at t0 = round(strength·999), in fp32,
    cast to ``dtype``. ``eps`` is drawn as the text-to-image latents of
    ``seed`` are (``pipeline.seed_noise``). Returns {"latents", "init_t"}."""
    if vae is None:
        raise ValueError("img2img needs a VAE on the pipeline")
    b = batch_size
    s0 = torch.broadcast_to(torch.as_tensor(strength, dtype=torch.float32), (b,))
    if bool(((s0 <= 0.0) | (s0 > 1.0)).any()):
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    clean = encode_init_image(vae, init_image).to(device)
    if clean.shape[0] != b:
        raise ValueError(f"init_image batch {clean.shape[0]} != prompt batch {b}")
    t0 = torch.round(s0 * 999.0).to(torch.int32).to(device)
    alpha_t, sigma_t = sigma_to_alpha_sigma_t(ddpm_sigmas_from_betas(device=device)[t0.long()])
    _, eps = seed_noise(seed, clean.shape, device, dtype)
    a, s = alpha_t.reshape(b, 1, 1, 1), sigma_t.reshape(b, 1, 1, 1)
    return {"latents": (a * clean + s * eps.float()).to(dtype), "init_t": t0}


def _cached_scfg(agent, cache_interval: int, guidance_interval=None, cache_tau: float = 0.0):
    """The predict-mode sampler config with the acceleration options set,
    or None (the agent's default) when none is on; JAX's checks."""
    if cache_tau and cache_interval >= 2:
        raise ValueError("cache_tau (input-aware policy) and cache_interval (fixed "
                         "schedule) are mutually exclusive")
    if guidance_interval is not None:
        gs = getattr(agent, "guidance_scale", None)
        if gs is None or gs <= 1:
            raise ValueError("guidance_interval requires classifier-free guidance "
                             f"(agent guidance_scale={gs})")
        guidance_interval = (float(guidance_interval[0]), float(guidance_interval[1]))
    if cache_interval < 2 and guidance_interval is None and not cache_tau:
        return None
    return dataclasses.replace(agent.sampler_cfg, predict=True, cache_activations=False,
                               cache_interval=cache_interval,
                               guidance_interval=guidance_interval, cache_tau=cache_tau)


class SD15Pipeline:
    """SD1.5 adaptive generation: the agent's rollout (predict) and the VAE
    decode. ``text_encoder``: a CLIP-L ``CLIPTextModel`` (SD1.5 conditions on
    its final hidden state) for ``generate(clip_ids=)``."""

    def __init__(self, agent, vae=None, text_encoder=None):
        self.agent = agent
        self.vae = None if vae is None else vae.requires_grad_(False).eval()
        self.text_encoder = (None if text_encoder is None
                             else text_encoder.requires_grad_(False).eval())

    def _encode(self, ids) -> torch.Tensor:
        device = next(self.text_encoder.parameters()).device
        return self.text_encoder(torch.as_tensor(np.asarray(ids), device=device).long())[1]

    @torch.no_grad()
    def generate(
        self,
        prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        clip_ids: Optional[np.ndarray] = None,
        negative_clip_ids: Optional[np.ndarray] = None,
        seed: int = 0,
        tpm_params=None,
        init_image: Optional[np.ndarray] = None,
        strength: float = 0.6,
        cache_interval: int = 0,
        guidance_interval: Optional[tuple] = None,
        cache_tau: float = 0.0,
    ) -> VariantResult:
        """Generate from embeds (b, n, d) or CLIP ids, with CFG against the
        negatives. ``seed`` seeds a ``torch.Generator`` on the UNet's device
        that draws the latents. ``tpm_params``: the TPM module (None: one
        drawn from a generator seeded 0).

        ``init_image`` (uint8 (b, H, W, 3)) runs integer-t image-to-image:
        the latents DDPM-noised to t0 = round(strength·999) and the loop
        starting at t0. At strength 1.0 the schedule starts at 999 as
        text-to-image does, but the latents keep alpha_999·x0 (~0.068 x0):
        not text-to-image to the bit, unlike the flow families.

        ``guidance_interval`` = (t_lo, t_hi): CFG only while the integer t
        is in the window. ``cache_interval`` >= 2: DeepCache, the deep
        feature reused between refreshes; ``cache_tau`` > 0 its input-aware
        policy. Both approximate; 0 is exact."""
        agent = self.agent
        if prompt_embeds is None:
            if self.text_encoder is None:
                raise ValueError("need prompt_embeds or a text encoder")
            prompt_embeds = self._encode(clip_ids)
            if negative_clip_ids is not None:
                negative_prompt_embeds = self._encode(negative_clip_ids)
        cfg_on = agent.guidance_scale is not None and agent.guidance_scale > 1
        if negative_prompt_embeds is None and cfg_on:
            raise ValueError(
                f"classifier-free guidance is on (guidance_scale={agent.guidance_scale}); pass "
                "negative_prompt_embeds or negative_clip_ids (the reference encodes an empty "
                "prompt)")
        batch = {"prompt_embeds": prompt_embeds, "negative_prompt_embeds": negative_prompt_embeds}
        generator = torch.Generator(device=agent.device).manual_seed(int(seed))
        if init_image is not None:
            batch.update(_ddpm_img2img_batch(self.vae, prompt_embeds.shape[0], init_image,
                                             strength, seed, agent.dtype, agent.device))
        if tpm_params is None:
            tpm_params = agent.init_tpm_params(
                torch.Generator(device=agent.device).manual_seed(0))
        out = agent.sample(tpm_params, batch, generator, predict=True,
                           sampler_cfg=_cached_scfg(agent, cache_interval, guidance_interval,
                                                    cache_tau))
        if self.vae is not None:
            images = postprocess_images(decode_latents(self.vae, out.final_latents))
        else:
            images = out.final_latents.float().cpu().numpy()
        return VariantResult(images=images, num_steps=int(out.num_steps),
                             last_valid_index=out.last_valid_index.cpu().numpy(),
                             schedule=out.times.cpu().numpy())
