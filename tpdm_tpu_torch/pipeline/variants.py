"""Generation pipelines of the other model families: SD1.5, SDXL and FLUX.

Counterpart of ``tpdm_tpu/pipeline/variants.py``: adaptive generation with
the agent's rollout in predict mode, the VAE decode of each sample's last
valid latents and the realised step counts and schedules; integer-t
image-to-image for SD1.5 and SDXL, and for SDXL also the refiner
(``SDXLRefinerPipeline.refine``) and the base + refiner ensemble
(``sdxl_ensemble_generate``). ``FluxPipeline`` generates in FLUX's
rectified-flow sigma space (image-to-image at sigma = strength, the
Δ-cache, AB2) and runs the fixed-schedule baseline (``generate_fixed``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpdm_tpu_torch.ops.dpm_solver import ddpm_sigmas_from_betas, sigma_to_alpha_sigma_t
from tpdm_tpu_torch.pipeline.pipeline import decode_latents, noised_latents, seed_noise
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


class SDXLPipeline:
    """SDXL adaptive generation: the agent's rollout (predict) and the VAE
    decode, the dual-CLIP context, bigG's pooled row and the size / crop
    time_ids threaded through CFG. ``text_encoders``: an
    ``SDXLTextEncoders`` for ``generate(clip_ids=)``.

    The VAE must be ``VAEConfig.sdxl()`` (scaling factor 0.13025): SD3's
    and SD1.5's configs decode an SDXL latent wrong without a warning."""

    def __init__(self, agent, vae=None, text_encoders=None):
        self.agent = agent
        self.vae = None if vae is None else vae.requires_grad_(False).eval()
        self.text_encoders = text_encoders

    def _encode_ids(self, clip_ids):
        return self.text_encoders.encode(np.asarray(clip_ids))

    def _resolve_conditioning(self, prompt_embeds, pooled_prompt_embeds, negative_prompt_embeds,
                              negative_pooled_prompt_embeds, clip_ids, negative_clip_ids,
                              time_ids) -> dict:
        """Embeds or ids, checked for CFG: the conditioning part of the
        agent's batch (shared by ``generate``, ``refine`` and the ensemble)."""
        if prompt_embeds is None:
            if self.text_encoders is None:
                raise ValueError("need prompt_embeds or text_encoders")
            prompt_embeds, pooled_prompt_embeds = self._encode_ids(clip_ids)
            if negative_clip_ids is not None:
                negative_prompt_embeds, negative_pooled_prompt_embeds = self._encode_ids(
                    negative_clip_ids)
        if pooled_prompt_embeds is None:
            raise ValueError("SDXL conditioning needs pooled_prompt_embeds (the bigG projected "
                             "EOS embedding) beside prompt_embeds: precomputed embeds come as "
                             "the (prompt_embeds, pooled_prompt_embeds) pair")
        gs = self.agent.guidance_scale
        if gs is not None and gs > 1 and (negative_prompt_embeds is None
                                          or negative_pooled_prompt_embeds is None):
            raise ValueError(
                f"classifier-free guidance is on (guidance_scale={gs}); pass "
                "negative_prompt_embeds AND negative_pooled_prompt_embeds (or negative_clip_ids: "
                "diffusers encodes an empty prompt)")
        batch = {"prompt_embeds": prompt_embeds, "pooled_prompt_embeds": pooled_prompt_embeds,
                 "negative_prompt_embeds": negative_prompt_embeds,
                 "negative_pooled_prompt_embeds": negative_pooled_prompt_embeds}
        if time_ids is not None:
            batch["time_ids"] = torch.as_tensor(np.asarray(time_ids, np.float32),
                                                device=self.agent.device)
        return batch

    def _decode_result(self, out) -> VariantResult:
        if self.vae is not None:
            images = postprocess_images(decode_latents(self.vae, out.final_latents))
        else:
            images = out.final_latents.float().cpu().numpy()
        return VariantResult(images=images, num_steps=int(out.num_steps),
                             last_valid_index=out.last_valid_index.cpu().numpy(),
                             schedule=out.times.cpu().numpy())

    def _tpm(self, tpm_params):
        agent = self.agent
        if tpm_params is None:
            tpm_params = agent.init_tpm_params(
                torch.Generator(device=agent.device).manual_seed(0))
        return tpm_params

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.agent.device).manual_seed(int(seed))

    @torch.no_grad()
    def generate(
        self,
        prompt_embeds: Optional[torch.Tensor] = None,  # (b, 77, 2048)
        pooled_prompt_embeds: Optional[torch.Tensor] = None,  # (b, 1280)
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        negative_pooled_prompt_embeds: Optional[torch.Tensor] = None,
        clip_ids: Optional[np.ndarray] = None,
        negative_clip_ids: Optional[np.ndarray] = None,
        time_ids: Optional[np.ndarray] = None,
        seed: int = 0,
        tpm_params=None,
        init_image: Optional[np.ndarray] = None,
        strength: float = 0.6,
        cache_interval: int = 0,
        guidance_interval: Optional[tuple] = None,
        cache_tau: float = 0.0,
    ) -> VariantResult:
        """From precomputed (prompt_embeds, pooled_prompt_embeds) [and the
        negatives under CFG] or from ids through ``text_encoders``.
        ``init_image`` runs integer-t img2img, and ``cache_interval``,
        ``guidance_interval`` and ``cache_tau`` are ``SD15Pipeline.generate``'s
        options (DeepCache reuse steps run no transformer of SDXL's UNet)."""
        agent = self.agent
        batch = self._resolve_conditioning(
            prompt_embeds, pooled_prompt_embeds, negative_prompt_embeds,
            negative_pooled_prompt_embeds, clip_ids, negative_clip_ids, time_ids)
        if init_image is not None:
            batch.update(_ddpm_img2img_batch(self.vae, batch["prompt_embeds"].shape[0],
                                             init_image, strength, seed, agent.dtype,
                                             agent.device))
        out = agent.sample(self._tpm(tpm_params), batch, self._generator(seed), predict=True,
                           sampler_cfg=_cached_scfg(agent, cache_interval, guidance_interval,
                                                    cache_tau))
        return self._decode_result(out)


class SDXLRefinerPipeline(SDXLPipeline):
    """SDXL's refiner: adaptive refinement of the low-noise tail (diffusers'
    ``StableDiffusionXLImg2ImgPipeline`` over the refiner UNet). ``refine``
    takes latents mid-denoise with their per-sample ``init_t`` (the
    ensemble's handoff) or a decoded image at a low ``strength``. The
    context is bigG alone ((b, 77, 1280) embeds, or ``clip_g_ids`` through
    ``text_encoders.encode_refiner``); the aesthetic score rides the agent's
    five time_ids."""

    def _encode_ids(self, clip_g_ids):
        return self.text_encoders.encode_refiner(np.asarray(clip_g_ids))

    def generate(self, *a, **kw):
        raise NotImplementedError(
            "the refiner is not a text-to-image model: call refine() with latents (+init_t) or "
            "init_image, or run the ensemble with sdxl_ensemble_generate(base, refiner, ...)")

    @torch.no_grad()
    def refine(
        self,
        latents: Optional[torch.Tensor] = None,  # (b, 4, h, w) mid-denoise
        init_t: Optional[np.ndarray] = None,  # (b,) int timesteps of the latents
        init_image: Optional[np.ndarray] = None,  # uint8 (b, H, W, 3)
        strength: float = 0.3,
        prompt_embeds: Optional[torch.Tensor] = None,  # (b, 77, 1280)
        pooled_prompt_embeds: Optional[torch.Tensor] = None,  # (b, 1280)
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        negative_pooled_prompt_embeds: Optional[torch.Tensor] = None,
        clip_g_ids: Optional[np.ndarray] = None,
        negative_clip_g_ids: Optional[np.ndarray] = None,
        time_ids: Optional[np.ndarray] = None,
        seed: int = 0,
        tpm_params=None,
    ) -> VariantResult:
        if (latents is None) == (init_image is None):
            raise ValueError("pass exactly one of latents (+init_t, the ensemble handoff) or "
                             "init_image (+strength, image refinement)")
        if latents is not None and init_t is None:
            raise ValueError("latents need their per-sample timesteps: pass init_t ((b,) ints, "
                             "e.g. the base stage's handoff times)")
        agent = self.agent
        batch = self._resolve_conditioning(
            prompt_embeds, pooled_prompt_embeds, negative_prompt_embeds,
            negative_pooled_prompt_embeds, clip_g_ids, negative_clip_g_ids, time_ids)
        if latents is not None:
            batch["latents"] = torch.as_tensor(latents, device=agent.device).to(agent.dtype)
            batch["init_t"] = torch.as_tensor(np.asarray(init_t), dtype=torch.int32,
                                              device=agent.device)
        else:
            batch.update(_ddpm_img2img_batch(self.vae, batch["prompt_embeds"].shape[0],
                                             init_image, strength, seed, agent.dtype,
                                             agent.device))
        out = agent.sample(self._tpm(tpm_params), batch, self._generator(seed), predict=True)
        return self._decode_result(out)


class SDXLEnsembleResult(NamedTuple):
    images: np.ndarray
    num_steps: int  # executed denoise steps, base + refiner
    base_steps: int
    refiner_steps: int
    handoff_t: np.ndarray  # (b,) timesteps where the refiner took over
    base_schedule: np.ndarray  # (b, T_base + 1) the base stage's times
    refiner_schedule: np.ndarray  # (b, T_ref + 1) the refiner stage's times
    last_valid_index: np.ndarray  # the refiner stage's (-1: the base finished alone)


def handoff_times(out) -> np.ndarray:
    """(b,) the t of each sample's last valid base step's t_next, the first
    below the cutoff (-1 valid steps: still at its starting t)."""
    times = out.times.cpu().numpy()
    lvi = out.last_valid_index.cpu().numpy()
    return times[np.arange(times.shape[0]), lvi + 1]


@torch.no_grad()
def sdxl_ensemble_generate(
    base: SDXLPipeline,
    refiner: SDXLRefinerPipeline,
    denoising_end: float = 0.8,
    seed: int = 0,
    tpm_params=None,
    refiner_tpm_params=None,
    clip_ids: Optional[np.ndarray] = None,
    negative_clip_ids: Optional[np.ndarray] = None,
    base_kwargs: Optional[dict] = None,
    refiner_kwargs: Optional[dict] = None,
) -> SDXLEnsembleResult:
    """SDXL's ensemble of experts with both stages adaptive.

    diffusers splits a fixed ladder at t_cut = round(999 (1 - denoising_end)):
    the base denoises t >= t_cut, the refiner the rest. Here the base runs
    its own TPM loop with min_time = t_cut (it stops once a sample crosses
    the cutoff), and the refiner resumes from each sample's actual handoff
    (its latents and t) through the integer-t img2img entry: exact, per
    sample, with no shared ladder. A sample that meets the base's step cap
    integrates to x0 there (t = 0) and the refiner passes it through.

    Prompts: ``clip_ids`` / ``negative_clip_ids`` through both stages'
    encoders (dual CLIP for the base, bigG alone for the refiner), or
    embeds in ``base_kwargs`` / ``refiner_kwargs`` (``prompt_embeds``,
    ``pooled_prompt_embeds``, the negatives, ``time_ids``). The base draws
    from seed ``seed``, the refiner from ``seed + 1``."""
    if not 0.0 < denoising_end < 1.0:
        raise ValueError(f"denoising_end must be in (0, 1), got {denoising_end}")
    bcfg, rcfg = base.agent.unet.config, refiner.agent.unet.config
    if bcfg.sample_size != rcfg.sample_size:
        raise ValueError(f"base and refiner latent grids differ: {bcfg.sample_size} vs "
                         f"{rcfg.sample_size}")
    bk, rk = dict(base_kwargs or {}), dict(refiner_kwargs or {})
    t_cut = int(round(999 * (1.0 - denoising_end)))

    def conditioning(pipe, kw, label):
        batch = pipe._resolve_conditioning(
            kw.pop("prompt_embeds", None), kw.pop("pooled_prompt_embeds", None),
            kw.pop("negative_prompt_embeds", None), kw.pop("negative_pooled_prompt_embeds", None),
            clip_ids, negative_clip_ids, kw.pop("time_ids", None))
        if kw:
            raise ValueError(f"unknown {label}: {sorted(kw)}")
        return batch

    batch = conditioning(base, bk, "base_kwargs")
    scfg = dataclasses.replace(base.agent.sampler_cfg, predict=True, min_time=max(t_cut, 1))
    out = base.agent.sample(base._tpm(tpm_params), batch, base._generator(seed),
                            sampler_cfg=scfg)
    handoff_t = handoff_times(out)

    rbatch = conditioning(refiner, rk, "refiner_kwargs")
    ragent = refiner.agent
    rbatch["latents"] = out.final_latents.to(ragent.dtype)
    rbatch["init_t"] = torch.as_tensor(handoff_t, dtype=torch.int32, device=ragent.device)
    rout = ragent.sample(refiner._tpm(refiner_tpm_params), rbatch, refiner._generator(seed + 1),
                         predict=True)
    res = refiner._decode_result(rout)
    return SDXLEnsembleResult(
        images=res.images, num_steps=int(out.num_steps) + int(rout.num_steps),
        base_steps=int(out.num_steps), refiner_steps=int(rout.num_steps), handoff_t=handoff_t,
        base_schedule=out.times.cpu().numpy(), refiner_schedule=res.schedule,
        last_valid_index=res.last_valid_index)


class FluxPipeline:
    """FLUX adaptive generation (embedded guidance, T5 features and the CLIP
    pooled vector as conditioning) and the fixed-schedule baseline.

    ``vae``: FLUX's 16-channel VAE, its config carrying FLUX.1's
    ``scaling_factor`` 0.3611 and ``shift_factor`` 0.1159; without one the
    final latents come back (fp32)."""

    def __init__(self, agent, vae=None):
        self.agent = agent
        self.vae = None if vae is None else vae.requires_grad_(False).eval()

    def encode_image(self, images) -> torch.Tensor:
        """uint8 (b, H, W, 3) -> model-space latents (fp32): the posterior
        mean, shifted and scaled by the VAE's factors."""
        if self.vae is None:
            raise ValueError("img2img needs a VAE on the pipeline")
        return encode_init_image(self.vae, images)

    def _images(self, latents: torch.Tensor) -> np.ndarray:
        if self.vae is None:
            return latents.float().cpu().numpy()
        return postprocess_images(decode_latents(self.vae, latents))

    def _img2img_batch(self, batch_size: int, init_image, strength, seed) -> dict:
        """{"latents", "init_sigma"}: the image's latents mixed in fp32 with
        the noise that text-to-image draws for ``seed`` at each sample's
        strength, so strength 1.0 is text-to-image to the bit."""
        agent, b = self.agent, batch_size
        s0 = torch.broadcast_to(torch.as_tensor(strength, dtype=torch.float32), (b,))
        if bool(((s0 <= 0.0) | (s0 > 1.0)).any()):
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        clean = self.encode_image(init_image).to(agent.device)
        if clean.shape[0] != b:
            raise ValueError(f"init_image batch {clean.shape[0]} != prompt batch {b}")
        if clean.shape[-1] != agent.latent_size:
            raise ValueError(f"init_image encodes to latent {clean.shape[-1]}, agent serves "
                             f"{agent.latent_size}")
        _, eps = seed_noise(seed, clean.shape, agent.device, agent.dtype)
        s0 = s0.to(agent.device)
        return {"latents": noised_latents(clean, eps, s0), "init_sigma": s0}

    @torch.no_grad()
    def generate(
        self,
        prompt_embeds: torch.Tensor,  # T5 features (b, n, txt_dim)
        pooled_prompt_embeds: torch.Tensor,  # CLIP pooled (b, vec_dim)
        seed: int = 0,
        tpm_params=None,
        init_image: Optional[np.ndarray] = None,
        strength: float = 0.6,
        cache_interval: int = 0,
        solver: str = "euler",
    ) -> VariantResult:
        """``seed`` seeds a ``torch.Generator`` on the backbone's device that
        draws the latents. ``tpm_params``: the TPM module (None: one drawn
        from a generator seeded 0).

        ``init_image`` (uint8 (b, H, W, 3)) runs image-to-image: the image's
        latents noised to sigma = ``strength`` by the flow's forward mix
        and the loop starting there; strength 1.0 is text-to-image.
        ``cache_interval`` >= 2 runs the Δ-cache (approximate; 0 and 1
        exact); ``solver`` "euler" or "ab2". ``schedule`` holds each
        step's sigma_next (b, T)."""
        agent = self.agent
        batch = {"prompt_embeds": prompt_embeds, "pooled_prompt_embeds": pooled_prompt_embeds}
        if init_image is not None:
            batch.update(self._img2img_batch(prompt_embeds.shape[0], init_image, strength,
                                             seed))
        if tpm_params is None:
            tpm_params = agent.init_tpm_params(
                torch.Generator(device=agent.device).manual_seed(0))
        # the activations feed no replay here: not kept
        scfg = dataclasses.replace(agent.sampler_cfg, predict=True, cache_activations=False,
                                   cache_interval=cache_interval, solver=solver)
        generator = torch.Generator(device=agent.device).manual_seed(int(seed))
        out = agent.sample(tpm_params, batch, generator, predict=True, sampler_cfg=scfg)
        return VariantResult(images=self._images(out.final_latents),
                             num_steps=int(out.num_steps),
                             last_valid_index=out.last_valid_index.cpu().numpy(),
                             schedule=out.sigmas.cpu().numpy())

    @torch.no_grad()
    def generate_fixed(
        self,
        prompt_embeds: torch.Tensor,
        pooled_prompt_embeds: torch.Tensor,
        num_steps: int = 28,
        seed: int = 0,
        solver: str = "euler",
    ) -> np.ndarray:
        """The fixed-schedule FLUX baseline (no TPM): ``num_steps`` steps down
        ``uniform_flow_sigmas(num_steps)`` with ``solver`` (``FLOW_SOLVERS``:
        euler, heun, midpoint, ab2), one forward an evaluation (no CFG
        doubling). Returns uint8 images, or the final latents without a
        VAE."""
        from tpdm_tpu_torch.ops.schedules import uniform_flow_sigmas
        from tpdm_tpu_torch.pipeline.sampler import FLOW_SOLVERS, fixed_schedule_sample_solver

        if solver not in FLOW_SOLVERS:
            raise ValueError(f"unknown solver {solver!r}; pick from {FLOW_SOLVERS}")
        agent = self.agent
        denoise_fn = agent.denoise_builder(agent.flux, {
            "prompt_embeds": prompt_embeds, "pooled_prompt_embeds": pooled_prompt_embeds})
        latents = agent.prepare_latents(
            torch.Generator(device=agent.device).manual_seed(int(seed)), prompt_embeds.shape[0])
        final = fixed_schedule_sample_solver(lambda lat, s: denoise_fn(lat, s)[0], latents,
                                             uniform_flow_sigmas(num_steps), solver)
        return self._images(final)
