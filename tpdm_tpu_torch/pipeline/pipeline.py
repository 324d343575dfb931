"""TPDMPipeline: adaptive-schedule SD3 generation, from text and from images.

Counterpart of ``tpdm_tpu/pipeline/pipeline.py``'s ``generate``,
``generate_fixed`` and ``encode_image``. ``generate`` takes precomputed
prompt embeds, or token ids that the pipeline's ``SD3TextEncoders``
encode. ``generate``: the CFG-doubled MMDiT and the TPM run the adaptive
loop (``pipeline/sampler.py``), then the VAE decodes each sample's last
valid latents to uint8 images. With ``init_image`` it runs image-to-image
(SDEdit): the image's latents (``encode_image``, the VAE encoder with K2 in
its mid block) are noised to ``strength`` and the loop starts there; with
``mask`` as well it inpaints, re-imposing the known region at each step's
noise level. ``generate_fixed``: the baseline without the TPM, a fixed
``num_steps`` ladder with the Euler, Heun, midpoint or AB2 solver. Both
take the Δ-cache (``cache_interval`` or ``cache_tau``) and the guidance
window (``guidance_interval``). The modules hold their own weights, on
their own device; the pipeline runs where the MMDiT's weights are.

With a sequence-parallel MMDiT (``MMDiTConfig.seq_group``) every rank of
the group calls ``generate`` with the same arguments. Rank 0's initial
latents are broadcast to the others, the sampler shares rank 0's ratios
each step, and every rank ends with the same final latents. Every rank
then decodes its own copy: the decode needs no collective and takes no
longer than rank 0's alone, and each rank returns the whole result. The
Δ-cache, the guidance window and ``generate_fixed`` refuse a seq group
(ROADMAP queue 1, item 14(g)).

``load_pipeline_from_pretrained`` builds the pipeline from a local
diffusers-layout directory (SD3 or, through ``mmdit_config``, SD3.5).
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from tpdm_tpu_torch.models.tpm import TimePredictor
from tpdm_tpu_torch.models.vae import VAE, VAEConfig, vae_scale_factor
from tpdm_tpu_torch.ops.schedules import uniform_flow_sigmas
from tpdm_tpu_torch.pipeline.denoise import (
    interval_cached_init_delta,
    make_cfg_denoise_cached_fns,
    make_cfg_denoise_fn,
    make_cfg_interval_denoise_cached_fns,
    make_cfg_interval_denoise_fn,
    make_cfg_interval_velocity_cached_fns,
    make_cfg_interval_velocity_fn,
    make_cfg_velocity_cached_fns,
    make_cfg_velocity_fn,
)
from tpdm_tpu_torch.pipeline.sampler import (
    FLOW_SOLVERS,
    CachedDenoise,
    SamplerConfig,
    adaptive_sample,
    cache_reuse_schedule,
    fixed_schedule_sample_autocached,
    fixed_schedule_sample_cached,
    fixed_schedule_sample_solver,
)
from tpdm_tpu_torch.utils.image import postprocess_images, preprocess_images


class GenerationResult(NamedTuple):
    images: np.ndarray  # (b, H, W, 3) uint8, the last valid image per sample
    num_steps: int  # loop iterations executed
    sigmas: np.ndarray  # (b, T)
    alphas: np.ndarray
    betas: np.ndarray
    prob_masks: np.ndarray
    last_valid_index: np.ndarray  # (b,) per-sample NFE - 1
    # (T, b, H, W, 3) uint8, one frame a step: return_full_process_images
    history_images: Optional[np.ndarray]


@torch.no_grad()
def decode_latents(vae: VAE, latents: torch.Tensor) -> torch.Tensor:
    """Final latents -> the VAE's images in [-1, 1]: z = latents /
    scaling_factor + shift_factor, decoded in the VAE's dtype (bf16 with K2
    on the card). Runs under ``torch.no_grad()``, whatever the caller's
    thread has set: grad mode is thread-local, and K2 has no backward."""
    cfg = vae.config
    return vae.decode(latents.float() / cfg.scaling_factor + cfg.shift_factor)


def seed_noise(seed, shape, device, dtype):
    """(generator, noise of ``shape``) for ``generate``'s ``seed``: an int
    draws the whole batch from ``torch.Generator(device).manual_seed(seed)``;
    a sequence of one seed a row draws row i as a batch-1 draw from its own
    seed does (the engines' per-request latents), and returns the first
    row's generator."""
    if np.ndim(seed) == 0:
        g = torch.Generator(device=device).manual_seed(int(seed))
        return g, torch.randn(shape, generator=g, device=device, dtype=dtype)
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seed]
    if len(gens) != shape[0]:
        raise ValueError(f"{len(gens)} seeds for a batch of {shape[0]}")
    row = (1,) + tuple(shape[1:])
    return gens[0], torch.cat([torch.randn(row, generator=g, device=device, dtype=dtype)
                               for g in gens])


def noised_latents(clean: torch.Tensor, noise: torch.Tensor, strength: torch.Tensor):
    """Image-to-image starting latents ``(1 - s) clean + s noise``, mixed in
    fp32 with ``strength`` (b,) fp32 and cast to the noise's dtype: at
    strength 1.0 the noise itself, bit for bit."""
    s = strength.to(device=noise.device, dtype=torch.float32).reshape(-1, 1, 1, 1)
    return ((1.0 - s) * clean.float() + s * noise.float()).to(noise.dtype)


def latent_mask(mask, size, device) -> torch.Tensor:
    """An inpainting mask (b, 1, H, W) at the image's size -> (b, 1, h, w)
    fp32 in [0, 1] on the latent grid: the antialiased bilinear resize
    that ``jax.image.resize(method="linear")`` is (a triangle filter
    widened by the scale factor), so a pixel boundary becomes a soft seam
    about one latent wide."""
    m = F.interpolate(mask.to(device), size=tuple(size), mode="bilinear", antialias=True,
                      align_corners=False)
    return torch.clamp(m, 0.0, 1.0)


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for an option whose port waits for ROADMAP queue 1's ``item``."""
    return NotImplementedError(
        f"{what} is not ported to tpdm_tpu_torch yet (ROADMAP queue 1, item {item})"
    )


def _raw_latents(latents: torch.Tensor) -> np.ndarray:
    """Final latents for a caller without a decode: numpy has no bf16, so a
    bf16 model's latents come back as float32 (the same values)."""
    return latents.float().cpu().numpy()


def _seq_group_refused(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} with seq_group has no parity check yet (ROADMAP queue 1, item 14(g))")


def _check_cache_options(cache_interval, cache_tau, guidance_interval, guidance_scale):
    """JAX's checks of the Δ-cache and window options; returns the window
    as floats (or None)."""
    if guidance_interval is not None:
        if guidance_scale is None:
            raise ValueError("guidance_interval requires classifier-free guidance "
                             "(guidance_scale is None)")
        guidance_interval = (float(guidance_interval[0]), float(guidance_interval[1]))
    if cache_tau and cache_interval >= 2:
        raise ValueError(
            "cache_tau (input-aware policy) and cache_interval (fixed schedule) are "
            "mutually exclusive — pick one reuse policy")
    return guidance_interval


class TPDMPipeline:
    """Adaptive-schedule SD3 generation (``generate``) and the fixed-schedule
    baseline (``generate_fixed``).

    Args:
        mmdit: the denoiser (``models.mmdit.MMDiT``).
        tpm: the time-prediction policy (``models.tpm.TimePredictor``).
        vae: decoder (optional: raw latents are returned without one);
            frozen (``requires_grad_(False)``, ``eval()``), as the text
            towers are.
        text_encoders: optional ``pipeline.text_encoding.SD3TextEncoders``
            for ``generate(clip_ids=, t5_ids=)``.
        min_sigma: stop threshold.
    """

    def __init__(
        self,
        mmdit: nn.Module,
        tpm: nn.Module,
        vae: Optional[VAE] = None,
        text_encoders=None,
        min_sigma: float = 0.001,
        relative: bool = True,
        prediction_type: str = "alpha_beta",
    ):
        self.mmdit = mmdit
        self.tpm = tpm
        self.vae = None if vae is None else vae.requires_grad_(False).eval()
        self.text_encoders = text_encoders
        self.min_sigma = min_sigma
        self.relative = relative
        self.prediction_type = prediction_type

    def _decode_impl(self, latents: torch.Tensor) -> torch.Tensor:
        return decode_latents(self.vae, latents)

    def _device_dtype(self):
        # a float parameter: a quantised MMDiT's int weights set no dtype
        param = next(p for p in self.mmdit.parameters() if p.is_floating_point())
        return param.device, param.dtype

    @torch.no_grad()
    def encode_image(self, images, generator: Optional[torch.Generator] = None,
                     sample_posterior: bool = False) -> torch.Tensor:
        """uint8 (b, H, W, 3) -> model-space latents (b, c, H/8, W/8), fp32
        on the VAE's device: the posterior mean (or, with
        ``sample_posterior``, a draw from ``generator``), then ``(z -
        shift_factor) * scaling_factor``, the inverse of the decode's
        transform. The encoder runs in the VAE's dtype (bf16 with K2 on the
        card). ``images``: a numpy array or a tensor."""
        if self.vae is None or self.vae.encoder is None:
            raise ValueError("pipeline has no VAE encoder; cannot encode images")
        device = next(self.vae.parameters()).device
        x = images if isinstance(images, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(images))
        mean, logvar = self.vae.encode(preprocess_images(x.to(device)))
        z = mean.float()
        if sample_posterior:
            if generator is None:
                raise ValueError("sample_posterior=True needs a generator")
            eps = torch.randn(mean.shape, generator=generator, device=device,
                              dtype=torch.float32)
            z = z + torch.exp(0.5 * logvar.float()) * eps
        cfg = self.vae.config
        return (z - cfg.shift_factor) * cfg.scaling_factor

    def _img2img(self, init_image, strength, mask, b, seed, device, dtype):
        """(generator, starting latents, init_sigma, projection or None) of
        ``generate(init_image=, strength=, mask=)``. The noise is drawn
        by the call that draws text-to-image latents, in the model dtype,
        and mixed in fp32, so strength 1.0 reproduces text-to-image bit for
        bit."""
        s0 = torch.broadcast_to(torch.as_tensor(strength, dtype=torch.float32), (b,))
        if bool(((s0 <= 0.0) | (s0 > 1.0)).any()):
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        clean = self.encode_image(init_image).to(device)
        if clean.shape[0] != b:
            raise ValueError(f"init_image batch {clean.shape[0]} != prompt batch {b}")
        generator, eps = seed_noise(seed, clean.shape, device, dtype)
        s0 = s0.to(device)
        latents = noised_latents(clean, eps, s0)
        if mask is None:
            return generator, latents, s0, None
        m = torch.as_tensor(mask, dtype=torch.float32)
        if m.dim() == 3:
            m = m[:, None]
        if m.dim() != 4 or m.shape[0] != b or m.shape[1] != 1:
            raise ValueError(f"mask must be (b, H, W) or (b, 1, H, W); got {tuple(m.shape)}")
        img_hw = tuple(init_image.shape[1:3])
        if tuple(m.shape[-2:]) != img_hw:
            raise ValueError(f"mask is {m.shape[-2]}x{m.shape[-1]}, init_image is "
                             f"{img_hw[0]}x{img_hw[1]}")
        return generator, latents, s0, (clean, eps.float(), latent_mask(m, clean.shape[-2:],
                                                                        device))

    def _cfg_embeds(self, prompt_embeds, pooled_prompt_embeds, negative_prompt_embeds,
                    negative_pooled_prompt_embeds, guidance_scale):
        """(prompt embeds, pooled embeds, guidance) on the MMDiT's device:
        [negative; positive] and (b,) fp32 strengths with CFG on."""
        device, dtype = self._device_dtype()
        as_dev = lambda t: torch.as_tensor(t, device=device, dtype=dtype)
        if guidance_scale is None:
            return as_dev(prompt_embeds), as_dev(pooled_prompt_embeds), None
        if negative_prompt_embeds is None or negative_pooled_prompt_embeds is None:
            raise ValueError(
                f"classifier-free guidance is on (guidance_scale={guidance_scale}); "
                "pass negative_prompt_embeds + negative_pooled_prompt_embeds "
                "(or guidance_scale=None)"
            )
        pe = torch.cat([as_dev(negative_prompt_embeds), as_dev(prompt_embeds)])
        pp = torch.cat([as_dev(negative_pooled_prompt_embeds), as_dev(pooled_prompt_embeds)])
        gs = torch.as_tensor(guidance_scale, dtype=torch.float32, device=device)
        return pe, pp, torch.broadcast_to(gs.reshape(-1), (prompt_embeds.shape[0],))

    def _cache_parts(self, latents, guided_rows: bool):
        """The MMDiT's record / reuse apply fns and the zero Δ for
        ``latents`` (on 2b rows with CFG)."""
        mcfg = self.mmdit.config
        device, dtype = self._device_dtype()
        p = mcfg.patch_size
        n_img = (latents.shape[-2] // p) * (latents.shape[-1] // p)
        rows = latents.shape[0] * (2 if guided_rows else 1)
        init_delta = torch.zeros((rows, n_img, mcfg.inner_dim), dtype=dtype, device=device)
        mode_apply = lambda mode: (
            lambda lat, t, pe, pp, d: self.mmdit(lat, t, pe, pp, delta=d, cache_mode=mode))
        return mode_apply("record"), mode_apply("reuse"), init_delta

    @torch.no_grad()
    def generate(
        self,
        prompt_embeds: Optional[torch.Tensor] = None,
        pooled_prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        negative_pooled_prompt_embeds: Optional[torch.Tensor] = None,
        clip_ids=None,
        t5_ids=None,
        negative_clip_ids=None,
        negative_t5_ids=None,
        latents: Optional[torch.Tensor] = None,
        max_inference_steps: int = 28,
        guidance_scale=7.0,
        predict: bool = True,
        seed: int = 0,
        return_full_process_images: bool = False,
        decode: bool = True,
        step_caps=None,
        init_image=None,
        strength: float = 0.6,
        mask=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        init_sigma=None,
        cache_interval: int = 0,
        guidance_interval: Optional[tuple] = None,
        cache_tau: float = 0.0,
        solver: str = "euler",
    ) -> GenerationResult:
        """Generate images with a per-prompt adaptive schedule.

        Takes precomputed embeds: ``prompt_embeds`` (b, n, joint_dim) and
        ``pooled_prompt_embeds`` (b, pooled_dim), plus their negatives when
        ``guidance_scale`` (a scalar or (b,) strengths) is not None. Or,
        without ``prompt_embeds``, token ids that the pipeline's
        ``text_encoders`` encode: ``clip_ids`` (b, 77) and ``t5_ids`` (b,
        256) or None, and ``negative_clip_ids`` / ``negative_t5_ids`` with
        CFG (each side encoded in one call of its own).
        ``latents`` (b, c, h, w) fixes the initial noise; otherwise it is
        drawn from ``torch.Generator().manual_seed(seed)`` on the MMDiT's
        device, which then also draws the Beta ratios when
        ``predict=False``; ``seed`` may also be one int a sample, each row
        then drawn as a batch-1 call with its seed draws it (the engines'
        per-request latents), the first row's generator drawing the
        ratios. ``step_caps`` caps each sample's steps;
        ``init_sigma`` sets per-sample starting noise levels;
        ``decode=False`` returns the raw final latents in ``images``.

        ``return_full_process_images`` keeps every step's latents and
        decodes the first ``num_steps`` of them into ``history_images``
        (T, b, H, W, 3) uint8 (with a VAE). ``cache_interval`` >= 2 reuses
        the Δ-cache between full forwards every ``cache_interval`` steps;
        ``cache_tau`` > 0 reuses it by the input-aware rule instead (see
        ``SamplerConfig``); both approximate, and reuse steps run only
        ``MMDiTConfig.cache_front_blocks`` blocks. ``guidance_interval``
        (lo, hi) applies CFG only while sigma is in [lo, hi), with one
        conditional forward at batch b on a step where no sample is.
        ``solver``: "euler" or "ab2".

        ``init_image`` uint8 (b, H, W, 3) runs image-to-image: its latents
        (``encode_image``) are noised to ``strength`` (a scalar or (b,), in
        (0, 1]) with the noise text-to-image would start from, and each
        sample starts at sigma = its strength; H and W set the size
        (``height`` / ``width`` are ignored). ``mask`` (b, H, W) or (b, 1,
        H, W) in [0, 1] inpaints: 1 regenerates, 0 keeps the init image.
        After each step the kept region is re-imposed at the step's noise
        level, and the final latents are composited with the init
        latents before the decode. ``init_image`` excludes ``latents``,
        ``init_sigma`` and a seq group.
        """
        if prompt_embeds is None:
            if self.text_encoders is None or clip_ids is None:
                raise ValueError("need prompt_embeds or (text_encoders + ids)")
            prompt_embeds, pooled_prompt_embeds = self.text_encoders.encode(clip_ids, t5_ids)
            if guidance_scale is not None:
                if negative_clip_ids is None:
                    raise ValueError("CFG needs negative ids (or embeds)")
                negative_prompt_embeds, negative_pooled_prompt_embeds = (
                    self.text_encoders.encode(negative_clip_ids, negative_t5_ids))
        if mask is not None and init_image is None:
            raise ValueError("mask (inpainting) requires init_image")
        if init_image is not None:
            if latents is not None:
                raise ValueError("pass init_image or latents, not both")
            if init_sigma is not None:
                raise ValueError("init_sigma is derived from strength when init_image is "
                                 "given; pass one or the other")
            if self.mmdit.config.seq_group is not None:
                raise _seq_group_refused("init_image (img2img, inpainting)")

        mcfg = self.mmdit.config
        device, dtype = self._device_dtype()
        b = prompt_embeds.shape[0]
        pe, pp, guidance_scale = self._cfg_embeds(
            prompt_embeds, pooled_prompt_embeds, negative_prompt_embeds,
            negative_pooled_prompt_embeds, guidance_scale)
        guidance_interval = _check_cache_options(cache_interval, cache_tau, guidance_interval,
                                                 guidance_scale)

        proj = None
        if init_image is not None:
            generator, latents, init_sigma, proj = self._img2img(
                init_image, strength, mask, b, seed, device, dtype)
        elif latents is None:
            lh = lw = mcfg.sample_size
            if height is not None or width is not None:
                f = vae_scale_factor(self.vae.config) if self.vae is not None else 8
                fp = f * mcfg.patch_size
                h_px = height if height is not None else width
                w_px = width if width is not None else height
                if h_px % fp or w_px % fp:
                    raise ValueError(
                        f"height/width must be divisible by {fp} (VAE factor {f} x patch "
                        f"{mcfg.patch_size}); got {h_px}x{w_px}"
                    )
                lh, lw = h_px // f, w_px // f
            generator, latents = seed_noise(seed, (b, mcfg.in_channels, lh, lw), device, dtype)
        else:
            generator = torch.Generator(device=device).manual_seed(int(np.ravel(seed)[0]))
            latents = torch.as_tensor(latents, device=device)
        group = mcfg.seq_group
        if group is not None and (guidance_interval is not None or cache_interval >= 2
                                  or cache_tau > 0):
            raise _seq_group_refused("the Δ-cache and the guidance window")
        if group is not None and group.size > 1:
            latents = latents.clone(memory_format=torch.contiguous_format)
            dist.broadcast(latents, src=group.global_rank(0), group=group.group)

        p = mcfg.patch_size
        grid = (latents.shape[-2] // p, latents.shape[-1] // p)
        windowed = guidance_interval is not None
        cached = denoise_fn = None
        if cache_interval >= 2 or cache_tau > 0:
            record, reuse, init_delta = self._cache_parts(latents, guidance_scale is not None)
            if windowed:
                full_fn, reuse_fn = make_cfg_interval_denoise_cached_fns(
                    record, reuse, pe, pp, guidance_scale, guidance_interval, grid, p)
                init_delta = interval_cached_init_delta(init_delta)
            else:
                full_fn, reuse_fn = make_cfg_denoise_cached_fns(
                    record, reuse, pe, pp, guidance_scale, grid, p)
            cached = CachedDenoise(full_fn, reuse_fn, init_delta,
                                   cache_reuse_schedule(max_inference_steps, cache_interval),
                                   tau=cache_tau if cache_tau > 0 else None)
        elif windowed:
            denoise_fn = make_cfg_interval_denoise_fn(
                self.mmdit, pe, pp, guidance_scale, guidance_interval, grid, p)
        else:
            denoise_fn = make_cfg_denoise_fn(self.mmdit, pe, pp, guidance_scale, grid, p)
        scfg = SamplerConfig(
            max_inference_steps=max_inference_steps,
            min_sigma=self.min_sigma,
            relative=self.relative,
            prediction_type=self.prediction_type,
            predict=predict,
            cache_activations=False,
            keep_history=return_full_process_images,
            cache_interval=cache_interval,
            cache_tau=cache_tau,
            guidance_interval=guidance_interval,
            solver=solver,
        )
        project_fn = None
        if proj is not None:
            x0, eps, m = proj

            def project_fn(lat, sig_next):
                # the known region at the step's new noise level, with the
                # starting noise (RePaint / diffusers-legacy)
                sb = sig_next.reshape(-1, 1, 1, 1)
                known = (1.0 - sb) * x0 + sb * eps
                return (m * lat.float() + (1.0 - m) * known).to(lat.dtype)

        out = adaptive_sample(
            denoise_fn, self.tpm, latents, generator, scfg,
            step_caps=step_caps, init_sigma=init_sigma, group=group, cached=cached,
            project_fn=project_fn,
        )
        if proj is not None:
            # the exact composite: the kept region is the init image's
            # latents, wherever each sample's schedule stopped
            final = out.final_latents
            out = out._replace(final_latents=(m * final.float() + (1.0 - m) * x0).to(final.dtype))
        history = None
        if return_full_process_images and self.vae is not None:
            history = np.stack([postprocess_images(self._decode_impl(out.history_latents[t]))
                                for t in range(out.num_steps)])
        if decode and self.vae is not None:
            images = postprocess_images(self._decode_impl(out.final_latents))
        else:
            images = _raw_latents(out.final_latents)
        host = lambda t: t.cpu().numpy()
        return GenerationResult(
            images=images,
            num_steps=out.num_steps,
            sigmas=host(out.sigmas),
            alphas=host(out.alphas),
            betas=host(out.betas),
            prob_masks=host(out.prob_masks),
            last_valid_index=host(out.last_valid_index),
            history_images=history,
        )

    @torch.no_grad()
    def generate_fixed(
        self,
        prompt_embeds,
        pooled_prompt_embeds,
        negative_prompt_embeds=None,
        negative_pooled_prompt_embeds=None,
        num_steps: int = 28,
        guidance_scale=7.0,
        seed: int = 0,
        latents=None,
        cache_interval: int = 0,
        guidance_interval: Optional[tuple] = None,
        cache_tau: float = 0.0,
        solver: str = "euler",
    ) -> np.ndarray:
        """The fixed-schedule baseline (no TPM): ``num_steps`` steps down
        ``uniform_flow_sigmas(num_steps)`` to sigma 0. Returns (b, H, W, 3)
        uint8 images, or the raw final latents without a VAE.

        ``solver`` (``FLOW_SOLVERS``): "euler", "heun" and "midpoint" (2
        evaluations a step, heun's last step Euler), or "ab2" (one
        evaluation a step, the previous velocity carried).
        ``cache_interval``, ``cache_tau`` and ``guidance_interval`` as in
        :meth:`generate`; the caches go with Euler only, since their reuse
        schedule counts one evaluation a ladder step. ``latents`` fixes the
        initial noise; otherwise it is drawn from
        ``torch.Generator().manual_seed(seed)`` on the MMDiT's device.
        """
        if solver not in FLOW_SOLVERS:
            raise ValueError(f"unknown solver {solver!r}; pick from {FLOW_SOLVERS}")
        if solver != "euler" and (cache_tau or cache_interval >= 2):
            raise ValueError(
                "second-order solvers do not compose with residual caching "
                "(cache_interval / cache_tau) — the Δ-cache reuse schedule counts one "
                "model evaluation per ladder step")
        guidance_interval = _check_cache_options(cache_interval, cache_tau, guidance_interval,
                                                 guidance_scale)
        mcfg = self.mmdit.config
        if mcfg.seq_group is not None:
            raise _seq_group_refused("generate_fixed")
        device, dtype = self._device_dtype()
        pe, pp, guidance_scale = self._cfg_embeds(
            prompt_embeds, pooled_prompt_embeds, negative_prompt_embeds,
            negative_pooled_prompt_embeds, guidance_scale)
        if latents is None:
            generator = torch.Generator(device=device).manual_seed(seed)
            shape = (prompt_embeds.shape[0], mcfg.in_channels, mcfg.sample_size, mcfg.sample_size)
            latents = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        else:
            latents = torch.as_tensor(latents, device=device)
        sigmas = uniform_flow_sigmas(num_steps)
        if cache_interval >= 2 or cache_tau > 0:
            record, reuse, init_delta = self._cache_parts(latents, guidance_scale is not None)
            if guidance_interval is not None:
                full_fn, reuse_fn = make_cfg_interval_velocity_cached_fns(
                    record, reuse, pe, pp, guidance_scale, guidance_interval)
                init_delta = interval_cached_init_delta(init_delta)
            else:
                full_fn, reuse_fn = make_cfg_velocity_cached_fns(record, reuse, pe, pp,
                                                                 guidance_scale)
            if cache_tau > 0:
                final, _ = fixed_schedule_sample_autocached(
                    full_fn, reuse_fn, latents, sigmas, init_delta, cache_tau, guidance_interval)
            else:
                final = fixed_schedule_sample_cached(
                    full_fn, reuse_fn, latents, sigmas, init_delta,
                    cache_reuse_schedule(num_steps, cache_interval), guidance_interval)
        else:
            if guidance_interval is not None:
                vfn = make_cfg_interval_velocity_fn(self.mmdit, pe, pp, guidance_scale,
                                                    guidance_interval)
            else:
                vfn = make_cfg_velocity_fn(self.mmdit, pe, pp, guidance_scale)
            final = fixed_schedule_sample_solver(vfn, latents, sigmas, solver, guidance_interval)
        if self.vae is None:
            return _raw_latents(final)
        return postprocess_images(self._decode_impl(final))


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on the CPU")
    return device


def _load_dir(root: str, sub: str, keep: Callable[[str], bool] = lambda key: True) -> dict:
    """The tensors of every ``*.safetensors`` shard in ``root/sub`` whose
    name ``keep`` accepts; the others' bytes are never read."""
    from tpdm_tpu_torch.utils import safetensors

    d = os.path.join(root, sub)
    shards = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors file in {d}")
    sd = {}
    for f in shards:
        path = os.path.join(d, f)
        keys = [k for k in safetensors.read_header(path) if k != "__metadata__" and keep(k)]
        sd.update(safetensors.load_file(path, keys))
    return sd


def _from_state(build: Callable[[], nn.Module], state: dict, device, dtype) -> nn.Module:
    """``build()`` on the meta device, given ``state``'s tensors, then moved
    to ``device`` and ``dtype``: no random initialisation, and a strict load."""
    with torch.device("meta"):
        module = build()
    module.load_state_dict(state, assign=True)
    return module.to(device=device, dtype=dtype).eval()


def load_pipeline_from_pretrained(
    root: str,
    dtype: torch.dtype = torch.bfloat16,
    load_text_encoders: bool = True,
    tpm_checkpoint: Optional[str] = None,
    mmdit_config: Optional[MMDiTConfig] = None,
    quant_int8: bool = False,
    quant_bits: int = 8,
    quant_text: bool = False,
    device="cuda",
) -> TPDMPipeline:
    """A pipeline from a local diffusers-layout SD3 directory.

    Counterpart of ``tpdm_tpu/pipeline/pipeline.py:load_pipeline_from_
    pretrained``. ``root`` holds ``transformer/``, ``vae/`` and, with
    ``load_text_encoders``, ``text_encoder/`` (CLIP-L), ``text_encoder_2/``
    (CLIP-G) and ``text_encoder_3/`` (T5-XXL), each with one or more
    ``*.safetensors`` shards, read by the port's own reader. The MMDiT is
    SD3-medium's, quantised at ``quant_bits`` with ``quant_int8``, unless
    ``mmdit_config`` names another (SD3.5: ``MMDiTConfig.sd35_medium()``,
    ``sd35_large()``), whose quant fields then hold, as in JAX. A
    quantised MMDiT loads the float weights and is prequantised once. The
    TPM (``in_channels`` 2 x the MMDiT's width, ``temb_dim`` its width)
    comes from ``tpm_checkpoint``, a TPM-only safetensors file in the
    reference's layout, or is drawn from seed 0; its weights stay fp32 and
    compute in ``dtype``. The MMDiT, VAE and towers are cast to ``dtype``.

    Everything is built on ``device`` (the card unless the caller asks for
    the CPU); JAX's host-resident text towers, a policy for a 16 GB TPU,
    are not carried over: the whole stack fits on an 80 GB card.
    ``quant_text`` stores T5-XXL's block matmuls as weight-only int8, or
    int4 at ``quant_bits`` 4 (``models/t5.py``): the float weights load,
    are cast to ``dtype`` and are prequantised once, as the MMDiT's are.
    """
    from tpdm_tpu_torch.ops.quant import prequantize_
    from tpdm_tpu_torch.utils import convert

    device = resolve_device(device)
    mcfg = mmdit_config or MMDiTConfig.sd3_medium(
        dtype=dtype, quant_matmuls=quant_int8, quant_bits=quant_bits)
    mmdit = _from_state(
        lambda: MMDiT(mcfg),
        convert.convert_mmdit(_load_dir(root, "transformer"), mcfg.num_layers,
                              mcfg.dual_attention_layers, mcfg.qk_norm),
        device, dtype)
    if mcfg.quant_matmuls:
        prequantize_(mmdit)

    vcfg = VAEConfig.sd3()
    vae_state = convert.convert_vae(_load_dir(root, "vae"), vcfg.block_out_channels,
                                    vcfg.layers_per_block)
    # a decoder-only directory builds a VAE without an encoder (no img2img)
    vae = _from_state(lambda: VAE(vcfg, encoder="encoder.conv_in.weight" in vae_state),
                      vae_state, device, dtype)

    with torch.device(device):
        tpm = TimePredictor(conv_out_channels=128, in_channels=2 * mcfg.inner_dim,
                            temb_dim=mcfg.inner_dim, dtype=dtype)
    if tpm_checkpoint is not None:
        tpm.load_state_dict(convert.convert_tpm(convert.load_safetensors(tpm_checkpoint)))
    else:
        tpm.init_weights(torch.Generator(device=device).manual_seed(0))
    tpm.eval()

    text = None
    if load_text_encoders:
        from tpdm_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
        from tpdm_tpu_torch.models.t5 import T5Config, T5Encoder
        from tpdm_tpu_torch.pipeline.text_encoding import SD3TextEncoders

        towers = []
        for sub, cfg in (("text_encoder", CLIPTextConfig.sd3_clip_l()),
                         ("text_encoder_2", CLIPTextConfig.sd3_clip_g())):
            state = convert.convert_clip_text(_load_dir(root, sub), cfg.num_hidden_layers)
            towers.append(_from_state(lambda: CLIPTextModel(cfg), state, device, dtype))
        tcfg = T5Config.t5_xxl(quant_matmuls=quant_text, quant_bits=quant_bits)
        t5 = _from_state(lambda: T5Encoder(tcfg),
                         convert.convert_t5(_load_dir(root, "text_encoder_3"), tcfg.num_layers),
                         device, dtype)
        if quant_text:
            prequantize_(t5)
        text = SD3TextEncoders(*towers, t5, t5_width=tcfg.d_model)
    return TPDMPipeline(mmdit, tpm, vae, text_encoders=text)
