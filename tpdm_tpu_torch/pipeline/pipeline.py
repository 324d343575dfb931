"""TPDMPipeline: adaptive-schedule SD3 text-to-image generation.

Counterpart of ``tpdm_tpu/pipeline/pipeline.py``'s ``generate`` and
``generate_fixed`` on precomputed prompt embeds. ``generate``: the
CFG-doubled MMDiT and the TPM run the adaptive loop (``pipeline/
sampler.py``), then the VAE decodes each sample's last valid latents to
uint8 images. ``generate_fixed``: the baseline without the TPM, a fixed
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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpdm_tpu_torch.models.vae import VAE, vae_scale_factor
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
from tpdm_tpu_torch.utils.image import postprocess_images


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


def decode_latents(vae: VAE, latents: torch.Tensor) -> torch.Tensor:
    """Final latents -> the VAE's images in [-1, 1]: z = latents /
    scaling_factor + shift_factor, decoded in the VAE's dtype (bf16 with K2
    on the card)."""
    cfg = vae.config
    return vae.decode(latents.float() / cfg.scaling_factor + cfg.shift_factor)


def _not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tpdm_tpu_torch yet (ROADMAP queue 1: {slice_name})"
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
        vae: decoder (optional: raw latents are returned without one).
        text_encoders: not ported yet; must be None.
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
        if text_encoders is not None:
            raise _not_ported("text_encoders", "text encoders")
        self.mmdit = mmdit
        self.tpm = tpm
        self.vae = vae
        self.min_sigma = min_sigma
        self.relative = relative
        self.prediction_type = prediction_type

    def _decode_impl(self, latents: torch.Tensor) -> torch.Tensor:
        return decode_latents(self.vae, latents)

    def _device_dtype(self):
        # a float parameter: a quantised MMDiT's int weights set no dtype
        param = next(p for p in self.mmdit.parameters() if p.is_floating_point())
        return param.device, param.dtype

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
        ``guidance_scale`` (a scalar or (b,) strengths) is not None.
        ``latents`` (b, c, h, w) fixes the initial noise; otherwise it is
        drawn from ``torch.Generator().manual_seed(seed)`` on the MMDiT's
        device, which then also draws the Beta ratios when
        ``predict=False``. ``step_caps`` caps each sample's steps;
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

        Text encoding (token ids) and img2img / inpainting (``init_image``,
        ``mask``) are not ported yet and raise NotImplementedError.
        """
        if clip_ids is not None or t5_ids is not None or prompt_embeds is None:
            raise _not_ported("prompt token ids (text encoding)", "text encoders")
        if init_image is not None or mask is not None:
            raise _not_ported("init_image / mask (img2img, inpainting)", "the VAE Encoder")

        mcfg = self.mmdit.config
        device, dtype = self._device_dtype()
        b = prompt_embeds.shape[0]
        pe, pp, guidance_scale = self._cfg_embeds(
            prompt_embeds, pooled_prompt_embeds, negative_prompt_embeds,
            negative_pooled_prompt_embeds, guidance_scale)
        guidance_interval = _check_cache_options(cache_interval, cache_tau, guidance_interval,
                                                 guidance_scale)

        generator = torch.Generator(device=device).manual_seed(seed)
        if latents is None:
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
            latents = torch.randn(
                (b, mcfg.in_channels, lh, lw), generator=generator, device=device, dtype=dtype
            )
        else:
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
        out = adaptive_sample(
            denoise_fn, self.tpm, latents, generator, scfg,
            step_caps=step_caps, init_sigma=init_sigma, group=group, cached=cached,
        )
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
