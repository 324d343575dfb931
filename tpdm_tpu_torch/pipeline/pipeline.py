"""TPDMPipeline: adaptive-schedule SD3 text-to-image generation.

Counterpart of ``tpdm_tpu/pipeline/pipeline.py``'s ``generate`` on
precomputed prompt embeds: the CFG-doubled MMDiT and the TPM run the
adaptive loop (``pipeline/sampler.py``), then the VAE decodes each sample's
last valid latents to uint8 images. The modules hold their own weights, on
their own device; the pipeline runs where the MMDiT's weights are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from tpdm_tpu_torch.models.vae import VAE, vae_scale_factor
from tpdm_tpu_torch.pipeline.denoise import make_cfg_denoise_fn
from tpdm_tpu_torch.pipeline.sampler import SamplerConfig, adaptive_sample
from tpdm_tpu_torch.utils.image import postprocess_images


class GenerationResult(NamedTuple):
    images: np.ndarray  # (b, H, W, 3) uint8, the last valid image per sample
    num_steps: int  # loop iterations executed
    sigmas: np.ndarray  # (b, T)
    alphas: np.ndarray
    betas: np.ndarray
    prob_masks: np.ndarray
    last_valid_index: np.ndarray  # (b,) per-sample NFE - 1
    history_images: Optional[np.ndarray]  # not ported yet: always None


def _not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tpdm_tpu_torch yet (ROADMAP queue 1: {slice_name})"
    )


class TPDMPipeline:
    """Adaptive-schedule SD3 generation.

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
        cfg = self.vae.config
        z = latents.float() / cfg.scaling_factor + cfg.shift_factor
        return self.vae.decode(z)

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

        Options whose slice is not ported yet raise NotImplementedError.
        """
        if clip_ids is not None or t5_ids is not None or prompt_embeds is None:
            raise _not_ported("prompt token ids (text encoding)", "text encoders")
        if return_full_process_images:
            raise _not_ported("return_full_process_images", "fixed_schedule_sample*/generate_fixed")
        if init_image is not None or mask is not None:
            raise _not_ported("init_image / mask (img2img, inpainting)", "the VAE Encoder")
        if cache_interval >= 2 or cache_tau > 0:
            raise _not_ported("cache_interval / cache_tau", "the Δ-cache and guidance-interval knobs")
        if guidance_interval is not None:
            raise _not_ported("guidance_interval", "the Δ-cache and guidance-interval knobs")
        if solver != "euler":
            raise _not_ported(f"solver={solver!r}", "the Δ-cache and guidance-interval knobs")

        mcfg = self.mmdit.config
        param = next(self.mmdit.parameters())
        device, dtype = param.device, param.dtype
        as_dev = lambda t: torch.as_tensor(t, device=device, dtype=dtype)
        b = prompt_embeds.shape[0]
        if guidance_scale is not None:
            if negative_prompt_embeds is None or negative_pooled_prompt_embeds is None:
                raise ValueError(
                    f"classifier-free guidance is on (guidance_scale={guidance_scale}); "
                    "pass negative_prompt_embeds + negative_pooled_prompt_embeds "
                    "(or guidance_scale=None)"
                )
            pe = torch.cat([as_dev(negative_prompt_embeds), as_dev(prompt_embeds)])
            pp = torch.cat([as_dev(negative_pooled_prompt_embeds), as_dev(pooled_prompt_embeds)])
            gs = torch.as_tensor(guidance_scale, dtype=torch.float32, device=device)
            guidance_scale = torch.broadcast_to(gs.reshape(-1), (b,))
        else:
            pe, pp = as_dev(prompt_embeds), as_dev(pooled_prompt_embeds)

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

        p = mcfg.patch_size
        denoise_fn = make_cfg_denoise_fn(
            self.mmdit, pe, pp, guidance_scale,
            (latents.shape[-2] // p, latents.shape[-1] // p), p,
        )
        scfg = SamplerConfig(
            max_inference_steps=max_inference_steps,
            min_sigma=self.min_sigma,
            relative=self.relative,
            prediction_type=self.prediction_type,
            predict=predict,
            cache_activations=False,
        )
        out = adaptive_sample(
            denoise_fn, self.tpm, latents, generator, scfg,
            step_caps=step_caps, init_sigma=init_sigma,
        )
        if decode and self.vae is not None:
            images = postprocess_images(self._decode_impl(out.final_latents))
        else:
            images = out.final_latents.cpu().numpy()
        host = lambda t: t.cpu().numpy()
        return GenerationResult(
            images=images,
            num_steps=out.num_steps,
            sigmas=host(out.sigmas),
            alphas=host(out.alphas),
            betas=host(out.betas),
            prob_masks=host(out.prob_masks),
            last_valid_index=host(out.last_valid_index),
            history_images=None,
        )
