"""SD1.5 agent: frozen UNet + TPM over the integer-t DPM-Solver++ loop.

Counterpart of ``tpdm_tpu/train/sd15_agent.py``: the denoise builders (CFG
applied to eps and to the TPM's inputs temb, h1 and h2; the guidance
window; the DeepCache pair) and ``SD15Agent`` with the agent protocol of
``train/rloo.py:TPDMAgent`` (sample, replay, logprobs, kl_divergence), zero
KL as the reference's SD1.5 model. The UNet runs under ``torch.no_grad()``
only: the CUDA kernels return tensors without a ``grad_fn``.

Not ported: the hooks that differentiate through the backbone
(``denoise_builder``, ``forward_noising``, ``draft_step_builder``) wait
for the kernels' backward (ROADMAP queue 1, item 9(e)); ``shard`` is the
TPU's GSPMD placement, which the port has no counterpart of.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from tpdm_tpu_torch.models.tpm import TimePredictor
from tpdm_tpu_torch.models.unet_sd15 import UNetSD15, deepcache_feature_shape
from tpdm_tpu_torch.pipeline.denoise import (
    _guide,
    _guide_in_window,
    _interval_weight,
    interval_cached_init_delta,
    make_interval_cached_denoise_pair,
)
from tpdm_tpu_torch.pipeline.pipeline import not_ported
from tpdm_tpu_torch.pipeline.sampler import CachedDenoise, cache_reuse_schedule
from tpdm_tpu_torch.pipeline.sd15_sampler import (
    SD15SampleOutput,
    SD15SamplerConfig,
    sd15_adaptive_sample,
    sd15_replay_logprobs,
)
from tpdm_tpu_torch.train.config import RLOOConfig


def _cfg_on(guidance_scale) -> bool:
    return guidance_scale is not None and guidance_scale > 1


def _doubled(latents, t):
    return torch.cat([latents, latents]), torch.cat([t, t])


def make_sd15_denoise_fn(unet_apply: Callable, prompt_embeds: torch.Tensor,
                         guidance_scale: Optional[float]):
    """``denoise_fn(latents, t) -> (eps, temb, h_combined)``: with CFG
    (guidance_scale > 1) one forward at the doubled batch against
    ``prompt_embeds`` = [negative; positive], the guidance combine applied
    to eps, temb, h1 and h2; h_combined = cat([h1, h2], channels).
    ``unet_apply(latents, t, ctx) -> (eps, temb, h1, h2)``."""

    def denoise_fn(latents, t):
        if _cfg_on(guidance_scale):
            outs = unet_apply(*_doubled(latents, t), prompt_embeds)
            outs = [_guide(a, guidance_scale) for a in outs]
        else:
            outs = unet_apply(latents, t, prompt_embeds)
        eps, temb, h1, h2 = outs
        return eps, temb, torch.cat([h1, h2], dim=1)

    return denoise_fn


def make_sd15_interval_denoise_fn(unet_apply: Callable, prompt_embeds: torch.Tensor,
                                  guidance_scale, interval):
    """The guidance-interval form, in integer-t units: ``denoise_fn(latents,
    t, guided)``. ``guided`` (a host bool: is any sample's t in [lo, hi)?)
    runs the doubled forward with weight ``guidance_scale`` inside the
    window and 1 (conditional only) outside; otherwise one conditional
    forward at batch b."""
    if not _cfg_on(guidance_scale):
        raise ValueError("guidance interval requires CFG on")
    n = prompt_embeds.shape[0] // 2

    def denoise_fn(latents, t, guided: bool):
        if guided:
            outs = unet_apply(*_doubled(latents, t), prompt_embeds)
            outs = _guide_in_window(outs, t, guidance_scale, interval)
        else:
            outs = unet_apply(latents, t, prompt_embeds[n:][:latents.shape[0]])
        eps, temb, h1, h2 = outs
        return eps, temb, torch.cat([h1, h2], dim=1)

    return denoise_fn


def make_sd15_denoise_cached_fns(unet_apply_record: Callable, unet_apply_reuse: Callable,
                                 prompt_embeds: torch.Tensor, guidance_scale):
    """The DeepCache pair ``(full_fn, reuse_fn)``, each ``(latents, t,
    cache) -> (eps, temb, h_combined, cache)``; the apply fns ``(latents,
    t, ctx, cache) -> (eps, temb, h1, h2, cache)``. The cache rides the
    doubled batch and is never guidance-combined."""

    def make(apply_fn):
        def denoise_fn(latents, t, cache):
            if _cfg_on(guidance_scale):
                *outs, cache = apply_fn(*_doubled(latents, t), prompt_embeds, cache)
                outs = [_guide(a, guidance_scale) for a in outs]
            else:
                *outs, cache = apply_fn(latents, t, prompt_embeds, cache)
            eps, temb, h1, h2 = outs
            return eps, temb, torch.cat([h1, h2], dim=1), cache

        return denoise_fn

    return make(unet_apply_record), make(unet_apply_reuse)


def make_sd15_interval_denoise_cached_fns(unet_apply_record: Callable,
                                          unet_apply_reuse: Callable,
                                          prompt_embeds: torch.Tensor, guidance_scale,
                                          interval):
    """DeepCache × the guidance window (integer-t units): the pair of
    ``pipeline/denoise.py:make_interval_cached_denoise_pair``, each fn
    ``(latents, t, cache_state, guided) -> (eps, temb, h_combined,
    cache_state)`` with ``cache_state`` from ``interval_cached_init_delta``."""
    if not _cfg_on(guidance_scale):
        raise ValueError("guidance interval requires CFG on")
    n = prompt_embeds.shape[0] // 2

    def g_fwd(apply_fn):
        def run(latents, t, cache):
            *outs, cache = apply_fn(*_doubled(latents, t), prompt_embeds, cache)
            return tuple(outs), cache

        return run

    def c_fwd(apply_fn):
        def run(latents, t, cache):
            *outs, cache = apply_fn(latents, t, prompt_embeds[n:][:latents.shape[0]], cache)
            return tuple(outs), cache

        return run

    return make_interval_cached_denoise_pair(
        g_fwd(unet_apply_record), g_fwd(unet_apply_reuse),
        c_fwd(unet_apply_record), c_fwd(unet_apply_reuse),
        lambda t: _interval_weight(t, guidance_scale, interval),
        lambda outs: (outs[0], outs[1], torch.cat([outs[2], outs[3]], dim=1)))


class SD15Agent:
    """Frozen SD1.5 UNet + trainable TPM + the integer-t adaptive loop.

    Args:
        unet: the ``UNetSD15``, on its device and dtype (bf16 on the card).
        config: RLOOConfig (``max_inference_steps``, ``init_alpha``,
            ``init_beta``, ``tpm_param_cap``).
        tpm: a factory that returns a fresh TPM module; None builds the
            SD1.5 TPM (128 conv channels over h_combined's 2 x 320 channels,
            conditioned on the 320-wide sinusoidal t_feat), fp32 parameters
            computing in the UNet's dtype.
        min_time: the loop's stop threshold in integer t.
        guidance_scale: CFG strength (None or <= 1: off).
    """

    prediction_space = "epsilon"

    def __init__(self, unet: UNetSD15, config: RLOOConfig,
                 tpm: Optional[Callable[[], nn.Module]] = None, min_time: int = 10,
                 guidance_scale: Optional[float] = 7.5):
        self.unet = unet.requires_grad_(False).eval()
        self.config = config
        self.guidance_scale = guidance_scale
        ucfg = unet.config
        param = next(unet.parameters())
        self.device, self.dtype = param.device, param.dtype
        self.tpm_factory = tpm or (lambda: TimePredictor(
            conv_out_channels=128,
            in_channels=2 * ucfg.block_out_channels[0],
            temb_dim=ucfg.block_out_channels[0],
            init_alpha=config.init_alpha,
            init_beta=config.init_beta,
            param_cap=config.tpm_param_cap,
            dtype=self.dtype,
        ))
        self.sampler_cfg = SD15SamplerConfig(
            num_inference_steps=config.max_inference_steps, min_time=min_time,
            cache_activations=True)

    def denoise_builder(self, params, batch):
        raise not_ported("SD15Agent.denoise_builder (a backward through the UNet)", "9(e)")

    def forward_noising(self, x0, eps, s):
        raise not_ported("SD15Agent.forward_noising (the DPO trainer)", "9(e)")

    def draft_step_builder(self, num_steps: int):
        raise not_ported("SD15Agent.draft_step_builder (reward-gradient rollouts)", "9(e)")

    def init_tpm_params(self, generator: torch.Generator) -> nn.Module:
        """A fresh TPM on the UNet's device, its weights drawn from
        ``generator`` (on that device): N(0, 0.02²), zero biases, the head's
        bias (init_alpha, init_beta)."""
        with torch.device(self.device):
            return self.tpm_factory().init_weights(generator)

    def tpm_fn(self, tpm: nn.Module) -> Callable:
        """The TPM as the loop calls it, ``(h_combined, t_feat) -> (b, 2)``."""
        return tpm

    def prepare_latents(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """Unit-variance noise (DPM-Solver's init_noise_sigma is 1 in
        epsilon space), (b, in_channels, sample_size, sample_size)."""
        ucfg = self.unet.config
        shape = (batch_size, ucfg.in_channels, ucfg.sample_size, ucfg.sample_size)
        return torch.randn(shape, generator=generator, device=self.device, dtype=self.dtype)

    def _embeds(self, batch: dict) -> torch.Tensor:
        pe = batch["prompt_embeds"]
        if _cfg_on(self.guidance_scale):
            pe = torch.cat([torch.as_tensor(batch["negative_prompt_embeds"]),
                            torch.as_tensor(pe)])
        return torch.as_tensor(pe, device=self.device).to(self.dtype)

    def _conditioning(self, batch: dict):
        """(context rows, unet): the text context ([negative; positive] under
        CFG) on the UNet's device and dtype, and the UNet as the denoise
        builders call it, ``(latents, t, ctx, **cache_kw)``. SDXL's agent
        adds its pooled and size conditioning here."""
        return self._embeds(batch), self.unet

    def _make_cached(self, latents, pe, scfg: SD15SamplerConfig, unet) -> CachedDenoise:
        """The DeepCache pair (with the guidance window composed where one
        is set), its zero initial feature at the doubled batch."""
        mode_apply = lambda mode: (
            lambda lat, t, ctx, c: unet(lat, t, ctx, cache=c, cache_mode=mode))
        bb = latents.shape[0] * (2 if _cfg_on(self.guidance_scale) else 1)
        init = torch.zeros(deepcache_feature_shape(self.unet.config, bb, latents.shape[-2:]),
                           dtype=self.dtype, device=self.device)
        if scfg.guidance_interval is not None:
            full_fn, reuse_fn = make_sd15_interval_denoise_cached_fns(
                mode_apply("record"), mode_apply("reuse"), pe, self.guidance_scale,
                scfg.guidance_interval)
            init = interval_cached_init_delta(init)
        else:
            full_fn, reuse_fn = make_sd15_denoise_cached_fns(
                mode_apply("record"), mode_apply("reuse"), pe, self.guidance_scale)
        return CachedDenoise(full_fn, reuse_fn, init,
                             cache_reuse_schedule(scfg.num_inference_steps, scfg.cache_interval),
                             tau=scfg.cache_tau if scfg.cache_tau > 0 else None)

    @torch.no_grad()
    def sample(self, tpm: nn.Module, batch: dict, generator: Optional[torch.Generator],
               predict: bool = False, sampler_cfg: Optional[SD15SamplerConfig] = None,
               step_caps=None) -> SD15SampleOutput:
        """Rollout of ``batch``: ``prompt_embeds`` (b, n, d) and, with CFG,
        ``negative_prompt_embeds``; optional ``latents`` (else drawn from
        ``generator``, which then draws the Beta ratios) and ``init_t``
        ((b,) int starting timesteps, the integer-t img2img entry)."""
        pe, unet = self._conditioning(batch)
        latents = batch.get("latents")
        if latents is None:
            latents = self.prepare_latents(generator, batch["prompt_embeds"].shape[0])
        latents = torch.as_tensor(latents, device=self.device).to(self.dtype)
        scfg = sampler_cfg or dataclasses.replace(self.sampler_cfg, predict=predict)
        denoise_fn = cached = None
        if scfg.cache_interval >= 2 or scfg.cache_tau > 0:
            cached = self._make_cached(latents, pe, scfg, unet)
        elif scfg.guidance_interval is not None:
            denoise_fn = make_sd15_interval_denoise_fn(unet, pe, self.guidance_scale,
                                                       scfg.guidance_interval)
        else:
            denoise_fn = make_sd15_denoise_fn(unet, pe, self.guidance_scale)
        if step_caps is not None:
            step_caps = torch.as_tensor(step_caps, dtype=torch.int32)
        return sd15_adaptive_sample(denoise_fn, self.tpm_fn(tpm), latents, generator, scfg,
                                    step_caps=step_caps, init_t=batch.get("init_t"),
                                    cached=cached)

    def replay(self, tpm: nn.Module, outputs: SD15SampleOutput, inputs=None) -> torch.Tensor:
        """Log-probs (b, T) of the rollout's ratios under ``tpm``, from its
        cached activations; differentiable with respect to the TPM."""
        return sd15_replay_logprobs(self.tpm_fn(tpm), outputs.h_cache, outputs.temb_cache,
                                    outputs.ratios, outputs.prob_masks, self.sampler_cfg)

    @torch.no_grad()
    def logprobs(self, tpm: nn.Module, outputs: SD15SampleOutput, inputs=None) -> torch.Tensor:
        return self.replay(tpm, outputs, inputs)

    def kl_divergence(self, outputs: SD15SampleOutput) -> torch.Tensor:
        """Identically zero, as the reference's SD1.5 model."""
        return torch.zeros_like(outputs.logprobs)
