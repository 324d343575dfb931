"""FLUX agent: the frozen FLUX backbone + TPM over the adaptive flow loop.

Counterpart of ``tpdm_tpu/train/flux_agent.py``. FLUX lives in SD3's
rectified-flow sigma space, so the rollout is ``pipeline/sampler.py``'s
``adaptive_sample`` (Euler or AB2, the Δ-cache, per-sample caps and
starting sigmas), with two differences from the SD3 agent: no CFG batch
doubling (the guidance scale is an embedded input, 3.5 by default) and
packed-token I/O around the backbone (``models/flux.py:pack_latents`` /
``unpack_latents``). The TPM reads h1 and h2 as maps of the token grid
(``reshape_tokens_to_2d(h, grid, grid, 2)``, grid = latent size / 2).

The backbone runs under ``torch.no_grad()`` in the rollout: the CUDA
kernels return tensors without a ``grad_fn``. ``denoise_builder`` builds
the denoiser over a given backbone for callers that bring their own (a
gradient through it waits for the kernels' backward, ROADMAP queue 1,
item 9(e), and a launch that needs one raises). Not ported: ``shard``,
the TPU's GSPMD placement of the 12B backbone (item 14); FLUX.1-dev in
bf16 fits one 80 GB card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from tpdm_tpu_torch.models.flux import Flux, pack_latents, unpack_latents
from tpdm_tpu_torch.models.tpm import TimePredictor, reshape_tokens_to_2d
from tpdm_tpu_torch.pipeline.pipeline import not_ported
from tpdm_tpu_torch.pipeline.sampler import (
    CachedDenoise,
    SampleOutput,
    SamplerConfig,
    adaptive_sample,
    cache_reuse_schedule,
    check_adaptive_solver,
    replay_logprobs,
)
from tpdm_tpu_torch.train.config import RLOOConfig
from tpdm_tpu_torch.train.rloo import compute_beta_kl_penalty


def _flux_outputs(outs, h: int, w: int):
    """(velocity tokens, vec, h1, h2[, delta]) -> (velocity (b, c, h, w),
    vec, h_combined (b, 2 hidden, h/2, w/2)[, delta])."""
    vel_tok, vec, h1, h2, *rest = outs
    grid_h, grid_w = h // 2, w // 2
    h_comb = torch.cat([reshape_tokens_to_2d(h1, grid_h, grid_w, 2),
                        reshape_tokens_to_2d(h2, grid_h, grid_w, 2)], dim=1)
    return (unpack_latents(vel_tok, h, w), vec, h_comb, *rest)


def _guidance(guidance: Optional[float], sigma: torch.Tensor):
    return None if guidance is None else torch.full(sigma.shape, float(guidance),
                                                    device=sigma.device)


def make_flux_denoise_fn(flux_apply: Callable, txt_tokens: torch.Tensor,
                         txt_ids: torch.Tensor, pooled: torch.Tensor,
                         guidance: Optional[float], latent_hw: tuple):
    """``denoise_fn(latents, sigma) -> (velocity, vec, h_combined)``: the
    latents packed into tokens, one forward ``flux_apply(tokens, img_ids,
    txt_tokens, txt_ids, sigma, pooled, guidance)`` (no CFG doubling), the
    velocity unpacked and h1, h2 read as maps of the token grid."""
    h, w = latent_hw

    def denoise_fn(latents, sigma):
        tokens, img_ids = pack_latents(latents)
        outs = flux_apply(tokens, img_ids, txt_tokens, txt_ids, sigma, pooled,
                          _guidance(guidance, sigma))
        return _flux_outputs(outs, h, w)

    return denoise_fn


def make_flux_denoise_cached_fns(flux_apply_record: Callable, flux_apply_reuse: Callable,
                                 txt_tokens: torch.Tensor, txt_ids: torch.Tensor,
                                 pooled: torch.Tensor, guidance: Optional[float],
                                 latent_hw: tuple):
    """The Δ-cache pair (``models/flux.py``'s "record" and "reuse"
    forwards): ``(full_fn, reuse_fn)``, each ``(latents, sigma, delta) ->
    (velocity, vec, h_combined, delta)``, the ``CachedDenoise`` contract;
    the apply fns take the cached Δ after the guidance."""
    h, w = latent_hw

    def make(apply_fn):
        def denoise_fn(latents, sigma, delta):
            tokens, img_ids = pack_latents(latents)
            outs = apply_fn(tokens, img_ids, txt_tokens, txt_ids, sigma, pooled,
                            _guidance(guidance, sigma), delta)
            return _flux_outputs(outs, h, w)

        return denoise_fn

    return make(flux_apply_record), make(flux_apply_reuse)


class FluxAgent:
    """The RL agent protocol (sample, replay, logprobs, kl_divergence) over
    a frozen ``Flux``.

    Args:
        flux: the backbone, on its device and dtype (bf16 on the card).
        config: RLOOConfig (``max_inference_steps``, ``min_sigma``,
            ``relative``, ``prediction_type``, ``solver``, the TPM's
            ``init_alpha`` / ``init_beta`` / ``tpm_param_cap``).
        tpm: a factory that returns a fresh TPM module; None builds FLUX's
            TPM (128 conv channels over h_combined's 2 x hidden channels,
            conditioned on the hidden-wide vec), fp32 parameters computing
            in the backbone's dtype.
        latent_size: the latent side (128 at 1024 px).
        latent_channels: 16 for FLUX.1.
        guidance: the embedded guidance scale (None: the model's 3.5
            default where it embeds guidance).
    """

    def __init__(self, flux: Flux, config: RLOOConfig,
                 tpm: Optional[Callable[[], nn.Module]] = None, latent_size: int = 128,
                 latent_channels: int = 16, guidance: Optional[float] = 3.5):
        check_adaptive_solver(config.solver)
        self.flux = flux.requires_grad_(False).eval()
        self.config = config
        self.latent_size = latent_size
        self.latent_channels = latent_channels
        self.guidance = guidance
        self.grid = latent_size // 2
        fcfg = flux.config
        self.device, self.dtype = flux.img_in.weight.device, flux.img_in.weight.dtype
        self.tpm_factory = tpm or (lambda: TimePredictor(
            conv_out_channels=128,
            in_channels=2 * fcfg.hidden_size,
            temb_dim=fcfg.hidden_size,
            init_alpha=config.init_alpha,
            init_beta=config.init_beta,
            param_cap=config.tpm_param_cap,
            dtype=self.dtype,
        ))
        self.sampler_cfg = SamplerConfig(
            max_inference_steps=config.max_inference_steps,
            min_sigma=config.min_sigma,
            relative=config.relative,
            prediction_type=config.prediction_type,
            cache_activations=True,
            solver=config.solver,
        )

    def shard(self, mesh):
        raise not_ported("FluxAgent.shard (a sharded FLUX backbone)", "14")

    @property
    def backbone_params(self) -> Flux:
        """The frozen backbone (what JAX's LoRA factors target)."""
        return self.flux

    @property
    def _hw(self) -> tuple:
        return (self.latent_size, self.latent_size)

    def _as_dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def _text(self, batch: dict):
        """(T5 features, zero text ids, pooled) on the backbone's device."""
        txt = self._as_dev(batch["prompt_embeds"])
        txt_ids = torch.zeros(txt.shape[:2] + (3,), device=self.device)
        return txt, txt_ids, self._as_dev(batch["pooled_prompt_embeds"])

    def denoise_builder(self, params: Flux, batch: dict):
        """``denoise_fn(latents, sigma) -> (velocity, vec, h_combined)`` over
        the backbone ``params`` for ``batch``'s embeds (no CFG doubling)."""
        txt, txt_ids, pooled = self._text(batch)
        return make_flux_denoise_fn(params, txt, txt_ids, pooled, self.guidance, self._hw)

    def init_tpm_params(self, generator: torch.Generator) -> nn.Module:
        """A fresh TPM on the backbone's device, its weights drawn from
        ``generator`` (on that device): N(0, 0.02²), zero biases, the head's
        bias (init_alpha, init_beta)."""
        with torch.device(self.device):
            return self.tpm_factory().init_weights(generator)

    def tpm_fn(self, tpm: nn.Module) -> Callable:
        """The TPM as the loop calls it, ``(h_combined, vec) -> (b, 2)``."""
        return tpm

    def prepare_latents(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """Unit-variance noise (b, latent_channels, latent_size,
        latent_size) in the backbone's dtype."""
        shape = (batch_size, self.latent_channels, self.latent_size, self.latent_size)
        return torch.randn(shape, generator=generator, device=self.device, dtype=self.dtype)

    def _cached(self, txt, txt_ids, pooled, batch_size: int, scfg: SamplerConfig):
        """The Δ-cache pair over the record / reuse forwards, its zero Δ."""
        mode_apply = lambda mode: (
            lambda tok, ii, tt, ti, sg, pl, g, d: self.flux(tok, ii, tt, ti, sg, pl, g,
                                                            delta=d, cache_mode=mode))
        full_fn, reuse_fn = make_flux_denoise_cached_fns(
            mode_apply("record"), mode_apply("reuse"), txt, txt_ids, pooled, self.guidance,
            self._hw)
        fcfg = self.flux.config
        init = torch.zeros((batch_size, self.grid * self.grid, fcfg.hidden_size),
                           dtype=self.dtype, device=self.device)
        return CachedDenoise(full_fn, reuse_fn, init,
                             cache_reuse_schedule(scfg.max_inference_steps, scfg.cache_interval),
                             tau=scfg.cache_tau if scfg.cache_tau > 0 else None)

    @torch.no_grad()
    def sample(self, tpm: nn.Module, batch: dict, generator: Optional[torch.Generator],
               predict: bool = False, sampler_cfg: Optional[SamplerConfig] = None,
               step_caps=None) -> SampleOutput:
        """Rollout of ``batch``: ``prompt_embeds`` (b, n, txt_dim), the T5
        features, and ``pooled_prompt_embeds`` (b, vec_dim); optional
        ``latents`` (else drawn from ``generator``, which then draws the
        Beta ratios) and ``init_sigma`` ((b,) starting noise levels, the
        image-to-image entry). ``sampler_cfg``'s ``cache_interval`` /
        ``cache_tau`` run the Δ-cache (serving only: rollouts for RL keep
        exact forwards)."""
        txt, txt_ids, pooled = self._text(batch)
        b = txt.shape[0]
        latents = batch.get("latents")
        if latents is None:
            latents = self.prepare_latents(generator, b)
        latents = self._as_dev(latents)
        scfg = sampler_cfg or dataclasses.replace(self.sampler_cfg, predict=predict)
        denoise_fn = cached = None
        if scfg.cache_interval >= 2 or scfg.cache_tau > 0:
            cached = self._cached(txt, txt_ids, pooled, b, scfg)
        else:
            denoise_fn = make_flux_denoise_fn(self.flux, txt, txt_ids, pooled, self.guidance,
                                              self._hw)
        if step_caps is not None:
            step_caps = torch.as_tensor(step_caps, dtype=torch.int32)
        return adaptive_sample(denoise_fn, self.tpm_fn(tpm), latents, generator, scfg,
                               step_caps=step_caps, init_sigma=batch.get("init_sigma"),
                               cached=cached)

    def replay(self, tpm: nn.Module, outputs: SampleOutput, inputs=None,
               backbone_params=None) -> torch.Tensor:
        """Log-probs (b, T) of the rollout's actions under ``tpm``, from its
        cached activations; differentiable with respect to the TPM."""
        return replay_logprobs(self.tpm_fn(tpm), outputs.h_cache, outputs.temb_cache,
                               outputs.sigmas, self.sampler_cfg)

    @torch.no_grad()
    def logprobs(self, tpm: nn.Module, outputs: SampleOutput, inputs=None) -> torch.Tensor:
        return self.replay(tpm, outputs, inputs)

    def kl_divergence(self, outputs: SampleOutput) -> torch.Tensor:
        return compute_beta_kl_penalty(outputs.alphas, outputs.betas, outputs.sigmas,
                                       outputs.prob_masks, relative=self.config.relative)
