"""SDXL agents: the frozen SDXL UNet (base or refiner) + TPM over the
integer-t DPM-Solver++ loop.

Counterpart of ``tpdm_tpu/train/sdxl_agent.py``: SDXL is SD1.5's
epsilon-prediction, integer-t regime, so the loop, the replay and the zero
KL of ``train/sd15_agent.py`` carry over. What changes is the
conditioning: both CLIP towers' penultimate states joined to 2048 wide,
and the "text_time" added embedding (bigG's pooled row and the size / crop
``time_ids``), each doubled through classifier-free guidance with the
context. The denoise builders are SD1.5's over a UNet call that picks the
added rows that go with its context (``_with_added``).

``SDXLEnsembleAgent`` trains the base's and the refiner's TPMs together
as one policy over the stitched base-then-refiner episode
(``EnsembleSampleOutput``). Not ported: the backbone-differentiating hooks
wait for the kernels' backward (ROADMAP queue 1, item 9(e)), as
SD15Agent's; ``shard`` waits for item 14.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from tpdm_tpu_torch.models.unet_sd15 import UNetSD15
from tpdm_tpu_torch.pipeline.pipeline import not_ported
from tpdm_tpu_torch.pipeline.sd15_sampler import sd15_replay_logprobs
from tpdm_tpu_torch.train.config import RLOOConfig
from tpdm_tpu_torch.train.sd15_agent import (
    SD15Agent,
    _cfg_on,
    make_sd15_denoise_cached_fns,
    make_sd15_denoise_fn,
    make_sd15_interval_denoise_cached_fns,
    make_sd15_interval_denoise_fn,
)


def _with_added(unet_apply: Callable, prompt_embeds: torch.Tensor, added_cond: dict) -> Callable:
    """``unet_apply(latents, t, ctx, added, **kw)`` as the SD1.5 builders
    call it, ``(latents, t, ctx, **kw)``: the added rows follow the context
    rows, all of them where ``ctx`` is ``prompt_embeds`` (the doubled
    forward, or CFG off), the conditional half's first b where ``ctx`` is
    the conditional slice ``prompt_embeds[n:][:b]`` of a guidance-window
    forward outside the window."""
    rows = prompt_embeds.shape[0]

    def apply(latents, t, ctx, **kw):
        added = added_cond
        if ctx.shape[0] != rows:
            added = {k: v[rows // 2:][:ctx.shape[0]] for k, v in added_cond.items()}
        return unet_apply(latents, t, ctx, added, **kw)

    return apply


def _cached_apply(fn: Callable, prompt_embeds: torch.Tensor, added_cond: dict) -> Callable:
    """``fn(latents, t, ctx, added, cache)`` as the SD1.5 cached builders
    call their apply fns, ``(latents, t, ctx, cache)``."""
    pick = _with_added(lambda lat, t, ctx, added, cache: fn(lat, t, ctx, added, cache),
                       prompt_embeds, added_cond)
    return lambda lat, t, ctx, cache: pick(lat, t, ctx, cache=cache)


def make_sdxl_denoise_fn(unet_apply: Callable, prompt_embeds: torch.Tensor, added_cond: dict,
                         guidance_scale: Optional[float]):
    """``denoise_fn(latents, t) -> (eps, temb, h_combined)`` over the SDXL
    UNet: with CFG one forward at the doubled batch against ``prompt_embeds``
    and ``added_cond`` = [uncond; cond], the guidance combine applied to
    eps, temb, h1 and h2. ``unet_apply(latents, t, ctx, added) -> (eps,
    temb, h1, h2)``."""
    return make_sd15_denoise_fn(_with_added(unet_apply, prompt_embeds, added_cond),
                                prompt_embeds, guidance_scale)


def make_sdxl_interval_denoise_fn(unet_apply: Callable, prompt_embeds: torch.Tensor,
                                  added_cond: dict, guidance_scale, interval):
    """The guidance-window form, ``denoise_fn(latents, t, guided)``, the
    added conditioning threaded through both branches."""
    return make_sd15_interval_denoise_fn(_with_added(unet_apply, prompt_embeds, added_cond),
                                         prompt_embeds, guidance_scale, interval)


def make_sdxl_denoise_cached_fns(unet_apply_record: Callable, unet_apply_reuse: Callable,
                                 prompt_embeds: torch.Tensor, added_cond: dict, guidance_scale):
    """The DeepCache pair; the apply fns ``(latents, t, ctx, added, cache)
    -> (eps, temb, h1, h2, cache)``. SDXL's shallow level is attention-free,
    so a reuse step runs no transformer."""
    wrap = lambda fn: _cached_apply(fn, prompt_embeds, added_cond)
    return make_sd15_denoise_cached_fns(wrap(unet_apply_record), wrap(unet_apply_reuse),
                                        prompt_embeds, guidance_scale)


def make_sdxl_interval_denoise_cached_fns(unet_apply_record: Callable,
                                          unet_apply_reuse: Callable,
                                          prompt_embeds: torch.Tensor, added_cond: dict,
                                          guidance_scale, interval):
    """DeepCache x the guidance window (integer-t units), the added
    conditioning threaded through the guided and conditional forwards."""
    wrap = lambda fn: _cached_apply(fn, prompt_embeds, added_cond)
    return make_sd15_interval_denoise_cached_fns(
        wrap(unet_apply_record), wrap(unet_apply_reuse), prompt_embeds, guidance_scale,
        interval)


class SDXLAgent(SD15Agent):
    """The SD1.5 agent over the SDXL UNet (``UNetConfig.sdxl()`` or
    ``toy_xl()``): the same TPM contract (h = cat([h1, h2]) at 2 x 320
    channels, the pre-MLP 320-wide t_feat), with the text_time conditioning.

    ``batch`` carries ``prompt_embeds`` (b, 77, 2048) and
    ``pooled_prompt_embeds`` (b, 1280), under CFG the negative pair, and
    optionally ``time_ids`` (b, num_time_ids), ``negative_time_ids``,
    ``latents`` and ``init_t``."""

    def __init__(self, unet: UNetSD15, config: RLOOConfig,
                 tpm: Optional[Callable[[], nn.Module]] = None, min_time: int = 10,
                 guidance_scale: Optional[float] = 5.0):
        if not unet.config.addition_embed:
            raise ValueError("SDXLAgent needs a UNetConfig with addition_embed=True "
                             "(UNetConfig.sdxl()/toy_xl()); use SD15Agent otherwise")
        super().__init__(unet, config, tpm=tpm, min_time=min_time,
                         guidance_scale=guidance_scale)

    def default_time_ids(self, batch_size: int) -> torch.Tensor:
        """[orig_h, orig_w, crop_top, crop_left, target_h, target_w] at the
        native resolution (diffusers' SDXL ``_get_add_time_ids``), fp32."""
        px = float(self.unet.config.sample_size * 8)
        row = torch.tensor([px, px, 0.0, 0.0, px, px], device=self.device)
        return row.expand(batch_size, 6)

    def negative_time_ids(self, time_ids: torch.Tensor, batch: Optional[dict] = None):
        """The uncond half of the doubled time_ids: the base model shares
        the size / crop ids between the branches; an explicit
        ``batch["negative_time_ids"]`` wins."""
        if batch is not None and batch.get("negative_time_ids") is not None:
            return torch.as_tensor(batch["negative_time_ids"], dtype=torch.float32,
                                   device=self.device)
        return time_ids

    def _as_rows(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def _conditioning(self, batch: dict):
        """The context rows and the UNet closed over the added conditioning
        (pooled rows and time_ids, [negative; positive] under CFG)."""
        pe, pooled = self._as_rows(batch["prompt_embeds"]), batch["pooled_prompt_embeds"]
        b = pe.shape[0]
        time_ids = batch.get("time_ids")
        time_ids = (self.default_time_ids(b) if time_ids is None
                    else torch.as_tensor(time_ids, dtype=torch.float32, device=self.device))
        pooled = self._as_rows(pooled)
        if _cfg_on(self.guidance_scale):
            if (batch.get("negative_prompt_embeds") is None
                    or batch.get("negative_pooled_prompt_embeds") is None):
                raise ValueError(
                    f"classifier-free guidance is on (guidance_scale={self.guidance_scale}); "
                    "pass negative_prompt_embeds AND negative_pooled_prompt_embeds (encode an "
                    "empty prompt, as diffusers does)")
            pe = torch.cat([self._as_rows(batch["negative_prompt_embeds"]), pe])
            pooled = torch.cat([self._as_rows(batch["negative_pooled_prompt_embeds"]), pooled])
            time_ids = torch.cat([self.negative_time_ids(time_ids, batch), time_ids])
        added = {"text_embeds": pooled, "time_ids": time_ids}
        return pe, _with_added(self.unet, pe, added)


class SDXLRefinerAgent(SDXLAgent):
    """The agent over SDXL's refiner UNet (``UNetConfig.sdxl_refiner()`` /
    ``toy_refiner()``), the second expert of SDXL's ensemble: bigG-only
    context (b, 77, 1280) and five time_ids whose last is the aesthetic
    score, ``aesthetic_score`` on the cond branch and
    ``negative_aesthetic_score`` on the uncond one (diffusers' defaults 6.0
    and 2.5). Used through ``SDXLRefinerPipeline`` (image refinement) or
    ``sdxl_ensemble_generate`` (the base stage's handoff)."""

    def __init__(self, unet: UNetSD15, config: RLOOConfig,
                 tpm: Optional[Callable[[], nn.Module]] = None, min_time: int = 10,
                 guidance_scale: Optional[float] = 5.0, aesthetic_score: float = 6.0,
                 negative_aesthetic_score: float = 2.5):
        if unet.config.num_time_ids != 5:
            raise ValueError(
                "SDXLRefinerAgent needs a refiner-topology UNetConfig with num_time_ids=5 "
                "([orig_h, orig_w, crop_top, crop_left, aesthetic_score]); got num_time_ids="
                f"{unet.config.num_time_ids}: use UNetConfig.sdxl_refiner()/toy_refiner(), or "
                "SDXLAgent for the 6-id base model")
        super().__init__(unet, config, tpm=tpm, min_time=min_time,
                         guidance_scale=guidance_scale)
        self.aesthetic_score = float(aesthetic_score)
        self.negative_aesthetic_score = float(negative_aesthetic_score)

    def default_time_ids(self, batch_size: int) -> torch.Tensor:
        """[orig_h, orig_w, crop_top, crop_left, aesthetic_score] at the
        native resolution (diffusers' img2img ``_get_add_time_ids`` with
        ``requires_aesthetics_score``)."""
        px = float(self.unet.config.sample_size * 8)
        row = torch.tensor([px, px, 0.0, 0.0, self.aesthetic_score], device=self.device)
        return row.expand(batch_size, 5)

    def negative_time_ids(self, time_ids: torch.Tensor, batch: Optional[dict] = None):
        """The uncond rows take ``negative_aesthetic_score`` in the last
        column: on the refiner the branches differ."""
        if batch is not None and batch.get("negative_time_ids") is not None:
            return super().negative_time_ids(time_ids, batch)
        neg = time_ids.clone()
        neg[:, -1] = self.negative_aesthetic_score
        return neg


class EnsembleSampleOutput(NamedTuple):
    """The stitched rollout of the SDXL base + refiner ensemble.

    The per-step fields are the base stage's T_base columns followed by
    the refiner's T_ref, batch-major (b, T_base + T_ref) as every family's
    rollout, the unexecuted columns masked on both sides of the handoff, so
    the trainer's masked reductions and the summed-log-prob PPO objective
    work unchanged. The activation caches stay per expert (the two UNets'
    channel widths differ); the replay runs each TPM over its own."""

    final_latents: torch.Tensor  # the refiner stage's (b, 4, h, w)
    times: torch.Tensor  # (b, T_base + T_ref + 2): [base (T_base + 1); refiner (T_ref + 1)]
    ratios: torch.Tensor  # (b, T_base + T_ref)
    logprobs: torch.Tensor
    prob_masks: torch.Tensor
    alphas: torch.Tensor
    betas: torch.Tensor
    num_steps: int  # loop iterations, base + refiner
    last_valid_index: torch.Tensor  # (b,) the total NFE - 1 across both experts
    handoff_t: torch.Tensor  # (b,) the timestep the refiner resumed from
    h_cache: Optional[torch.Tensor]  # the base's (T_base, b, 2 C_base, h, w)
    temb_cache: Optional[torch.Tensor]  # (T_base, b, C_base)
    refiner_h_cache: Optional[torch.Tensor]  # (T_ref, b, 2 C_ref, h, w)
    refiner_temb_cache: Optional[torch.Tensor]  # (T_ref, b, C_ref)


class SDXLEnsembleAgent:
    """One RL agent over both experts of SDXL's ensemble.

    The episode is base steps (t >= t_cut = round(999 (1 - denoising_end)):
    the base stage's loop stops once a sample's t falls below the cutoff,
    and its step cap lands on the cutoff through ``cap_floor_time``)
    followed by refiner steps that resume from each sample's handoff
    (latents and t). The RLOO reward discounts over the total NFE, so the
    two policies learn to split the step budget across the cutoff. The
    agent protocol of every family (sample, replay, logprobs,
    kl_divergence, init_tpm_params) over a TPM that is an ``nn.ModuleDict``
    of the two heads, "base" and "refiner"; the trainer's optimizer updates
    both in one Adam step.

    ``batch`` carries both experts' conditioning: the base's
    ``prompt_embeds`` / ``pooled_prompt_embeds`` (and the negative pair
    under CFG) and the refiner's bigG-only ``refiner_prompt_embeds`` /
    ``refiner_pooled_prompt_embeds`` (and ``refiner_negative_*``;
    optionally ``refiner_time_ids`` / ``refiner_negative_time_ids``).
    """

    needs_inputs_for_replay = False

    def __init__(self, base: SDXLAgent, refiner: SDXLRefinerAgent, denoising_end: float = 0.8):
        if not 0.0 < denoising_end < 1.0:
            raise ValueError(f"denoising_end must be in (0, 1), got {denoising_end}")
        if base.unet.config.sample_size != refiner.unet.config.sample_size:
            raise ValueError(
                "ensemble experts must share the latent geometry: base sample_size "
                f"{base.unet.config.sample_size} != refiner {refiner.unet.config.sample_size}")
        self.base, self.refiner = base, refiner
        self.config = base.config
        self.device, self.dtype = base.device, base.dtype
        self.denoising_end = float(denoising_end)
        self.t_cut = int(round(999 * (1.0 - denoising_end)))
        # the base stage decays to the cutoff; its cap step lands on the
        # cutoff (never x0), so the refiner always gets work
        self._base_scfg = dataclasses.replace(base.sampler_cfg, min_time=max(self.t_cut, 1),
                                              cap_floor_time=max(self.t_cut - 1, 0))

    @property
    def base_steps(self) -> int:
        """T_base, the base stage's columns in the stitched rollout."""
        return self._base_scfg.num_inference_steps

    @property
    def sampler_cfg(self):
        """The base stage's config; each stage's other settings go through
        the member agents."""
        return self._base_scfg

    def shard(self, mesh):
        raise not_ported("SDXLEnsembleAgent.shard (sharded SDXL experts)", "14")

    def init_tpm_params(self, generator: torch.Generator) -> nn.ModuleDict:
        """Both heads, the base's then the refiner's drawn from ``generator``."""
        return nn.ModuleDict({"base": self.base.init_tpm_params(generator),
                              "refiner": self.refiner.init_tpm_params(generator)})

    @staticmethod
    def _refiner_batch_view(batch: dict) -> dict:
        out = {"prompt_embeds": batch["refiner_prompt_embeds"],
               "pooled_prompt_embeds": batch["refiner_pooled_prompt_embeds"]}
        for src, dst in (("refiner_negative_prompt_embeds", "negative_prompt_embeds"),
                         ("refiner_negative_pooled_prompt_embeds",
                          "negative_pooled_prompt_embeds"),
                         ("refiner_time_ids", "time_ids"),
                         ("refiner_negative_time_ids", "negative_time_ids")):
            if batch.get(src) is not None:
                out[dst] = batch[src]
        return out

    def _split_caps(self, step_caps):
        """(base caps, refiner caps) of per-sample caps on the total NFE, the
        split serving uses: the base clip(round(cap x denoising_end), 1,
        max(cap - 1, 1)), the refiner the rest, at least 1."""
        caps = torch.as_tensor(step_caps, dtype=torch.int32)
        base = torch.round(caps * self.denoising_end).to(torch.int32)
        base = torch.minimum(torch.clamp(base, min=1), torch.clamp(caps - 1, min=1))
        return base, torch.clamp(caps - base, min=1)

    @torch.no_grad()
    def sample(self, tpm: nn.ModuleDict, batch: dict, generator: Optional[torch.Generator],
               predict: bool = False, sampler_cfg=None, step_caps=None) -> EnsembleSampleOutput:
        """Base, then refiner from the base's latents at each sample's
        handoff t (the t after its last valid step). ``step_caps`` bounds
        the total NFE (``_split_caps``). ``generator`` draws the initial
        latents (without ``batch["latents"]``) and both stages' ratios."""
        if sampler_cfg is not None:
            raise ValueError(
                "SDXLEnsembleAgent's stages own their sampler configs (the base's min_time "
                "and cap_floor_time pin the handoff); replace base.sampler_cfg / "
                "refiner.sampler_cfg instead")
        base_caps = ref_caps = None
        if step_caps is not None:
            base_caps, ref_caps = self._split_caps(step_caps)
        scfg = dataclasses.replace(self._base_scfg, predict=predict)
        out = self.base.sample(tpm["base"], batch, generator, sampler_cfg=scfg,
                               step_caps=base_caps)
        handoff_t = out.times.gather(1, out.last_valid_index.long()[:, None] + 1)[:, 0]
        rbatch = self._refiner_batch_view(batch)
        rbatch["latents"] = out.final_latents.to(self.refiner.dtype)
        rbatch["init_t"] = handoff_t
        rout = self.refiner.sample(tpm["refiner"], rbatch, generator, predict=predict,
                                   step_caps=ref_caps)
        cat = lambda a, b: torch.cat([a, b], dim=1)
        return EnsembleSampleOutput(
            final_latents=rout.final_latents,
            times=cat(out.times, rout.times),
            ratios=cat(out.ratios, rout.ratios),
            logprobs=cat(out.logprobs, rout.logprobs),
            prob_masks=cat(out.prob_masks, rout.prob_masks),
            alphas=cat(out.alphas, rout.alphas),
            betas=cat(out.betas, rout.betas),
            num_steps=out.num_steps + rout.num_steps,
            last_valid_index=out.last_valid_index + rout.last_valid_index + 1,
            handoff_t=handoff_t,
            h_cache=out.h_cache,
            temb_cache=out.temb_cache,
            refiner_h_cache=rout.h_cache,
            refiner_temb_cache=rout.temb_cache,
        )

    def replay(self, tpm: nn.ModuleDict, outputs: EnsembleSampleOutput,
               inputs=None) -> torch.Tensor:
        """Log-probs (b, T_base + T_ref) of the stitched episode: each head
        replays its own stage's cached activations; differentiable with
        respect to both heads."""
        tb = self.base_steps
        lp_base = sd15_replay_logprobs(
            self.base.tpm_fn(tpm["base"]), outputs.h_cache, outputs.temb_cache,
            outputs.ratios[:, :tb], outputs.prob_masks[:, :tb], self.base.sampler_cfg)
        lp_ref = sd15_replay_logprobs(
            self.refiner.tpm_fn(tpm["refiner"]), outputs.refiner_h_cache,
            outputs.refiner_temb_cache, outputs.ratios[:, tb:], outputs.prob_masks[:, tb:],
            self.refiner.sampler_cfg)
        return torch.cat([lp_base, lp_ref], dim=1)

    @torch.no_grad()
    def logprobs(self, tpm: nn.ModuleDict, outputs: EnsembleSampleOutput,
                 inputs=None) -> torch.Tensor:
        return self.replay(tpm, outputs, inputs)

    def kl_divergence(self, outputs: EnsembleSampleOutput) -> torch.Tensor:
        """Zero on both stages, as each expert's."""
        return torch.zeros_like(outputs.logprobs)
