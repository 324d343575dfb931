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

Not ported: ``SDXLEnsembleAgent`` and ``EnsembleSampleOutput``, which only
ensemble training uses (they come with the SD1.5 trainer, ROADMAP queue 1,
item 12); the backbone-differentiating hooks wait for the kernels'
backward (item 9(e)), as SD15Agent's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from tpdm_tpu_torch.models.unet_sd15 import UNetSD15
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
