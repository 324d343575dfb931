"""SD3 prompt encoding: CLIP-L + CLIP-G + T5 -> MMDiT conditioning tensors.

Counterpart of ``tpdm_tpu/pipeline/text_encoding.py``'s ``SD3TextEncoders``:

    clip = cat([clip_l_penultimate, clip_g_penultimate], -1)  # (b, 77, 2048)
    clip = pad_last_dim(clip, t5_width)                        # (b, 77, 4096)
    prompt_embeds = cat([clip, t5_last_hidden], -2)            # (b, 333, 4096)
    pooled = cat([clip_l_projected, clip_g_projected], -1)     # (b, 2048)

Tokenization happens on the host (``utils/tokenizer.py``,
``utils/t5_tokenizer.py``); this module takes ids. The towers are frozen
(``requires_grad_(False)``, ``eval()``) and ``encode`` runs under
``torch.no_grad()``: grad mode is thread-local, so a serving worker
thread would otherwise build an autograd graph over T5-XXL on every cold
batch, and the embed cache would keep it alive with its rows.

``SDXLTextEncoders`` is the counterpart of JAX's SDXL bundle: the same two
CLIP towers without T5, the penultimate states joined to 2048 wide and
bigG's projected EOS as the pooled row; ``encode_refiner`` runs bigG
alone, as the refiner conditions on it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

# T5's sequence length in SD3's conditioning: the zero rows stand in for a
# dropped T5 tower
T5_TOKENS = 256


class PromptEmbeds(NamedTuple):
    prompt_embeds: torch.Tensor  # (b, 77 + t5_len, t5_width)
    pooled_prompt_embeds: torch.Tensor  # (b, clip_l proj + clip_g proj)


class SD3TextEncoders:
    """The three towers and the assembly. The towers sit on one device,
    and the embeds come back there in CLIP-L's dtype. ``t5`` None drops T5
    (its rows are zeros)."""

    def __init__(self, clip_l: nn.Module, clip_g: nn.Module, t5: Optional[nn.Module] = None,
                 t5_width: int = 4096):
        self.clip_l = clip_l.requires_grad_(False).eval()
        self.clip_g = clip_g.requires_grad_(False).eval()
        self.t5 = None if t5 is None else t5.requires_grad_(False).eval()
        self.t5_width = t5_width

    @torch.no_grad()
    def encode(self, clip_ids, t5_ids=None) -> PromptEmbeds:
        """``clip_ids`` (b, 77), shared by both CLIP towers, and ``t5_ids``
        (b, 256) or None; numpy arrays or tensors."""
        device = next(self.clip_l.parameters()).device
        as_ids = lambda ids: torch.as_tensor(ids, dtype=torch.long, device=device)
        clip_ids = as_ids(clip_ids)
        pen_l, _, _, proj_l = self.clip_l(clip_ids)
        pen_g, _, _, proj_g = self.clip_g(clip_ids)
        clip_embeds = torch.cat([pen_l, pen_g], dim=-1)
        clip_embeds = F.pad(clip_embeds, (0, self.t5_width - clip_embeds.shape[-1]))
        if t5_ids is not None and self.t5 is not None:
            t5_embeds = self.t5(as_ids(t5_ids)).to(clip_embeds.dtype)
        else:
            t5_embeds = torch.zeros((clip_embeds.shape[0], T5_TOKENS, self.t5_width),
                                    dtype=clip_embeds.dtype, device=device)
        prompt_embeds = torch.cat([clip_embeds, t5_embeds], dim=-2)
        pooled = torch.cat([proj_l, proj_g], dim=-1)
        return PromptEmbeds(prompt_embeds, pooled)


class SDXLTextEncoders:
    """SDXL prompt encoding: CLIP-L + CLIP-bigG -> UNet conditioning.

        prompt_embeds = cat([clip_l_penultimate, clip_g_penultimate], -1)
                        # (b, 77, 768 + 1280 = 2048)
        pooled        = clip_g_projected                     # (b, 1280)

    diffusers' ``StableDiffusionXLPipeline.encode_prompt`` (clip_skip None):
    both towers give their penultimate hidden states, only the second
    tower's projected EOS embedding is pooled. The embeds come back in
    CLIP-L's dtype, on the towers' device."""

    def __init__(self, clip_l: nn.Module, clip_g: nn.Module):
        self.clip_l = clip_l.requires_grad_(False).eval()
        self.clip_g = clip_g.requires_grad_(False).eval()

    def _ids(self, ids) -> torch.Tensor:
        device = next(self.clip_g.parameters()).device
        return torch.as_tensor(ids, dtype=torch.long, device=device)

    @torch.no_grad()
    def encode(self, clip_ids, clip_g_ids=None) -> PromptEmbeds:
        """``clip_ids`` (b, 77) for CLIP-L and, by default, bigG too;
        ``clip_g_ids`` the bigG tower's own ids where they differ (diffusers
        tokenizes each tower on its own: bigG's tokenizer pads with id 0, not
        49407, and a second prompt may go to it)."""
        clip_ids = self._ids(clip_ids)
        g_ids = clip_ids if clip_g_ids is None else self._ids(clip_g_ids)
        pen_l = self.clip_l(clip_ids)[0]
        pen_g, _, _, proj_g = self.clip_g(g_ids)
        return PromptEmbeds(torch.cat([pen_l, pen_g.to(pen_l.dtype)], dim=-1), proj_g)

    @torch.no_grad()
    def encode_refiner(self, clip_g_ids) -> PromptEmbeds:
        """The refiner's conditioning, bigG alone: its penultimate state (b,
        77, 1280) and its projected EOS embedding (diffusers'
        ``StableDiffusionXLImg2ImgPipeline`` without a first tower)."""
        pen_g, _, _, proj_g = self.clip_g(self._ids(clip_g_ids))
        return PromptEmbeds(pen_g, proj_g)
