"""Turn an MMDiT into the sampler's denoise callable, with CFG.

Counterpart of ``tpdm_tpu/pipeline/denoise.py:make_cfg_denoise_fn``: the
latents are batch-doubled against [negative; positive] embeds, one forward
runs, and the guidance combine is applied to all four outputs — velocity,
temb, h1 and h2 — before h1 and h2 become the TPM's input map.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from tpdm_tpu_torch.models.tpm import reshape_tokens_to_2d


def make_cfg_denoise_fn(
    mmdit_apply: Callable,
    prompt_embeds: torch.Tensor,
    pooled_embeds: torch.Tensor,
    guidance_scale: Optional[Union[float, torch.Tensor]],
    token_grid: Union[int, tuple],
    patch_size: int = 2,
):
    """Build denoise_fn(latents, sigma) -> (velocity, temb, h_combined).

    Args:
        mmdit_apply: (latents, timestep, ctx, pooled) -> (vel, temb, h1, h2).
        prompt_embeds, pooled_embeds: (2b, ...) as [negative; positive] when
            guidance_scale is not None, else (b, ...).
        guidance_scale: None turns CFG off; a scalar or a (b,) tensor of
            per-sample strengths, cast to each output's dtype.
        token_grid: token-grid side (latent size // patch size) or (gh, gw).
    """
    gh, gw = token_grid if isinstance(token_grid, tuple) else (token_grid, token_grid)

    def denoise_fn(latents: torch.Tensor, sigma: torch.Tensor):
        if guidance_scale is not None:
            lat = torch.cat([latents, latents])
            t = torch.cat([sigma, sigma]) * 1000.0
        else:
            lat, t = latents, sigma * 1000.0
        vel, temb, h1, h2 = mmdit_apply(lat, t, prompt_embeds, pooled_embeds)
        if guidance_scale is not None:

            def guide(a):
                uncond, cond = a.chunk(2)
                g = torch.as_tensor(guidance_scale, dtype=uncond.dtype, device=uncond.device)
                g = g.reshape((-1,) + (1,) * (uncond.dim() - 1))
                return uncond + g * (cond - uncond)

            vel, temb, h1, h2 = guide(vel), guide(temb), guide(h1), guide(h2)
        h_combined = torch.cat(
            [
                reshape_tokens_to_2d(h1, gh, gw, patch_size),
                reshape_tokens_to_2d(h2, gh, gw, patch_size),
            ],
            dim=1,
        )
        return vel, temb, h_combined

    return denoise_fn
