"""Turn an MMDiT into the samplers' denoise callables, with CFG.

Counterpart of ``tpdm_tpu/pipeline/denoise.py``. The latents are
batch-doubled against [negative; positive] embeds, one forward runs, and
the guidance combine is applied to the outputs (velocity, temb, h1 and h2)
before h1 and h2 become the TPM's input map. The velocity-only builders
feed the fixed-schedule samplers.

The Δ-cache builders return a ``(full_fn, reuse_fn)`` pair over the MMDiT's
"record" and "reuse" forwards: full_fn runs every block and refreshes Δ,
reuse_fn runs only the front blocks on the cached Δ. Δ lives on the
CFG-doubled rows ([uncond; cond]) and is never guidance-combined.

The guidance-interval builders apply CFG only while sigma lies in
``interval = (lo, hi)``; outside it the per-sample weight is 1 (the
conditional output), and a step on which no sample is inside runs one
conditional forward at batch b. JAX picks that branch with ``lax.cond`` on
the device; here the caller passes the decision as a host bool,
``guided``, and only the chosen branch runs. The samplers compute it with
``in_window`` on the sigma they pass, in the latents' dtype: on the host
from the ladder in the fixed samplers, on the device beside the all-done
flag in the adaptive loop (one host read a step).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from tpdm_tpu_torch.models.tpm import reshape_tokens_to_2d


def _grid(token_grid):
    return token_grid if isinstance(token_grid, tuple) else (token_grid, token_grid)


def _guide(a: torch.Tensor, g) -> torch.Tensor:
    """uncond + g (cond - uncond) over the two halves of ``a``; ``g`` a
    scalar or (b,) weights, cast to ``a``'s dtype."""
    uncond, cond = a.chunk(2)
    g = torch.as_tensor(g, dtype=uncond.dtype, device=uncond.device)
    g = g.reshape((-1,) + (1,) * (uncond.dim() - 1))
    return uncond + g * (cond - uncond)


def _doubled(latents, sigma):
    return torch.cat([latents, latents]), torch.cat([sigma, sigma]) * 1000.0


def _h_combined(h1, h2, gh, gw, patch_size):
    return torch.cat([reshape_tokens_to_2d(h1, gh, gw, patch_size),
                      reshape_tokens_to_2d(h2, gh, gw, patch_size)], dim=1)


def in_window(sigma: torch.Tensor, interval) -> torch.Tensor:
    """0-dim bool: is any sample's sigma in [lo, hi)? Compared in
    ``sigma``'s dtype, as the JAX samplers compare the sigma that they pass
    to the denoiser (bf16 on the card)."""
    lo, hi = interval
    return ((sigma >= lo) & (sigma < hi)).any()


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
    gh, gw = _grid(token_grid)

    def denoise_fn(latents: torch.Tensor, sigma: torch.Tensor):
        if guidance_scale is not None:
            lat, t = _doubled(latents, sigma)
        else:
            lat, t = latents, sigma * 1000.0
        outs = mmdit_apply(lat, t, prompt_embeds, pooled_embeds)
        if guidance_scale is not None:
            outs = [_guide(a, guidance_scale) for a in outs]
        vel, temb, h1, h2 = outs
        return vel, temb, _h_combined(h1, h2, gh, gw, patch_size)

    return denoise_fn


def make_cfg_denoise_cached_fns(
    mmdit_apply_record: Callable,
    mmdit_apply_reuse: Callable,
    prompt_embeds: torch.Tensor,
    pooled_embeds: torch.Tensor,
    guidance_scale,
    token_grid,
    patch_size: int = 2,
):
    """The Δ-cache pair of :func:`make_cfg_denoise_fn`: each fn is
    ``(latents, sigma, delta) -> (velocity, temb, h_combined, delta)``, the
    apply fns ``(latents, t, ctx, pooled, delta) -> (vel, temb, h1, h2,
    delta)``."""
    gh, gw = _grid(token_grid)

    def make(apply_fn):
        def denoise_fn(latents, sigma, delta):
            if guidance_scale is not None:
                lat, t = _doubled(latents, sigma)
            else:
                lat, t = latents, sigma * 1000.0
            *outs, delta = apply_fn(lat, t, prompt_embeds, pooled_embeds, delta)
            if guidance_scale is not None:
                outs = [_guide(a, guidance_scale) for a in outs]
            vel, temb, h1, h2 = outs
            return vel, temb, _h_combined(h1, h2, gh, gw, patch_size), delta

        return denoise_fn

    return make(mmdit_apply_record), make(mmdit_apply_reuse)


def make_cfg_velocity_fn(mmdit_apply: Callable, prompt_embeds, pooled_embeds, guidance_scale):
    """velocity_fn(latents, sigma) -> the guided velocity (the fixed-schedule
    samplers' denoiser)."""

    def velocity_fn(latents, sigma):
        if guidance_scale is not None:
            lat, t = _doubled(latents, sigma)
        else:
            lat, t = latents, sigma * 1000.0
        vel = mmdit_apply(lat, t, prompt_embeds, pooled_embeds)[0]
        return vel if guidance_scale is None else _guide(vel, guidance_scale)

    return velocity_fn


def make_cfg_velocity_cached_fns(
    mmdit_apply_record: Callable,
    mmdit_apply_reuse: Callable,
    prompt_embeds,
    pooled_embeds,
    guidance_scale,
):
    """The Δ-cache pair of :func:`make_cfg_velocity_fn`: each fn is
    ``(latents, sigma, delta) -> (velocity, delta)``."""

    def make(apply_fn):
        def velocity_fn(latents, sigma, delta):
            if guidance_scale is not None:
                lat, t = _doubled(latents, sigma)
            else:
                lat, t = latents, sigma * 1000.0
            out = apply_fn(lat, t, prompt_embeds, pooled_embeds, delta)
            vel, delta = out[0], out[4]
            return (vel if guidance_scale is None else _guide(vel, guidance_scale)), delta

        return velocity_fn

    return make(mmdit_apply_record), make(mmdit_apply_reuse)


def _interval_weight(sigma, guidance_scale, interval):
    """(b,) fp32 weight: ``guidance_scale`` where sigma is in [lo, hi), 1
    (conditional only) outside."""
    lo, hi = interval
    in_iv = (sigma >= lo) & (sigma < hi)
    g = torch.as_tensor(guidance_scale, dtype=torch.float32, device=sigma.device)
    g = torch.broadcast_to(g.reshape(-1), sigma.shape)
    return torch.where(in_iv, g, torch.ones_like(g))


def _guide_in_window(outs, sigma, guidance_scale, interval):
    w = _interval_weight(sigma, guidance_scale, interval)
    return [_guide(a, w) for a in outs]


def make_cfg_interval_denoise_fn(
    mmdit_apply: Callable,
    prompt_embeds,
    pooled_embeds,
    guidance_scale,
    interval,
    token_grid,
    patch_size: int = 2,
):
    """The guidance-interval form of :func:`make_cfg_denoise_fn`:
    ``denoise_fn(latents, sigma, guided)``. ``guided`` (a host bool, =
    ``in_window(sigma, interval)``) runs the CFG-doubled forward with
    per-sample weights; otherwise one conditional forward at batch b."""
    if guidance_scale is None:
        raise ValueError("guidance interval requires CFG on")
    gh, gw = _grid(token_grid)
    n = prompt_embeds.shape[0] // 2

    def denoise_fn(latents, sigma, guided: bool):
        b = latents.shape[0]
        if guided:
            outs = mmdit_apply(*_doubled(latents, sigma), prompt_embeds, pooled_embeds)
            outs = _guide_in_window(outs, sigma, guidance_scale, interval)
        else:
            outs = mmdit_apply(latents, sigma * 1000.0, prompt_embeds[n:][:b],
                               pooled_embeds[n:][:b])
        vel, temb, h1, h2 = outs
        return vel, temb, _h_combined(h1, h2, gh, gw, patch_size)

    return denoise_fn


def make_cfg_interval_velocity_fn(mmdit_apply: Callable, prompt_embeds, pooled_embeds,
                                  guidance_scale, interval):
    """The guidance-interval form of :func:`make_cfg_velocity_fn`:
    ``velocity_fn(latents, sigma, guided)``."""
    if guidance_scale is None:
        raise ValueError("guidance interval requires CFG on")
    n = prompt_embeds.shape[0] // 2

    def velocity_fn(latents, sigma, guided: bool):
        b = latents.shape[0]
        if guided:
            vel = mmdit_apply(*_doubled(latents, sigma), prompt_embeds, pooled_embeds)[0]
            return _guide_in_window([vel], sigma, guidance_scale, interval)[0]
        return mmdit_apply(latents, sigma * 1000.0, prompt_embeds[n:][:b],
                           pooled_embeds[n:][:b])[0]

    return velocity_fn


def make_interval_cached_denoise_pair(
    g_fwd_record: Callable,
    g_fwd_reuse: Callable,
    c_fwd_record: Callable,
    c_fwd_reuse: Callable,
    weight_fn: Callable,
    post: Callable,
):
    """The Δ-cache composed with the guidance interval.

    Args:
        g_fwd_record / g_fwd_reuse: ``(latents, sigma, cache2b) -> (outs,
            cache2b)``, the raw (not guidance-combined) CFG-doubled forward,
            record resp. reuse; ``outs`` a tuple on 2b rows, ``cache2b`` the
            Δ on [uncond; cond] rows.
        c_fwd_record / c_fwd_reuse: the same as one conditional forward at
            batch b over the cond half of the cache.
        weight_fn: ``sigma -> (b,) weight``.
        post: ``outs -> tuple``, the final output shaping.

    Returns ``(full_fn, reuse_fn)``, each ``(latents, sigma, delta, guided)
    -> (*outs, delta)`` with ``delta = {"d": Δ (2b rows), "uncond_valid":
    bool}``. ``uncond_valid`` says whether the uncond rows were refreshed
    at the last full step: a conditional full step refreshes only the cond
    rows, so a reuse step that enters the window over a stale uncond half
    is promoted to a full guided forward. Step cost: guided full 2b rows
    through every block, guided reuse 2b rows through the front blocks,
    cond full b rows through every block, cond reuse b rows through the
    front blocks. ``uncond_valid`` and the branch are host values.
    """

    def guided_run(g_fwd, latents, sigma, d):
        outs, d_new = g_fwd(latents, sigma, d)
        w = weight_fn(sigma)
        return tuple(_guide(a, w) for a in outs), d_new

    def cond_run(c_fwd, latents, sigma, d):
        half = d.shape[0] // 2
        outs, d_c = c_fwd(latents, sigma, d[half:])
        # a new tensor: the caller may still hold the old Δ
        return outs, torch.cat([d[:half], d_c])

    def full_fn(latents, sigma, delta, guided: bool):
        if guided:
            outs, d_new = guided_run(g_fwd_record, latents, sigma, delta["d"])
        else:
            outs, d_new = cond_run(c_fwd_record, latents, sigma, delta["d"])
        return (*post(outs), {"d": d_new, "uncond_valid": guided})

    def reuse_fn(latents, sigma, delta, guided: bool):
        valid = delta["uncond_valid"]
        if not guided:  # outside the window: cond-only reuse
            outs, d_new = cond_run(c_fwd_reuse, latents, sigma, delta["d"])
        elif valid:  # inside, cache fresh: guided reuse
            outs, d_new = guided_run(g_fwd_reuse, latents, sigma, delta["d"])
        else:  # entering over a stale uncond cache: promoted to a full guided step
            outs, d_new = guided_run(g_fwd_record, latents, sigma, delta["d"])
            valid = True
        return (*post(outs), {"d": d_new, "uncond_valid": valid})

    return full_fn, reuse_fn


def interval_cached_init_delta(family_cache):
    """The composed pair's initial cache state: the zero Δ and a False
    uncond flag (step 0 is always a full step, which sets it)."""
    return {"d": family_cache, "uncond_valid": False}


def _sd3_interval_cached_parts(prompt_embeds, pooled_embeds, guidance_scale, interval):
    """The SD3 g_fwd / c_fwd / weight closures of the composed builders."""
    if guidance_scale is None:
        raise ValueError("guidance interval requires CFG on")
    n = prompt_embeds.shape[0] // 2

    def g_fwd(apply_fn):
        def run(latents, sigma, d):
            *outs, d_new = apply_fn(*_doubled(latents, sigma), prompt_embeds, pooled_embeds, d)
            return tuple(outs), d_new

        return run

    def c_fwd(apply_fn):
        def run(latents, sigma, d):
            b = latents.shape[0]
            *outs, d_new = apply_fn(latents, sigma * 1000.0, prompt_embeds[n:][:b],
                                    pooled_embeds[n:][:b], d)
            return tuple(outs), d_new

        return run

    def weight_fn(sigma):
        return _interval_weight(sigma, guidance_scale, interval)

    return g_fwd, c_fwd, weight_fn


def make_cfg_interval_denoise_cached_fns(
    mmdit_apply_record: Callable,
    mmdit_apply_reuse: Callable,
    prompt_embeds,
    pooled_embeds,
    guidance_scale,
    interval,
    token_grid,
    patch_size: int = 2,
):
    """The Δ-cache × guidance interval for the adaptive loop: each fn is
    ``(latents, sigma, delta, guided) -> (velocity, temb, h_combined,
    delta)``, ``delta`` from :func:`interval_cached_init_delta`."""
    gh, gw = _grid(token_grid)
    g_fwd, c_fwd, weight_fn = _sd3_interval_cached_parts(
        prompt_embeds, pooled_embeds, guidance_scale, interval)

    def post(outs):
        vel, temb, h1, h2 = outs
        return vel, temb, _h_combined(h1, h2, gh, gw, patch_size)

    return make_interval_cached_denoise_pair(
        g_fwd(mmdit_apply_record), g_fwd(mmdit_apply_reuse),
        c_fwd(mmdit_apply_record), c_fwd(mmdit_apply_reuse), weight_fn, post)


def make_cfg_interval_velocity_cached_fns(
    mmdit_apply_record: Callable,
    mmdit_apply_reuse: Callable,
    prompt_embeds,
    pooled_embeds,
    guidance_scale,
    interval,
):
    """The Δ-cache × guidance interval for the fixed-schedule samplers: each
    fn is ``(latents, sigma, delta, guided) -> (velocity, delta)``."""
    g_fwd, c_fwd, weight_fn = _sd3_interval_cached_parts(
        prompt_embeds, pooled_embeds, guidance_scale, interval)

    def vel_only(run):
        def wrapped(latents, sigma, d):
            outs, d_new = run(latents, sigma, d)
            return (outs[0],), d_new

        return wrapped

    return make_interval_cached_denoise_pair(
        vel_only(g_fwd(mmdit_apply_record)), vel_only(g_fwd(mmdit_apply_reuse)),
        vel_only(c_fwd(mmdit_apply_record)), vel_only(c_fwd(mmdit_apply_reuse)),
        weight_fn, lambda outs: (outs[0],))
