"""Serving engine: request batching over one ``TPDMPipeline``.

Counterpart of ``tpdm_tpu/serving.py``'s ``BatchingEngine``. It:

- queues incoming requests and coalesces them, for ``window_ms`` after the
  first, into batches of ``max_batch``, padding the tail by repeating the
  last request, so one batch shape serves every traffic level (one cuBLAS
  algorithm choice a shape, no new first-call cost under load);
- sheds load: a full queue raises ``EngineOverloaded`` at submit, and a
  request whose ``deadline_s`` passed while it waited fails with
  ``RequestExpired`` instead of taking a slot;
- takes per-request step caps, CFG strengths, negative prompts and
  resolutions (one sub-batch a resolution), and keeps the text embeddings
  of recent prompts in an LRU of device rows, so a batch whose prompts are
  all cached skips the three towers;
- runs img2img rows (``init_image``, ``strength``) beside text-to-image
  rows in one batch: a batch with any image runs as ``TPDMPipeline.
  generate(init_image=, strength=, seed=<one a row>)``, a text-to-image
  row there being a blank image at strength 1.0, whose starting latent is
  its seed's noise exactly and whose sigma starts at 1.0. The whole padded
  batch is encoded in one VAE call, so each served resolution has one
  encode shape, as it has one denoise shape;
- serves named LoRA adapters next to the base model (``register_
  adapter``; a request's ``lora=``): each adapter's merged backbone
  (``models/lora.py:apply_lora``) is kept in an LRU of ``merged_cache``
  copies and run through ``call_merged``, which swaps the merged tensors in
  for the batch and never writes the base module, so a base request after
  adapter traffic is the adapter-free engine's to the bit. A window groups
  by (resolution, adapter): one sub-batch each;
- keeps per-request determinism: each request's initial latent is drawn
  as a batch-1 ``TPDMPipeline.generate(seed=s)`` draws it,
  ``torch.randn`` from ``torch.Generator(device).manual_seed(s)`` on the
  MMDiT's device, and ``predict=True`` draws nothing else. The engine,
  ``serve.py --cli`` and a direct call (``generate(seed=[s0, s1, ...])``)
  so give the same (prompt, seed[, image, strength]) the same image at the
  same batch shape. It is not the JAX package's image for that seed:
  ``jax.random`` and ``torch.Generator`` draw different numbers.

A model family other than SD3 is served through a ``runner`` (``serving_
families.make_sd15_runner``): the engine keeps the queue, the window, the
padding and the stats, the runner owns tokenize, encode, sample and
decode, and per-request resolutions, guidance, negatives, img2img and the
engine-level acceleration options are refused, as in JAX.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
queue 1 item: data-parallel replicas and the sharded mesh (``dp``,
``mesh_shape``: 9(d) and 14). The continuous engine, which refills a
finished request's slot mid-denoise, is ``serving_continuous.py``.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from tpdm_tpu_torch.models.lora import MergedLRU, call_merged, check_lora, lora_targets
from tpdm_tpu_torch.pipeline.pipeline import not_ported, seed_noise
from tpdm_tpu_torch.utils.image import postprocess_images

logger = logging.getLogger(__name__)


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the request queue is at its limit."""


class RequestExpired(RuntimeError):
    """The request's deadline passed while it waited in the queue."""


@dataclass
class ServeRequest:
    prompt: str
    seed: int = 0
    # per-request step cap; None = the engine's max_steps. The batch runs to
    # its largest cap
    steps: Optional[int] = None
    # output resolution in image pixels; None = the engine's default.
    # Requests coalesce per resolution
    resolution: Optional[int] = None
    # seconds this request may wait before it starts; None = forever
    deadline_s: Optional[float] = None
    # image-to-image: uint8 (H, W, 3) at the request's resolution, noised to
    # ``strength`` (submit() defaults it to 0.6); None = text-to-image
    init_image: Optional[np.ndarray] = None
    strength: Optional[float] = None
    # per-request CFG strength; None = the engine's guidance_scale
    guidance_scale: Optional[float] = None
    # per-request negative prompt; None/"" = the engine's constant negative
    # (the towers on zero ids)
    negative_prompt: Optional[str] = None
    # the registered LoRA adapter this request runs under; None = the base.
    # Requests coalesce per adapter
    lora: Optional[str] = None
    submitted_at: float = field(default_factory=time.monotonic)
    _event: threading.Event = field(default_factory=threading.Event)
    _result: Optional[dict] = None
    _error: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None) -> dict:
        if not self._event.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        if self._error is not None:
            raise self._error
        return self._result

    def expired(self) -> bool:
        return (self.deadline_s is not None
                and time.monotonic() - self.submitted_at > self.deadline_s)

    def _expire(self) -> None:
        self._error = RequestExpired(f"request waited >{self.deadline_s:.1f}s in the queue")
        self._event.set()


def generate_ranked(
    engine,
    prompt: str,
    seed: int = 0,
    n: int = 4,
    steps: Optional[int] = None,
    ranker: Optional[Callable] = None,
    timeout: float = 600.0,
    lora: Optional[str] = None,
) -> dict:
    """Best-of-N: submit ``n`` seeds (seed..seed+n-1) of one prompt, and rank
    the candidates with ``ranker`` ``(prompt, images (n, H, W, 3) uint8) ->
    (ranking, rewards)`` where one is given (``train.builders.
    build_inference_ranker``). Returns {candidates, seeds[, ranking,
    rewards, best]}: ranking 1-based in candidate order (1 = best), best
    the index of the largest reward."""
    if n < 1:
        raise ValueError("n must be >= 1")
    kw = {} if lora is None else {"lora": lora}
    reqs = [engine.submit(prompt, seed=seed + i, steps=steps, **kw) for i in range(n)]
    results = [r.result(timeout=timeout) for r in reqs]
    out = {"candidates": results, "seeds": [seed + i for i in range(n)]}
    if ranker is not None:
        images = np.stack([np.asarray(r["image"]) for r in results])
        ranking, rewards = ranker(prompt, images)
        out["ranking"] = [int(x) for x in ranking]
        out["rewards"] = [float(x) for x in rewards]
        out["best"] = int(np.argmax(out["rewards"]))
    return out


def checked_img2img(pipe, init_image, strength, px: int):
    """(init_image, strength) of a request, checked as the JAX engines check
    them: a uint8 (px, px, 3) image, the strength in (0, 1] (default 0.6),
    a strength only with an image, and a pipeline with a VAE encoder.
    (None, None) for a text-to-image request."""
    if init_image is None:
        if strength is not None:
            raise ValueError("strength needs an init_image")
        return None, None
    if pipe.vae is None or pipe.vae.encoder is None:
        raise ValueError("img2img needs a pipeline with a VAE encoder")
    s = 0.6 if strength is None else float(strength)
    if not 0.0 < s <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    init_image = np.asarray(init_image)
    if init_image.ndim != 3 or init_image.shape[-1] != 3:
        raise ValueError("init_image must be (H, W, 3) uint8")
    if init_image.shape[:2] != (px, px):
        raise ValueError(f"init_image is {init_image.shape[0]}x{init_image.shape[1]}; "
                         f"this request serves {px}x{px}")
    return init_image, s


def _percentile(vals, q):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


class BatchingEngine:
    """Coalesces requests into fixed-shape batches for one pipeline.

    Args:
        pipe: a ``TPDMPipeline`` with ``text_encoders``; None with a runner.
        tokenize: prompt -> (clip_ids (1, 77), t5_ids (1, L)) numpy arrays.
        max_batch: the batch size; partial batches are padded to it.
        window_ms: how long to wait for more requests after the first.
        max_steps: the adaptive sampler's step cap.
        guidance_scale: the default CFG strength (None: CFG off).
        queue_limit: submit() raises EngineOverloaded beyond this many
            queued requests (default 8 x max_batch).
        split_stages: decode in a call of its own, so that stats() reports
            the denoise and decode seconds apart (one more host round trip
            of the latents a batch).
        embed_cache: LRU capacity of per-prompt text embeddings, held on the
            device (0 disables). A batch whose prompts are all cached skips
            the towers; a cached row equals an encoded one, since the towers
            couple no rows.
        resolutions: further per-request output resolutions in pixels (the
            MMDiT's default is always served); each is a batch shape of its
            own.
        vae_scale_factor: image pixels per latent cell (8 for SD3's VAE).
        cache_interval, guidance_interval, cache_tau, solver: as in
            ``TPDMPipeline.generate``, for every batch (not with a runner,
            which takes them where it is built).
        runner: ``(prompts, seeds, caps) -> [{image, inference_steps,
            sigmas}, ...]`` over the padded batch, in place of the SD3
            pipeline (``serving_families.make_sd15_runner``).
        dp, mesh_shape: not ported (ROADMAP queue 1, items 9(d) and 14).

    LoRA adapters: ``register_adapter``, then ``submit(lora=name)`` or
    ``generate_batch(lora=name)``; ``stats()`` adds ``adapter_batches``
    and ``adapter_merges`` once one is registered.
    """

    def __init__(
        self,
        pipe,
        tokenize: Callable[[str], tuple],
        max_batch: int = 4,
        window_ms: float = 25.0,
        max_steps: int = 35,
        guidance_scale: Optional[float] = 7.0,
        dp: Optional[int] = None,
        queue_limit: Optional[int] = None,
        split_stages: bool = False,
        mesh_shape: Optional[tuple] = None,
        runner: Optional[Callable] = None,
        embed_cache: int = 32,
        resolutions: Optional[Sequence[int]] = None,
        vae_scale_factor: int = 8,
        cache_interval: int = 0,
        guidance_interval: Optional[tuple] = None,
        cache_tau: float = 0.0,
        solver: str = "euler",
    ):
        if dp is not None:
            raise not_ported("dp (data-parallel replicas)", "9(d)")
        if mesh_shape is not None:
            raise not_ported("mesh_shape (sharded-model serving)", "14")
        if runner is not None and resolutions:
            raise ValueError("per-request resolutions are SD3-pipeline-only")
        if runner is not None and (cache_interval or guidance_interval or cache_tau):
            raise ValueError("cache_interval/guidance_interval on the engine apply to the SD3 "
                             "pipeline path; family runners take them at construction "
                             "(serving_families.make_*_runner)")
        if runner is not None and solver != "euler":
            raise ValueError("solver applies to the SD3 pipeline path; family runners own "
                             "their sampler configs")
        if solver not in ("euler", "ab2"):
            raise ValueError("engine solver must be 'euler' or 'ab2' (the adaptive loop "
                             f"has no two-eval solvers), got {solver!r}")
        if cache_tau and cache_interval:
            raise ValueError("cache_tau (input-aware policy) and cache_interval (fixed "
                             "schedule) are mutually exclusive")
        if guidance_interval is not None and guidance_scale is None:
            raise ValueError("guidance_interval requires classifier-free guidance "
                             "(engine guidance_scale=None)")
        self.pipe = pipe
        self.tokenize = tokenize
        self._runner = runner
        self.max_batch = max_batch
        self.window_ms = window_ms
        self.max_steps = max_steps
        self.guidance_scale = guidance_scale
        self.cache_interval = cache_interval
        self.guidance_interval = guidance_interval
        self.cache_tau = cache_tau
        self.solver = solver
        self.split_stages = split_stages
        self._queue: "queue.Queue[Optional[ServeRequest]]" = queue.Queue(
            maxsize=queue_limit if queue_limit is not None else 8 * max_batch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.batches_run = 0
        self.requests_expired = 0
        self.padded_slots = 0  # tail-padding waste, in slots
        # prompt (or ("\x00neg", text)) -> (embed row, pooled row) on the
        # device; the constant negative (zero ids) is kept apart
        self._embed_cache = collections.OrderedDict() if embed_cache else None
        self._embed_cache_size = embed_cache
        self._neg_embed = None
        self.embed_hits = 0
        self.embed_misses = 0
        self.vae_scale_factor = vae_scale_factor
        self.default_resolution = (pipe.mmdit.config.sample_size * vae_scale_factor
                                   if pipe is not None else None)
        self.resolutions = set(resolutions or [])
        if self.default_resolution is not None:
            self.resolutions.add(self.default_resolution)
        for r in self.resolutions:
            lat = r // vae_scale_factor
            if lat * vae_scale_factor != r or lat < 1:
                raise ValueError(f"resolution {r} not a multiple of vae_scale_factor "
                                 f"{vae_scale_factor}")
        # deque(maxlen): the worker appends while HTTP threads read stats();
        # a deque's append and iteration are thread-safe
        self._stage_times: "collections.deque" = collections.deque(maxlen=256)
        # LoRA adapters: name -> (factors, scale), and their merged weights
        self._adapters: dict = {}
        self._merged = MergedLRU()
        self.adapter_batches: dict = {}

    @property
    def adapter_merges(self) -> int:
        """Merges paid: the merged-weight LRU's misses."""
        return self._merged.merges

    # -- LoRA adapters -------------------------------------------------------
    def register_adapter(self, name: str, lora: dict, scale: float = 1.0,
                         merged_cache: Optional[int] = None) -> None:
        """Serve a named LoRA adapter (``models/lora.py`` factors, e.g. from
        ``train/draft.py:load_lora``) next to the base model: a request
        with ``lora=name`` runs on ``apply_lora(mmdit, lora, scale)``,
        merged when first needed into an LRU of ``merged_cache`` entries
        (default 1). Not on a runner engine (the runner owns its model) nor
        a quantised backbone (a stored-int weight has no float to merge
        into); a factor key that names no dense layer of the MMDiT raises."""
        if self._runner is not None:
            raise ValueError("adapters need the SD3 pipeline path; runner families own "
                             "their own params")
        if not name:
            raise ValueError("adapter name must be non-empty")
        if any(not m.weight.is_floating_point() for m in lora_targets(self.pipe.mmdit).values()):
            raise ValueError("cannot merge LoRA into a quantized backbone; serve float "
                             "weights to use adapters")
        self._adapters[name] = (check_lora(self.pipe.mmdit, lora), float(scale))
        self._merged.drop(name)  # a new registration invalidates its merge
        if merged_cache is not None:
            if merged_cache < 1:
                raise ValueError("merged_cache must be >= 1")
            self._merged.size = merged_cache

    def _params_for(self, lora_name: Optional[str]):
        """The merged weights of one adapter (None for the base)."""
        if lora_name is None:
            return None
        if lora_name not in self._adapters:
            raise ValueError(f"unknown adapter {lora_name!r}; registered: "
                             f"{sorted(self._adapters)}")
        return self._merged.get(self.pipe.mmdit, lora_name, *self._adapters[lora_name])

    # -- per-prompt embedding cache -----------------------------------------
    def _remember(self, key, row) -> None:
        cache = self._embed_cache
        cache[key] = row
        while len(cache) > self._embed_cache_size:
            cache.popitem(last=False)

    def _ensure_neg_embed(self, clip_ids, t5_ids):
        if self._neg_embed is None:
            ne, npp = self.pipe.text_encoders.encode(np.zeros_like(clip_ids[:1]), np.zeros_like(t5_ids[:1]))
            self._neg_embed = (ne[0].clone(), npp[0].clone())

    def _neg_rows(self, negatives, clip_ids, t5_ids):
        """Per-request negative rows: ""/None takes the constant negative;
        a text is embedded through the towers and the LRU like a prompt,
        under a key of its own so a prompt and a negative never collide."""
        cache = self._embed_cache
        self._ensure_neg_embed(clip_ids, t5_ids)
        rows = []
        for text in negatives:
            if not text:
                rows.append(self._neg_embed)
                continue
            key = ("\x00neg", text)
            if key in cache:
                cache.move_to_end(key)
                self.embed_hits += 1
            else:
                e, p = self.pipe.text_encoders.encode(*self.tokenize(text))
                self._remember(key, (e[0].clone(), p[0].clone()))
                self.embed_misses += 1
            rows.append(cache[key])
        return torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows])

    def _embeds_for(self, prompts, clip_ids, t5_ids, negatives):
        """(pe, pp, ne, npp) of the padded batch: from the LRU when every
        prompt (and the constant negative) is cached, else from one run of
        the towers over the batch, which fills the cache row by row."""
        cache = self._embed_cache
        b = len(prompts)
        need_neg = self.guidance_scale is not None
        if all(p in cache for p in prompts) and (not need_neg or self._neg_embed is not None):
            for p in prompts:
                cache.move_to_end(p)
            pe = torch.stack([cache[p][0] for p in prompts])
            pp = torch.stack([cache[p][1] for p in prompts])
            self.embed_hits += b
        else:
            pe, pp = self.pipe.text_encoders.encode(clip_ids, t5_ids)
            for i, p in enumerate(prompts):
                if p in cache:
                    cache.move_to_end(p)
                else:
                    # a copy: a view would keep the whole batch's rows alive
                    self._remember(p, (pe[i].clone(), pp[i].clone()))
            self.embed_misses += b
        ne = npp = None
        if need_neg:
            if any(negatives):
                ne, npp = self._neg_rows(negatives, clip_ids, t5_ids)
            else:
                self._ensure_neg_embed(clip_ids, t5_ids)
                ne = self._neg_embed[0][None].expand(b, -1, -1)
                npp = self._neg_embed[1][None].expand(b, -1)
        return pe, pp, ne, npp

    # -- synchronous core ---------------------------------------------------
    def _latents(self, seeds, lat_size: int) -> torch.Tensor:
        """Each seed's initial latent, drawn as a batch-1 ``generate(seed=s)``
        draws it, stacked."""
        mcfg = self.pipe.mmdit.config
        device, dtype = self.pipe._device_dtype()
        shape = (len(seeds), mcfg.in_channels, lat_size, lat_size)
        return seed_noise(seeds, shape, device, dtype)[1]

    def generate_batch(
        self, prompts: Sequence[str], seeds: Sequence[int],
        record_stats: bool = True, steps: Optional[Sequence] = None,
        resolution: Optional[int] = None, lora: Optional[str] = None,
        init_images: Optional[Sequence] = None,
        strengths: Optional[Sequence] = None,
        guidances: Optional[Sequence] = None,
        negative_prompts: Optional[Sequence] = None,
    ):
        """Run ONE batch padded to ``max_batch``; returns a list of {image,
        inference_steps, sigmas}, one a request. ``record_stats=False``
        (warmup) keeps the run out of stats(). ``steps`` (None entries = the
        engine's max) caps each request's steps; ``guidances`` (None
        entries = the engine's default) sets each one's CFG strength;
        ``negative_prompts`` (None/"" = the constant negative) each one's
        negative; ``init_images`` / ``strengths`` (None entries = text-to-
        image) run img2img rows (see the module docstring). ``lora`` names
        a registered adapter that the whole batch runs under."""
        args = (prompts, seeds, record_stats, steps, resolution, lora, init_images, strengths,
                guidances, negative_prompts)
        if lora is None and not self._adapters:
            return self._generate_batch_impl(*args)
        if self._runner is not None:
            raise ValueError("adapters are SD3-pipeline-only")
        merged = self._params_for(lora)
        if merged is None:
            return self._generate_batch_impl(*args)
        return call_merged(self.pipe.mmdit, merged, self._generate_batch_impl, *args)

    def _generate_batch_impl(self, prompts, seeds, record_stats, steps, resolution, lora,
                             init_images, strengths, guidances, negative_prompts):
        # the adapter's weights are in place (generate_batch); ``lora`` here
        # only labels the stats
        n = len(prompts)
        if not 0 < n <= self.max_batch:
            raise ValueError(f"a batch takes 1 to {self.max_batch} prompts, got {n}")
        pad = self.max_batch - n
        prompts = list(prompts) + [prompts[-1]] * pad
        seeds = list(seeds) + [seeds[-1]] * pad
        caps = [min(c or self.max_steps, self.max_steps)
                for c in (list(steps) if steps is not None else [None] * n)]
        caps = caps + [caps[-1]] * pad
        imgs = list(init_images) if init_images is not None else [None] * n
        strs = list(strengths) if strengths is not None else [None] * n
        imgs, strs = imgs + [imgs[-1]] * pad, strs + [strs[-1]] * pad
        gds = list(guidances) if guidances is not None else [None] * n
        negs = [x or "" for x in (list(negative_prompts) if negative_prompts is not None
                                  else [None] * n)]
        if (any(g is not None for g in gds) or any(negs)) and self.guidance_scale is None:
            raise ValueError("per-request guidance/negative prompts need a CFG-enabled "
                             "engine (this one was built with guidance_scale=None)")
        gds = gds + [gds[-1]] * pad
        negs = negs + [negs[-1]] * pad
        if self._runner is not None:
            return self._run_runner(prompts, seeds, caps, n, pad, record_stats,
                                    any(im is not None for im in imgs), gds, negs)
        gs_batch = None
        if self.guidance_scale is not None:
            gs_batch = np.asarray([self.guidance_scale if g is None else float(g) for g in gds],
                                  np.float32)

        t_start = time.monotonic()
        clip_rows, t5_rows = [], []
        for p in prompts:
            c, t = self.tokenize(p)
            clip_rows.append(c[0])
            t5_rows.append(t[0])
        clip_ids, t5_ids = np.stack(clip_rows), np.stack(t5_rows)
        if resolution is not None and resolution not in self.resolutions:
            raise ValueError(f"resolution {resolution} not in the served set "
                             f"{sorted(self.resolutions)}")
        lat_size = (resolution // self.vae_scale_factor if resolution is not None
                    else self.pipe.mmdit.config.sample_size)
        if any(im is not None for im in imgs):
            px = lat_size * self.vae_scale_factor
            rows = [checked_img2img(self.pipe, im, st, px) for im, st in zip(imgs, strs)]
            blank = np.zeros((px, px, 3), np.uint8)
            start = dict(init_image=np.stack([blank if im is None else im for im, _ in rows]),
                         strength=np.asarray([1.0 if im is None else st for im, st in rows],
                                             np.float32),
                         seed=seeds)
        else:
            start = dict(latents=self._latents(seeds, lat_size))
        t_tokenized = time.monotonic()
        split = self.split_stages and self.pipe.vae is not None
        embeds = None
        if self._embed_cache is not None:
            embeds = self._embeds_for(prompts, clip_ids, t5_ids, negs)
        t_encoded = time.monotonic()
        common = dict(
            **start, predict=True, max_inference_steps=self.max_steps,
            guidance_scale=gs_batch if gs_batch is not None else self.guidance_scale,
            decode=not split, step_caps=np.asarray(caps, np.int32),
            cache_interval=self.cache_interval, guidance_interval=self.guidance_interval,
            cache_tau=self.cache_tau, solver=self.solver)
        if embeds is not None:
            res = self.pipe.generate(
                prompt_embeds=embeds[0], pooled_prompt_embeds=embeds[1],
                negative_prompt_embeds=embeds[2], negative_pooled_prompt_embeds=embeds[3],
                **common)
        else:
            # ""-negative slots take the zero-ids negative; the others
            # tokenize as prompts do
            nc, nt = np.zeros_like(clip_ids), np.zeros_like(t5_ids)
            for i, text in enumerate(negs):
                if text:
                    c, t = self.tokenize(text)
                    nc[i], nt[i] = c[0], t[0]
            res = self.pipe.generate(clip_ids=clip_ids, t5_ids=t5_ids, negative_clip_ids=nc,
                                     negative_t5_ids=nt, **common)
        stage = {"batch": n, "padded": pad, "tokenize_s": t_tokenized - t_start}
        if resolution is not None:
            stage["resolution"] = resolution
        if lora is not None:
            stage["lora"] = lora
        if record_stats and (lora is not None or self._adapters):
            key = lora or "<base>"
            self.adapter_batches[key] = self.adapter_batches.get(key, 0) + 1
        if embeds is not None:
            stage["encode_s"] = t_encoded - t_tokenized
        t_device = t_encoded if embeds is not None else t_tokenized
        if split:
            # res.images holds the final latents (decode=False), on the host:
            # generate() has waited for the denoise
            t_denoised = time.monotonic()
            device = self.pipe._device_dtype()[0]
            images = postprocess_images(
                self.pipe._decode_impl(torch.as_tensor(res.images, device=device)))
            t_done = time.monotonic()
            stage["denoise_s"] = t_denoised - t_device
            stage["decode_s"] = t_done - t_denoised
        else:
            images = res.images
            t_done = time.monotonic()
        stage["device_s"] = t_done - t_device
        stage["total_s"] = t_done - t_start
        if record_stats:
            self.batches_run += 1
            self.padded_slots += pad
            self._stage_times.append(stage)
        out = []
        for i in range(n):
            nfe = int(res.last_valid_index[i]) + 1
            out.append({"image": images[i], "inference_steps": nfe,
                        "sigmas": np.asarray(res.sigmas[i][:nfe]).tolist()})
        return out

    def _run_runner(self, prompts, seeds, caps, n, pad, record_stats, any_img2img, gds, negs):
        """A padded batch through the family runner, with the engine's stats."""
        if any_img2img:
            raise ValueError("img2img is SD3-pipeline-engine-only")
        if any(g is not None for g in gds) or any(negs):
            raise ValueError("per-request guidance/negative prompts are SD3-pipeline-engine-only")
        t_start = time.monotonic()
        results = self._runner(prompts, seeds, caps)
        t_done = time.monotonic()
        if len(results) != self.max_batch:
            raise RuntimeError(f"runner returned {len(results)} results for a padded batch "
                               f"of {self.max_batch}")
        if record_stats:
            self.batches_run += 1
            self.padded_slots += pad
            self._stage_times.append({"batch": n, "padded": pad, "device_s": t_done - t_start,
                                      "total_s": t_done - t_start})
        return results[:n]

    # -- async surface -------------------------------------------------------
    def submit(
        self, prompt: str, seed: int = 0, steps: Optional[int] = None,
        resolution: Optional[int] = None,
        deadline_s: Optional[float] = None,
        lora: Optional[str] = None,
        init_image: Optional[np.ndarray] = None,
        strength: Optional[float] = None,
        guidance_scale: Optional[float] = None,
        negative_prompt: Optional[str] = None,
    ) -> ServeRequest:
        if self._stop.is_set():
            # a request queued after stop() would never run and block its
            # caller until the result() timeout
            raise EngineOverloaded("engine is stopped; no worker will run this")
        if lora is not None and lora not in self._adapters:
            raise ValueError(f"unknown adapter {lora!r}; registered: {sorted(self._adapters)}")
        if steps is not None and steps < 1:
            raise ValueError("steps must be >= 1")
        if self._runner is not None:
            if guidance_scale is not None or negative_prompt:
                raise ValueError("per-request guidance/negative prompts are SD3-only")
            if init_image is not None or strength is not None:
                raise ValueError("img2img needs the SD3 pipeline engine with a VAE")
            if resolution is not None:
                raise ValueError("per-request resolutions are SD3-only")
        if guidance_scale is not None or negative_prompt:
            if self.guidance_scale is None:
                raise ValueError("per-request guidance/negative prompts need a CFG-enabled "
                                 "engine (built with guidance_scale=None)")
            if guidance_scale is not None and not np.isfinite(guidance_scale):
                raise ValueError(f"bad guidance_scale {guidance_scale}")
        if resolution is not None and resolution not in self.resolutions:
            raise ValueError(f"resolution {resolution} not in the served set "
                             f"{sorted(self.resolutions)}")
        init_image, strength = checked_img2img(
            self.pipe, init_image, strength,
            resolution if resolution is not None else self.default_resolution)
        req = ServeRequest(
            prompt=prompt, seed=seed, steps=steps, resolution=resolution,
            deadline_s=deadline_s, init_image=init_image, strength=strength,
            guidance_scale=None if guidance_scale is None else float(guidance_scale),
            negative_prompt=negative_prompt or None, lora=lora)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise EngineOverloaded(f"request queue full ({self._queue.maxsize}); retry later")
        if self._stop.is_set():
            # stop() may have drained the queue between the check above and
            # the put: drain again so this request cannot strand its caller
            self._drain_failed("engine stopped before this request ran")
            raise EngineOverloaded("engine is stopped; no worker will run this")
        return req

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        try:
            self._queue.put_nowait(None)  # wake the worker
        except queue.Full:
            pass  # the worker is mid-batch; it checks _stop on its next loop
        self._thread.join(timeout=30)
        self._thread = None
        # fail the requests still queued so no waiter blocks forever
        self._drain_failed("engine stopped before this request ran")

    def _drain_failed(self, message: str):
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req._error = RuntimeError(message)
                req._event.set()

    def _collect(self) -> List[ServeRequest]:
        """Block for the first request, then coalesce for window_ms."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.window_ms / 1000.0
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _worker(self):
        while not self._stop.is_set():
            batch = self._collect()
            expired = [r for r in batch if r.expired()]
            for r in expired:
                r._expire()
            self.requests_expired += len(expired)
            batch = [r for r in batch if r not in expired]
            # one sub-batch a (resolution, adapter), in first-seen order: a
            # resolution is a shape of its own, an adapter weights of its own
            groups: dict = {}
            for r in batch:
                groups.setdefault((r.resolution, r.lora), []).append(r)
            for (res_px, lora_name), group in groups.items():
                try:
                    now = time.monotonic()
                    waits = [now - r.submitted_at for r in group]
                    results = self.generate_batch(
                        [r.prompt for r in group], [r.seed for r in group],
                        steps=[r.steps for r in group], resolution=res_px, lora=lora_name,
                        init_images=[r.init_image for r in group],
                        strengths=[r.strength for r in group],
                        guidances=[r.guidance_scale for r in group],
                        negative_prompts=[r.negative_prompt for r in group])
                    if self._stage_times:
                        self._stage_times[-1]["queue_wait_s_max"] = max(waits)
                    for req, res in zip(group, results):
                        req._result = res
                except Exception as e:  # every waiter of the batch gets the error
                    logger.exception("batch failed")
                    for req in group:
                        req._error = e
                finally:
                    for req in group:
                        req._event.set()

    def stats(self) -> dict:
        """Latency summary over recent batches (p50/p95 a stage) and queue
        waits, under the JAX engine's key names."""
        rows = list(self._stage_times)
        if not rows:
            return {"batches_run": self.batches_run}

        def pct(key, q):
            vals = [r[key] for r in rows if key in r]
            return _percentile(vals, q) if vals else 0.0

        waits = [r["queue_wait_s_max"] for r in rows if "queue_wait_s_max" in r]
        wait_stats = ({"queue_wait_s_max": max(waits),
                       "queue_wait_s_p50": sorted(waits)[len(waits) // 2]} if waits else {})
        decode_stats = {}
        if any("decode_s" in r for r in rows):
            decode_stats = {f"{key}_p{q}": pct(key, q / 100) for key in ("denoise_s", "decode_s")
                            for q in (50, 95)}
        return {
            "batches_run": self.batches_run,
            "requests_expired": self.requests_expired,
            "solver": self.solver,
            "recent": len(rows),
            **wait_stats,
            "batch_fill_mean": float(np.mean([r["batch"] for r in rows])) / self.max_batch,
            # requests whose batch skipped the text towers
            "embed_cache_hits": self.embed_hits,
            "embed_cache_misses": self.embed_misses,
            "padded_slots": self.padded_slots,
            "padded_slot_frac": self.padded_slots / max(1, self.batches_run * self.max_batch),
            "tokenize_s_p50": pct("tokenize_s", 0.5),
            "tokenize_s_p95": pct("tokenize_s", 0.95),
            "device_s_p50": pct("device_s", 0.5),
            "device_s_p95": pct("device_s", 0.95),
            **decode_stats,
            "total_s_p50": pct("total_s", 0.5),
            "total_s_p95": pct("total_s", 0.95),
            **({"adapter_batches": dict(self.adapter_batches),
                "adapter_merges": self.adapter_merges} if self._adapters else {}),
        }

    def warmup(self):
        """Run the serving shape once before taking traffic (not counted in
        stats(): a padded warm-up batch is not traffic waste)."""
        self.generate_batch(["warmup"], [0], record_stats=False)
