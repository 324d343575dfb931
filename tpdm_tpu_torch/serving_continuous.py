"""Continuous batching for adaptive-NFE serving: step-level slot recycling.

Counterpart of ``tpdm_tpu/serving_continuous.py``'s ``PromptEmbedCache``,
``ContinuousBatchingEngine``, ``MultiResContinuousRouter`` and the SD1.5,
SDXL and FLUX engines. TPDM gives every prompt its own number of denoise steps.
Under the fixed-batch engine (``serving.BatchingEngine``) a batch runs
until its slowest row finishes, so the other rows idle. This engine treats
the batch as S persistent *slots* and the denoise loop as a sequence of
fixed-length *segments*:

    ┌─ refill free slots from the request queue (prompt embeds, latent)
    │  run ONE segment: ``seg_steps`` adaptive steps over all S slots
    │  (finished and empty slots are frozen by the done-mask)
    │  read (sigma, steps) back: slots that crossed min_sigma or their cap
    │  hand their latent row to a decode worker thread and free the slot
    └─ repeat

so a finished slot takes new work after at most ``seg_steps`` more
forwards. The segment is a Python loop of ``seg_steps`` steps with no host
read inside it; every slot runs the CFG-doubled MMDiT forward at batch
2 x S whether it is busy or not, so one batch shape serves every traffic
level (one cuBLAS algorithm choice a shape). ``segment_traces`` counts the
distinct state shapes the segment has run on and stays 1 for an engine.

Host reads. At dispatch the segment's sigma, step counters and (seg, S)
sigma trace are copied to pinned host buffers without blocking, and a CUDA
event is recorded; the readback waits on that event alone. A plain
``.cpu()`` after segment k + 1 was launched would wait for k + 1 too and
cancel ``pipeline_depth=2``. Host-to-device inputs (the live mask, token
ids) go through pinned buffers without blocking for the same reason. On the
CPU the same code reads synchronously.

Tensors are mutable, JAX arrays are not. Every state update here is out of
place: a refill writes into clones, and the segment returns new tensors. A
finished slot's latent row, a view into the state of its readback, so
stays as it was while the slot is refilled and further segments run, and
the decode worker may read it at any time. Both workers launch on the
default stream, so the decode of a row is ordered after the segment that
wrote it. Grad mode is per thread: each worker enters ``torch.no_grad()``.

img2img slots: a request with ``init_image`` has its image encoded at
batch 1 when it takes a slot, mixed into its seed's noise at its
``strength`` as ``TPDMPipeline.generate`` mixes it, and its slot starts at
sigma = strength, sharing the segment with text-to-image slots.

Determinism: with ``predict=True`` a request's image depends only on its
(prompt, seed, cap, guidance, negative[, image, strength]): its latent is
drawn as ``BatchingEngine._latents`` draws it, and the segment runs the ops of
``TPDMPipeline.generate``'s loop in the same dtypes, so at the same batch
shape its latents equal the fixed engine's to the bit. With
``predict=False`` the Beta draws come from one ``torch.Generator`` owned
by the engine, shared by all slots. The negative prompt's embeds (the
towers on zero ids) are encoded once at build.

The family engines: ``ContinuousSD15Engine`` and ``ContinuousSDXLEngine``
(on ``_AgentContinuousEngine``) run the same host loop over an agent, its
``encode`` and ``decode``: a slot carries the integer t and the
DPM-Solver++ history, and its segment mirrors ``pipeline/sd15_sampler.py``'s
step, so a request's schedule equals the family runner's
(``serving_families.py``). ``ContinuousFluxEngine`` runs the SD3 engine's
sigma-ratio segment over FLUX's denoise (packed tokens, embedded guidance,
no CFG doubling).

LoRA adapters (``register_adapter``, ``submit(lora=)``) come in two
modes. Multiplexed (the SD3 engine's default): each segment runs one
adapter's merged weights (``models/lora.py:apply_lora`` into an LRU,
swapped in by ``call_merged``), picked greedily by runnable slots with a
fairness floor (``adapter_fair_every``); the live mask freezes the other
adapters' slots, so a request's trajectory is its merged solo run's, and
the refill prefers requests whose adapter is already in flight, for at
most ``adapter_starvation_s``. Fused (``fused_lora=True``, the family
engines' only mode): the adapters are stacked into a bank at ``start()``
and every segment runs under ``lora_interceptor``, each slot's row adding
its own rank-r delta, so one segment advances every tenant, over a float
or a quantised backbone. Under CFG the row ids double as [uncond; cond].

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
queue 1 item: ``dp`` (9(d)) and ``mesh_shape`` (14).
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpdm_tpu_torch.models.lora import (
    MergedLRU,
    call_merged,
    check_lora,
    lora_interceptor,
    lora_targets,
    stack_adapters,
)
from tpdm_tpu_torch.ops.beta import beta_mode, beta_sample
from tpdm_tpu_torch.ops.flow_euler import flow_euler_step
from tpdm_tpu_torch.ops.flow_solver import flow_ab2_step
from tpdm_tpu_torch.pipeline.denoise import make_cfg_denoise_cached_fns, make_cfg_denoise_fn
from tpdm_tpu_torch.pipeline.pipeline import noised_latents, not_ported, seed_noise
from tpdm_tpu_torch.pipeline.sampler import SamplerConfig, _clamp_ratio, _raw_to_alpha_beta
from tpdm_tpu_torch.serving import EngineOverloaded, ServeRequest, checked_img2img
from tpdm_tpu_torch.utils.image import postprocess_images

logger = logging.getLogger(__name__)


class PromptEmbedCache:
    """Thread-safe LRU of prompt -> (embed row, pooled row) on the device.

    Shareable across engines: embeds depend only on the prompt, never on
    the latent resolution, so ``MultiResContinuousRouter`` hands one
    instance to every per-resolution engine and a repeated prompt pays one
    text encode in all. The lock matters because each engine reads and
    writes from its own worker thread.
    """

    def __init__(self, size: int = 256):
        self.size = size
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            hit = self._d.get(key)
            if hit is not None:
                self._d.move_to_end(key)
            return hit

    def put(self, key, val):
        with self._lock:
            self._d[key] = val
            while len(self._d) > self.size:
                self._d.popitem(last=False)
        return val

    def __len__(self) -> int:
        return len(self._d)


class _SlotState(NamedTuple):
    """Per-slot state carried across segments, on the pipe's device. The
    random state of ``predict=False`` is the engine's ``torch.Generator``."""

    latents: torch.Tensor  # (S, c, h, w) model dtype
    sigma: torch.Tensor  # (S,) f32; below min_sigma: finished or empty
    steps: torch.Tensor  # (S,) i32, executed denoise steps (NFE so far)
    caps: torch.Tensor  # (S,) i32, per-request step cap
    pe: torch.Tensor  # (S, L, D) positive prompt embeds, model dtype
    pp: torch.Tensor  # (S, P) positive pooled embeds
    # per-request CFG state (None with CFG off)
    gs: Optional[torch.Tensor] = None  # (S,) f32 guidance strength
    neg_pe: Optional[torch.Tensor] = None  # (S, L, D) negative embeds
    neg_pp: Optional[torch.Tensor] = None  # (S, P) negative pooled embeds


class _Readback(NamedTuple):
    """One dispatched segment's results on their way to the host."""

    busy: list  # [(slot, request)] at dispatch
    advanced: list  # the adapters this segment advanced
    sigma: torch.Tensor  # (S,) host
    steps: torch.Tensor  # (S,) host
    trace: torch.Tensor  # (seg, S) host, sigma after each step
    event: Optional[torch.cuda.Event]  # None on the CPU: already read


def _put(t: torch.Tensor, slot: int, value) -> torch.Tensor:
    """A copy of ``t`` with row ``slot`` set to ``value``: out of place."""
    out = t.clone()
    out[slot] = value
    return out


class ContinuousBatchingEngine:
    """Slot-recycling serving engine for adaptive-NFE pipelines.

    Args:
        pipe: a ``TPDMPipeline`` with ``text_encoders``.
        tokenize: prompt -> (clip_ids (1, 77), t5_ids (1, L)) numpy arrays.
        slots: the persistent batch width S.
        seg_steps: denoise steps a segment, between host reads.
        max_steps: per-request adaptive step cap.
        guidance_scale: the default CFG strength (None: CFG off).
        predict: Beta-mode schedules (the serving default).
        queue_limit: submit() raises EngineOverloaded beyond this many
            queued requests (default 8 x slots).
        embed_cache_size / embed_cache: the prompt-embed LRU (a shared
            ``PromptEmbedCache`` when given).
        resolution: output pixels served by this engine (None: the MMDiT's
            sample_size x vae_scale_factor); one engine serves one latent
            shape, ``MultiResContinuousRouter`` several.
        vae_scale_factor: image pixels per latent cell.
        pipeline_depth: dispatched segments kept in flight; a readback
            then waits on an older segment while the card runs the newer.
        decode_batch: finished slots the decode worker coalesces into one
            decode, padded to a power of two.
        cache_interval: >= 2 runs the Δ-cache inside each segment (a full
            forward every N steps, a fresh cache every segment).
        solver: "euler" or "ab2" (per segment: each segment's first step
            is Euler).
        fused_lora: serve registered adapters fused (per-slot deltas in
            every segment) instead of multiplexed (one adapter's merged
            weights a segment); see the module docstring.
        dp, mesh_shape: not ported (ROADMAP queue 1, items 9(d) and 14).
    """

    def __init__(
        self,
        pipe,
        tokenize: Callable[[str], tuple],
        slots: int = 4,
        seg_steps: int = 4,
        max_steps: int = 35,
        guidance_scale: Optional[float] = 7.0,
        predict: bool = True,
        queue_limit: Optional[int] = None,
        embed_cache_size: int = 256,
        embed_cache: Optional[PromptEmbedCache] = None,
        dp: Optional[int] = None,
        mesh_shape: Optional[tuple] = None,
        resolution: Optional[int] = None,
        vae_scale_factor: int = 8,
        fused_lora: bool = False,
        pipeline_depth: int = 1,
        decode_batch: int = 1,
        cache_interval: int = 0,
        solver: str = "euler",
    ):
        _refuse_unported(dp, mesh_shape)
        if cache_interval == 1 or cache_interval < 0:
            raise ValueError("cache_interval must be 0 (off) or >= 2")
        if solver not in ("euler", "ab2"):
            raise ValueError(f"continuous engine solver must be 'euler' or 'ab2', got {solver!r}")
        if solver != "euler" and cache_interval:
            raise ValueError("solver='ab2' and cache_interval are mutually exclusive on the "
                             "continuous engine (both extend the segment carry)")
        mcfg = pipe.mmdit.config
        if resolution is not None:
            if resolution % vae_scale_factor != 0:
                raise ValueError(f"resolution {resolution} not a multiple of vae_scale_factor "
                                 f"{vae_scale_factor}")
            # the latent grid must also patchify: caught here, not as a
            # shape error inside the worker thread's first segment
            if (resolution // vae_scale_factor) % mcfg.patch_size:
                raise ValueError(
                    f"resolution {resolution} needs a latent grid divisible by patch_size "
                    f"{mcfg.patch_size}: use a multiple of {vae_scale_factor * mcfg.patch_size}")
        self.pipe = pipe
        self.tokenize = tokenize
        self.resolution = resolution
        self.vae_scale_factor = vae_scale_factor
        self.cache_interval = cache_interval
        self.solver = solver
        self._init_host(slots, seg_steps, max_steps, guidance_scale, predict, queue_limit,
                        embed_cache_size, embed_cache, pipeline_depth, decode_batch, fused_lora)

        self._device, self._dtype = pipe._device_dtype()
        self._min_live = pipe.min_sigma  # a slot below it has finished
        self._lat_size = (resolution // vae_scale_factor if resolution is not None
                          else mcfg.sample_size)
        self._token_grid = self._lat_size // mcfg.patch_size
        self._clamp_cfg = SamplerConfig(relative=pipe.relative)
        # the uncond branch's default is the empty prompt (zero ids, as
        # BatchingEngine's constant negative): encoded once here, which
        # also gives the embed shapes
        c, t = tokenize("")
        probe = self._encode(np.zeros_like(c), None if t is None else np.zeros_like(t))
        self._probe_shapes = (probe[0].shape[1:], probe[1].shape[1:])
        self._neg_rows = (probe[0][0], probe[1][0]) if guidance_scale is not None else None
        self._generator = torch.Generator(device=self._device)
        self._reset_state()

    def _init_host(self, slots, seg_steps, max_steps, guidance_scale, predict, queue_limit,
                   embed_cache_size, embed_cache, pipeline_depth, decode_batch, fused_lora):
        """The host side that every engine shares: the queue, the workers,
        the slot table and its mirrors, the counters, the embed cache and
        the adapters."""
        if slots < 1 or seg_steps < 1:
            raise ValueError("slots and seg_steps must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if decode_batch < 1:
            raise ValueError("decode_batch must be >= 1")
        self.slots = slots
        self.seg_steps = seg_steps
        self.max_steps = max_steps
        self.guidance_scale = guidance_scale
        self.predict = predict
        self.pipeline_depth = int(pipeline_depth)
        self.decode_batch = int(decode_batch)
        self._queue: "queue.Queue[Optional[ServeRequest]]" = queue.Queue(
            maxsize=queue_limit if queue_limit is not None else 8 * slots)
        # requests drained from _queue awaiting a slot (worker-owned)
        self._pending: "collections.deque" = collections.deque()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # finished slots' (req, latent row, nfe, sigmas) awaiting decode
        self._decode_queue: "queue.Queue" = queue.Queue()
        self._decode_thread: Optional[threading.Thread] = None
        # host-side slot table: index -> in-flight ServeRequest (or None)
        self._slot_req: list = [None] * slots
        self._slot_sigmas: list = [[] for _ in range(slots)]
        # host mirror of the step counters and caps: executed steps a
        # segment come from consecutive readbacks, caps predict finishes
        self._steps_host = np.zeros((slots,), np.int64)
        self._caps_host = np.full((slots,), max_steps, np.int64)
        # observability
        self.segments_run = 0
        self.segment_traces = 0
        self._segment_shapes: set = set()
        self.requests_done = 0
        self.requests_expired = 0
        self.slot_steps_total = 0  # S x seg_steps x segments
        self.slot_steps_active = 0  # steps that advanced a real request
        self.decode_rows_coalesced = 0  # rows decoded in batches > 1
        self._nfe_done: "collections.deque" = collections.deque(maxlen=512)
        self._latency_done: "collections.deque" = collections.deque(maxlen=512)
        self._embed_cache = (embed_cache if embed_cache is not None
                             else PromptEmbedCache(embed_cache_size))
        self._lock = threading.Lock()  # guards the counters stats() reads
        # LoRA adapters: name -> (factors, scale); the slots' adapters; the
        # multiplexed mode's merged-weight LRU, the fused mode's bank
        self._adapters: dict = {}
        self._slot_adapter: list = [None] * slots
        self._merged = MergedLRU()
        self.fused_lora = bool(fused_lora)
        self._bank = None
        self._adapter_ids: dict = {}
        self.adapter_segments: dict = {}  # adapter -> segments that advanced it
        # fairness: an adapter with busy slots runs at least every
        # adapter_fair_every segments, whatever the greedy count says
        self.adapter_fair_every = 4
        self._adapter_skipped: dict = {}  # adapter -> consecutive skips
        # the refill's adapter affinity yields to FIFO for a request that has
        # waited longer than this
        self.adapter_starvation_s = 5.0

    # -- LoRA adapters ------------------------------------------------------
    @property
    def adapter_merges(self) -> int:
        """Merges paid: the merged-weight LRU's misses."""
        return self._merged.merges

    def _backbone(self):
        """The module the adapters target."""
        return self.pipe.mmdit

    def _row_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """The bank row of every backbone batch row: the slots' ids, twice
        under CFG ([uncond; cond], each branch with its slot's adapter)."""
        return torch.cat([ids, ids]) if self.guidance_scale is not None else ids

    def register_adapter(self, name: str, lora: dict, scale: float = 1.0,
                         merged_cache: int = 1):
        """Serve a named LoRA adapter next to the base model: requests with
        ``lora=name`` run under ``apply_lora(mmdit, lora, scale)``,
        multiplexed (merged weights in an LRU of ``merged_cache`` entries,
        the largest asked for) or, with ``fused_lora``, fused. A quantised
        backbone serves adapters fused only (nothing float to merge into).
        Register before ``start()``."""
        if not self.fused_lora and any(not m.weight.is_floating_point()
                                       for m in lora_targets(self._backbone()).values()):
            raise ValueError("quantized (--int8/--int4) backbones serve adapters "
                             "fused-only: build the engine with fused_lora=True")
        self._store_adapter(name, lora, scale)
        self._merged.size = max(self._merged.size, merged_cache)

    def _store_adapter(self, name: str, lora: dict, scale: float):
        if not name:
            raise ValueError("adapter name must be non-empty")
        if self._thread is not None:
            raise RuntimeError("register adapters before start()")
        self._adapters[name] = (check_lora(self._backbone(), lora), float(scale))
        self._merged.drop(name)

    def _pick_adapter(self, counts: dict):
        """The adapter this segment runs (None: the base): the most runnable
        slots, unless an adapter with busy slots was skipped
        ``adapter_fair_every`` segments in a row, which then runs."""
        if not counts:
            return None
        starved = [n for n in counts
                   if self._adapter_skipped.get(n, 0) >= self.adapter_fair_every]
        pool = starved or list(counts)
        active = max(pool, key=lambda n: (counts[n], n is None))
        for n in counts:
            self._adapter_skipped[n] = 0 if n == active else self._adapter_skipped.get(n, 0) + 1
        return active

    def _run_adapted(self, fn, active, ids):
        """``fn()`` under the segment's adapters: the fused bank with the
        slots' ids, or the active adapter's merged weights, or neither."""
        if ids is not None:
            with lora_interceptor(self._backbone(), self._bank, self._row_ids(ids)):
                return fn()
        if active is not None:
            merged = self._merged.get(self._backbone(), active, *self._adapters[active])
            return call_merged(self._backbone(), merged, fn)
        return fn()

    # -- device state -------------------------------------------------------
    def _reset_state(self):
        """All-empty slots (sigma 0: frozen) and a reseeded generator."""
        S, mcfg = self.slots, self.pipe.mmdit.config
        dev, dtype = self._device, self._dtype
        zeros = lambda *shape: torch.zeros((S,) + tuple(shape), dtype=dtype, device=dev)
        cfg = {}
        if self.guidance_scale is not None:
            npe, npp = self._neg_rows
            cfg = dict(gs=torch.full((S,), float(self.guidance_scale), dtype=torch.float32,
                                     device=dev),
                       neg_pe=npe.to(dtype).expand(S, -1, -1).clone(),
                       neg_pp=npp.to(dtype).expand(S, -1).clone())
        self._state = _SlotState(
            latents=zeros(mcfg.in_channels, self._lat_size, self._lat_size),
            sigma=torch.zeros((S,), dtype=torch.float32, device=dev),
            steps=torch.zeros((S,), dtype=torch.int32, device=dev),
            caps=torch.full((S,), self.max_steps, dtype=torch.int32, device=dev),
            pe=zeros(*self._probe_shapes[0]),
            pp=zeros(*self._probe_shapes[1]),
            **cfg)
        self._generator.manual_seed(0)
        self._steps_host[:] = 0
        self._caps_host[:] = self.max_steps

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the pipe's device; to a card through a pinned
        buffer without blocking (a pageable copy would wait for every
        kernel queued on the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self._device.type != "cuda":
            return t.to(self._device)
        return t.pin_memory().to(self._device, non_blocking=True)

    @torch.no_grad()
    def _segment(self, st: _SlotState, live: torch.Tensor):
        """``seg_steps`` adaptive steps over every slot; returns the new
        state and the (seg, S) sigma trace. A slot is done before a step
        where sigma < min_sigma, its steps reached its cap, or it is not
        live; a done slot keeps its latents and sigma. The step is
        ``adaptive_sample``'s (``pipeline/sampler.py``): the same ops in
        the same dtypes, so a slot's trajectory is a solo ``generate``'s."""
        self._note_state_shapes(st)
        pipe, mcfg = self.pipe, self.pipe.mmdit.config
        dtype = self._dtype
        cfg_on = st.gs is not None
        pe = torch.cat([st.neg_pe, st.pe]) if cfg_on else st.pe
        pp = torch.cat([st.neg_pp, st.pp]) if cfg_on else st.pp
        grid = (self._token_grid, self._token_grid)
        n_cache = self.cache_interval
        if n_cache:
            # a fresh Δ every segment: step 0 of each segment is full, so
            # a refilled slot never reads a stale cache
            record, reuse, delta = pipe._cache_parts(st.latents, cfg_on)
            full_fn, reuse_fn = make_cfg_denoise_cached_fns(
                record, reuse, pe, pp, st.gs, grid, mcfg.patch_size)
        else:
            denoise_fn = make_cfg_denoise_fn(pipe.mmdit, pe, pp, st.gs, grid, mcfg.patch_size)
        ab2 = self.solver == "ab2"
        if ab2:
            # per-segment AB2: h_prev 0 makes each segment's first step Euler
            v_prev, sigma_prev = torch.zeros_like(st.latents), st.sigma
        lat, sigma, steps = st.latents, st.sigma, st.steps
        bcast = (-1,) + (1,) * (lat.dim() - 1)
        trace = []
        for i in range(self.seg_steps):
            if n_cache:
                fn = reuse_fn if i % n_cache else full_fn
                vel, temb, h, delta = fn(lat, sigma.to(dtype), delta)
            else:
                vel, temb, h = denoise_fn(lat, sigma.to(dtype))
            raw = pipe.tpm(h, temb)
            alpha, beta = _raw_to_alpha_beta(raw.float(), pipe.prediction_type)
            ratio = (beta_mode(alpha, beta) if self.predict
                     else beta_sample(self._generator, alpha, beta))
            ratio = _clamp_ratio(ratio, sigma, self._clamp_cfg)
            sig_next = sigma * ratio if pipe.relative else sigma - ratio
            done = (sigma < pipe.min_sigma) | (steps >= st.caps) | ~live
            sig_next = torch.where(done, sigma, sig_next)
            if ab2:
                upd = flow_ab2_step(vel, v_prev, sig_next, sigma, sigma_prev, lat)
                v_prev, sigma_prev = vel, sigma
            else:
                upd = flow_euler_step(vel, sig_next, sigma, lat)
            lat = torch.where(done.reshape(bcast), lat, upd)
            steps = steps + (~done).to(torch.int32)
            sigma = sig_next
            trace.append(sig_next)
        return st._replace(latents=lat, sigma=sigma, steps=steps), torch.stack(trace)

    def _note_state_shapes(self, st):
        """Count the distinct state shapes a segment has run on."""
        shapes = tuple(None if x is None else (tuple(x.shape), x.dtype) for x in st)
        if shapes not in self._segment_shapes:
            self._segment_shapes.add(shapes)
            self.segment_traces = len(self._segment_shapes)

    # -- host side ----------------------------------------------------------
    def _encode(self, clip_ids, t5_ids):
        """(embeds, pooled) of token ids; the ids reach the card without
        blocking."""
        return self.pipe.text_encoders.encode(
            self._to_device(clip_ids), None if t5_ids is None else self._to_device(t5_ids))

    def _cached_embeds(self, key: str, text: str):
        hit = self._embed_cache.get(key)
        if hit is not None:
            return hit
        pe, pp = self._encode(*self.tokenize(text))
        return self._embed_cache.put(key, (pe[0], pp[0]))

    def _prompt_embeds(self, prompt: str):
        """LRU-cached batch-1 positive embed rows of one prompt."""
        return self._cached_embeds(prompt, prompt)

    def _neg_prompt_embeds(self, text: str):
        """A negative prompt's rows, cached under a reserved key prefix so a
        prompt and a negative never collide ("" takes the engine's constant
        negative instead)."""
        return self._cached_embeds("\x00neg\x00" + text, text)

    def _init_latent(self, seed: int) -> torch.Tensor:
        """(c, h, w): drawn as ``BatchingEngine._latents`` and a batch-1
        ``generate(seed=s)`` draw it, so (prompt, seed) give the same image
        through every entry point."""
        shape = (1, self.pipe.mmdit.config.in_channels, self._lat_size, self._lat_size)
        return seed_noise([seed], shape, self._device, self._dtype)[1][0]

    def _slot_init(self, req: ServeRequest):
        """(latent row, starting sigma) of a fresh slot: text-to-image at
        sigma 1.0 from the seed's noise; img2img from the image's latents
        (encoded at batch 1) mixed into that noise at the strength, the
        slot starting at sigma = strength."""
        lat = self._init_latent(req.seed)
        if req.init_image is None:
            return lat, 1.0
        clean = self.pipe.encode_image(req.init_image[None])
        s = torch.tensor([req.strength], dtype=torch.float32)
        return noised_latents(clean, lat[None], s)[0], float(s)

    def _assign(self, slot: int, req: ServeRequest):
        pe_row, pp_row = self._prompt_embeds(req.prompt)
        lat, sigma0 = self._slot_init(req)
        cap = min(req.steps or self.max_steps, self.max_steps)
        st = self._state
        new = dict(latents=_put(st.latents, slot, lat), sigma=_put(st.sigma, slot, sigma0),
                   steps=_put(st.steps, slot, 0), caps=_put(st.caps, slot, cap),
                   pe=_put(st.pe, slot, pe_row), pp=_put(st.pp, slot, pp_row))
        new.update(self._assign_extra(st, slot, sigma0))
        if getattr(st, "gs", None) is not None:
            gs0 = self.guidance_scale if req.guidance_scale is None else req.guidance_scale
            npe_row, npp_row = (self._neg_prompt_embeds(req.negative_prompt)
                                if req.negative_prompt else self._neg_rows)
            new.update(gs=_put(st.gs, slot, float(np.float32(gs0))),
                       neg_pe=_put(st.neg_pe, slot, npe_row),
                       neg_pp=_put(st.neg_pp, slot, npp_row))
        self._state = st._replace(**new)
        self._slot_req[slot] = req
        self._slot_adapter[slot] = req.lora
        self._slot_sigmas[slot] = []
        self._steps_host[slot] = 0
        self._caps_host[slot] = cap

    def _assign_extra(self, st, slot: int, sigma0) -> dict:
        """Further state rows a fresh slot sets (the family engines' solver
        history); none here."""
        return {}

    def _decode_rows(self, lats: torch.Tensor) -> np.ndarray:
        """(b, c, h, w) latents -> (b, H, W, 3) uint8 images; without a VAE
        the latents themselves, as fp32."""
        if self.pipe.vae is None:
            return lats.float().cpu().numpy()
        return postprocess_images(self.pipe._decode_impl(lats))

    def _finish(self, slot: int, nfe: int):
        """Free one finished slot: capture its latent row (a view of a state
        that no update writes into) and hand it to the decode worker, or
        decode inline when none runs (warmup)."""
        req = self._slot_req[slot]
        lat_row = self._state.latents[slot : slot + 1]
        sigmas = [float(s) for s in self._slot_sigmas[slot][:nfe]]
        self._slot_req[slot] = None
        self._slot_adapter[slot] = None
        self._slot_sigmas[slot] = []
        if self._decode_thread is not None:
            self._decode_queue.put((req, lat_row, nfe, sigmas))
        else:
            self._complete(req, lat_row, nfe, sigmas)

    def _resolve(self, req: ServeRequest, image, nfe: int, sigmas: list):
        req._result = {"image": image, "inference_steps": nfe, "sigmas": sigmas}
        req._event.set()
        with self._lock:
            self.requests_done += 1
            self._nfe_done.append(nfe)
            self._latency_done.append(time.monotonic() - req.submitted_at)

    def _complete(self, req: ServeRequest, lat_row, nfe: int, sigmas: list):
        """Decode one finished latent (batch 1) and resolve its request."""
        try:
            image = self._decode_rows(lat_row)[0]
        except Exception as e:
            logger.exception("decode failed")
            req._error = e
            req._event.set()
            return
        self._resolve(req, image, nfe, sigmas)

    @torch.no_grad()
    def _decode_worker(self):
        while True:
            item = self._decode_queue.get()
            if item is None:
                return
            done = False
            items = [item]
            # coalesce the finishes already waiting (several slots often
            # cross min_sigma or their cap in the same segment)
            while len(items) < self.decode_batch:
                try:
                    nxt = self._decode_queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    done = True
                    break
                items.append(nxt)
            if len(items) == 1:
                self._complete(*items[0])
            else:
                self._complete_batch(items)
            if done:
                return

    def _complete_batch(self, items: list):
        """Decode several finished latents as one batch padded to a power of
        two by repeating the last row (at most log2(decode_batch) + 1 decode
        shapes); if it fails, each row is retried alone, so one bad latent
        does not fail its peers."""
        n = len(items)
        bucket = 1
        while bucket < n:
            bucket *= 2
        rows = [it[1] for it in items]
        rows += [rows[-1]] * (bucket - n)
        try:
            images = self._decode_rows(torch.cat(rows))
        except Exception:
            logger.exception("batched decode failed; retrying the %d rows singly", n)
            for it in items:
                self._complete(*it)
            return
        with self._lock:
            self.decode_rows_coalesced += n
        for (req, _lat, nfe, sigmas), image in zip(items, images):
            self._resolve(req, image, nfe, sigmas)

    def _refill(self, block: bool) -> bool:
        """Fill free slots from the queue. Returns False on shutdown.
        Multiplexed adapters: a free slot prefers the oldest pending request
        whose adapter already holds a slot (the scheduler's runnable set
        grows), unless the queue's head has waited over
        ``adapter_starvation_s``, which then takes it."""
        # drain the queue into the worker-owned pending deque; only the
        # first get may block, and only when nothing is pending
        while True:
            try:
                req = self._queue.get(block=block and not self._pending)
            except queue.Empty:
                break
            block = False
            if req is None:
                return False
            self._pending.append(req)
        # load shedding: an abandoned request takes no slot
        kept: "collections.deque" = collections.deque()
        for req in self._pending:
            if req.expired():
                req._expire()
                with self._lock:
                    self.requests_expired += 1
            else:
                kept.append(req)
        self._pending = kept
        inflight = {self._slot_adapter[i] for i in range(self.slots)
                    if self._slot_req[i] is not None}
        affinity = self._adapters and self._bank is None
        now = time.monotonic()
        for slot in range(self.slots):
            if not self._pending:
                break
            if self._slot_req[slot] is not None:
                continue
            idx = 0
            if (affinity and inflight
                    and now - self._pending[0].submitted_at <= self.adapter_starvation_s):
                idx = next((j for j, r in enumerate(self._pending) if r.lora in inflight), 0)
            req = self._pending[idx]
            del self._pending[idx]
            self._assign(slot, req)
            inflight.add(req.lora)
        return True

    def _run_segment(self):
        self._process_readback(self._dispatch_segment())

    def _dispatch_segment(self) -> _Readback:
        """Enqueue one segment and the copies of its results to the host.
        With pipeline_depth > 1 the worker dispatches ahead of the
        readbacks: a slot that finished in segment k is frozen by the
        done-mask in k + 1, so the speculative segment changes nothing."""
        busy = [(i, r) for i, r in enumerate(self._slot_req) if r is not None]
        counts: dict = {}
        for i, _ in busy:
            counts[self._slot_adapter[i]] = counts.get(self._slot_adapter[i], 0) + 1
        live = np.array([r is not None for r in self._slot_req])
        active = ids = None
        if self._bank is not None:
            # fused: every tenant advances; the bank rows route the deltas
            ids = self._to_device(np.array([0 if a is None else self._adapter_ids[a]
                                            for a in self._slot_adapter], np.int64))
            advanced = [n for n in counts if n is not None]
        elif self._adapters:
            # multiplexed: one adapter's merged weights; the live mask
            # freezes the other adapters' slots
            active = self._pick_adapter(counts)
            live &= np.array([a == active for a in self._slot_adapter])
            advanced = [] if active is None else [active]
        else:
            advanced = []
        live = self._to_device(live)
        self._state, trace = self._run_adapted(lambda: self._segment(self._state, live),
                                               active, ids)
        results = (self._state.sigma, self._state.steps, trace)
        if self._device.type != "cuda":
            return _Readback(busy, advanced, *results, None)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in results]
        for h, t in zip(host, results):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Readback(busy, advanced, *host, event)

    def _may_finish(self, entry: _Readback) -> bool:
        """Will the oldest in-flight segment free a slot by its cap? Cap
        finishes are known on the host (``_steps_host`` is exact through
        the segment before ``entry``); sigma finishes are not, and wait
        one segment more."""
        return any(self._slot_req[i] is req
                   and self._steps_host[i] + self.seg_steps >= self._caps_host[i]
                   for i, req in entry.busy)

    def _process_readback(self, entry: _Readback):
        """Read one dispatched segment's results; free the finished slots.
        Entries are read in dispatch order (executed steps are consecutive
        differences of ``_steps_host``). A slot whose request changed since
        dispatch was frozen in that segment and is skipped."""
        if entry.event is not None:
            entry.event.synchronize()
        sigma, steps, trace = (t.numpy() for t in (entry.sigma, entry.steps, entry.trace))
        with self._lock:
            self.segments_run += 1
            self.slot_steps_total += self.slots * self.seg_steps
            for name in entry.advanced:
                self.adapter_segments[name] = self.adapter_segments.get(name, 0) + 1
        for i, req in entry.busy:
            if self._slot_req[i] is not req:
                continue
            executed = int(steps[i] - self._steps_host[i])
            self._steps_host[i] = steps[i]
            with self._lock:
                self.slot_steps_active += executed
            self._slot_sigmas[i].extend(float(s) for s in trace[:executed, i])
            if sigma[i] < self._min_live or steps[i] >= self._caps_host[i]:
                self._finish(i, int(steps[i]))

    # -- public surface -----------------------------------------------------
    def submit(
        self, prompt: str, seed: int = 0, steps: Optional[int] = None,
        resolution: Optional[int] = None,
        deadline_s: Optional[float] = None,
        init_image: Optional[np.ndarray] = None,
        strength: Optional[float] = None,
        guidance_scale: Optional[float] = None,
        negative_prompt: Optional[str] = None,
        lora: Optional[str] = None,
    ) -> ServeRequest:
        """Enqueue one request. ``steps`` caps its NFE (clamped to the
        engine's max): a short request frees its slot early instead of
        riding out a batch. ``deadline_s`` sheds it with RequestExpired if
        it still waits for a slot that long after submit.
        ``guidance_scale`` / ``negative_prompt`` set its CFG strength and
        negative (per-slot state: any mix shares the segment).
        ``init_image`` (uint8 (H, W, 3) at the engine's resolution) runs it
        image-to-image: its slot starts at sigma = ``strength`` (default
        0.6) from the noised init latents. ``lora`` names a registered
        adapter that it runs under (see ``register_adapter``)."""
        if self._stop.is_set():
            raise EngineOverloaded("engine is stopped; no worker will run this")
        if lora is not None and lora not in self._adapters:
            raise ValueError(f"unknown adapter {lora!r}")
        if steps is not None and steps < 1:
            raise ValueError("steps must be >= 1")
        if guidance_scale is not None or negative_prompt:
            if self.guidance_scale is None:
                raise ValueError("per-request guidance/negative prompts need a CFG-enabled "
                                 "engine (built with guidance_scale=None)")
            if guidance_scale is not None and not np.isfinite(guidance_scale):
                raise ValueError(f"bad guidance_scale {guidance_scale}")
        if resolution is not None:
            raise ValueError("slots share one latent shape: serve several resolutions with "
                             "MultiResContinuousRouter (or the fixed-batch engine's "
                             "resolutions=)")
        init_image, strength = checked_img2img(self.pipe, init_image, strength,
                                               self._lat_size * self.vae_scale_factor)
        req = ServeRequest(
            prompt=prompt, seed=seed, steps=steps, deadline_s=deadline_s,
            init_image=init_image, strength=strength,
            guidance_scale=None if guidance_scale is None else float(guidance_scale),
            negative_prompt=negative_prompt or None, lora=lora)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise EngineOverloaded(f"request queue full ({self._queue.maxsize}); retry later")
        if self._stop.is_set():
            # stop() may have drained between the check and the put
            self._drain_failed("engine stopped before this request ran")
            raise EngineOverloaded("engine is stopped; no worker will run this")
        return req

    def start(self):
        if self._thread is not None:
            return
        if self.fused_lora and self._adapters and self._bank is None:
            self._bank, self._adapter_ids = stack_adapters(self._adapters)
        self._stop.clear()
        self._decode_thread = threading.Thread(target=self._decode_worker, daemon=True)
        self._decode_thread.start()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=60)
        self._thread = None
        if self._decode_thread is not None:
            # the segment worker is joined, so no decode arrives any more;
            # the pending ones finished denoising and complete, then the
            # decode worker retires
            self._decode_queue.put(None)
            self._decode_thread.join(timeout=60)
            self._decode_thread = None
        self._drain_failed("engine stopped before this request ran")
        # in-flight slots fail too: their segments will not resume
        had_inflight = False
        for i, req in enumerate(self._slot_req):
            if req is not None:
                had_inflight = True
                req._error = RuntimeError("engine stopped mid-generation")
                req._event.set()
                self._slot_req[i] = None
                self._slot_adapter[i] = None
                self._slot_sigmas[i] = []
        if had_inflight:  # a restart begins from clean, all-empty slots
            self._reset_state()

    def _drain_failed(self, message: str):
        def fail(req):
            req._error = RuntimeError(message)
            req._event.set()

        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                fail(req)
        # _pending belongs to the worker: drain it only once the worker is
        # no longer running (submit()'s race path may meet a live one)
        if self._thread is None or not self._thread.is_alive():
            while self._pending:
                fail(self._pending.popleft())

    @torch.no_grad()
    def _worker(self):
        # dispatched segments not yet read back, oldest first
        inflight: "collections.deque" = collections.deque()
        while not self._stop.is_set():
            have_work = any(r is not None for r in self._slot_req) or bool(inflight)
            try:
                if not self._refill(block=not have_work):
                    continue  # the shutdown sentinel; the loop checks _stop
            except Exception:
                logger.exception("refill failed")
                continue
            if all(r is None for r in self._slot_req) and not inflight:
                continue
            try:
                if any(r is not None for r in self._slot_req):
                    if inflight and self._may_finish(inflight[0]):
                        # the oldest segment frees a slot by its cap: read it
                        # now, so the next dispatch seats new work there
                        self._process_readback(inflight.popleft())
                        if not self._refill(block=False):
                            continue
                    if any(r is not None for r in self._slot_req):
                        inflight.append(self._dispatch_segment())
                # keep depth - 1 segments running ahead of the readback;
                # with every slot empty, drain what is in flight
                if inflight and (len(inflight) >= self.pipeline_depth
                                 or all(r is None for r in self._slot_req)):
                    self._process_readback(inflight.popleft())
            except Exception as e:
                logger.exception("segment failed")
                for i, req in enumerate(self._slot_req):
                    if req is not None:
                        req._error = e
                        req._event.set()
                        self._slot_req[i] = None
                        self._slot_adapter[i] = None
                        self._slot_sigmas[i] = []
                # the other in-flight segments continue the failed state:
                # start again from all-empty slots
                inflight.clear()
                self._reset_state()

    @torch.no_grad()
    def warmup(self):
        """Run one request through the segment, encode and decode shapes
        before traffic; it counts in no statistic."""
        self._assign(0, ServeRequest(prompt="warmup", seed=0))
        while self._slot_req[0] is not None:
            self._run_segment()
        with self._lock:
            self.segments_run = 0
            self.requests_done = 0
            self.slot_steps_total = 0
            self.slot_steps_active = 0
            self._nfe_done.clear()
            self._latency_done.clear()

    def stats(self) -> dict:
        """The JAX engine's stats() keys; with adapters registered also
        ``adapter_merges``, ``adapter_segments`` and ``lora_mode``."""
        with self._lock:
            nfes = list(self._nfe_done)
            lats = sorted(self._latency_done)
            out = {
                "segments_run": self.segments_run,
                "segment_traces": self.segment_traces,
                "requests_done": self.requests_done,
                "requests_expired": self.requests_expired,
                "slots": self.slots,
                "seg_steps": self.seg_steps,
                "solver": self.solver,
                "pipeline_depth": self.pipeline_depth,
                "decode_batch": self.decode_batch,
                "decode_rows_coalesced": self.decode_rows_coalesced,
                "slot_steps_total": self.slot_steps_total,
                "slot_steps_active": self.slot_steps_active,
                # the share of slot-steps that advanced a real request: what
                # a fixed batch loses to its finished rows
                "slot_utilization": (self.slot_steps_active / self.slot_steps_total
                                     if self.slot_steps_total else 0.0),
                "queue_depth": self._queue.qsize() + len(self._pending),
                "decode_pending": self._decode_queue.qsize(),
                "embed_cache_entries": len(self._embed_cache),
            }
            if self._adapters:
                out["adapter_merges"] = self.adapter_merges
                out["adapter_segments"] = dict(self.adapter_segments)
                out["lora_mode"] = "fused" if self.fused_lora else "multiplex"
        if nfes:
            out["nfe_mean"] = float(np.mean(nfes))
            out["nfe_max"] = int(np.max(nfes))
        if lats:
            out["latency_s_p50"] = lats[len(lats) // 2]
            out["latency_s_p95"] = lats[min(len(lats) - 1, int(0.95 * len(lats)))]
        return out


def _refuse_unported(dp, mesh_shape):
    if dp is not None:
        raise not_ported("dp (data-parallel slots)", "9(d)")
    if mesh_shape is not None:
        raise not_ported("mesh_shape (sharded-model serving)", "14")


class _AgentContinuousEngine(ContinuousBatchingEngine):
    """The plumbing of the agent-backed family engines: built from (agent,
    encode, decode) instead of a pipeline, per-seed latents drawn as the
    family runners draw them, the decode given or none. A request carries a
    prompt, a seed and a cap: per-request guidance, negatives and img2img
    are the SD3 engine's. Adapters are served fused only (``fused_lora=
    True``): the agent owns its backbone, and a merged copy a tenant of a
    12B FLUX would not fit."""

    def __init__(
        self,
        agent,
        encode: Callable,
        decode: Optional[Callable] = None,
        tpm_params=None,
        slots: int = 4,
        seg_steps: int = 4,
        max_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        predict: bool = True,
        queue_limit: Optional[int] = None,
        embed_cache_size: int = 256,
        dp: Optional[int] = None,
        mesh_shape: Optional[tuple] = None,
        fused_lora: bool = False,
        pipeline_depth: int = 1,
        decode_batch: int = 1,
    ):
        _refuse_unported(dp, mesh_shape)
        self.agent = agent
        self._encode_fn = encode
        self._decode_fn = decode
        self._device, self._dtype = agent.device, agent.dtype
        self._tpm_params = (tpm_params if tpm_params is not None else agent.init_tpm_params(
            torch.Generator(device=agent.device).manual_seed(0)))
        self.pipe = self.tokenize = None
        self.resolution = None
        self._lat_size, self.vae_scale_factor = self._latent_size(), 8
        self.cache_interval = 0
        self.solver = "euler"
        self._init_host(slots, seg_steps, max_steps or self._default_max_steps(),
                        guidance_scale if guidance_scale is not None
                        else self._default_guidance(),
                        predict, queue_limit, embed_cache_size, None, pipeline_depth,
                        decode_batch, fused_lora)
        self._generator = torch.Generator(device=self._device)
        self._build()
        self._reset_state()

    def register_adapter(self, name: str, lora: dict, scale: float = 1.0,
                         merged_cache: int = 1):
        """Serve a named adapter, fused: needs ``fused_lora=True``."""
        del merged_cache  # the fused mode keeps factors only
        if not self.fused_lora:
            raise ValueError("family engines serve adapters fused-only: build with "
                             "fused_lora=True")
        self._store_adapter(name, lora, scale)

    def _backbone(self):
        return self.agent.unet

    def _row_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """The UNets double the batch under CFG (guidance above 1)."""
        gs = self.guidance_scale
        return torch.cat([ids, ids]) if gs is not None and gs > 1 else ids

    def _default_max_steps(self) -> int:
        raise NotImplementedError

    def _default_guidance(self) -> Optional[float]:
        return None

    def _latent_size(self) -> int:
        return self.agent.unet.config.sample_size

    def _build(self):
        """Family hook: the encode probe and the segment's constants."""
        raise NotImplementedError

    def _init_latent(self, seed: int) -> torch.Tensor:
        """(c, h, w): the family runners' draw of a batch-1 request with this
        seed (``serving_families._per_seed_latents``)."""
        g = torch.Generator(device=self.agent.device).manual_seed(int(seed))
        return self.agent.prepare_latents(g, 1)[0]

    def _decode_rows(self, lats: torch.Tensor) -> np.ndarray:
        if self._decode_fn is not None:
            return self._decode_fn(lats)
        return lats.float().cpu().numpy()

    def submit(self, prompt: str, seed: int = 0, steps: Optional[int] = None,
               resolution: Optional[int] = None, deadline_s: Optional[float] = None,
               init_image: Optional[np.ndarray] = None, strength: Optional[float] = None,
               guidance_scale: Optional[float] = None, negative_prompt: Optional[str] = None,
               lora: Optional[str] = None) -> ServeRequest:
        """Enqueue one text-to-image request (``steps`` caps its NFE);
        ``guidance_scale``, ``negative_prompt`` and ``init_image`` are
        refused, as the JAX family engines refuse them."""
        if guidance_scale is not None or negative_prompt:
            raise ValueError("per-request guidance/negative prompts are SD3-only")
        if init_image is not None or strength is not None:
            raise ValueError("img2img needs the SD3 pipeline engine with a VAE")
        return super().submit(prompt, seed=seed, steps=steps, resolution=resolution,
                              deadline_s=deadline_s, lora=lora)


class _SD15SlotState(NamedTuple):
    """The SD1.5 and SDXL slots' state: the integer t (carried as fp32 in
    ``sigma``, so the host's finish check reads it as the SD3 sigma) and
    the DPM-Solver++ history (t_prev, x0_prev)."""

    latents: torch.Tensor  # (S, 4, h, w) model dtype
    sigma: torch.Tensor  # (S,) f32, the integer t; below min_time: finished or empty
    steps: torch.Tensor  # (S,) i32
    caps: torch.Tensor  # (S,) i32
    pe: torch.Tensor  # (S, n, d) positive context rows
    pp: torch.Tensor  # (S, P): (S, 1) zeros for SD1.5, bigG's pooled rows for SDXL
    t_prev: torch.Tensor  # (S,) i32
    x0_prev: torch.Tensor  # (S, 4, h, w) f32


class ContinuousSD15Engine(_AgentContinuousEngine):
    """Slot-recycling serving for the SD1.5 family: the integer-t adaptive
    DPM-Solver++ loop a slot at a time.

    The segment mirrors ``pipeline/sd15_sampler.py``'s step: a slot is done
    before a step where t < min_time, its steps reached its cap, or it is
    not live; t_next = int(t x ratio), truncated; the first- or
    second-order update picked per slot (first on a slot's first step, at
    t_next = 0 and on the cap step); the cap step integrates to x0. So a
    slot's integer schedule equals a fixed-batch rollout's, and at the same
    CFG batch its latents equal it to the bit.

    Args:
        agent: an ``SD15Agent``.
        encode: ``(prompts) -> (prompt_embeds, negative_prompt_embeds)``,
            the negative the empty prompt's (``make_sd15_runner``'s).
        decode: optional ``final_latents -> uint8 images``; None returns
            the final latents (fp32).
        tpm_params: the TPM module (default ``agent.init_tpm_params`` of a
            generator seeded 0).
        fused_lora: serve registered adapters fused (the family engines'
            only mode); the row ids double under CFG.
        dp, mesh_shape: not ported (ROADMAP queue 1, items 9(d) and 14).
    """

    def _default_max_steps(self) -> int:
        return self.agent.sampler_cfg.num_inference_steps

    def _default_guidance(self) -> Optional[float]:
        return self.agent.guidance_scale

    def _cfg_on(self) -> bool:
        return self.guidance_scale is not None and self.guidance_scale > 1

    def _encode_probe(self):
        """(positive probe rows, negative context (1, n, d), negative pooled
        (1, P) or None, the pooled row's shape)."""
        pe, npe = self._encode_fn(["probe"])
        return pe, npe[:1], None, (1,)

    def _build(self):
        from tpdm_tpu_torch.ops.dpm_solver import ddpm_sigmas_from_betas

        self._min_live = float(self.agent.sampler_cfg.min_time)  # the carried scalar is t
        pe, self._neg_pe, self._neg_pp, self._pp_shape = self._encode_probe()
        self._pe_shape, self._pe_dtype = tuple(pe.shape[1:]), pe.dtype
        self._sigmas = ddpm_sigmas_from_betas(device=self._device)

    def _reset_state(self):
        """All-empty slots (t 0: frozen) and a reseeded generator."""
        S, ucfg, dev = self.slots, self.agent.unet.config, self._device
        hw = (ucfg.in_channels, ucfg.sample_size, ucfg.sample_size)
        self._state = _SD15SlotState(
            latents=torch.zeros((S,) + hw, dtype=self._dtype, device=dev),
            sigma=torch.zeros((S,), dtype=torch.float32, device=dev),
            steps=torch.zeros((S,), dtype=torch.int32, device=dev),
            caps=torch.full((S,), self.max_steps, dtype=torch.int32, device=dev),
            pe=torch.zeros((S,) + self._pe_shape, dtype=self._pe_dtype, device=dev),
            pp=torch.zeros((S,) + tuple(self._pp_shape), dtype=torch.float32, device=dev),
            t_prev=torch.full((S,), 999, dtype=torch.int32, device=dev),
            x0_prev=torch.zeros((S,) + hw, dtype=torch.float32, device=dev))
        self._generator.manual_seed(0)
        self._steps_host[:] = 0
        self._caps_host[:] = self.max_steps

    def _slot_init(self, req: ServeRequest):
        """A fresh slot starts at t = 999 from its seed's latent."""
        return self._init_latent(req.seed), 999.0

    def _assign_extra(self, st, slot: int, sigma0) -> dict:
        return dict(t_prev=_put(st.t_prev, slot, int(sigma0)),
                    x0_prev=_put(st.x0_prev, slot, 0.0))

    def _prompt_embeds(self, prompt: str):
        hit = self._embed_cache.get(prompt)
        if hit is not None:
            return hit
        pe, _ = self._encode_fn([prompt])
        return self._embed_cache.put(
            prompt, (pe[0], torch.zeros((1,), dtype=torch.float32, device=self._device)))

    def _segment_denoise(self, st: _SD15SlotState):
        """The segment's ``(latents, t) -> (eps, temb, h)`` from the slots'
        context rows, [negative; positive] under CFG."""
        from tpdm_tpu_torch.train.sd15_agent import make_sd15_denoise_fn

        pe = st.pe
        if self._cfg_on():
            pe = torch.cat([self._neg_pe.expand(st.pe.shape), st.pe])
        return make_sd15_denoise_fn(self.agent.unet, pe, self.guidance_scale)

    @torch.no_grad()
    def _segment(self, st: _SD15SlotState, live: torch.Tensor):
        """``seg_steps`` integer-t steps over every slot; returns the new
        state and the (seg, S) trace of t. A done slot keeps its latents, t
        and history."""
        from tpdm_tpu_torch.ops.dpm_solver import (
            dpm_first_order_update,
            dpm_second_order_update,
            epsilon_to_x0,
        )

        self._note_state_shapes(st)
        scfg = self.agent.sampler_cfg
        denoise_fn = self._segment_denoise(st)
        tpm_fn = self.agent.tpm_fn(self._tpm_params)
        table = self._sigmas
        lat, t_f, steps = st.latents, st.sigma, st.steps
        t_prev, x0_prev = st.t_prev, st.x0_prev
        bcast = (-1,) + (1,) * (lat.dim() - 1)
        trace = []
        for _ in range(self.seg_steps):
            t = t_f.to(torch.int32)
            tf = t.to(torch.float32)
            eps, temb, h = denoise_fn(lat, tf)
            raw = tpm_fn(h, temb).float()
            alpha, beta = raw[:, 0], raw[:, 1]
            ratio = (beta_mode(alpha, beta) if self.predict
                     else beta_sample(self._generator, alpha, beta))
            ratio = torch.clamp(ratio, scfg.epsilon, 1.0 - scfg.epsilon)
            t_next = (tf * ratio).to(torch.int32)
            done = (t < scfg.min_time) | (steps >= st.caps) | ~live
            cap_now = ~done & (steps >= st.caps - 1)
            t_next = torch.where(cap_now, torch.zeros_like(t_next), t_next)
            lat32 = lat.float()
            sigma_s0, sigma_s1 = table[t.long()], table[t_prev.long()]
            sigma_t = torch.where(cap_now, torch.zeros_like(sigma_s0), table[t_next.long()])
            x0 = epsilon_to_x0(eps.float(), lat32, sigma_s0)
            first = dpm_first_order_update(x0, lat32, sigma_t, sigma_s0)
            second = dpm_second_order_update(x0, x0_prev, lat32, sigma_t, sigma_s0, sigma_s1,
                                             solver_type=scfg.solver_type)
            use_first = (steps == 0) | (t_next == 0) | cap_now
            stepped = torch.where(use_first.reshape(bcast), first, second).to(lat.dtype)
            lat = torch.where(done.reshape(bcast), lat, stepped)
            t_f = torch.where(done, t, t_next).to(torch.float32)
            t_prev = torch.where(done, t_prev, t)
            x0_prev = torch.where(done.reshape(bcast), x0_prev, x0)
            steps = steps + (~done).to(torch.int32)
            trace.append(t_f)
        return (st._replace(latents=lat, sigma=t_f, steps=steps, t_prev=t_prev,
                            x0_prev=x0_prev), torch.stack(trace))


class ContinuousSDXLEngine(ContinuousSD15Engine):
    """Slot-recycling serving for the SDXL family: the SD1.5 engine's
    segment, the slots' ``pp`` rows holding bigG's pooled embedding and the
    segment threading the text_time conditioning (pooled rows and the
    agent's ``default_time_ids``) through CFG.

    The size / crop ids are fixed for the engine: every request is
    conditioned on ``agent.default_time_ids``, the native resolution's.

    Args:
        agent: an ``SDXLAgent``.
        encode: ``(prompts) -> (prompt_embeds, pooled, negative_prompt_embeds,
            negative_pooled)`` (``make_sdxl_runner``'s).
    """

    def _encode_probe(self):
        pe, pooled, npe, npooled = self._encode_fn(["probe"])
        return pe, npe[:1], npooled[:1], tuple(pooled.shape[1:])

    def _prompt_embeds(self, prompt: str):
        hit = self._embed_cache.get(prompt)
        if hit is not None:
            return hit
        pe, pooled, _, _ = self._encode_fn([prompt])
        return self._embed_cache.put(prompt, (pe[0], pooled[0]))

    def _segment_denoise(self, st: _SD15SlotState):
        from tpdm_tpu_torch.train.sdxl_agent import make_sdxl_denoise_fn

        pe, pp = st.pe, st.pp
        if self._cfg_on():
            pe = torch.cat([self._neg_pe.expand(st.pe.shape), st.pe])
            pp = torch.cat([self._neg_pp.to(st.pp.dtype).expand(st.pp.shape), st.pp])
        added = {"text_embeds": pp, "time_ids": self.agent.default_time_ids(pe.shape[0])}
        return make_sdxl_denoise_fn(self.agent.unet, pe, added, self.guidance_scale)


class ContinuousFluxEngine(_AgentContinuousEngine):
    """Slot-recycling serving for the FLUX family: the SD3 engine's
    sigma-ratio segment over FLUX's denoise (packed tokens, the embedded
    guidance, no CFG batch doubling). A slot carries its T5 rows (``pe``)
    and pooled vector (``pp``); the text ids are zero.

    The segment runs the ops of ``adaptive_sample``'s Euler step in the
    same dtypes, so a slot's schedule equals a ``make_flux_runner`` call's
    and, at the same batch shape with the request in the slot's row, its
    final latents equal the runner's to the bit.

    Args:
        agent: a ``FluxAgent``.
        encode: ``(prompts) -> (txt (b, n, txt_dim), pooled (b, vec_dim))``.
        decode: optional ``final_latents -> uint8 images``
            (``serving_families.make_vae_decoder``); None returns the final
            latents (fp32).
        tpm_params: the TPM module (default ``agent.init_tpm_params`` of a
            generator seeded 0).
        fused_lora: serve registered adapters fused (the family engines'
            only mode); FLUX has no CFG batch, so a slot is one row.
        dp, mesh_shape: not ported (ROADMAP queue 1, items 9(d) and 14).
    """

    def _backbone(self):
        return self.agent.flux

    def _row_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return ids

    def _default_max_steps(self) -> int:
        return self.agent.sampler_cfg.max_inference_steps

    def _latent_size(self) -> int:
        return self.agent.latent_size

    def _build(self):
        scfg = self.agent.sampler_cfg
        self._min_live = scfg.min_sigma
        txt, pooled = self._encode_fn(["probe"])
        self._probe_rows = (txt[0], pooled[0])  # a slot's rows: shapes and dtypes
        self._clamp_cfg = SamplerConfig(relative=scfg.relative, epsilon=scfg.epsilon)

    def _reset_state(self):
        """All-empty slots (sigma 0: frozen) and a reseeded generator."""
        S, agent, dev = self.slots, self.agent, self._device
        zeros = lambda row: torch.zeros((S,) + tuple(row.shape), dtype=row.dtype, device=dev)
        self._state = _SlotState(
            latents=torch.zeros((S, agent.latent_channels, self._lat_size, self._lat_size),
                                dtype=self._dtype, device=dev),
            sigma=torch.zeros((S,), dtype=torch.float32, device=dev),
            steps=torch.zeros((S,), dtype=torch.int32, device=dev),
            caps=torch.full((S,), self.max_steps, dtype=torch.int32, device=dev),
            pe=zeros(self._probe_rows[0]), pp=zeros(self._probe_rows[1]))
        self._generator.manual_seed(0)
        self._steps_host[:] = 0
        self._caps_host[:] = self.max_steps

    def _slot_init(self, req: ServeRequest):
        """A fresh slot starts at sigma 1.0 from its seed's latent."""
        return self._init_latent(req.seed), 1.0

    def _prompt_embeds(self, prompt: str):
        hit = self._embed_cache.get(prompt)
        if hit is not None:
            return hit
        txt, pooled = self._encode_fn([prompt])
        return self._embed_cache.put(prompt, (txt[0], pooled[0]))

    @torch.no_grad()
    def _segment(self, st: _SlotState, live: torch.Tensor):
        """``seg_steps`` adaptive steps over every slot; returns the new
        state and the (seg, S) sigma trace. A slot is done before a step
        where sigma < min_sigma, its steps reached its cap, or it is not
        live; a done slot keeps its latents and sigma."""
        from tpdm_tpu_torch.train.flux_agent import make_flux_denoise_fn

        self._note_state_shapes(st)
        agent, scfg, dtype = self.agent, self.agent.sampler_cfg, self._dtype
        txt = st.pe.to(dtype)
        txt_ids = torch.zeros(txt.shape[:2] + (3,), device=txt.device)
        denoise_fn = make_flux_denoise_fn(agent.flux, txt, txt_ids, st.pp.to(dtype),
                                          agent.guidance, (self._lat_size, self._lat_size))
        tpm_fn = agent.tpm_fn(self._tpm_params)
        lat, sigma, steps = st.latents, st.sigma, st.steps
        bcast = (-1,) + (1,) * (lat.dim() - 1)
        trace = []
        for _ in range(self.seg_steps):
            vel, temb, h = denoise_fn(lat, sigma.to(dtype))
            alpha, beta = _raw_to_alpha_beta(tpm_fn(h, temb).float(), scfg.prediction_type)
            ratio = (beta_mode(alpha, beta) if self.predict
                     else beta_sample(self._generator, alpha, beta))
            ratio = _clamp_ratio(ratio, sigma, self._clamp_cfg)
            sig_next = sigma * ratio if scfg.relative else sigma - ratio
            done = (sigma < scfg.min_sigma) | (steps >= st.caps) | ~live
            sig_next = torch.where(done, sigma, sig_next)
            lat = torch.where(done.reshape(bcast), lat, flow_euler_step(vel, sig_next, sigma, lat))
            steps = steps + (~done).to(torch.int32)
            sigma = sig_next
            trace.append(sig_next)
        return st._replace(latents=lat, sigma=sigma, steps=steps), torch.stack(trace)


class MultiResContinuousRouter:
    """Per-request output resolution for continuous batching: one engine a
    served resolution, all on the same pipeline and one shared
    ``PromptEmbedCache``, each request routed to its resolution's slots.

    Args:
        pipe: the shared ``TPDMPipeline``.
        tokenize: prompt -> (clip_ids, t5_ids).
        resolutions: further output resolutions (pixels) besides the
            default; each must divide by vae_scale_factor and patchify.
        default_resolution: for requests that ask for none (default: the
            MMDiT's sample_size x vae_scale_factor).
        slots / seg_steps / **engine_kw: for every engine (slots a
            resolution).
    """

    def __init__(self, pipe, tokenize, resolutions, slots: int = 4, seg_steps: int = 4,
                 vae_scale_factor: int = 8, default_resolution: Optional[int] = None,
                 **engine_kw):
        mcfg = pipe.mmdit.config
        self.default_resolution = (default_resolution if default_resolution is not None
                                   else mcfg.sample_size * vae_scale_factor)
        served = set(resolutions or []) | {self.default_resolution}
        shared_cache = PromptEmbedCache(engine_kw.pop("embed_cache_size", 256))
        self._engines = {
            r: ContinuousBatchingEngine(pipe, tokenize, slots=slots, seg_steps=seg_steps,
                                        resolution=r, vae_scale_factor=vae_scale_factor,
                                        embed_cache=shared_cache, **engine_kw)
            for r in sorted(served)
        }
        self.max_steps = self._engines[self.default_resolution].max_steps

    @property
    def resolutions(self):
        return sorted(self._engines)

    def submit(self, prompt: str, seed: int = 0, steps: Optional[int] = None,
               resolution: Optional[int] = None, deadline_s: Optional[float] = None,
               init_image: Optional[np.ndarray] = None, strength: Optional[float] = None,
               guidance_scale: Optional[float] = None,
               negative_prompt: Optional[str] = None) -> ServeRequest:
        r = resolution if resolution is not None else self.default_resolution
        eng = self._engines.get(r)
        if eng is None:
            raise ValueError(f"resolution {r} not in the served set {self.resolutions}")
        return eng.submit(prompt, seed=seed, steps=steps, deadline_s=deadline_s,
                          init_image=init_image, strength=strength,
                          guidance_scale=guidance_scale, negative_prompt=negative_prompt)

    def warmup(self):
        for eng in self._engines.values():
            eng.warmup()

    def start(self):
        for eng in self._engines.values():
            eng.start()

    def stop(self):
        for eng in self._engines.values():
            eng.stop()

    def stats(self) -> dict:
        per = {r: e.stats() for r, e in self._engines.items()}
        return {
            "resolutions": {str(r): s for r, s in per.items()},
            "requests_done": sum(s["requests_done"] for s in per.values()),
            "queue_depth": sum(s["queue_depth"] for s in per.values()),
        }
