"""Serve text prompts from the port: ``python -m tpdm_tpu_torch.serve``.

The port's counterpart of the repository's root ``serve.py``: adaptive-
schedule generation from a prompt (``predict=True``, up to ``--max_steps``
steps, the realised step count reported). ``--cli`` generates once and
writes a PNG; otherwise a stdlib HTTP server answers ``POST /generate``
and ``POST /rank`` (best-of-N) through a ``serving.BatchingEngine``, and
``GET /stats``, ``/metrics`` (Prometheus text) and ``/healthz``. With
``--continuous`` the server runs ``serving_continuous.
ContinuousBatchingEngine`` instead (``--max_batch`` slots, ``--seg_steps``,
``--pipeline_depth``, ``--decode_batch``), or with ``--resolutions`` a
``MultiResContinuousRouter``. ``POST /generate`` takes ``init_image_png_base64``
(a PNG at the served resolution, read without PIL) and ``strength`` for
image-to-image:

    python -m tpdm_tpu_torch.serve --toy --cli --prompt "a cat"         # on the card
    python -m tpdm_tpu_torch.serve --toy --cpu --cli --prompt "a cat"   # anywhere
    python -m tpdm_tpu_torch.serve --toy --cpu --port 7860              # HTTP
    python -m tpdm_tpu_torch.serve --toy --cpu --continuous --max_batch 2 --seg_steps 2

It runs on the card unless ``--cpu`` is given, and exits non-zero without
one. ``--toy`` builds random toy towers, MMDiT, TPM and VAE from a fixed
seed and a deterministic toy tokenizer. ``--pretrained DIR`` loads a local
diffusers-layout SD3-medium directory (``pipeline.
load_pipeline_from_pretrained``; bf16 on the card, fp32 with ``--cpu``),
with ``--tpm FILE`` a TPM-only safetensors checkpoint, and tokenizes with
the port's own CLIP and T5 tokenizers from ``DIR/tokenizer/`` and
``DIR/tokenizer_3/``; a missing tokenizer file exits naming it (there is
no ``transformers`` fallback):

    python -m tpdm_tpu_torch.serve --pretrained DIR --tpm tpm.safetensors --cli

``--family sd15 --toy``, ``--family sdxl --toy`` and ``--family flux
--toy`` serve the families' toy worlds (UNet or FLUX, text towers or
hashed-prompt features, TPM and VAE drawn from the same seed, bf16 on the
card) through ``serving_families.make_sd15_runner`` / ``make_sdxl_runner``
/ ``make_flux_runner``, on ``--cli`` or the HTTP engine; ``--refiner``
adds SDXL's toy refiner behind ``make_sdxl_ensemble_runner`` (the handoff
at ``--denoising_end``), ``--int8`` / ``--int4`` quantise the toy FLUX,
and ``--continuous`` serves a family through ``ContinuousSD15Engine`` /
``ContinuousSDXLEngine`` / ``ContinuousFluxEngine`` (not with
``--refiner``). A full-width model is served through the library (build
the agent and call the runner or the engine), as with the JAX package:

    python -m tpdm_tpu_torch.serve --family sdxl --toy --cli --prompt "a cat"
    python -m tpdm_tpu_torch.serve --family sd15 --toy --continuous --port 7861
    python -m tpdm_tpu_torch.serve --family flux --toy --cpu --int4 --cli

LoRA adapters (``train/draft.py`` files): ``--lora PATH`` merges one
adapter into the backbone at load (``--lora_scale``; not into a quantised
backbone); ``--lora NAME=PATH`` (repeated) registers named adapters on
the engine, which requests pick with ``{"lora": "NAME"}`` on ``/generate``
and ``/rank``: SD3's ``BatchingEngine`` (merged, ``--lora_cache`` merged
copies) or ``--continuous`` engine (multiplexed, or with ``--lora_fused``
per-slot fused deltas, also over ``--int8`` / ``--int4``), and a family's
continuous engine with ``--continuous --lora_fused``. ``--quant_text``
stores the T5-XXL tower's matmuls as weight-only int8 (int4 with
``--int4``), run on K5:

    python -m tpdm_tpu_torch.serve --toy --cpu --lora a=a.safetensors --port 7860
    python -m tpdm_tpu_torch.serve --toy --cpu --continuous --lora_fused --lora a=a.safetensors
    python -m tpdm_tpu_torch.serve --toy --cpu --quant_text --cli --prompt "a cat"

Not ported yet, each exiting with a message that names its ROADMAP queue 1
item: ``--dp`` / ``--mesh`` (9(d) and 14), ``--few_step`` (9(e)) and
``--reward_checkpoint`` (8); gradio is not ported. Importing the module
starts nothing.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import os
import signal
import threading
import zlib

import numpy as np
import torch

from tpdm_tpu_torch.pipeline.pipeline import not_ported

logger = logging.getLogger("tpdm_tpu_torch.serve")

_IMAGE_FORMATS = ("png", "jpeg")
TOY_SEED = 0
# flags of the root serve.py that the port refuses: flag -> (what, item)
_NOT_PORTED_FLAGS = {
    "dp": ("--dp (data-parallel replicas)", "9(d)"),
    "mesh": ("--mesh (sharded-model serving)", "14"),
    "few_step": ("--few_step (the distilled few-step sampler)", "9(e)"),
    "reward_checkpoint": ("--reward_checkpoint (convert_image_reward)", "8"),
}


def _pil_image():
    """PIL's Image module, or None where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _check_format(fmt) -> str:
    """The response image format: "png" (the default, zlib alone) or
    "jpeg" (quality 92, only where PIL imports)."""
    if fmt is None:
        return "png"
    if not isinstance(fmt, str) or fmt.lower() not in _IMAGE_FORMATS:
        raise ValueError(f"format must be one of {_IMAGE_FORMATS}")
    fmt = fmt.lower()
    if fmt == "jpeg" and _pil_image() is None:
        raise ValueError("format jpeg needs PIL, which is not installed here; use png")
    return fmt


def _encode_image(image: np.ndarray, fmt: str):
    """uint8 (H, W, 3) -> (payload key, base64 string)."""
    if fmt == "jpeg":
        buf = io.BytesIO()
        _pil_image().fromarray(image).save(buf, format="JPEG", quality=92)
        data = buf.getvalue()
    else:
        from tpdm_tpu_torch.utils.image import png_bytes

        data = png_bytes(image)
    return f"image_{fmt}_base64", base64.b64encode(data).decode()


def _device(args) -> torch.device:
    if getattr(args, "cpu", False):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port serves on a CUDA card (pass --cpu to "
                         "serve on the CPU)")
    return torch.device("cuda")


def _quant_bits(args):
    """--int8 / --int4: the MMDiT's stored-int weights (None: bf16/fp32)."""
    if getattr(args, "int8", False) and getattr(args, "int4", False):
        raise SystemExit("--int8 and --int4 are mutually exclusive")
    if getattr(args, "int4", False):
        return 4
    return 8 if getattr(args, "int8", False) else None


def _split_lora_args(args):
    """--lora entries -> (bare path merged at load | None, [(name, path),
    ...] registered on the engine). Mixing the two forms, more than one
    bare path and a repeated name exit."""
    entries = getattr(args, "lora", None) or []
    if isinstance(entries, str):
        entries = [entries]
    merge, named = [], []
    for e in entries:
        name, sep, path = e.partition("=")
        if sep and name and "/" not in name:
            named.append((name, path))
        else:
            merge.append(e)
    if merge and named:
        raise SystemExit("--lora: mix of bare-path (merge at load) and NAME=PATH (registered "
                         "adapter) entries; pick one mode")
    if len(merge) > 1:
        raise SystemExit("--lora: multiple bare paths; to serve several adapters use "
                         "NAME=PATH entries")
    dup = sorted({n for n, _ in named if sum(1 for m, _ in named if m == n) > 1})
    if dup:
        raise SystemExit(f"--lora: duplicate adapter names {dup}")
    return (merge[0] if merge else None), named


@torch.no_grad()
def _merge_lora_(module, path: str, args, what: str) -> None:
    """Merge the LoRA file ``path`` into ``module``'s weights in place, at
    ``--lora_scale``. A factor key that names no dense layer of the module
    raises (``models/lora.py``): the base weights are never served while an
    adapter is believed live."""
    from tpdm_tpu_torch.models.lora import apply_lora
    from tpdm_tpu_torch.train.draft import load_lora

    lora = load_lora(path)
    scale = getattr(args, "lora_scale", 1.0)
    try:
        merged = apply_lora(module, lora, scale=scale)
    except ValueError as e:
        raise ValueError(f"--lora {path}: {e}") from None
    for name, w in merged.items():
        module.get_parameter(name).copy_(w)
    logger.info("merged LoRA %s into the %s (%d layers, scale %.2f)", path, what, len(lora), scale)


def _apply_cli_lora(pipe, args):
    """--lora PATH: merge one adapter into the MMDiT at load, so every
    engine mode serves it unchanged. NAME=PATH entries are registered on
    the engine by ``make_http_server``."""
    path, _named = _split_lora_args(args)
    if not path:
        return pipe
    if _quant_bits(args) is not None:
        raise SystemExit("--lora cannot merge into a quantized (--int8/--int4) backbone; merge "
                         "first, then quantize the merged weights")
    _merge_lora_(pipe.mmdit, path, args, "MMDiT")
    return pipe


def _merge_family_lora(module, args, family: str) -> None:
    """--lora for a family backbone: a bare path merges at load; NAME=PATH
    adapters need --continuous --lora_fused (the family engines serve
    adapters fused only)."""
    if not getattr(args, "lora", None):
        return
    path, named = _split_lora_args(args)
    if named:
        if not (getattr(args, "lora_fused", False) and getattr(args, "continuous", False)):
            raise SystemExit(f"--family {family} NAME=PATH adapters need --continuous "
                             "--lora_fused (per-slot fused deltas; family engines have no "
                             "merged multiplex path); a bare path merges a single adapter at "
                             "load")
        return  # registered on the continuous engine by make_http_server
    if _quant_bits(args) is not None:
        raise SystemExit("--lora cannot merge into a quantized (--int8/--int4) backbone; merge "
                         "first, then quantize the merged weights")
    _merge_lora_(module, path, args, f"{family} backbone")


def toy_tokenize(prompt: str, n: int = 8):
    """The toy towers' tokenizer: bos 97, up to six words at stable ids in
    [1, 90] (crc32, the same in every process), eos 98, zero padding; T5
    ids all ones. Returns (clip_ids (1, n), t5_ids (1, 12)) int32."""
    words = [zlib.crc32(w.encode()) % 90 + 1 for w in prompt.split()[:6]]
    ids = ([97] + words + [98])[:n]
    ids = ids + [0] * (n - len(ids))
    return np.array([ids], np.int32), np.ones((1, 12), np.int32)


def pretrained_tokenize(root: str):
    """The tokenize function of a checkpoint directory: the port's CLIP BPE
    (``tokenizer/``: vocab.json, merges.txt) and T5 Unigram
    (``tokenizer_3/``: spiece.model or tokenizer.json) tokenizers, 77 and
    256 ids. A missing file exits naming it."""
    from tpdm_tpu_torch.utils.t5_tokenizer import T5Tokenizer
    from tpdm_tpu_torch.utils.tokenizer import CLIPTokenizer

    try:
        tok_clip = CLIPTokenizer.from_pretrained(os.path.join(root, "tokenizer"))
        tok_t5 = T5Tokenizer.from_pretrained(os.path.join(root, "tokenizer_3"))
    except FileNotFoundError as e:
        raise SystemExit(f"--pretrained {root}: a tokenizer file is missing ({e}); the port "
                         "reads its own tokenizers and has no transformers fallback") from None

    def tokenize(prompt, _n=None):
        return (tok_clip([prompt], max_length=77)["input_ids"],
                tok_t5([prompt], max_length=256)["input_ids"])

    return tokenize


def build_pipeline(args):
    """(pipe, tokenize) for ``args``: ``--pretrained`` loads a checkpoint
    directory (bf16 on the card, fp32 on the CPU; ``--int8`` / ``--int4``
    prequantise its MMDiT); ``--toy`` builds the root serve.py's toy
    configs (CLIP widths 32 and 48, T5 96, a 2-layer MMDiT caching its
    front block, a 4-channel TPM, the toy VAE) with N(0, 0.02²) weights
    drawn from a torch generator seeded with ``TOY_SEED``, on the card or,
    with ``--cpu``, the CPU; ``--int8`` / ``--int4`` prequantise its MMDiT,
    ``--quant_text`` its T5 tower (weight-only, int4 with ``--int4``). A
    bare ``--lora PATH`` is merged into the MMDiT."""
    if getattr(args, "pretrained", None):
        from tpdm_tpu_torch.pipeline.pipeline import load_pipeline_from_pretrained

        device = _device(args)
        tokenize = pretrained_tokenize(args.pretrained)
        bits = _quant_bits(args)
        pipe = load_pipeline_from_pretrained(
            args.pretrained, dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
            tpm_checkpoint=getattr(args, "tpm", None), quant_int8=bits is not None,
            quant_bits=bits or 8, quant_text=getattr(args, "quant_text", False), device=device)
        return _apply_cli_lora(pipe, args), tokenize
    if getattr(args, "tpm", None):
        raise SystemExit("--tpm loads a checkpoint's TPM: pass --pretrained")
    if not getattr(args, "toy", False):
        raise SystemExit("pass --pretrained DIR (a local diffusers-layout checkpoint) or --toy")
    from tpdm_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    from tpdm_tpu_torch.models.t5 import T5Config, T5Encoder
    from tpdm_tpu_torch.models.tpm import TimePredictor
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig
    from tpdm_tpu_torch.ops.quant import prequantize_
    from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline
    from tpdm_tpu_torch.pipeline.text_encoding import SD3TextEncoders

    device = _device(args)
    bits = _quant_bits(args)
    quant_text = getattr(args, "quant_text", False)
    mcfg = MMDiTConfig.toy(joint_attention_dim=96, pooled_projection_dim=64,
                           cache_front_blocks=1, quant_matmuls=bits is not None,
                           quant_bits=bits or 8)
    with torch.device(device):
        clip_l = CLIPTextModel(CLIPTextConfig.toy(hidden_size=32, projection_dim=24))
        clip_g = CLIPTextModel(CLIPTextConfig.toy(hidden_size=48, projection_dim=40))
        t5 = T5Encoder(T5Config.toy(d_model=96, quant_matmuls=quant_text,
                                    quant_bits=4 if bits == 4 else 8))
        mmdit = MMDiT(mcfg)
        tpm = TimePredictor(conv_out_channels=4, in_channels=2 * mcfg.inner_dim,
                            temb_dim=mcfg.inner_dim, init_alpha=0.5, init_beta=2.0)
        vae = VAE(VAEConfig.toy(latent_channels=16))
    g = torch.Generator(device=device).manual_seed(TOY_SEED)
    for module in (clip_l, clip_g, t5, mmdit, tpm, vae):
        module.init_weights(g).eval()
    if bits is not None:
        prequantize_(mmdit)
    if quant_text:
        prequantize_(t5)
    text = SD3TextEncoders(clip_l, clip_g, t5, t5_width=96)
    return _apply_cli_lora(TPDMPipeline(mmdit, tpm, vae, text_encoders=text), args), toy_tokenize


def build_family_world(args):
    """``--family sd15`` / ``sdxl`` / ``flux``: the family's toy world as the
    root serve.py builds it, weights N(0, 0.02²) from ``TOY_SEED``, on the
    card in bf16 unless ``--cpu`` (K1 serves the toy UNets' head dims 4, 6
    and 8 and the toy FLUX's 12 on operands padded to 64 columns): a dict
    of the agent, its TPM, ``encode``, ``decode`` and the fixed-batch
    ``runner``. None for sd3.

    - sd15: the toy UNet at cross-attention width 32, an 8-token CLIP tower
      32 wide, a 4-channel TPM, the toy VAE at 4 latent channels, at most 8
      steps;
    - sdxl: ``UNetConfig.toy_xl`` on CLIP towers 16 and 24 wide (context
      40, pooled 12), the same TPM and VAE; ``--refiner`` adds the toy
      refiner (bigG context 24) behind the ensemble runner;
    - flux: ``FluxConfig.toy`` caching one front block (``--int8`` /
      ``--int4`` prequantise it; on the card K4 refuses the toy's 48-wide
      contraction, so ``--int8`` serves on the CPU), 5 text rows of
      hashed-prompt features (a numpy generator seeded by the prompt's
      crc32, the next seed for the pooled vector), a 4-channel TPM over
      the 8 x 8 latents of the toy VAE at 4 latent channels.

    Without ``--toy`` it exits: a full-width model is built in the library
    and served with the family's runner."""
    fam = getattr(args, "family", "sd3")
    if fam == "sd3":
        return None
    if not getattr(args, "toy", False):
        raise SystemExit(f"--family {fam} currently serves --toy configs from the CLI; for "
                         "real checkpoints build a runner with "
                         f"tpdm_tpu_torch.serving_families.make_{fam}_runner")
    if _quant_bits(args) is not None and fam != "flux":
        raise SystemExit(f"--int8/--int4 are not supported for --family {fam} (quantization "
                         "covers the MMDiT/FLUX transformer backbones)")
    if getattr(args, "quant_text", False):
        raise SystemExit(f"--quant_text quantises SD3's T5-XXL tower; --family {fam} has none")
    refiner = getattr(args, "refiner", False)
    ci, gi, tau = _accel_kwargs(args)
    if refiner:
        if fam != "sdxl":
            raise SystemExit("--refiner is SDXL's second expert: pass --family sdxl")
        if getattr(args, "continuous", False):
            raise SystemExit("--refiner serves through the fixed-batch ensemble runner; "
                             "--continuous is not supported with it")
        if ci or gi is not None or tau:
            raise SystemExit("--cache_interval/--guidance_interval/--cache_tau are not "
                             "supported with --refiner (the ensemble runner owns both experts' "
                             "sampler configs)")
    from tpdm_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from tpdm_tpu_torch.models.tpm import TimePredictor
    from tpdm_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig
    from tpdm_tpu_torch import serving_families as families
    from tpdm_tpu_torch.train.config import RLOOConfig

    device = _device(args)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    config = RLOOConfig(max_inference_steps=min(args.max_steps, 8))
    g = torch.Generator(device=device).manual_seed(TOY_SEED)

    def tpm_of(ucfg):
        ch0 = ucfg.block_out_channels[0]
        return lambda: TimePredictor(conv_out_channels=4, in_channels=2 * ch0, temb_dim=ch0,
                                     dtype=dtype)

    def build(module):
        with torch.device(device):
            return module().init_weights(g).to(dtype).eval()

    def ids_of(prompts):
        return torch.as_tensor(np.concatenate([toy_tokenize(p)[0] for p in prompts]),
                               device=device).long()

    vae = lambda: VAE(VAEConfig.toy(latent_channels=4))
    if fam == "flux":
        return _flux_world(args, config, build, vae, g, dtype)
    if fam == "sd15":
        from tpdm_tpu_torch.train.sd15_agent import SD15Agent

        ucfg = UNetConfig.toy(cross_attention_dim=32)
        unet = build(lambda: UNetSD15(ucfg))
        _merge_family_lora(unet, args, fam)
        text = build(lambda: CLIPTextModel(CLIPTextConfig.toy(hidden_size=32,
                                                              max_position_embeddings=8)))
        decode = families.make_vae_decoder(build(vae))
        agent = SD15Agent(unet, config, tpm=tpm_of(ucfg))
        tpm = agent.init_tpm_params(g).eval()

        @torch.no_grad()
        def encode(prompts):
            ids = ids_of(prompts)
            return text(ids)[1], text(torch.zeros_like(ids))[1]

        runner = families.make_sd15_runner(agent, tpm, encode, decode, cache_interval=ci,
                                           guidance_interval=gi, cache_tau=tau)
        return dict(family=fam, agent=agent, tpm_params=tpm, encode=encode, decode=decode,
                    runner=runner)

    from tpdm_tpu_torch.pipeline.text_encoding import SDXLTextEncoders
    from tpdm_tpu_torch.train.sdxl_agent import SDXLAgent, SDXLRefinerAgent

    ucfg = UNetConfig.toy_xl(cross_attention_dim=16 + 24, addition_pooled_dim=12)
    unet = build(lambda: UNetSD15(ucfg))
    _merge_family_lora(unet, args, fam)
    towers = [build(lambda w=w, p=p: CLIPTextModel(CLIPTextConfig.toy(
        hidden_size=w, projection_dim=p, max_position_embeddings=8))) for w, p in ((16, 8), (24, 12))]
    text = SDXLTextEncoders(*towers)
    decode = families.make_vae_decoder(build(vae))
    agent = SDXLAgent(unet, config, tpm=tpm_of(ucfg))
    tpm = agent.init_tpm_params(g).eval()

    def encoder(fn):
        """(prompts) -> (pe, pooled, negative pe, negative pooled): the
        negative pair is the towers on zero ids."""
        def encode(prompts):
            ids = ids_of(prompts)
            pos, neg = fn(ids), fn(torch.zeros_like(ids))
            return (pos.prompt_embeds, pos.pooled_prompt_embeds, neg.prompt_embeds,
                    neg.pooled_prompt_embeds)

        return encode

    encode = encoder(text.encode)
    if refiner:
        rcfg = UNetConfig.toy_refiner(cross_attention_dim=24, addition_pooled_dim=12)
        ragent = SDXLRefinerAgent(build(lambda: UNetSD15(rcfg)), config, tpm=tpm_of(rcfg))
        rtpm = ragent.init_tpm_params(g).eval()
        runner = families.make_sdxl_ensemble_runner(
            agent, tpm, ragent, rtpm, encode, encoder(text.encode_refiner), decode,
            denoising_end=args.denoising_end)
    else:
        runner = families.make_sdxl_runner(agent, tpm, encode, decode, cache_interval=ci,
                                           guidance_interval=gi, cache_tau=tau)
    return dict(family=fam, agent=agent, tpm_params=tpm, encode=encode, decode=decode,
                runner=runner)


def _flux_world(args, config, build, vae, g, dtype):
    """``build_family_world``'s FLUX part (see there)."""
    from tpdm_tpu_torch import serving_families as families
    from tpdm_tpu_torch.models.flux import Flux, FluxConfig
    from tpdm_tpu_torch.models.tpm import TimePredictor
    from tpdm_tpu_torch.ops.quant import prequantize_
    from tpdm_tpu_torch.train.flux_agent import FluxAgent

    bits = _quant_bits(args)
    # one front block, so --cache_interval has blocks to skip (the JAX
    # world keeps the default 4 of the toy's 2 and refuses it)
    fcfg = FluxConfig.toy(quant_matmuls=bits is not None, quant_bits=bits or 8,
                          cache_front_blocks=1)
    flux = build(lambda: Flux(fcfg))
    _merge_family_lora(flux, args, "flux")
    if bits is not None:
        prequantize_(flux)
    decode = families.make_vae_decoder(build(vae))
    agent = FluxAgent(flux, config, latent_size=8, latent_channels=4,
                      tpm=lambda: TimePredictor(conv_out_channels=4,
                                                in_channels=2 * fcfg.hidden_size,
                                                temb_dim=fcfg.hidden_size, dtype=dtype))
    tpm = agent.init_tpm_params(g).eval()
    n_txt = 5

    def encode(prompts):
        rngs = [np.random.default_rng(zlib.crc32(p.encode())) for p in prompts]
        txt = np.stack([r.normal(size=(n_txt, fcfg.txt_dim)) for r in rngs])
        rngs = [np.random.default_rng(zlib.crc32(p.encode()) + 1) for p in prompts]
        pooled = np.stack([r.normal(size=(fcfg.vec_dim,)) for r in rngs])
        as_dev = lambda a: torch.as_tensor(a.astype(np.float32), device=agent.device).to(dtype)
        return as_dev(txt), as_dev(pooled)

    ci, gi, tau = _accel_kwargs(args)
    try:
        runner = families.make_flux_runner(agent, tpm, encode, decode, cache_interval=ci,
                                           guidance_interval=gi, cache_tau=tau)
    except ValueError as e:
        raise SystemExit(f"--family flux: {e}") from None
    return dict(family="flux", agent=agent, tpm_params=tpm, encode=encode, decode=decode,
                runner=runner)


def generate(pipe, tokenize, prompt, seed, max_steps, cache_interval=0,
             guidance_interval=None, cache_tau=0.0, solver="euler"):
    """One prompt through ``pipe.generate`` at batch 1, the negative the
    towers on zero ids, as the engine's constant negative."""
    clip_ids, t5_ids = tokenize(prompt)
    return pipe.generate(
        clip_ids=clip_ids, t5_ids=t5_ids, negative_clip_ids=np.zeros_like(clip_ids),
        negative_t5_ids=np.zeros_like(t5_ids), predict=True, seed=seed,
        max_inference_steps=max_steps, cache_interval=cache_interval,
        guidance_interval=guidance_interval, cache_tau=cache_tau, solver=solver)


def _accel_kwargs(args):
    """(cache_interval, guidance_interval, cache_tau) from the flags."""
    ci = getattr(args, "cache_interval", 0) or 0
    gi = getattr(args, "guidance_interval", None)
    if isinstance(gi, str):
        parts = gi.split(",")
        if len(parts) != 2:
            raise SystemExit(f"--guidance_interval expects 'lo,hi', got {gi!r}")
        gi = (float(parts[0]), float(parts[1]))
    tau = getattr(args, "cache_tau", 0.0) or 0.0
    if tau and ci:
        raise SystemExit("--cache_tau and --cache_interval are mutually exclusive "
                         "(one reuse policy)")
    return ci, gi, float(tau)


def _resolutions(args):
    res = getattr(args, "resolutions", None)
    if isinstance(res, str):
        res = [int(x) for x in res.split(",") if x]
    return res


def _pipe_vae_scale_factor(pipe) -> int:
    """Pixels per latent cell of the pipeline's VAE; 8 without one."""
    if getattr(pipe, "vae", None) is None:
        return 8
    from tpdm_tpu_torch.models.vae import vae_scale_factor

    return vae_scale_factor(pipe.vae.config)


def _family_continuous_engine(world, args):
    """``--continuous`` for a family world: ``ContinuousSD15Engine``,
    ``ContinuousSDXLEngine`` or ``ContinuousFluxEngine`` over its agent,
    encode and decode
    (``--max_batch`` slots), the agent's own step budget as ``max_steps``.
    The family segments carry no cache or guidance-window state, so those
    flags exit, as in the root serve.py."""
    ci, gi, tau = _accel_kwargs(args)
    if ci or gi is not None or tau:
        raise SystemExit("--cache_interval/--guidance_interval/--cache_tau serve through the "
                         "fixed-batch runners (the family continuous engines' segments do not "
                         "carry the cache/branch state); drop --continuous")
    from tpdm_tpu_torch.serving_continuous import (
        ContinuousFluxEngine,
        ContinuousSD15Engine,
        ContinuousSDXLEngine,
    )

    cls = {"sd15": ContinuousSD15Engine, "sdxl": ContinuousSDXLEngine,
           "flux": ContinuousFluxEngine}[world["family"]]
    return cls(world["agent"], world["encode"], decode=world["decode"],
               tpm_params=world["tpm_params"], slots=args.max_batch,
               seg_steps=getattr(args, "seg_steps", 4),
               pipeline_depth=getattr(args, "pipeline_depth", 1) or 1,
               decode_batch=getattr(args, "decode_batch", 1) or 1,
               fused_lora=getattr(args, "lora_fused", False))


def make_engine(pipe, tokenize, args, runner=None, world=None):
    """The serving engine for ``args``: a ``BatchingEngine``, or with
    ``--continuous`` a ``ContinuousBatchingEngine`` (``--max_batch``
    slots), or with ``--continuous --resolutions`` a
    ``MultiResContinuousRouter``. The continuous engines take the Δ-cache
    per segment (``--cache_interval``) and exit on ``--guidance_interval``
    and ``--cache_tau``, as the root serve.py does. With a family
    ``runner``, a ``BatchingEngine`` over it (``pipe`` None), or with
    ``--continuous`` the family's continuous engine over ``world``
    (``build_family_world``'s)."""
    from tpdm_tpu_torch.serving import BatchingEngine

    if runner is not None:
        if _resolutions(args):
            raise SystemExit("--resolutions is SD3-only (fixed-batch sub-batches or "
                             "MultiResContinuousRouter); the family agents serve one latent "
                             "geometry")
        if getattr(args, "continuous", False):
            if world is None:
                raise SystemExit("--continuous with a bare runner needs the family world "
                                 "(agent/encode/decode): build a ContinuousSD15Engine, "
                                 "ContinuousSDXLEngine or ContinuousFluxEngine directly")
            return _family_continuous_engine(world, args)
        return BatchingEngine(None, tokenize, max_batch=args.max_batch,
                              window_ms=args.batch_window_ms, max_steps=args.max_steps,
                              runner=runner)
    ci, gi, tau = _accel_kwargs(args)
    solver = getattr(args, "solver", "euler")
    if not getattr(args, "continuous", False):
        return BatchingEngine(
            pipe, tokenize, max_batch=args.max_batch, window_ms=args.batch_window_ms,
            max_steps=args.max_steps, resolutions=_resolutions(args),
            vae_scale_factor=_pipe_vae_scale_factor(pipe), cache_interval=ci,
            guidance_interval=gi, cache_tau=tau, solver=solver)
    from tpdm_tpu_torch.serving_continuous import (
        ContinuousBatchingEngine,
        MultiResContinuousRouter,
    )

    if gi is not None or tau:
        raise SystemExit("--guidance_interval/--cache_tau serve through the fixed-batch "
                         "engine (the continuous segment carries the per-segment Δ-cache "
                         "only: use --cache_interval); drop --continuous")
    common = dict(slots=args.max_batch, seg_steps=getattr(args, "seg_steps", 4),
                  max_steps=args.max_steps, cache_interval=ci,
                  pipeline_depth=getattr(args, "pipeline_depth", 1) or 1,
                  decode_batch=getattr(args, "decode_batch", 1) or 1,
                  vae_scale_factor=_pipe_vae_scale_factor(pipe))
    res = _resolutions(args)
    if res:
        return MultiResContinuousRouter(pipe, tokenize, resolutions=res, **common)
    return ContinuousBatchingEngine(pipe, tokenize, solver=solver,
                                    fused_lora=getattr(args, "lora_fused", False), **common)


def register_named_adapters(engine, args, runner=None) -> None:
    """--lora NAME=PATH: each adapter registered on ``engine`` at
    --lora_scale (--lora_cache merged copies). SD3's engines serve them
    (fixed-batch sub-batches, or continuous multiplexed or fused); a family
    engine only fused (--continuous --lora_fused); the multi-resolution
    router none."""
    from tpdm_tpu_torch.serving import BatchingEngine
    from tpdm_tpu_torch.serving_continuous import (
        ContinuousBatchingEngine,
        _AgentContinuousEngine,
    )

    _path, named = _split_lora_args(args)
    fused = getattr(args, "lora_fused", False)
    if fused:
        if not isinstance(engine, ContinuousBatchingEngine):
            raise SystemExit("--lora_fused needs a single continuous engine (--continuous, no "
                             "--resolutions router)")
        if not named:
            raise SystemExit("--lora_fused without --lora NAME=PATH adapters")
    if not named:
        return
    ok_fixed = isinstance(engine, BatchingEngine) and runner is None
    ok_cont = isinstance(engine, ContinuousBatchingEngine) and (
        not isinstance(engine, _AgentContinuousEngine) or fused)
    if not (ok_fixed or ok_cont):
        raise SystemExit("--lora NAME=PATH needs an SD3 engine (fixed-batch sub-batches or "
                         "--continuous segments) or a family engine with --continuous "
                         "--lora_fused; the multi-resolution router serves no adapters")
    from tpdm_tpu_torch.train.draft import load_lora

    for name, path in named:
        engine.register_adapter(name, load_lora(path), scale=getattr(args, "lora_scale", 1.0),
                                merged_cache=getattr(args, "lora_cache", 1) or 1)
        logger.info("registered adapter %r from %s", name, path)


def _alive(engine) -> bool:
    """Every worker thread of the engine (each of a router's) runs."""
    engines = getattr(engine, "_engines", {None: engine}).values()
    return all(e._thread is not None for e in engines)


def make_http_server(pipe, tokenize, args, ranker=None, runner=None, world=None):
    """A threaded HTTP server over ``make_engine``'s engine: concurrent
    requests coalesce into one batch, or share the continuous engine's
    slots. ``ranker`` (``train.builders.build_inference_ranker``) ranks
    ``/rank``'s candidates; without one they come back unranked. Returns
    (engine, server); start the engine, then ``server.serve_forever()``.
    ``runner``: a family runner, served by a ``BatchingEngine`` over it, or
    with ``--continuous`` by the family's continuous engine over ``world``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from tpdm_tpu_torch.serving import EngineOverloaded, RequestExpired, generate_ranked
    from tpdm_tpu_torch.utils.image import read_png_rgb
    from tpdm_tpu_torch.utils.metrics_export import prometheus_text

    engine = make_engine(pipe, tokenize, args, runner=runner, world=world)
    register_named_adapters(engine, args, runner=runner)

    def lora_of(req):
        """The request's adapter name (None: the base)."""
        lora = req.get("lora")
        if lora is not None and not isinstance(lora, str):
            raise ValueError("lora must be an adapter name string")
        if lora is not None and not hasattr(engine, "register_adapter"):
            raise ValueError("this engine does not serve adapters")
        return lora

    def steps_of(req):
        steps = req.get("steps")
        if steps is not None:
            steps = int(steps)
            if not 1 <= steps <= args.max_steps:
                raise ValueError(f"steps must be in [1, {args.max_steps}]")
        return steps

    def prompt_of(req):
        prompt = req.get("prompt", args.prompt)
        if not isinstance(prompt, str):
            raise ValueError("prompt must be a string")
        return prompt

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every response carries Content-Length
        # (_reply, _text and send_error all do)
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            if self.path == "/stats":
                self._reply(engine.stats())
            elif self.path == "/healthz":
                # liveness: the worker threads must still be running
                alive = _alive(engine)
                self._text(200 if alive else 503, b"ok\n" if alive else b"stopped\n",
                           "text/plain")
            elif self.path == "/metrics":
                self._text(200, prometheus_text(engine.stats()).encode(),
                           "text/plain; version=0.0.4")
            else:
                self.send_error(404)

        def _body(self, limit: int):
            """The JSON body, or None after a 413."""
            length = int(self.headers.get("Content-Length", 0))
            if length > limit:
                self.send_error(413, "request body too large")
                return None
            return json.loads(self.rfile.read(length) or b"{}")

        def do_POST(self):
            if self.path == "/rank":
                self._do_rank()
                return
            if self.path != "/generate":
                self.send_error(404)
                return
            # validate untrusted input before it reaches the batch worker:
            # one bad request must not poison a coalesced batch
            try:
                req = self._body(8 * 1024 * 1024)
                if req is None:
                    return
                lora = lora_of(req)
                prompt = prompt_of(req)
                seed = int(req.get("seed", args.seed))
                steps = steps_of(req)
                resolution = req.get("resolution")
                if resolution is not None:
                    resolution = int(resolution)
                deadline_s = req.get("deadline_s")
                if deadline_s is not None:
                    deadline_s = float(deadline_s)
                    if deadline_s <= 0:
                        raise ValueError("deadline_s must be > 0")
                guidance = req.get("guidance_scale")
                if guidance is not None:
                    guidance = float(guidance)
                negative = req.get("negative_prompt")
                if negative is not None and not isinstance(negative, str):
                    raise ValueError("negative_prompt must be a string")
                init_image = strength = None
                if req.get("init_image_png_base64"):
                    # a malformed image is the client's error: ValueError, a 400
                    init_image = read_png_rgb(base64.b64decode(req["init_image_png_base64"],
                                                               validate=True))
                    if req.get("strength") is not None:
                        strength = float(req["strength"])
                fmt = _check_format(req.get("format"))
            except Exception as e:
                self.send_error(400, str(e)[:100])
                return
            try:
                kw = {} if lora is None else {"lora": lora}
                res = engine.submit(prompt, seed, steps=steps, resolution=resolution,
                                    deadline_s=deadline_s, init_image=init_image,
                                    strength=strength, guidance_scale=guidance,
                                    negative_prompt=negative or None, **kw).result(timeout=600)
            except ValueError as e:  # an unknown resolution etc.
                self.send_error(400, str(e)[:100])
                return
            except (RequestExpired, EngineOverloaded) as e:
                self.send_error(503, str(e)[:100])
                return
            except Exception as e:
                self.send_error(500, str(e)[:100])
                return
            key, data = _encode_image(res["image"], fmt)
            self._reply({key: data, "inference_steps": res["inference_steps"],
                         "sigmas": res["sigmas"]})

        def _do_rank(self):
            """Best-of-N: ``n`` seeds of one prompt, ranked by ``ranker``
            where one is configured."""
            try:
                req = self._body(65536)
                if req is None:
                    return
                lora = lora_of(req)
                prompt = prompt_of(req)
                seed = int(req.get("seed", args.seed))
                n = int(req.get("n", 4))
                max_n = getattr(args, "max_rank_n", 8)
                if not 1 <= n <= max_n:
                    raise ValueError(f"n must be in [1, {max_n}]")
                steps = steps_of(req)
                fmt = _check_format(req.get("format"))
            except Exception as e:
                self.send_error(400, str(e)[:100])
                return
            try:
                out = generate_ranked(engine, prompt, seed=seed, n=n, steps=steps,
                                      ranker=ranker, lora=lora)
            except ValueError as e:
                self.send_error(400, str(e)[:100])
                return
            except EngineOverloaded as e:
                self.send_error(503, str(e)[:100])
                return
            except Exception as e:
                self.send_error(500, str(e)[:100])
                return
            payload = {"seeds": out["seeds"],
                       "inference_steps": [c["inference_steps"] for c in out["candidates"]],
                       "ranked": "ranking" in out}
            for k in ("ranking", "rewards", "best"):
                if k in out:
                    payload[k] = out[k]
            payload[f"images_{fmt}_base64"] = [_encode_image(c["image"], fmt)[1]
                                               for c in out["candidates"]]
            self._reply(payload)

        def _text(self, status: int, body: bytes, content_type: str):
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, payload: dict):
            self._text(200, json.dumps(payload).encode(), "application/json")

        def log_message(self, *a):
            logger.info("%s", a)

    server = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    return engine, server


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pretrained", default=None,
                   help="a local diffusers-layout SD3-medium directory")
    p.add_argument("--tpm", default=None, help="a TPM-only safetensors checkpoint")
    p.add_argument("--toy", action="store_true", help="random toy weights (runs anywhere)")
    p.add_argument("--family", default="sd3", choices=["sd3", "sd15", "sdxl", "flux"])
    p.add_argument("--refiner", action="store_true",
                   help="--family sdxl: the base + refiner ensemble runner")
    p.add_argument("--denoising_end", type=float, default=0.8,
                   help="--refiner: the base's share of the noise levels")
    p.add_argument("--cli", action="store_true", help="generate --prompt once, write --out")
    p.add_argument("--cpu", action="store_true", help="serve on the CPU instead of the card")
    p.add_argument("--prompt", default="a serene mountain lake at dawn")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_steps", type=int, default=35)
    p.add_argument("--max_batch", type=int, default=2,
                   help="serving batch; partial batches pad to it")
    p.add_argument("--batch_window_ms", type=float, default=25.0)
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--mesh", default=None)
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching: finished slots are refilled mid-denoise")
    p.add_argument("--seg_steps", type=int, default=4,
                   help="--continuous: denoise steps a segment, between slot refills")
    p.add_argument("--pipeline_depth", type=int, default=1,
                   help="--continuous: segments in flight ahead of the host's readback")
    p.add_argument("--decode_batch", type=int, default=1,
                   help="--continuous: finished slots coalesced into one decode")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--lora", action="append", default=None,
                   help="a LoRA file: a bare PATH merges into the backbone at load; NAME=PATH "
                        "(repeat the flag) registers named adapters that requests pick with "
                        '{"lora": "NAME"}')
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--lora_cache", type=int, default=1,
                   help="merged copies of the backbone kept for NAME=PATH adapters")
    p.add_argument("--lora_fused", action="store_true",
                   help="--continuous: NAME=PATH adapters as per-slot fused deltas (one "
                        "segment advances every tenant; also over --int8/--int4)")
    p.add_argument("--tb_dir", default=None,
                   help="stream the engine's stats() to TensorBoard event files here")
    p.add_argument("--tb_interval", type=float, default=10.0)
    p.add_argument("--out", default="generated.png")
    p.add_argument("--reward_checkpoint", default=None)
    p.add_argument("--max_rank_n", type=int, default=8, help="cap on /rank's candidates")
    p.add_argument("--quant_text", action="store_true",
                   help="weight-only int8 T5-XXL tower (int4 with --int4), run on K5")
    p.add_argument("--int4", action="store_true", help="int4 weight-only MMDiT or FLUX (K5)")
    p.add_argument("--int8", action="store_true", help="W8A8 int8 MMDiT or FLUX (K4)")
    p.add_argument("--few_step", default=None)
    p.add_argument("--solver", default="euler", choices=["euler", "ab2"])
    p.add_argument("--cache_interval", type=int, default=0,
                   help=">= 2: the Δ-cache, refreshed every N steps")
    p.add_argument("--cache_tau", type=float, default=0.0,
                   help="> 0: the input-aware Δ-cache (exclusive with --cache_interval)")
    p.add_argument("--guidance_interval", default=None,
                   help="'lo,hi': CFG only while sigma is in [lo, hi)")
    p.add_argument("--resolutions", default=None,
                   help="comma-separated further output resolutions in pixels")
    args = p.parse_args(argv)
    for name, (what, item) in _NOT_PORTED_FLAGS.items():
        if getattr(args, name):
            raise SystemExit(str(not_ported(what, item)))
    if args.family != "sd3" and args.solver != "euler":
        raise SystemExit("--solver serves the SD3 engines and --cli; family runners keep euler")
    if args.solver != "euler" and args.continuous and args.resolutions:
        raise SystemExit("--solver with --continuous serves the single-resolution engine; "
                         "drop --resolutions")
    if args.cli and _split_lora_args(args)[1]:
        raise SystemExit("--lora NAME=PATH registers adapters on the HTTP engine; --cli "
                         "merges a bare --lora PATH")
    return args


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    world = build_family_world(args)
    runner = None
    if world is not None:
        runner = world["runner"]
        pipe = None

        def tokenize(prompt, _n=None):  # the runner encodes; the engine needs the prompts
            return None, None

        if args.cli:
            from tpdm_tpu_torch.utils.image import write_png

            res = runner([args.prompt], [args.seed], [args.max_steps])[0]
            write_png(args.out, res["image"])
            print(f"saved {args.out}; inference steps: {res['inference_steps']} / cap "
                  f"{args.max_steps}")
            return
    else:
        pipe, tokenize = build_pipeline(args)

    if args.cli:
        from tpdm_tpu_torch.utils.image import write_png

        ci, gi, tau = _accel_kwargs(args)
        res = generate(pipe, tokenize, args.prompt, args.seed, args.max_steps,
                       cache_interval=ci, guidance_interval=gi, cache_tau=tau,
                       solver=args.solver)
        write_png(args.out, res.images[0])
        nfe = int(res.last_valid_index[0]) + 1
        print(f"saved {args.out}; inference steps: {nfe} / cap {args.max_steps}")
        return

    engine, server = make_http_server(pipe, tokenize, args, runner=runner, world=world)
    engine.start()
    streamer = None
    if args.tb_dir:
        from tpdm_tpu_torch.utils.tb_writer import StatsStreamer

        streamer = StatsStreamer(engine.stats, args.tb_dir, args.tb_interval)
    logger.info("serving on http://127.0.0.1:%d/generate (POST json; GET /stats) through %s, "
                "max_batch %d", server.server_address[1], type(engine).__name__, args.max_batch)

    # graceful drain on SIGTERM / ctrl-C: stop accepting, let the engine
    # finish its batch, exit; serve_forever() returns once shutdown() runs
    def _drain(signum, frame):
        logger.info("signal %d: draining and shutting down", signum)
        threading.Thread(target=server.shutdown, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _drain)
    try:
        server.serve_forever()
    finally:
        if streamer is not None:
            streamer.stop()
        engine.stop()
        server.server_close()


if __name__ == "__main__":
    main()
