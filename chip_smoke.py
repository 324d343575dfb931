#!/usr/bin/env python3
"""Drive the PyTorch port (tpdm_tpu_torch) once on the visible CUDA cards (one is enough).

Run from the repository root on a machine with sm_90a (Hopper) cards:

    python3 chip_smoke.py [--seed N] [--seq-parallel-only | --lora-only | --lora-train-only]

Phases, one line each, and any failure exits non-zero:

1. the device: its name and power limit as nvidia-smi reports them;
2. build: the hand-written kernels from tpdm_tpu_torch/csrc with nvcc;
   for each instantiation of the wgmma kernels (K1 and K3 of attn_sm90.cu,
   K2 of attn_d512_sm90.cu, K4 and K5 of gemm_sm90.cu, the 16 K6, 2 K8, 3
   K7 and 4 K9 instantiations of attn_studies_sm90.cu) the registers and spills
   ptxas reported and the wgmma (HGMMA, IGMMA), TMA (UTMALDG, UTMASTG) and
   mma.sync (HMMA, IMMA) instructions that cuobjdump finds in it; it fails
   on a spill, on a kernel without wgmma or TMA loads, or on one with
   mma.sync;
3. each kernel against its plain PyTorch version at the main path's
   shapes, with errors and median times (CUDA events): K1 (at CFG batch
   2, the RLOO rollout's 8 and replay's 4, the conditional-only batch 1 of
   a guidance window, phase 13's eval batch 20 and phase 14's 512 px
   request at CFG batch 4, (4, 24, 1408, 64)), K2 (at the
   1024 px decode's (1, 1, 16384, 512), (2, 1, 16384, 512), the RLOO
   reward's (4, 1, 16384, 512), phase 14's 512 px decode's (2, 1, 4096,
   512), phase 15's batch-1 512 px decode's (1, 1, 4096, 512), phase
   18's engine decode's (4, 1, 4096, 512) and phase
   13's eval decode's (10, 1, 16384, 512) against the
   plain version in 4096-row query blocks, at 2048 px's
   (1, 1, 65536, 512) against the plain version in 4096-row query blocks,
   every 64-column block of O held on its own, and with strongly negative
   scores), and the
   GEMMs K4 (int8, bit for bit on its int32 accumulator) and K5 (bf16) at
   every matmul shape of the batch 1 and batch 2 requests, beside
   torch._int_mm and cuBLAS's bf16 product; K1's, K4's and K5's TFLOP/s
   (TOP/s) and share of their bound. Then SD3.5's shapes: K1 at
   SD3.5-medium's image-only attn2 (2, 24, 4096, 64) and (4, 24, 4096,
   64) without a kv_len and at SD3.5-large's joint attention (2, 38, 4480,
   64), kv_len 4429 (each timed over back-to-back calls between CUDA
   events, and by its device time: calls queued behind a sleep on the
   card), and K4
   at every W8A8 matmul shape of an SD3.5-large batch-1 request (K and N
   in {2432, 9728}, 8192 image and 666 text rows);
4. a reference check: a 2-layer MMDiT (float, W8A8 and int4), a 2-layer
   SD3.5 MMDiT (dual attention in layer 0, qk RMSNorm; float and W8A8)
   and a VAE decoder with a 512-wide mid block, on the card in bf16
   through the kernels, against the same weights run in fp32 on the CPU
   through the plain versions;
5. the slice: full-width SD3-medium MMDiT (24 layers, 24 heads x 64), the
   TPM and the SD3 VAE decoder at 1024 px, weights drawn from the seed,
   answering two requests (batch 1, then batch 2) through
   TPDMPipeline.generate, with the kernels' launch counts read around them;
6. the quantised slice: copies of that MMDiT prequantised to W8A8 int8
   (K4) and to int4 weight-only (K5), one 1024 px forward of each against
   the bf16 forward, then two W8A8 requests (batch 1, then 2) and one int4
   request, with the launch counts read around each;
7. K3 against its plain version at the per-rank shapes of a 4-way ring at
   2048 px, of a ring of one (q (2, 24, 16717, 64) against the whole image
   kv, the plain version on a subset of query rows) and of this machine's
   ring size, with its time at the first two beside its bound and
   PyTorch's flash-attention call that also returns the log-sum-exp;
8. the merge on one card: K3 over four image shards and the text tokens
   of the 2048 px joint sequence, merged by merge_attention_shards,
   against K1 over the whole sequence;
9. sequence parallelism: one process per visible card, joined in an NCCL
   seq group (one card makes a ring of one, and then no NCCL exchange
   runs). A full-width MMDiT forward at 2048 px through the ring against
   the unsharded K1 forward on the same bf16 weights, beside the gap that
   one bf16 step on the latents makes in the unsharded forward; then two
   2048 px requests (batch 1) through TPDMPipeline.generate, every rank
   reporting its steps, times, launch counts and peak memory;
10. the K1 layout and tuning studies (tpdm_tpu_torch.experiments, on K6-K9)
   at the SD3 1024 px study shape (2, 24, 4480, 64): every study function
   and three attention blocks at width 1536 once, with the launch counts
   read around them, each against the same function with the plain
   versions swapped in (the K9 noexp probe against its plain version in
   fp64); then each one's median time, each kernel mode's alone with its
   bound, share of the bound and load routes, and K6-K9 beside
   their plain versions and scaled_dot_product_attention;
11. RLOO training (tpdm_tpu_torch.train): two updates of RLOOTrainer at
   the full width of SD3-medium (phase 5's MMDiT and VAE, frozen), a TPM
   with fp32 parameters computing in bf16, and a random-weight ImageReward
   (ViT-L + BERT-med, fp32) with a WordPiece vocabulary of the example
   prompts written to a temporary directory. Each update rolls out 2
   prompts x rloo_k 2 (CFG batch 8, up to 28 steps, the activations
   cached), decodes the 4 final latents (K2), scores them, and runs one PPO
   epoch of 2 micro-batches with gradient accumulation 2 (one Adam step);
   its metrics, seconds (rollout, reward, PPO), peak memory and K1/K2
   launches are printed and checked. Then the checkpoint of update 2 is
   restored against the trained TPM, and update 2's rollout is replayed in
   the recompute mode (the backbone re-run with K1) against the cached
   replay;
12. the fixed-schedule baseline and the sampling options on phase 5's
   weights (rebuilt from the seed), each request warm, timed, and its K1
   and K2 launches checked exactly: TPDMPipeline.generate_fixed with 28
   Euler steps at batch 1 and 2 beside the adaptive generate, the heun,
   midpoint and ab2 solvers, cache_interval 2, cache_tau 0.1, the guidance
   window (0.15, 0.95) alone (each forward at the batch that its sigma
   decides, fixed and adaptive) and with cache_interval 2; windows holding
   every and no sigma against plain CFG and guidance_scale=None on the
   final latents; generate with ab2, each cache and the window; the
   history images (one decode a step, the last frame equal to the image);
   and the Δ-cache forward (record, then reuse) of phase 4's 2-layer MMDiT
   on the card against fp32 on the CPU;
13. RLOO training from the command line: tpdm_tpu_torch.train.main.main
   called in-process three times on phase 11's configuration (its models
   built once from the seed by this file's cli_* builders, which YAMLs
   written to a temporary directory name; the dataset YAML is
   configs/torch/datasets/jsonl_prompts.yaml). Run A trains two updates
   with TensorBoard, the eval at update 2 (10 prompts, up to 40 steps,
   their image strip) and the profiler over update 2; it checks
   metrics.jsonl against the event file, the eval record and PNG, the
   trace's K1 and K2 kernels, and the K1 and K2 launches, and prints the
   trace by kernel group. Run B resumes from run A's checkpoint-2 for
   update 3. Run C runs update 1 again with offload_cache="host": its
   metrics against run A's (1e-6), and the memory allocated at the reward
   call against run A's, lower by at least 90 % of the cache moved;
14. serving text prompts: a 2-layer CLIP-G and T5 at full width on the
   card in bf16 against fp32 on the CPU; CLIP-L, CLIP-G and T5-XXL in
   bf16 from the seed beside phase 5's models (rebuilt from the seed),
   with toy CLIP and T5 vocabularies of the example prompts; generate
   from token ids against generate from their embeds (equal to the bit);
   a BatchingEngine (max_batch 2, 25 ms window, 35 steps, 512 px served
   too) answering two concurrent prompts in one batch, the first again
   (an embed-cache hit, the same image), steps=5, guidance 4.0 with a
   negative prompt and a 512 px request, its batch of two against a
   direct generate on the same latents and embeds (equal to the bit);
   then tpdm_tpu_torch.serve's HTTP server: POST /generate (its PNG
   against the engine's image), GET /stats, /metrics and /healthz, POST
   /rank ranked by a random ImageReward, and a bad request's 400. K1 and
   K2 launches are checked around every call; tokenize, encode (each
   tower, the T5-XXL forward's TFLOP/s), request, PNG and round-trip
   times and the engine's stats() are printed;
15. continuous batching on phase 14's models at 1024 px (CFG 7.0,
   predict=True, 35 steps at most): a burst of 12 requests (example
   prompts and seeds 0-11, caps cycling none, 4, none, 8) submitted at
   once. A: ContinuousBatchingEngine(slots=4, seg_steps=4), warmed up;
   each request equal to the bit to BatchingEngine(max_batch=4).
   generate_batch at the same CFG batch 8 (its final latents decoded at
   batch 1, as the engine decodes a slot; given the engine's batch-1
   embeds), capped requests at their cap. B: A with pipeline_depth=2,
   equal to A. C: decode_batch=4, at least two rows coalesced, its gap to
   A. D: cache_interval=2 and solver="ab2" on 4 requests, twice each,
   equal to the bit. E: MultiResContinuousRouter(resolutions=[512],
   slots=2), two requests at 1024 px then the same at 512 px, each equal
   to BatchingEngine(max_batch=2, resolutions=[512]) and no prompt
   encoded twice. F: BatchingEngine(max_batch=4, window_ms=25) on the
   burst. G: serve --continuous over HTTP (/generate's PNG, /stats,
   /metrics, /healthz, a 400). Each run prints its makespan, images a
   second, latency p50 / p95, slot utilisation, segments, host syncs, ms
   a segment (CUDA events), peak memory and K1 / K2 launches, checked
   exactly (K1 layers x the steps of each segment, K2 one a decode call);
   any request error, segment_traces other than 1 or a record at ERROR
   from serving_continuous fails the phase;
16. SD3.5 at 1024 px (CFG 7.0, predict=True, TPM head bias (1.0, 0.55)),
   weights drawn on the card from the seed: (a) SD3.5-medium at full
   width (24 layers, 24 x 64 heads, dual attention in layers 0-12, qk
   RMSNorm, a 384 x 384 sincos table) with its TPM and the SD3 VAE,
   requests at batch 1 and 2 (K1 37 launches a step: 24 joint + 13
   attn2); (b) SD3.5-large at full width (38 layers, 38 x 64 heads, 8.1 B
   parameters), a bf16 request at batch 1, then the same model
   prequantised W8A8 in place and the same request (K1 38 a step, K4 453
   a step); (c) a synthetic diffusers-layout directory written to a
   temporary directory (a 2-layer SD3.5-medium-width transformer in two
   shards, the SD3 VAE, a TPM file) loaded by
   load_pipeline_from_pretrained, every tensor and one request equal to
   the bit to the same weights built in memory. Each request (after a
   one-step warm-up at its batch) prints its steps, warm wall time (CUDA
   events), peak memory and K1 / K2 / K4 launches, checked exactly;
17. image-to-image and inpainting on phase 14's models at 1024 px (the
   VAE's encoder drawn from the seed with the decoder): encode_image at
   batch 1 and 4 (K2 one launch a call, encode ms by CUDA events; the
   bf16 latents against an fp32 encode of the same weights with the
   plain attention, mean |dz| / mean |z| < ENCODE_REL_BOUND);
   generate(init_image, strength=1.0) equal to text-to-image to the bit;
   per-sample strengths (0.4, 0.8) at batch 2, each starting at its
   strength, the lower nearer the init image; a half-mask inpaint whose
   kept latents equal the encoded ones to the bit; a BatchingEngine batch
   of two text and two img2img rows (the text rows equal a text-only
   batch's, the batch a direct generate(init_image=, seed=<one a row>));
   a ContinuousBatchingEngine(slots=4, seg_steps=4) burst of 8, half
   img2img, each equal to BatchingEngine(max_batch=4) with its images
   encoded and decoded at batch 1; /generate with init_image_png_base64
   (and a malformed PNG's 400). K1 (24 a step) and K2 (one an encode
   call, one a decode call) are checked exactly around every call; the
   encode ms, the img2img request's wall time and steps beside the
   text-to-image request's, peak memory and the phase's seconds are
   printed beside nvidia-smi's name and power limit;
18. SD1.5 at 512 px (CFG 7.5, predict=True, TPM head bias (1.0, 0.55),
   at most 25 steps), after the SD3 models are freed: K1 at each SD1.5
   shape at the CFG batches 2, 4 and 8 that the phase's calls run (head
   dims 40, 80 and 160; self-attention at 4096, 1024, 256 and the mid
   block's 64 tokens, cross-attention against 77 text tokens) against its
   plain version, timed beside it and scaled_dot_product_attention over
   back-to-back calls between CUDA events, and by its device time (calls
   queued behind a sleep on the card); the SD1.5 UNet (860 M parameters),
   CLIP-L with a toy vocabulary of the example prompts and the SD1.5 VAE with its
   encoder drawn from the seed in bf16; one UNet forward against an fp32
   copy of the same weights on the card (MODULE_REL_TOL of each output's
   range), its warm time at CFG batch 2 and 4, and a profiler trace of
   three forwards at each (device busy time, K1's share of it, the
   device's idle share); SD15Pipeline.generate at
   batch 1 and 2 (each warmed by a one-step rollout), an img2img request
   at strength 0.6 (the loop starting at t 599), and a BatchingEngine over
   make_sd15_runner with three requests of mixed caps, each row equal to a
   direct runner call on the same padded batch to the bit, caps exact. K1
   (32 a forward) and K2 (one an encode, one a decode) are checked exactly
   around every call.
19. SDXL at 1024 px (CFG 5.0, predict=True, TPM head bias (1.0, 0.55),
   at most 25 steps) and the UNet families' continuous engines, after
   phase 18's models are freed: K1 at d 64 at SDXL's shapes (the base's 10
   heads over 4096 tokens and 20 over 1024 at CFG batch 2, 4 and 8, the
   refiner's 12 over 4096, 24 over 1024 and 256 at CFG batch 2 and 4, each
   with its cross-attention against 77 text tokens) and at the toy
   worlds' head dims below 64 (padded to 64 columns) against its plain
   version, timed as phase 18 times it; ContinuousSD15Engine(slots=4,
   seg_steps=4) at full SD1.5 width at 512 px on a burst of 8 requests
   with mixed caps, then the same burst through BatchingEngine(max_batch=4)
   over make_sd15_runner: every schedule equal, every image equal or within
   the 1-level seam, makespan and p50 side by side; the SDXL base (2.6 B
   parameters) and refiner (2.3 B), CLIP-L, bigG and the SDXL VAE drawn in
   bf16; one base forward at CFG batch 2 against an fp32 copy on the card
   and its warm time; SDXLPipeline.generate from text through
   SDXLTextEncoders at batch 1 and 2; the refiner on the decoded batch-1
   image at strength 0.3; the ensemble at denoising_end 0.8 through
   make_sdxl_ensemble_runner behind BatchingEngine; ContinuousSDXLEngine's
   burst as the SD1.5 engine's; and ``serve --family sdxl --toy`` and
   ``serve --family sd15 --continuous --toy`` on the card, one HTTP
   /generate each. K1 (140 a base forward, 88 a refiner forward, 32 an
   SD1.5 forward) and K2 (one an encode or decode) are checked exactly
   around every call.
20. FLUX.1-dev (guidance 3.5 embedded, predict=True, TPM head bias
   (1.0, 0.55), at most 28 steps), after phase 19's models are freed: K1 at
   head dim 128 at (1, 24, 4608, 128) and (2, 24, 4608, 128) (1024 px: 512
   T5 + 4096 image tokens) and (4, 24, 1536, 128) (512 px, 4 slots) against
   its plain version, timed as phase 18 times it; FLUX at full width with
   2 double and 2 single blocks, bf16 against an fp32 copy on the card
   (MODULE_REL_TOL of each output's range); the full-depth model (19
   double + 38 single blocks, 11.9 B parameters) built on the meta device
   and drawn on the card in bf16 from the seed, its TPM and a 16-channel
   VAE with FLUX.1's factors (scaling 0.3611, shift 0.1159); FluxPipeline.
   generate at 1024 px at batch 1 and 2 (random T5-shaped embeds), the
   28-step Euler generate_fixed, image-to-image at strength 0.6 and
   cache_interval 2; ContinuousFluxEngine(slots=4, seg_steps=4) at 512 px
   on a burst of 8 against BatchingEngine(max_batch=4) over
   make_flux_runner, as phase 19 holds the UNet engines; ``serve --family
   flux --toy`` and ``--family flux --toy --continuous`` on the card over
   HTTP; then the model prequantised W8A8 in place and, drawn again from
   the seed, int4: one 1024 px forward of each against the bf16 forward
   (mean |dv| / mean |v| under QUANT_REL_BOUND) and one request each. K1
   (57 a forward, cache_front_blocks a Δ-cache reuse forward), K2 (one an
   encode or decode), K4 (304 a W8A8 forward) and K5 (77 a W8A8 forward,
   381 an int4 one) are checked exactly around every call.
21. RLOO training over the families (tpdm_tpu_torch.train): one update of
   RLOOTrainer over SD15Agent (512 px, CFG 7.5), SDXLAgent (1024 px, CFG
   5.0), SDXLEnsembleAgent (base + refiner at denoising_end 0.8, both TPM
   heads in one Adam step) and FluxAgent (1024 px, guidance 3.5 embedded,
   no CFG doubling), each run by phases 18, 19 and 20 on the backbones and
   VAEs they hold (FLUX before its quantised modes), with phase 11's
   training configuration (2 prompts x rloo_k 2, one PPO epoch of 2
   micro-batches, gradient accumulation 2, lr 1e-6, an fp32 TPM computing
   in bf16) and reward (the family's VAE decode, then phase 11's
   random-weight ImageReward). Each update prints its metrics, rollout,
   reward and PPO seconds, steps (base + refiner), peak memory and
   activation-cache bytes, and is checked: finite metrics, no skipped
   step, |val/ratio - 1| < 1e-2, the TPM (each head) moved by more than 0
   and at most 1.5 x lr, and K1 (a forward's launches times each stage's
   loop iterations) and K2 (one, the decode) exact around the rollout and
   the reward, none in the PPO epochs. K1 at the new shapes these
   rollouts run (the refiner's at CFG batch 8, FLUX's (4, 24, 4608, 128))
   is checked and timed with phases 19 and 20's.
22. LoRA adapters on the serving engines and the weight-only quantised T5
   tower (tpdm_tpu_torch.models.lora, serving, serving_continuous), run by
   phases 14-20 on their models: rank-16 adapters with a non-zero b drawn
   from the seed, every request capped at 4 steps. On phase 14's SD3-medium
   at 1024 px: BatchingEngine with two adapters over every dense layer
   (merged_cache 2; the merge's ms, the merged copy's bytes, peak memory),
   an adapter request equal to the bit to an adapter-free engine on the
   manually merged backbone and a base request after adapter traffic equal
   to the bit to the adapter-free engine's; a burst of six (two prompts,
   each on the base and under both adapters) through
   ContinuousBatchingEngine(slots=4, seg_steps=4) multiplexed, each request
   equal to the bit to its merged solo run (BatchingEngine(max_batch=4) at
   the same CFG batch on the merged backbone), then fused over bf16 (base
   requests within the 1-level seam, adapter requests within 24 levels and
   a mean under 3 of their merged solo run and moving their image further
   from the base than that gap) and over W8A8 (K4) and int4 (K5) copies
   (adapter requests against the same rows of BatchingEngine under the
   interceptor); T5-XXL at weight-only int8 and int4 (K5, 7 a block) on the
   example prompts against the bf16 tower (error, ms, bytes). On phase
   18's SD1.5 and phase 20's FLUX.1-dev (at 512 px, an adapter over its
   attention projections): a base and an adapter request through the
   family's continuous engine with fused_lora, held to the runner at the
   engine's batch with each request at its slot's row (the base and the
   merged backbone), and the base request alone through BatchingEngine,
   its gap to the engine's row reported against the seam (the UNet row
   check, which fails for SD1.5 beyond the seam: its UNet convolves each
   row alone). K1, K2, K4 and K5 are checked exactly around every call;
   ``--lora-only`` runs phases 1, 2 and 22 alone (no kernels line).
23. LoRA training through the SD3-medium backbone at full width, 1024 px,
   bf16: K1's backward (attn_bwd_sm90.cu) against autograd through the
   plain version in fp32 at DRaFT's (2, 24, 4480, 64) and DPO's (4, 24,
   4480, 64), kv_len 4429, and a padded toy head dim (dK = dV = 0 past
   kv_len), timed beside the plain version and SDPA's backward; K2's
   chunked backward at (1, 1, 16384, 512) against the dense plain one;
   one DRaFT update (28 steps, K = 1, CFG 7, ImageReward through
   score_grad, the decode under autograd) and one DPO update (2 pairs of
   1024 px latents, no CFG) through ``python -m tpdm_tpu_torch.train.main
   --trainer draft|dpo`` in-process, each with a second, warm update
   (metrics, seconds, peak memory, every b factor moved within 1.5 x lr x
   updates, the base weights unchanged to the bit, K1 forward, K1
   backward and K2 launches against the count the code implies); a DRaFT
   loss's LoRA gradient with the kernels against the plain versions in
   fp32 (cosine, beside a plain bf16 run's); one DistillTrainer update at
   batch 2 (the EMA target moved); and phase 22's SD1.5 row check.
   ``--lora-train-only`` runs phases 1, 2 and 23 alone (no kernels line).

It then prints a JSON line of the kernels' results and, last, one JSON
object naming the device. There is no CPU path: without a CUDA card it
exits with an error and prints no result. ``--seq-parallel-only`` runs
phases 1, 2 and 9 alone (for a machine with several cards) and prints no
kernels line.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parent
T_MAX = 28
N_CTX = 333  # SD3's joint text length: 77 CLIP + 256 T5 tokens
TPM_HEAD_BIAS = (1.0, 0.55)  # a trained-like policy: the schedule stops itself
WEIGHT_STD = 0.02  # N(0, 0.02²) weights keep every bf16 activation finite
# bf16 kernel vs plain version: both round P and the output to bf16 (2^-8
# relative) and sum in different orders. With N(0, 1) q, k, v at d = 64 an
# output's scale is sqrt(e / n_kv), about 0.026 against 4096 kv rows and
# 0.013 against 16384, so the bound is relative: the max abs error within
# KERNEL_REL_TOL of the plain output's largest magnitude (a few bf16 steps
# there), as for the merged shards below
KERNEL_REL_TOL = 2e-2
# bf16 on the card vs fp32 on the CPU through whole modules: bf16 rounding
# of every activation; bound on max error relative to the output's range
MODULE_REL_TOL = 5e-2
# K3's statistics in the frame log2(l) + m: exact bf16 products summed in
# fp32 in another order, on values of order 10 (or -170 when strongly negative)
LSE_ATOL, LSE_RTOL = 1e-3, 1e-4
# ring-merged K3 (bf16 partial outputs, fp32 merge) against K1: max error
# relative to the output's range, a few bf16 steps (2^-8). The seq-parallel
# 24-layer forward against the unsharded one: RMS error relative to the
# output's RMS within it. Its max error is held to the rounding floor
# instead: the two paths round attention at other places, and the layers
# amplify any bf16 step to a few steps at h2's largest elements, so each
# gap may be at most FLOOR_FACTOR times the gap that one bf16 step on every
# input latent makes in the unsharded forward
SHARDED_REL_TOL = 2e-2
FLOOR_FACTOR = 2.0
# H100 SXM published dense peaks: the bound of a kernel is the larger of its
# bytes over the memory rate and its operations over the tensor rate of
# its type
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
SLEEP_CYCLES_PER_MS = 2.0e6  # torch.cuda._sleep spins on the SM clock (1.98 GHz at most)
MIN_SLEEP_MS = 10.0  # device_ms's least sleep: well above a host stall of a few ms
# K4's dequant epilogue against its plain version: the same fp32 operations,
# each rounded once, then one rounding to bf16, so within one bf16 step
# (2^-8 of |plain|) at every element; its int32 accumulator is exact
BF16_STEP = 2.0**-8
# (M, K, N) of the quantised matmuls at 1024 px, batch 1 (CFG 2): image rows
# against the qkv/out, FF proj_in and FF proj_out weights, then text rows;
# then the same at batch 2 (CFG 4), which the second W8A8 request runs; the
# first FF proj_in shape is the one in the kernels line
_GEMM_KN = [(1536, 1536), (1536, 6144), (6144, 1536)]
GEMM_SHAPES = [(m, k, n) for m in (8192, 666, 16384, 1332) for k, n in _GEMM_KN]
TIMED_GEMM = (8192, 1536, 6144)
# SD3.5-large's W8A8 matmuls at 1024 px, batch 1 (CFG 2): image rows then
# text rows against the qkv/out (2432 x 2432), FF proj_in and FF proj_out
# weights; the FF proj_in shape is the one in the kernels line
SD35_LARGE_GEMM_SHAPES = [(m, k, n) for m in (8192, 666)
                          for k, n in ((2432, 2432), (2432, 9728), (9728, 2432))]
SD35_LARGE_TIMED_GEMM = (8192, 2432, 9728)
# a quantised 24-layer forward against the bf16 one, mean |dv| / mean |v|:
# int8 within the JAX package's bound (tests/test_mmdit.py:153); int4 only
# within an order one, since N(0, 0.02^2) weights are int4's worst case
# (about 12 % weight error a matmul) and the bit-exact and reference checks
# hold the kernels and layouts
QUANT_REL_BOUND = {8: 0.15, 4: 1.0}
# RLOO training (phase 11): the paper's learning rate; update 1 replays the
# rollout's own policy, so its ratio is one up to the TPM's bf16 rounding
# at micro-batch 2 against the rollout's batch 4 (the JAX trainer's own
# invariant, tests/test_rloo.py:218-224); Adam moves a parameter by at
# most about lr a step (|m_hat| / sqrt(v_hat) <= 1 up to the bias
# corrections), so 1.5 lr a step bounds it
RLOO_LR = 1e-6
RATIO_TOL = 1e-2
ADAM_STEP_FACTOR = 1.5
# recompute replay against cached replay, per valid step: the backbone
# re-runs at CFG batch 4 where the rollout ran 8, so its bf16 activations
# could round apart, yet on the H100 both readings so far were 0 (the
# kernels and GEMMs give batch-independent rows). The bound stays well under
# the 7e-3 that one Adam step at lr 1e-6 moves the log-probs, so a replay
# fed the wrong activations cannot pass as one that rounds apart
RECOMPUTE_LP_TOL = 1e-3
N_IMG_2048 = 16384  # 2048 px: 256 x 256 latents, 128 x 128 tokens
N_VAE_2048 = 65536  # 2048 px: the VAE mid block's 256 x 256 tokens
# 512 px (phase 14's engine): 32 x 32 image tokens + 333 text tokens, the
# joint sequence padded to a multiple of 128; the VAE mid block's 64 x 64
N_TOK_512 = 1024 + N_CTX
N_JOINT_512 = N_TOK_512 + (-N_TOK_512 % 128)
N_VAE_512 = 4096
SERVE_EXTRA_PX = 512  # phase 14's engine serves this resolution beside 1024 px
# phase 17: the bf16 encode against an fp32 encode of the same weights,
# mean |dz| / mean |z| of the model-space latents (the bf16 decode's CPU
# test bound, tests/test_torch_vae.py)
ENCODE_REL_BOUND = 5e-2
I2I_STRENGTHS = (0.4, 0.8)  # phase 17's per-sample strengths
CONT_REQUESTS = 12  # phase 15's burst: example prompts 0-11, seeds 0-11
CONT_CAPS = (None, 4, None, 8)  # its step caps, in turn (the schedule stops at ~15)
# phase 18, SD1.5 at 512 px: the sampler's step cap (the JAX agent's
# default), CFG 7.5, img2img strength, the engine batch's caps, and K1's
# shapes (8 heads of C/8: each level's self-attention and its
# cross-attention against the 77 CLIP tokens) at each CFG batch the
# phase runs: 2 (a batch-1 request, img2img, the checked forward), 4 (the
# batch-2 request, the timed batch-2 forward) and 8 (the engine's batch
# padded to 4), by the kernels line's key (CFG batch 2 without a suffix)
SD15_T_MAX = 25
SD15_GS = 7.5
SD15_STRENGTH = 0.6
SD15_ENGINE_CAPS = (None, 3, 6)
_SD15_LEVELS = (("d40", 4096, 40), ("d80", 1024, 80), ("d160", 256, 160), ("mid", 64, 160))
SD15_K1_SHAPES = {
    f"sd15_{level}_{kind}{'' if b == 2 else f'_batch_{b}'}":
        (b, 8, n, n if kind == "self" else 77, d)
    for b in (2, 4, 8) for level, n, d in _SD15_LEVELS for kind in ("self", "cross")
}
# the wgmma kernels' instantiations, each by a piece of its mangled name
# (template arguments between I and E: Lb0 / Lb1 kStats off / on; 'a'
# int8_t, then the epilogue: Li0 bf16 rounding, Li1 dequant, Li2 int32;
# K2's kernel is not a template: E closes its name)
# K1 and K3 are flash_attn_sm90_kernel<stats, consumers, 64-column boxes>:
# K1 at d 64 and d 40 share one instantiation (the head dim is the tensor
# maps' extent), as do d 80 and d 128; d 160 has its own
WGMMA_KERNELS = (
    ("K1", "flash_attn_sm90_kernelILb0ELi3ELi1E"),
    ("K1 d80/d128", "flash_attn_sm90_kernelILb0ELi2ELi2E"),
    ("K1 d160", "flash_attn_sm90_kernelILb0ELi1ELi3E"),
    ("K2", "flash_attn_d512_kernelE"),
    ("K3", "flash_attn_sm90_kernelILb1ELi3ELi1E"),
    ("K4", "gemm_sm90_kernelIaLi1E"),
    ("K4 int32", "gemm_sm90_kernelIaLi2E"),
    ("K5", "gemm_sm90_kernelI13__nv_bfloat16Li0E"),
)
# K6-K9, one template in attn_studies_sm90.cu: its arguments are q^T, K^T,
# V^T (booleans), the kind (an int: 0 K6's online softmax, 1 K8's int8
# QK^T, 2 K7's max-free softmax, 3 K9 qk_only, 4 K9 noexp) and two streams
_STUDIES_FORMS = (
    [("K6", qt, kt, vt, 0, two) for qt in (0, 1) for kt in (0, 1) for vt in (0, 1)
     for two in (0, 1)]
    + [("K8", 0, 0, vt, 1, 0) for vt in (0, 1)]
    + [("K7", qt, 0, vt, 2, 0) for qt, vt in ((0, 0), (0, 1), (1, 1))]
    + [(f"K9 {mode}", 0, kt, 0, kind, 0) for kind, mode in ((3, "qk_only"), (4, "noexp"))
       for kt in (0, 1)]
)
STUDIES_KERNELS = tuple(
    (f"{name} {'q^T' if qt else 'q'}/{'K^T' if kt else 'K'}/{'V^T' if vt else 'V'}"
     f"{' two streams' if two else ''}",
     f"studies_sm90_kernelILb{qt}ELb{kt}ELb{vt}ELi{kind}ELb{two}E")
    for name, qt, kt, vt, kind, two in _STUDIES_FORMS)
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "HMMA", "IMMA")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def attention_bound(bh, n_q, n_kv, d, kv_len=None, stats=False):
    """(bound_ms, bound_by) of one attention call: 4*bh*n_q*kv_len*d
    operations (the masked columns need none) against q, the valid rows of
    k and v, o (and m, l) moved once."""
    n_valid = n_kv if kv_len is None else kv_len
    flops = 4 * bh * n_q * n_valid * d
    nbytes = 2 * bh * d * (2 * n_q + 2 * n_valid) + (8 * bh * n_q if stats else 0)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gemm_bound(m, k, n, operand_bytes, out_bytes, peak, extra_bytes=0):
    """(bound_ms, bound_by) of an (M, K) x (K, N) product: 2MNK operations
    over ``peak``, against both operands read once, the output written once
    and ``extra_bytes`` (scales, bias) moved once."""
    t_ops = 2 * m * n * k / peak
    t_bytes = (operand_bytes * (m * k + n * k) + out_bytes * m * n + extra_bytes) / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rel_to_range(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def rel_rms(got, ref):
    ref = ref.float()
    return (torch.linalg.vector_norm(got.float() - ref) / torch.linalg.vector_norm(ref)).item()


def output_error(name, out, ref):
    """(max abs error, its share of max |ref|, mean |ref|) of a kernel's
    bf16 output against its plain version; fails beyond KERNEL_REL_TOL."""
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not (bool(torch.isfinite(out.float()).all()) and err <= KERNEL_REL_TOL * scale):
        fail(f"{name} disagrees with its plain version: max abs err {err}, "
             f"max |plain| {scale} (bound {KERNEL_REL_TOL} of it)")
    return err, err / scale, ref.abs().mean().item()


def fmt_err(err):
    """'max abs err E (R of max |o|, typical |o| T)' for output_error's triple."""
    return f"max abs err {err[0]:.3e} ({err[1]:.3e} of max |o|, typical |o| {err[2]:.3e})"


def check_k3(name, q, k, v, kv_len, rows=None):
    """K3 against attention_reference_stats on the same inputs; with
    ``rows`` (an index of query rows) the plain version runs on those rows
    only (rows are independent; the full one would not fit in memory).
    Returns output_error's triple for o and the max abs error on
    log2(l) + m."""
    from tpdm_tpu_torch.ops.attention import attention_reference_stats, flash_attention_with_stats

    o, m, l = flash_attention_with_stats(q, k, v, kv_len)
    q_ref = q if rows is None else q.index_select(2, rows)
    o_ref, m_ref, l_ref = attention_reference_stats(q_ref, k, v, kv_len)
    if rows is not None:
        o, m, l = (x.index_select(2, rows) for x in (o, m, l))
    torch.cuda.synchronize()
    o_err = output_error(name, o, o_ref)
    lse, lse_ref = torch.log2(l) + m, torch.log2(l_ref) + m_ref
    lse_err = (lse - lse_ref).abs().max().item()
    if not (bool(torch.isfinite(lse).all())
            and torch.allclose(lse, lse_ref, atol=LSE_ATOL, rtol=LSE_RTOL)):
        fail(f"{name} disagrees with its plain version: max abs err log2(l)+m {lse_err}")
    return o_err, lse_err


def block_error(name, out, ref):
    """The largest share, over the 64-column blocks of the head, of a
    block's max abs error in its own max |ref|; fails beyond KERNEL_REL_TOL.
    (K2's 512 columns are eight TMA boxes: a wrong stride between them would
    spoil whole blocks and could hide behind one global maximum.)"""
    err = (out.float() - ref.float()).abs().flatten(0, -2).amax(0).view(-1, 64).amax(1)
    share = err / ref.float().abs().flatten(0, -2).amax(0).view(-1, 64).amax(1)
    if not bool((share <= KERNEL_REL_TOL).all()):
        fail(f"{name} disagrees with its plain version in a 64-column block: max abs err over "
             f"max |plain| of each block {[round(x, 4) for x in share.tolist()]}")
    return share.max().item()


def blocked_reference(q, k, v, kv_len=None, rows=4096):
    """attention_reference over blocks of ``rows`` query rows (rows are
    independent), where the whole fp32 score matrix would not fit: K2 at
    2048 px, K1 at the RLOO rollout's CFG batch."""
    from tpdm_tpu_torch.ops.attention import attention_reference

    return torch.cat([attention_reference(q[:, :, i:i + rows], k, v, kv_len)
                      for i in range(0, q.shape[2], rows)], dim=2)


def check_kernel(name, kernel, plain, q, k, v, kv_len):
    out = kernel(q, k, v, kv_len)
    ref = plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    return output_error(name, out, ref)


def trace_device_events(fn, calls, attempts=3):
    """The device events (name, start us, end us) of ``calls`` calls of
    fn() under torch.profiler, read from its Chrome trace; [] if none of
    ``attempts`` sessions recorded one (a session on the card now and then
    records no device event, after others in the same process did)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = trace_kernels(path)
        if events:
            return events
    return []


def device_ms(fn, calls=20, reps=5, attempts=4):
    """fn()'s device time a call: ``calls`` warm calls queued behind a
    torch.cuda._sleep that outlasts the host's launches, then timed between
    CUDA events, so the card runs them back to back without waiting on the
    host (the kernels' own time and the gaps between them); the median of
    ``reps``. The sleep is four times the host's time to queue the calls,
    at least MIN_SLEEP_MS. A rep whose sleep ended before its calls were
    queued (the host stalled: it shares its cores) would time the host, so
    it is dropped and taken again behind a sleep four times that queue time;
    fails if ``attempts`` reps in a row are dropped."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    sleep_ms = max(4e3 * (time.perf_counter() - start), MIN_SLEEP_MS)
    torch.cuda.synchronize()
    times, dropped = [], 0
    while len(times) < reps:
        before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        before.record()
        torch.cuda._sleep(int(sleep_ms * SLEEP_CYCLES_PER_MS))
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        end.synchronize()
        slept_ms = before.elapsed_time(start)
        if slept_ms > queued_ms:
            times.append(start.elapsed_time(end) / calls)
            dropped = 0
            continue
        dropped += 1
        if dropped == attempts:
            fail(f"device_ms: in {attempts} reps in a row the card slept less than the host took "
                 f"to queue {calls} calls (last: slept {slept_ms:.3f} ms, queued {queued_ms:.3f} ms)")
        sleep_ms = max(sleep_ms, 4 * queued_ms)
    return statistics.median(times)


def timed_ms(fn, target_ms=2.0, reps=10):
    """median_ms over back-to-back calls between one pair of CUDA events,
    as many (1 to 50) as take about ``target_ms``: the median time a call,
    in which a short kernel's launch overlaps the one before it."""
    calls = max(1, min(50, round(target_ms / median_ms(fn, reps=3))))
    return median_ms(fn, reps=reps, calls=calls)


def k1_check(g, dev, label, b, h, n_q, n_kv, d, kv_len=None):
    """K1 at q (b, h, n_q, d) x kv (b, h, n_kv, d), N(0, 1) bf16 drawn from
    ``g`` (q, k, v in turn), against its plain version (KERNEL_REL_TOL),
    timed (timed_ms) beside the plain version and
    scaled_dot_product_attention on the valid kv rows, and by its and the
    library call's device time (device_ms). Prints one line; returns the
    kernels line's entry."""
    from tpdm_tpu_torch.ops.attention import attention_reference, flash_attention
    from torch.nn.functional import scaled_dot_product_attention

    q = torch.randn(b, h, n_q, d, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, h, n_kv, d, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    err = check_kernel(f"K1 {label}", flash_attention, attention_reference, q, k, v, kv_len)
    n_valid = n_kv if kv_len is None else kv_len
    kernel = lambda: flash_attention(q, k, v, kv_len)
    library = lambda: scaled_dot_product_attention(q, k[:, :, :n_valid], v[:, :, :n_valid])
    ms, lib_ms = timed_ms(kernel), timed_ms(library)
    plain_ms = timed_ms(lambda: attention_reference(q, k, v, kv_len))
    dev_ms, lib_dev_ms = device_ms(kernel), device_ms(library)
    bound, by = attention_bound(b * h, n_q, n_kv, d, kv_len)
    flop = 4 * b * h * n_q * n_valid * d
    phase("K1", f"{label} ({b}, {h}, {n_q}, {d}) x kv {n_kv}"
                f"{'' if kv_len is None else f' kv_len {kv_len}'} bf16: {fmt_err(err)} (bound "
                f"{KERNEL_REL_TOL} of max |o|); kernel {ms:.4f} ms a call back to back, "
                f"{flop / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.1f} % of bound (device time "
                f"{dev_ms:.4f} ms, {100 * bound / dev_ms:.1f} %); plain {plain_ms:.4f} ms, "
                f"scaled_dot_product_attention {lib_ms:.4f} ms (device time {lib_dev_ms:.4f}), "
                f"bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=err[0], ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, device_ms=dev_ms, library_device_ms=lib_dev_ms)


def launch_counter(prefix, totals):
    """counted(label, fn, want): fn() between synchronizes on the host
    clock, K1's and K2's launch counts set to 0 just before and read just
    after, added to ``totals`` and checked against ``want(out)`` (unless
    None); returns (out, seconds)."""
    from tpdm_tpu_torch.ops.attention import flash_attention, flash_attention_streaming

    def counted(label, fn, want):
        torch.cuda.synchronize()
        flash_attention.launches = flash_attention_streaming.launches = 0
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        got = (flash_attention.launches, flash_attention_streaming.launches)
        totals[0] += got[0]
        totals[1] += got[1]
        if want is not None and got != want(out):
            fail(f"{prefix} {label}: K1 {got[0]}, K2 {got[1]} launches, expected K1 "
                 f"{want(out)[0]}, K2 {want(out)[1]}")
        return out, seconds

    return counted


def load_profile_script():
    """scripts/profile_torch_generate.py as a module (group_of, summarise);
    its chip_smoke imports resolve to this module, not to a second copy."""
    import importlib.util

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    spec = importlib.util.spec_from_file_location(
        "profile_torch_generate", REPO / "scripts" / "profile_torch_generate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ptxas_report(kernel):
    """(registers, spill store bytes, spill load bytes) that ptxas reported
    for the entry whose mangled name holds ``kernel``, read from the
    build's log (the count is the one at launch, before setmaxnreg), or
    None where the log has no such entry."""
    from tpdm_tpu_torch.ops import _build

    lines = (_build.BUILD_DIR / "build.log").read_text().splitlines()
    starts = [i for i, line in enumerate(lines)
              if "Compiling entry function" in line and kernel in line]
    if not starts:
        return None
    regs = spills = None
    for line in lines[starts[0] + 1:]:
        if "Compiling entry function" in line:
            break
        regs = regs or re.search(r"Used (\d+) registers", line)
        spills = spills or re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    if regs is None or spills is None:
        return None
    return int(regs.group(1)), int(spills.group(1)), int(spills.group(2))


def sass_report(lib_path, kernels):
    """{kernel: {op: count} for SASS_OPS} in the built library's SASS
    (cuobjdump, beside nvcc), summed over the functions whose mangled name
    holds ``kernel``; None without cuobjdump."""
    from tpdm_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split("\n", 1)[0]
        for kernel in kernels:
            if kernel in name:
                found = counts.setdefault(kernel, dict.fromkeys(SASS_OPS, 0))
                for op in SASS_OPS:
                    found[op] += len(re.findall(rf"\b{op}\b", section))
    return counts


def wgmma_phase(lib_path):
    """Phase 2's checks of the wgmma kernels: each instantiation's ptxas
    registers and spills, and its wgmma, TMA and mma.sync instructions in
    the SASS. Fails on a spill, on an instantiation without wgmma or TMA
    loads, or on one with mma.sync."""
    groups = (("ptxas", "sass", WGMMA_KERNELS), ("ptxas K6-K9", "sass K6-K9", STUDIES_KERNELS))
    sass = sass_report(lib_path, [key for *_, kernels in groups for _, key in kernels])
    if sass is None:
        fail("cuobjdump not found beside nvcc: the wgmma kernels' SASS cannot be read")
    for ptxas_name, sass_name, kernels in groups:
        regs = {key: ptxas_report(key) for _, key in kernels}
        phase(ptxas_name, "; ".join(
            f"{label}: " + ("not in build.log" if regs[key] is None else
                            f"{regs[key][0]} registers, {regs[key][1]} bytes spill stores, "
                            f"{regs[key][2]} bytes spill loads")
            for label, key in kernels))
        phase(sass_name, "; ".join(
            f"{label}: " + ("not found" if key not in sass else
                            ", ".join(f"{sass[key][op]} {op}" for op in SASS_OPS))
            for label, key in kernels))
        for label, key in kernels:
            if regs[key] is None or regs[key][1] or regs[key][2]:
                fail(f"{label} ({key}): ptxas reports a spill, or no report: {regs[key]}")
            ops = sass.get(key)
            if (ops is None or ops["HGMMA"] + ops["IGMMA"] == 0 or ops["UTMALDG"] == 0
                    or ops["HMMA"] + ops["IMMA"]):
                fail(f"{label} ({key}): no wgmma, no TMA load, or mma.sync in its SASS: {ops}")


def kernel_phase(g, dev, seed):
    """Phase 3: K1 and K2 against their plain versions at the 1024 px
    path's shapes and the RLOO training's (K2 also at 2048 px's), with
    their times, bounds and PyTorch's own call."""
    from tpdm_tpu_torch.ops.attention import (
        attention_reference,
        flash_attention,
        flash_attention_streaming,
    )
    from torch.nn.functional import scaled_dot_product_attention

    rand = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    n_joint = 4480  # 4096 image + 333 text tokens, padded to a multiple of 128
    q, k, v = (rand(2, 24, n_joint, 64) for _ in range(3))
    k1_err = check_kernel("K1", flash_attention, attention_reference, q, k, v, 4429)
    qn, kn = q.clone(), k.clone()
    qn[..., 0] += 12.0
    kn[..., 0] = -80.0  # every valid score ~ -120: the mask must act as -inf
    k1n_err = check_kernel("K1 (strongly negative)", flash_attention,
                           attention_reference, qn, kn, v, 4429)
    k1_ms = median_ms(lambda: flash_attention(q, k, v, 4429))
    k1_plain_ms = median_ms(lambda: attention_reference(q, k, v, 4429))
    # PyTorch's flash attention takes no mask: the same function is the call
    # on the valid kv rows (views, no copy)
    k_v, v_v = k[:, :, :4429], v[:, :, :4429]
    k1_lib_ms = median_ms(lambda: scaled_dot_product_attention(q, k_v, v_v))
    k1_bound, k1_by = attention_bound(48, n_joint, n_joint, 64, 4429)
    k1_flop = 4 * 48 * n_joint * 4429 * 64
    phase("K1", f"(2, 24, 4480, 64) bf16 kv_len 4429: {fmt_err(k1_err)}; strongly negative "
                f"{fmt_err(k1n_err)} (bound {KERNEL_REL_TOL} of max |o|); kernel "
                f"{k1_ms:.3f} ms, {k1_flop / k1_ms / 1e9:.1f} TFLOP/s, "
                f"{100 * k1_bound / k1_ms:.1f} % of bound; plain {k1_plain_ms:.3f} ms, "
                f"scaled_dot_product_attention {k1_lib_ms:.3f} ms, bound {k1_bound:.3f} ms "
                f"({k1_by})")
    del q, k, v, qn, kn, k_v, v_v
    # K1 at the RLOO training's shapes: the rollout's CFG batch 8 and the
    # recompute replay's 4 (2 samples a micro-batch); then batch 1, the
    # conditional-only forward outside a guidance window (phase 12), and
    # batch 20, the CFG batch of phase 13's eval of 10 prompts. They
    # draw from a generator of their own, so every later phase keeps its
    # inputs; the plain version runs over 1120-row query blocks (its fp32
    # scores would take 15 GB at batch 8)
    k1_train = {}
    g_k1 = torch.Generator(device=dev).manual_seed(seed + 8)
    for b in (8, 4, 1, 20):
        q, k, v = (torch.randn(b, 24, n_joint, 64, generator=g_k1, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        plain = lambda q, k, v, kv_len: blocked_reference(q, k, v, kv_len, rows=1120)
        err = check_kernel(f"K1 ({b}, 24, {n_joint}, 64)", flash_attention, plain, q, k, v, 4429)
        ms = median_ms(lambda: flash_attention(q, k, v, 4429))
        plain_ms = median_ms(lambda: plain(q, k, v, 4429), reps=3)
        lib_ms = median_ms(lambda: scaled_dot_product_attention(q, k[:, :, :4429],
                                                                v[:, :, :4429]))
        bound, by = attention_bound(24 * b, n_joint, n_joint, 64, 4429)
        phase("K1", f"({b}, 24, {n_joint}, 64) bf16 kv_len 4429: {fmt_err(err)} (bound "
                    f"{KERNEL_REL_TOL} of max |o|); kernel {ms:.3f} ms, "
                    f"{4 * 24 * b * n_joint * 4429 * 64 / ms / 1e9:.1f} TFLOP/s, "
                    f"{100 * bound / ms:.1f} % of bound; plain {plain_ms:.3f} ms (1120-row "
                    f"query blocks), scaled_dot_product_attention {lib_ms:.3f} ms, bound "
                    f"{bound:.3f} ms ({by})")
        k1_train[b] = dict(max_abs_err=err[0], ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by, library_ms=lib_ms)
        del q, k, v
        torch.cuda.empty_cache()
    # K1 at phase 14's 512 px request: 1024 image + 333 text tokens padded
    # to 1408, at the engine's CFG batch 4, from a generator of its own
    g_512 = torch.Generator(device=dev).manual_seed(seed + 9)
    q, k, v = (torch.randn(4, 24, N_JOINT_512, 64, generator=g_512, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    err = check_kernel(f"K1 (4, 24, {N_JOINT_512}, 64)", flash_attention, attention_reference,
                       q, k, v, N_TOK_512)
    ms = median_ms(lambda: flash_attention(q, k, v, N_TOK_512))
    plain_ms = median_ms(lambda: attention_reference(q, k, v, N_TOK_512))
    lib_ms = median_ms(lambda: scaled_dot_product_attention(q, k[:, :, :N_TOK_512],
                                                            v[:, :, :N_TOK_512]))
    bound, by = attention_bound(96, N_JOINT_512, N_JOINT_512, 64, N_TOK_512)
    phase("K1", f"(4, 24, {N_JOINT_512}, 64) bf16 kv_len {N_TOK_512} (512 px, CFG batch 4): "
                f"{fmt_err(err)} (bound {KERNEL_REL_TOL} of max |o|); kernel {ms:.3f} ms, "
                f"{4 * 96 * N_JOINT_512 * N_TOK_512 * 64 / ms / 1e9:.1f} TFLOP/s, "
                f"{100 * bound / ms:.1f} % of bound; plain {plain_ms:.3f} ms, "
                f"scaled_dot_product_attention {lib_ms:.3f} ms, bound {bound:.3f} ms ({by})")
    k1_train["512px"] = dict(max_abs_err=err[0], ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by, library_ms=lib_ms)
    del q, k, v
    # K2 at the decode's shapes: 1024 px at batch 1 (the kernels line), 2
    # and 4 (the RLOO reward's decode), 10 (phase 13's eval decode),
    # 2048 px, and 512 px at batch 2 (phase 14's engine), 1 (phase 15's
    # router, which decodes a finished slot alone) and 4 (phase 18's engine
    # batch, SD1.5's VAE: the same shape); at 2048 px and
    # batch 10 the plain version runs over 4096-row query blocks (its fp32
    # scores would take 11 and 17 GB).
    # All but the first draw from a generator of their own, so every later
    # phase keeps the inputs that it had before they were added
    k2 = {}
    g_k2 = torch.Generator(device=dev).manual_seed(seed + 7)
    for b, n in ((1, 16384), (2, 16384), (1, N_VAE_2048), (4, 16384), (10, 16384),
                 (2, N_VAE_512), (1, N_VAE_512), (4, N_VAE_512)):
        gen = g if (b, n) == (1, 16384) else g_k2
        q, k, v = (torch.randn(b, 1, n, 512, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        # else the plain version's fp32 scores take 10+ GB
        whole = (n == 16384 and b <= 4) or n == N_VAE_512
        plain = attention_reference if whole else blocked_reference
        out, ref = flash_attention_streaming(q, k, v), plain(q, k, v)
        torch.cuda.synchronize()
        err = output_error(f"K2 ({b}, 1, {n}, 512)", out, ref)
        block = block_error(f"K2 ({b}, 1, {n}, 512)", out, ref)
        del out, ref
        reps = 10 if whole else 3
        ms = median_ms(lambda: flash_attention_streaming(q, k, v))
        plain_ms = median_ms(lambda: plain(q, k, v), reps=reps)
        lib_ms = median_ms(lambda: scaled_dot_product_attention(q, k, v), reps=reps)
        bound, by = attention_bound(b, n, n, 512)
        phase("K2", f"({b}, 1, {n}, 512) bf16: {fmt_err(err)}; worst 64-column block "
                    f"{block:.3e} of its max |o| (bound {KERNEL_REL_TOL}); kernel {ms:.3f} ms, "
                    f"{4 * b * n * n * 512 / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.1f} % of "
                    f"bound; plain {plain_ms:.3f} ms"
                    f"{'' if whole else ' (4096-row query blocks)'}, "
                    f"scaled_dot_product_attention {lib_ms:.3f} ms, bound {bound:.3f} ms ({by})")
        k2[(b, n)] = dict(max_abs_err=err[0], ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, library_ms=lib_ms)
        if (b, n) == (1, 16384):
            # every valid score ~ -120 (34 * -80 / sqrt(512)), kv_len < n_kv
            qn, kn = q.clone(), k.clone()
            qn[..., 0] += 34.0
            kn[..., 0] = -80.0
            neg = check_kernel("K2 (strongly negative)", flash_attention_streaming,
                               attention_reference, qn, kn, v, 16000)
            phase("K2", f"(1, 1, 16384, 512) bf16 kv_len 16000, every valid score ~ -120: "
                        f"{fmt_err(neg)} (bound {KERNEL_REL_TOL} of max |o|)")
            k2[(b, n)]["max_abs_err"] = max(err[0], neg[0])
            del qn, kn
        del q, k, v
        torch.cuda.empty_cache()
    return {
        "K1": dict(max_abs_err=max(k1_err[0], k1n_err[0]), ms=k1_ms, plain_ms=k1_plain_ms,
                   bound_ms=k1_bound, bound_by=k1_by, library_ms=k1_lib_ms,
                   batch_8=k1_train[8], batch_4=k1_train[4], batch_1=k1_train[1],
                   batch_20=k1_train[20], at_512px=k1_train["512px"]),
        "K2": dict(**k2[(1, 16384)], batch_2=k2[(2, 16384)], at_2048px=k2[(1, N_VAE_2048)],
                   batch_4=k2[(4, 16384)], batch_10=k2[(10, 16384)],
                   at_512px=k2[(2, N_VAE_512)], at_512px_batch_1=k2[(1, N_VAE_512)],
                   at_512px_batch_4=k2[(4, N_VAE_512)]),
    }


def gemm_phase(g, dev):
    """Phase 3, the GEMMs: K4 (both epilogues) and K5 against their plain
    versions at every quantised matmul shape of the 1024 px path, with
    their times, bounds and PyTorch's own products on the same operands
    (torch._int_mm and torch.matmul in bf16, both on b_t.t())."""
    from tpdm_tpu_torch.ops.gemm import bf16_gemm, bf16_gemm_reference

    res = {}
    k4_err = k5_err = 0.0
    for m, k, n in GEMM_SHAPES:
        k4, k4_text = k4_check(g, dev, m, k, n)
        k4_err = max(k4_err, k4["max_abs_err"])
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device=dev) * WEIGHT_STD).to(torch.bfloat16)
        k5 = output_error(f"K5 ({m}, {k}) x ({n}, {k})", bf16_gemm(x, w), bf16_gemm_reference(x, w))
        k5_err = max(k5_err, k5[0])
        times = dict(
            k5=median_ms(lambda: bf16_gemm(x, w)),
            k5_plain=median_ms(lambda: bf16_gemm_reference(x, w)),
            k5_lib=median_ms(lambda: torch.matmul(x, w.t())),
        )
        k5_bound = gemm_bound(m, k, n, 2, 2, PEAK_BF16_FLOPS)
        phase("K4/K5", f"{k4_text}; K5 {fmt_err(k5)}, {times['k5']:.4f} ms, plain "
              f"{times['k5_plain']:.4f} ms, torch.matmul {times['k5_lib']:.4f} ms, bound "
              f"{k5_bound[0]:.4f} ms ({k5_bound[1]}), {2 * m * n * k / times['k5'] / 1e9:.1f} "
              f"TFLOP/s, {100 * k5_bound[0] / times['k5']:.1f} % of bound")
        if (m, k, n) == TIMED_GEMM:
            res["K4"] = {key: v for key, v in k4.items() if key != "max_abs_err"}
            res["K5"] = dict(ms=times["k5"], plain_ms=times["k5_plain"], bound_ms=k5_bound[0],
                             bound_by=k5_bound[1], library_ms=times["k5_lib"])
        del x, w
    res["K4"]["max_abs_err"] = k4_err
    res["K5"]["max_abs_err"] = k5_err
    torch.cuda.empty_cache()
    return res


def k4_check(g, dev, m, k, n):
    """K4 (both epilogues) against its plain version on int8 operands of
    (m, k) x (n, k) drawn from ``g``, timed beside torch._int_mm. Returns
    (a kernels-line dict, the line's text)."""
    from tpdm_tpu_torch.ops.gemm import int8_gemm, int8_gemm_reference

    a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    b_t = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    acc, acc_ref = int8_gemm(a, b_t), int8_gemm_reference(a, b_t)
    lib_acc = torch._int_mm(a, b_t.t())
    torch.cuda.synchronize()
    if not torch.equal(acc, acc_ref):
        fail(f"K4 int32 ({m}, {k}) x ({n}, {k}) is not bit-identical to its plain version: "
             f"{int((acc != acc_ref).sum())} elements differ")
    lib_equal = torch.equal(lib_acc, acc_ref)
    del acc, acc_ref, lib_acc
    x_scale = torch.rand(m, generator=g, device=dev) * 1e-2 + 1e-3
    w_scale = torch.rand(n, generator=g, device=dev) * 1e-2 + 1e-3
    bias = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
    out = int8_gemm(a, b_t, x_scale, w_scale, bias)
    ref = int8_gemm_reference(a, b_t, x_scale, w_scale, bias).float()
    torch.cuda.synchronize()
    gap = (out.float() - ref).abs()
    if not (gap <= BF16_STEP * ref.abs()).all():
        fail(f"K4 dequant ({m}, {k}) x ({n}, {k}) is more than one bf16 step from its plain "
             f"version: max abs err {gap.max().item()}")
    err = gap.max().item()
    del out, ref, gap
    ms = median_ms(lambda: int8_gemm(a, b_t, x_scale, w_scale, bias))
    plain_ms = median_ms(lambda: int8_gemm_reference(a, b_t, x_scale, w_scale, bias))
    lib_ms = median_ms(lambda: torch._int_mm(a, b_t.t()))
    bound, by = gemm_bound(m, k, n, 1, 2, PEAK_INT8_OPS, extra_bytes=4 * m + 6 * n)
    text = (f"({m}, {k}) x ({n}, {k}): K4 int32 bit-identical (torch._int_mm "
            f"{'equal' if lib_equal else 'DIFFERS'}), dequant max abs err {err:.3e} (bound one "
            f"bf16 step), {ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({by}), {2 * m * n * k / ms / 1e9:.1f} TOP/s, "
            f"{100 * bound / ms:.1f} % of bound")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms), text


def sd35_kernel_phase(seed, dev):
    """Phase 3, SD3.5's shapes, from a generator of their own: K1 at
    SD3.5-medium's image-only attn2 without a kv_len, (2, 24, 4096, 64) and
    (4, 24, 4096, 64) (CFG batch 2 and 4: phase 16's requests at batch 1
    and 2), and at SD3.5-large's joint attention (2, 38, 4480, 64), kv_len
    4429 (CFG batch 2), and K4 at every W8A8 matmul shape of an SD3.5-large
    batch-1 request (K and N in {2432, 9728}; N 2432 ends in half a
    256-column tile). Returns the kernels line's entries."""
    g = torch.Generator(device=dev).manual_seed(seed + 16)
    out = {"K1": {}}
    for key, (b, h, n, kv_len), what in (
            ("sd35_attn2", (2, 24, 4096, None), "SD3.5-medium attn2"),
            ("sd35_attn2_batch_4", (4, 24, 4096, None), "SD3.5-medium attn2"),
            ("sd35_large", (2, 38, 4480, 4429), "SD3.5-large joint attention")):
        out["K1"][key] = k1_check(g, dev, f"{key} ({what})", b, h, n, n, 64, kv_len)
        torch.cuda.empty_cache()
    k4_err = 0.0
    for m, k, n in SD35_LARGE_GEMM_SHAPES:
        k4, text = k4_check(g, dev, m, k, n)
        phase("K4", f"{text} (SD3.5-large)")
        k4_err = max(k4_err, k4["max_abs_err"])
        if (m, k, n) == SD35_LARGE_TIMED_GEMM:
            out["K4"] = {"sd35_large": k4}
    out["K4"]["sd35_large"]["max_abs_err"] = k4_err
    torch.cuda.empty_cache()
    return out


def reference_phase(seed, dev):
    """Phase 4: card (bf16, kernels) vs CPU (fp32, plain versions)."""
    from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig
    from tpdm_tpu_torch.ops.attention import flash_attention
    from tpdm_tpu_torch.ops.gemm import bf16_gemm, int8_gemm
    from tpdm_tpu_torch.ops.quant import prequantize_

    rel_err = lambda card_out, cpu_out: rel_to_range(card_out.cpu(), cpu_out)
    cpu_gen = torch.Generator().manual_seed(seed)
    small = MMDiTConfig.sd3_medium(num_layers=2, num_attention_heads=4,
                                   caption_projection_dim=256, sample_size=16)
    m_cpu = MMDiT(small).init_weights(cpu_gen, WEIGHT_STD).to(torch.bfloat16).float()
    m_card = MMDiT(small).to(dev)
    m_card.load_state_dict(m_cpu.state_dict())
    m_card.to(torch.bfloat16)
    inputs = (torch.randn(2, 16, 16, 16, generator=cpu_gen), torch.tensor([1000.0, 420.0]),
              torch.randn(2, 77, 4096, generator=cpu_gen), torch.randn(2, 2048, generator=cpu_gen))
    with torch.no_grad():
        ref_out = m_cpu(*inputs)
        card_out = m_card(*(x.to(dev, torch.bfloat16) for x in inputs))
    mmdit_err = max(rel_err(c, r) for c, r in zip(card_out, ref_out))
    vcfg_small = VAEConfig.sd3(block_out_channels=(128, 512), layers_per_block=1)
    # the decoder alone: its weights and the draws after it stay as they were
    v_cpu = VAE(vcfg_small, encoder=False).init_weights(cpu_gen, WEIGHT_STD).to(
        torch.bfloat16).float()
    v_card = VAE(vcfg_small, encoder=False).to(dev)
    v_card.load_state_dict(v_cpu.state_dict())
    v_card.to(torch.bfloat16)
    z = torch.randn(1, 16, 16, 16, generator=cpu_gen)
    with torch.no_grad():
        vae_err = rel_err(v_card.decode(z.to(dev)), v_cpu.decode(z))
    # the quantised MMDiT: the same int weights on both sides (quantised
    # once from the bf16-rounded float weights), K4 / K5 on the card
    quant_errs = {}
    for bits, kernel in ((8, int8_gemm), (4, bf16_gemm)):
        qsmall = dataclasses.replace(small, quant_matmuls=True, quant_bits=bits)
        q_cpu = prequantize_(MMDiT(qsmall).init_weights(cpu_gen, WEIGHT_STD)
                             .to(torch.bfloat16).float())
        q_card = MMDiT(qsmall).to(dev)
        q_card.load_state_dict(q_cpu.state_dict())
        q_card.to(torch.bfloat16)
        before = kernel.launches
        with torch.no_grad():
            ref_out = q_cpu(*inputs)
            card_out = q_card(*(x.to(dev, torch.bfloat16) for x in inputs))
        if kernel.launches - before != 12 + 9:
            fail(f"the 2-layer int{bits} MMDiT launched its GEMM {kernel.launches - before} "
                 f"times, expected 21")
        quant_errs[bits] = max(rel_err(c, r) for c, r in zip(card_out, ref_out))
    phase("reference", f"2-layer MMDiT (4x64 heads, 64+77 tokens, kv_len mask) max rel err "
                       f"{mmdit_err:.3e}, W8A8 (K4) {quant_errs[8]:.3e}, int4 (K5) "
                       f"{quant_errs[4]:.3e}; VAE decoder with 512-wide mid block (256 tokens) "
                       f"max rel err {vae_err:.3e} (bound {MODULE_REL_TOL})")
    # SD3.5: dual attention in layer 0 (attn2 on K1 without a kv_len) and the
    # qk RMSNorm with scales drawn around 1; float, then W8A8 on K4 with
    # attn2 quantised (12 + 4 matmuls in layer 0, 9 in the last)
    sd35 = MMDiTConfig.sd35_medium(num_layers=2, num_attention_heads=4,
                                   caption_projection_dim=256, sample_size=16,
                                   dual_attention_layers=(0,))
    sd35_errs = {}
    for label, cfg in (("float", sd35), ("W8A8", dataclasses.replace(sd35, quant_matmuls=True))):
        m_cpu = MMDiT(cfg).init_weights(cpu_gen, WEIGHT_STD)
        with torch.no_grad():
            for name, param in m_cpu.named_parameters():
                if ".norm_" in name:
                    param.uniform_(0.8, 1.2, generator=cpu_gen)
        m_cpu = m_cpu.to(torch.bfloat16).float()
        if cfg.quant_matmuls:
            prequantize_(m_cpu)
        m_card = MMDiT(cfg).to(dev)
        m_card.load_state_dict(m_cpu.state_dict())
        m_card.to(torch.bfloat16)
        before = flash_attention.launches, int8_gemm.launches
        with torch.no_grad():
            ref_out = m_cpu(*inputs)
            card_out = m_card(*(x.to(dev, torch.bfloat16) for x in inputs))
        n = flash_attention.launches - before[0], int8_gemm.launches - before[1]
        if n != (3, 25 if cfg.quant_matmuls else 0):
            fail(f"the 2-layer SD3.5 MMDiT ({label}) launched K1 {n[0]}, K4 {n[1]} times, "
                 f"expected 3 and {25 if cfg.quant_matmuls else 0}")
        sd35_errs[label] = max(rel_err(c, r) for c, r in zip(card_out, ref_out))
    phase("reference", f"2-layer SD3.5 MMDiT (4x64 heads, dual attention in layer 0, qk "
                       f"RMSNorm, 384-wide sincos table) max rel err {sd35_errs['float']:.3e}, "
                       f"W8A8 (K4, attn2 quantised) {sd35_errs['W8A8']:.3e} (bound "
                       f"{MODULE_REL_TOL}); K1 3 launches a forward (2 joint + 1 attn2)")
    if not max(mmdit_err, vae_err, *quant_errs.values(), *sd35_errs.values()) < MODULE_REL_TOL:
        fail("the card's modules disagree with their CPU fp32 reference")


def build_models(dev, seed, mmdit_config):
    """The MMDiT of ``mmdit_config`` (SD3-medium's or SD3.5's), its TPM and
    the SD3 VAE decoder in bf16 with N(0, WEIGHT_STD²) weights from
    ``seed``, on ``dev``."""
    from tpdm_tpu_torch.models.mmdit import MMDiT
    from tpdm_tpu_torch.models.tpm import TimePredictor
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig

    gen = torch.Generator(device=dev).manual_seed(seed)
    width = mmdit_config.inner_dim
    with torch.device(dev):
        mmdit = MMDiT(mmdit_config)
        tpm = TimePredictor(conv_out_channels=128, in_channels=2 * width, temb_dim=width,
                            init_alpha=TPM_HEAD_BIAS[0], init_beta=TPM_HEAD_BIAS[1],
                            dtype=torch.bfloat16)
        vae = VAE(VAEConfig.sd3())
    for module in (mmdit, tpm, vae):
        module.init_weights(gen, WEIGHT_STD)
        module.to(device=dev, dtype=torch.bfloat16).eval()
    return mmdit, tpm, vae


def from_rank0(group, tensors):
    """Overwrite ``tensors`` on every rank of ``group`` with rank 0's, so no
    rank depends on its own card's random bits; nothing on a ring of 1."""
    import torch.distributed as dist

    if group.size > 1:
        for t in tensors:
            dist.broadcast(t, src=group.global_rank(0), group=group.group)


def seq_parallel_rank(rank, world, store, seed):
    """One rank's start: its seq group over the visible cards (NCCL, rank r
    on cuda:r, joined through the file ``store``) and build_models'
    SD3-medium modules, the MMDiT sequence-parallel over the group, with
    rank 0's weights on every rank. Returns (group, (mmdit, tpm, vae))."""
    sys.path.insert(0, str(REPO))
    from tpdm_tpu_torch.models.mmdit import MMDiTConfig
    from tpdm_tpu_torch.parallel import seq_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = seq_group("cuda", rank=rank, world_size=world, init_method=f"file://{store}")
    modules = build_models(group.device, seed, MMDiTConfig.sd3_medium(seq_group=group))
    for module in modules:
        from_rank0(group, module.state_dict().values())
    return group, modules


def timed_decoder(pipe, decode_s):
    """Wrap pipe's decode so it checks its input and output and records its
    seconds in decode_s["last"]."""

    def timed_decode(latents, _decode=pipe._decode_impl):
        if not torch.isfinite(latents).all():
            fail("non-finite latents reached the decoder")
        torch.cuda.synchronize()
        start = time.perf_counter()
        images = _decode(latents)
        torch.cuda.synchronize()
        decode_s["last"] = time.perf_counter() - start
        if not torch.isfinite(images).all():
            fail("non-finite decoder output")
        return images

    pipe._decode_impl = timed_decode


def check_schedule(res, b, px):
    """uint8 images of (b, px, px, 3) and strictly decreasing valid sigmas."""
    n = res.num_steps
    if res.images.dtype.name != "uint8" or res.images.shape != (b, px, px, 3):
        fail(f"images {res.images.dtype} {res.images.shape}, expected uint8 ({b}, {px}, {px}, 3)")
    if not 1 <= n <= T_MAX:
        fail(f"{n} steps, expected 1..{T_MAX}")
    for i in range(b):
        last = int(res.last_valid_index[i])
        sig = [1.0] + [float(s) for s in res.sigmas[i, : last + 1]]
        if last < 0 or not all(a > c for a, c in zip(sig, sig[1:])):
            fail(f"sample {i}: sigma not strictly decreasing over valid steps: {sig}")


def timed_request(pipe, dev, b, req_seed, counters):
    """One 1024 px request of batch b through ``pipe.generate`` (prompt
    embeds drawn from ``req_seed``), its schedule checked. Returns the
    result, its seconds and each counter's launches during it."""
    eg = torch.Generator(device=dev).manual_seed(req_seed)
    emb = lambda *shape: torch.randn(shape, generator=eg, device=dev, dtype=torch.bfloat16)
    pe, npe = emb(b, N_CTX, 4096), emb(b, N_CTX, 4096)
    pp, npp = emb(b, 2048), emb(b, 2048)
    before = [fn.launches for fn in counters]
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    start = time.perf_counter()
    res = pipe.generate(pe, pp, npe, npp, max_inference_steps=T_MAX, guidance_scale=7.0,
                        predict=True, seed=req_seed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check_schedule(res, b, 1024)
    return res, seconds, [fn.launches - n for fn, n in zip(counters, before)]


def slice_1024_phase(seed, dev):
    """Phase 5: two full-width 1024 px requests; returns the K1 and K2
    launches counted over them, the modules for phase 6, and each batch's
    (steps, seconds) for phase 12."""
    from tpdm_tpu_torch.models.mmdit import MMDiTConfig
    from tpdm_tpu_torch.ops.attention import flash_attention, flash_attention_streaming
    from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline

    t0 = time.perf_counter()
    mmdit, tpm, vae = build_models(dev, seed, MMDiTConfig.sd3_medium())
    n_params = sum(p.numel() for m in (mmdit, tpm, vae) for p in m.parameters())
    pipe = TPDMPipeline(mmdit, tpm, vae)
    torch.cuda.synchronize()
    phase("models", f"SD3-medium MMDiT + TPM + SD3 VAE decoder, {n_params / 1e9:.3f} B "
                    f"params bf16 on {dev}, weights N(0, {WEIGHT_STD}^2) from seed "
                    f"{seed}, TPM head bias {TPM_HEAD_BIAS}; "
                    f"{time.perf_counter() - t0:.1f} s")

    decode_s = {}
    timed_decoder(pipe, decode_s)
    flash_attention.launches = 0
    flash_attention_streaming.launches = 0
    adaptive = {}
    for request, (b, req_seed) in enumerate([(1, seed + 1), (2, seed + 2)]):
        res, seconds, (k1_n, k2_n) = timed_request(
            pipe, dev, b, req_seed, (flash_attention, flash_attention_streaming))
        n = res.num_steps
        adaptive[b] = (n, seconds)
        if k1_n != mmdit.config.num_layers * n:
            fail(f"K1 launched {k1_n} times in {n} steps, expected {mmdit.config.num_layers * n}")
        if k2_n < 1:
            fail("K2 was not launched by the decode")
        step_ms = 1000 * (seconds - decode_s["last"]) / n
        phase(f"request {request + 1}", f"batch {b}: {n} steps, sigmas "
              f"{[round(float(s), 5) for s in res.sigmas[0, :n]]}, {step_ms:.1f} ms/step "
              f"(CFG batch {2 * b}), decode {1000 * decode_s['last']:.1f} ms, "
              f"{seconds:.3f} s total, {seconds / b:.3f} s/image, K1 launches {k1_n}, "
              f"K2 launches {k2_n}, peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return (flash_attention.launches, flash_attention_streaming.launches, [mmdit, tpm, vae],
            adaptive)


def module_bytes(module):
    return sum(t.nbytes for t in (*module.parameters(), *module.buffers()))


def quantized_copy(mmdit, bits, dev):
    """A quant_matmuls copy of the bf16 ``mmdit`` on ``dev``, prequantised
    from its weights (W8A8 int8 at bits 8, int4 weight-only at bits 4)."""
    from tpdm_tpu_torch.models.mmdit import MMDiT
    from tpdm_tpu_torch.ops.quant import prequantize_

    with torch.device(dev):
        qm = MMDiT(dataclasses.replace(mmdit.config, quant_matmuls=True, quant_bits=bits))
    qm.to(device=dev, dtype=torch.bfloat16).eval()  # the sincos table is made on the CPU
    qm.load_state_dict(mmdit.state_dict())
    return prequantize_(qm)


def quant_phase(seed, dev, modules):
    """Phase 6: the quantised slice on phase 5's modules (``modules`` is
    emptied, so the bf16 MMDiT is freed once it is no longer needed).
    Returns the K4 and K5 launches counted over its requests."""
    from tpdm_tpu_torch.ops.attention import flash_attention
    from tpdm_tpu_torch.ops.gemm import bf16_gemm, int8_gemm
    from tpdm_tpu_torch.ops.quant import DenseMaybeQuant
    from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline

    mmdit, tpm, vae = modules
    modules.clear()
    cfg = mmdit.config
    t0 = time.perf_counter()
    quant = {bits: quantized_copy(mmdit, bits, dev) for bits in (8, 4)}
    torch.cuda.synchronize()
    n_quant = sum(isinstance(m, DenseMaybeQuant) for m in quant[8].modules())
    mb = lambda m: f"{module_bytes(m) / 1e9:.3f} GB"
    phase("quant models", f"prequantised from the bf16 MMDiT in {time.perf_counter() - t0:.1f} "
          f"s: {n_quant} quantised matmuls; MMDiT weights bf16 {mb(mmdit)}, W8A8 {mb(quant[8])}, "
          f"int4 {mb(quant[4])}")

    # one CFG-batch 1024 px forward of each against the bf16 forward
    eg = torch.Generator(device=dev).manual_seed(seed + 20)
    rand = lambda *shape: torch.randn(shape, generator=eg, device=dev, dtype=torch.bfloat16)
    inputs = (rand(2, 16, 128, 128), torch.tensor([1000.0, 420.0], device=dev, dtype=torch.bfloat16),
              rand(2, N_CTX, 4096), rand(2, 2048))
    gaps = {}
    with torch.no_grad():
        v_ref = mmdit(*inputs)[0].float()
        for bits, qm in quant.items():
            v = qm(*inputs)[0].float()
            if not bool(torch.isfinite(v).all()):
                fail(f"the int{bits} MMDiT forward gave non-finite values")
            gaps[bits] = ((v - v_ref).abs().mean() / v_ref.abs().mean()).item()
    phase("quant forward", f"SD3-medium 1024 px (CFG batch 2), mean |dv| / mean |v| against the "
          f"bf16 forward on the same weights: W8A8 {gaps[8]:.4e} (bound {QUANT_REL_BOUND[8]}), "
          f"int4 {gaps[4]:.4e} (bound {QUANT_REL_BOUND[4]})")
    for bits, gap in gaps.items():
        if not gap < QUANT_REL_BOUND[bits]:
            fail(f"the int{bits} forward is {gap} from the bf16 one (bound {QUANT_REL_BOUND[bits]})")
    del mmdit, v_ref, v
    quant[4].to("cpu")  # resident on the card only for its own request
    gc.collect()  # timed_decoder's closure holds phase 5's pipeline in a cycle
    torch.cuda.empty_cache()

    per_step = (cfg.num_layers - 1) * 12 + 9  # quantised matmuls a CFG-doubled step
    counters = (int8_gemm, bf16_gemm, flash_attention)
    decode_s = {}
    int8_gemm.launches = bf16_gemm.launches = 0
    for mode, bits, b, req_seed in (("W8A8", 8, 1, seed + 5), ("W8A8", 8, 2, seed + 6),
                                    ("int4", 4, 1, seed + 7)):
        if bits == 4 and quant[8] is not None:
            pipe = quant[8] = None  # the W8A8 model leaves the card first
            gc.collect()
            torch.cuda.empty_cache()
            quant[4].to(dev)
        pipe = TPDMPipeline(quant[bits], tpm, vae)
        timed_decoder(pipe, decode_s)
        res, seconds, (k4_n, k5_n, k1_n) = timed_request(pipe, dev, b, req_seed, counters)
        n = res.num_steps
        want = (per_step * n, 0) if bits == 8 else (0, per_step * n)
        if (k4_n, k5_n) != want or k1_n != cfg.num_layers * n:
            fail(f"{mode} request: K4 {k4_n}, K5 {k5_n}, K1 {k1_n} launches in {n} steps, "
                 f"expected K4 {want[0]}, K5 {want[1]}, K1 {cfg.num_layers * n}")
        step_ms = 1000 * (seconds - decode_s["last"]) / n
        phase(f"request {mode}", f"batch {b}: {n} steps, sigmas "
              f"{[round(float(s), 5) for s in res.sigmas[0, :n]]}, {step_ms:.1f} ms/step "
              f"(CFG batch {2 * b}), decode {1000 * decode_s['last']:.1f} ms, {seconds:.3f} s "
              f"total, {seconds / b:.3f} s/image, K4 launches {k4_n}, K5 launches {k5_n} "
              f"({per_step} a step), K1 launches {k1_n}, peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    totals = int8_gemm.launches, bf16_gemm.launches
    del quant, pipe, tpm, vae
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def k3_phase(g, dev, world):
    """Phase 7: K3 at the ring's per-rank shapes of 2048 px generation at
    batch 1 (CFG 2): a 4-way ring, a ring of one, and this machine's ring
    of ``world``."""
    from tpdm_tpu_torch.ops.attention import flash_attention_with_stats
    from tpdm_tpu_torch.ops.attention import attention_reference_stats

    rand = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    n_q4 = N_IMG_2048 // 4 + N_CTX  # rank 0 of 4: its image shard + the text queries
    q, k, v = rand(2, 24, n_q4, 64), rand(2, 24, 4096, 64), rand(2, 24, 4096, 64)
    kt, vt = rand(2, 24, 384, 64), rand(2, 24, 384, 64)
    # the text kv as the ring launches it (333 rows, no mask), and padded to
    # 384 rows with the pad masked
    kt0, vt0 = kt[:, :, :N_CTX].contiguous(), vt[:, :, :N_CTX].contiguous()
    o_err, lse_err = check_k3("K3 ring step", q, k, v, None)
    t_o_err, t_lse_err = check_k3("K3 text tokens", q, kt0, vt0, None)
    p_o_err, p_lse_err = check_k3("K3 text tokens, padded", q, kt, vt, N_CTX)
    qn, kn = q.clone(), kt.clone()
    qn[..., 0] += 12.0
    kn[..., 0] = -80.0  # every valid score ~ -120 against masked pad columns
    n_o_err, n_lse_err = check_k3("K3 (strongly negative)", qn, kn, vt, N_CTX)
    del qn, kn
    t_ms = median_ms(lambda: flash_attention_with_stats(q, kt0, vt0))
    t_bound, t_by = attention_bound(48, n_q4, N_CTX, 64, stats=True)
    ms = median_ms(lambda: flash_attention_with_stats(q, k, v))
    plain_ms = median_ms(lambda: attention_reference_stats(q, k, v))
    # PyTorch's flash attention returns the output and the natural-log
    # log-sum-exp, K3's function; its lse also checks K3's m and l
    lib = lambda: torch.ops.aten._scaled_dot_product_flash_attention(q, k, v)
    lib_ms = median_ms(lib)
    _, m, l = flash_attention_with_stats(q, k, v)
    lib_lse, lse = lib()[1], (torch.log2(l) + m) * math.log(2.0)
    lib_lse_err = (f"{(lib_lse - lse).abs().max().item():.3e}" if lib_lse.shape == lse.shape
                   else f"not compared, its shape is {tuple(lib_lse.shape)}")
    bound, bound_by = attention_bound(48, n_q4, 4096, 64, stats=True)
    phase("K3", f"q (2, 24, {n_q4}, 64) x kv (2, 24, 4096, 64) bf16: o {fmt_err(o_err)}, "
                f"log2(l)+m max abs err {lse_err:.3e}; x text kv (2, 24, {N_CTX}, 64): o "
                f"{fmt_err(t_o_err)}, log2(l)+m {t_lse_err:.3e}; x text kv (2, 24, 384, 64) "
                f"kv_len {N_CTX}: o {fmt_err(p_o_err)}, log2(l)+m {p_lse_err:.3e}; the same, "
                f"strongly negative: o {fmt_err(n_o_err)}, log2(l)+m {n_lse_err:.3e} (o bound "
                f"{KERNEL_REL_TOL} of max |o|, log2(l)+m atol {LSE_ATOL} rtol {LSE_RTOL}); "
                f"kernel {ms:.3f} ms, {4 * 48 * n_q4 * 4096 * 64 / ms / 1e9:.1f} TFLOP/s, "
                f"{100 * bound / ms:.1f} % of bound, plain {plain_ms:.3f} ms, "
                f"_scaled_dot_product_flash_attention {lib_ms:.3f} ms (its lse vs K3's: max abs "
                f"{lib_lse_err}), bound {bound:.3f} ms ({bound_by}); x text kv (2, 24, {N_CTX}, "
                f"64): kernel {t_ms:.3f} ms, bound {t_bound:.3f} ms ({t_by})")
    del q, k, v, kt, vt, kt0, vt0, m, l, lib_lse, lse
    errs = [o_err, t_o_err, p_o_err, n_o_err]
    # a ring of one (one card at 2048 px): all 16717 queries against the
    # whole image kv and the text kv, the plain version on a subset of the
    # query rows (the full one's fp32 scores would not fit the card); the
    # ring of this machine too where it is another size
    ring1 = {}
    for size in sorted({1, world} - {4}):
        n_local = N_IMG_2048 // size
        q = rand(2, 24, n_local + N_CTX, 64)
        k, v = rand(2, 24, n_local, 64), rand(2, 24, n_local, 64)
        kt, vt = rand(2, 24, N_CTX, 64), rand(2, 24, N_CTX, 64)
        rows = torch.cat([torch.arange(1024), torch.arange(n_local, n_local + N_CTX)]).to(dev)
        w_o_err, w_lse_err = check_k3(f"K3 ring of {size}", q, k, v, None, rows)
        wt_o_err, wt_lse_err = check_k3(f"K3 ring of {size}, text", q, kt, vt, None, rows)
        errs += [w_o_err, wt_o_err]
        timing = ""
        if size == 1:
            n_q1 = n_local + N_CTX
            ring1["ring1_ms"] = median_ms(lambda: flash_attention_with_stats(q, k, v))
            ring1["ring1_library_ms"] = median_ms(
                lambda: torch.ops.aten._scaled_dot_product_flash_attention(q, k, v))
            ring1["ring1_bound_ms"], by1 = attention_bound(48, n_q1, n_local, 64, stats=True)
            ring1["ring1_text_ms"] = median_ms(lambda: flash_attention_with_stats(q, kt, vt))
            flop = 4 * 48 * n_q1 * n_local * 64
            timing = (f"; x image kv: kernel {ring1['ring1_ms']:.3f} ms, "
                      f"{flop / ring1['ring1_ms'] / 1e9:.1f} TFLOP/s, "
                      f"{100 * ring1['ring1_bound_ms'] / ring1['ring1_ms']:.1f} % of bound, "
                      f"_scaled_dot_product_flash_attention {ring1['ring1_library_ms']:.3f} ms, "
                      f"bound {ring1['ring1_bound_ms']:.3f} ms ({by1}); x text kv: kernel "
                      f"{ring1['ring1_text_ms']:.3f} ms")
        phase("K3", f"ring of {size}, plain version on {rows.numel()} query rows: q (2, 24, "
                    f"{n_local + N_CTX}, 64) x kv (2, 24, {n_local}, 64): o {fmt_err(w_o_err)}, "
                    f"log2(l)+m {w_lse_err:.3e}; x text kv (2, 24, {N_CTX}, 64): o "
                    f"{fmt_err(wt_o_err)}, log2(l)+m {wt_lse_err:.3e}{timing}")
        del q, k, v, kt, vt
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(e[0] for e in errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=lib_ms, **ring1)


def merge_phase(g, dev):
    """Phase 8: K3 over 4 image shards + the text tokens, merged, against
    K1 over the whole 2048 px joint sequence (padded to 128 as the
    unsharded model pads it, the pad masked)."""
    from tpdm_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_with_stats,
        merge_attention_shards,
    )

    n_tok = N_IMG_2048 + N_CTX
    n_pad = -(-n_tok // 128) * 128
    rand = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (rand(2, 24, n_pad, 64) for _ in range(3))
    bounds = [(i, i + N_IMG_2048 // 4) for i in range(0, N_IMG_2048, N_IMG_2048 // 4)]
    bounds.append((N_IMG_2048, n_tok))
    parts = [flash_attention_with_stats(q, k[:, :, a:b].contiguous(), v[:, :, a:b].contiguous())
             for a, b in bounds]
    merged = merge_attention_shards(*(torch.stack(x) for x in zip(*parts)))
    whole = flash_attention(q, k, v, n_tok)
    torch.cuda.synchronize()
    err = rel_to_range(merged[:, :, :n_tok], whole[:, :, :n_tok])
    abs_err = (merged[:, :, :n_tok].float() - whole[:, :, :n_tok].float()).abs().max().item()
    phase("merge", f"2048 px joint attention q (2, 24, {n_pad}, 64): K3 over 4 image shards of "
                   f"4096 + {N_CTX} text tokens, merge_attention_shards, vs K1 with kv_len "
                   f"{n_tok}: max abs err {abs_err:.3e}, {err:.3e} of the output's range "
                   f"(bound {SHARDED_REL_TOL})")
    if not err < SHARDED_REL_TOL:
        fail("merged K3 shards disagree with K1 over the whole sequence")
    del q, k, v, parts, merged, whole
    torch.cuda.empty_cache()


def _seq_parallel_rank(rank, world, store, seed, out_dir):
    """Phase 9 on one rank: the seq-parallel forward against the unsharded
    one (rank 0), then two 2048 px requests; writes its numbers to
    out_dir/rank{rank}.json."""
    group, (mmdit, tpm, vae) = seq_parallel_rank(rank, world, store, seed)
    import torch.distributed as dist

    from tpdm_tpu_torch.models.mmdit import MMDiT
    from tpdm_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_streaming,
        flash_attention_with_stats,
    )
    from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline

    dev = group.device
    report = {"rank": rank, "world": world, "device": str(dev)}
    counters = (flash_attention, flash_attention_with_stats, flash_attention_streaming)

    def reset():
        for fn in counters:
            fn.launches = 0

    # the forward: CFG batch 2 at 2048 px, inputs from rank 0
    eg = torch.Generator(device=dev).manual_seed(seed + 10)
    inputs = [torch.randn(2, 16, 256, 256, generator=eg, device=dev, dtype=torch.bfloat16),
              torch.tensor([1000.0, 1000.0], device=dev, dtype=torch.bfloat16),
              torch.randn(2, N_CTX, 4096, generator=eg, device=dev, dtype=torch.bfloat16),
              torch.randn(2, 2048, generator=eg, device=dev, dtype=torch.bfloat16)]
    from_rank0(group, inputs)
    # the same latents, each moved by one bf16 step up or down
    step = torch.randint(0, 2, inputs[0].shape, generator=eg, device=dev, dtype=torch.int16)
    nudged = [(inputs[0].view(torch.int16) + 2 * step - 1).view(torch.bfloat16), *inputs[1:]]
    names = ("velocity", "temb", "h1", "h2")

    def gaps(out, ref):
        return ({n: rel_to_range(a, b) for n, a, b in zip(names, out, ref)},
                {n: rel_rms(a, b) for n, a, b in zip(names, out, ref)})

    def timed(model):
        with torch.no_grad():
            model(*inputs)  # warm-up: cuBLAS picks its kernels for these shapes
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = model(*inputs)
            torch.cuda.synchronize()
        return out, 1000 * (time.perf_counter() - start)

    # the seq-parallel forward, and on rank 0 the unsharded one twice: on
    # the same inputs, and on the nudged latents (the rounding floor)
    reset()
    sp_out, report["sp_forward_ms"] = timed(mmdit)
    report["sp_forward_k3"] = flash_attention_with_stats.launches  # over timed()'s two forwards
    report["sp_forward_k1"] = flash_attention.launches
    if rank == 0:
        with torch.device(dev):
            plain = MMDiT(dataclasses.replace(mmdit.config, seq_group=None))
        plain.to(torch.bfloat16).eval()
        plain.load_state_dict(mmdit.state_dict())
        ref_out, report["unsharded_forward_ms"] = timed(plain)
        report["forward_rel_err"], report["forward_rel_rms"] = gaps(sp_out, ref_out)
        report["forward_finite"] = all(bool(torch.isfinite(a.float()).all()) for a in sp_out)
        with torch.no_grad():
            floor_out = plain(*nudged)
        report["floor_rel_err"], report["floor_rel_rms"] = gaps(floor_out, ref_out)
        del plain, ref_out, floor_out
    del sp_out, nudged
    torch.cuda.empty_cache()
    if world > 1:
        dist.barrier()

    pipe = TPDMPipeline(mmdit, tpm, vae)
    decode_s = {}
    timed_decoder(pipe, decode_s)
    report["requests"] = []
    for req_seed in (seed + 3, seed + 4):
        eg = torch.Generator(device=dev).manual_seed(req_seed)
        emb = lambda *shape: torch.randn(shape, generator=eg, device=dev, dtype=torch.bfloat16)
        pe, npe, pp, npp = emb(1, N_CTX, 4096), emb(1, N_CTX, 4096), emb(1, 2048), emb(1, 2048)
        from_rank0(group, (pe, npe, pp, npp))
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        reset()
        start = time.perf_counter()
        res = pipe.generate(pe, pp, npe, npp, max_inference_steps=T_MAX, guidance_scale=7.0,
                            predict=True, seed=req_seed, height=2048, width=2048)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = [fn.launches for fn in counters]
        check_schedule(res, 1, 2048)
        n = res.num_steps
        report["requests"].append(dict(
            steps=n, sigmas=[float(x) for x in res.sigmas[0, :n]], seconds=seconds,
            decode_ms=1000 * decode_s["last"],
            step_ms=1000 * (seconds - decode_s["last"]) / n,
            k1=counts[0], k3=counts[1], k2=counts[2],
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
            image_mean=float(res.images.mean())))
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(report))
    if world > 1:
        dist.barrier()
    dist.destroy_process_group()


def seq_parallel_phase(seed, world):
    """Phase 9: one process per card; rank 0's numbers printed, every rank's
    checked. Returns rank 0's K3 launches over the second request."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        mp.spawn(_seq_parallel_rank, args=(world, f"{tmp}/store", seed, tmp), nprocs=world,
                 join=True)
        reports = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(world)]
        wall = time.perf_counter() - t0
    layers = 24
    per_step = layers * (world + 1)  # a layer: one K3 per image shard of the ring + the text
    r0 = reports[0]
    nccl = (f"NCCL ring of {world}" if world > 1
            else "a ring of 1 on one card: no NCCL exchange ran")
    if not r0["forward_finite"]:
        fail("the seq-parallel forward gave non-finite values")
    show = lambda gaps: ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
    phase("seq-parallel forward", f"{nccl}; SD3-medium at 2048 px (CFG batch 2, {N_IMG_2048} "
          f"+ {N_CTX} tokens), seq-parallel (K3) vs unsharded (K1): RMS err "
          f"{show(r0['forward_rel_rms'])} of each output's RMS (bound {SHARDED_REL_TOL}), max "
          f"err {show(r0['forward_rel_err'])} of its range; the unsharded forward on latents "
          f"moved by one bf16 step against itself: RMS err {show(r0['floor_rel_rms'])}, max err "
          f"{show(r0['floor_rel_err'])} (bound {FLOOR_FACTOR}x each). Warm forward "
          f"{r0['sp_forward_ms']:.1f} ms seq-parallel, {r0['unsharded_forward_ms']:.1f} ms "
          f"unsharded; per rank over two forwards K3 launches "
          f"{[rep['sp_forward_k3'] for rep in reports]} (expected {2 * per_step}), K1 "
          f"{[rep['sp_forward_k1'] for rep in reports]}")
    if not max(r0["forward_rel_rms"].values()) <= SHARDED_REL_TOL:
        fail("the seq-parallel forward disagrees with the unsharded one")
    for key in ("rel_err", "rel_rms"):
        sp, floor = r0[f"forward_{key}"], r0[f"floor_{key}"]
        if not all(sp[n] <= FLOOR_FACTOR * floor[n] for n in sp):
            fail(f"the seq-parallel 24-layer forward is further from the unsharded one "
                 f"({sp}) than {FLOOR_FACTOR}x one bf16 step on the latents moves it ({floor})")
    for rep in reports:
        if rep["sp_forward_k3"] != 2 * per_step or rep["sp_forward_k1"] != 0:
            fail(f"rank {rep['rank']}: two forwards launched K3 {rep['sp_forward_k3']} and K1 "
                 f"{rep['sp_forward_k1']} times, expected {2 * per_step} and 0")
    for i in range(2):
        reqs = [rep["requests"][i] for rep in reports]
        q0 = reqs[0]
        for rep, q in zip(reports, reqs):
            if q["steps"] != q0["steps"] or q["sigmas"] != q0["sigmas"]:
                fail(f"rank {rep['rank']} took other steps than rank 0")
            if q["k3"] != per_step * q["steps"] or q["k1"] != 0 or q["k2"] < 1:
                fail(f"rank {rep['rank']}: K3 {q['k3']} (expected {per_step * q['steps']}), "
                     f"K1 {q['k1']} (expected 0), K2 {q['k2']} (expected >= 1) launches")
        phase(f"request 2048 px {i + 1}", f"{nccl}; batch 1: {q0['steps']} steps, sigmas "
              f"{[round(s, 5) for s in q0['sigmas']]}, {q0['step_ms']:.1f} ms/step (CFG batch "
              f"2), decode {q0['decode_ms']:.1f} ms, {q0['seconds']:.3f} s/image; per rank "
              f"K3 launches {[q['k3'] for q in reqs]} (expected {per_step} a step), K1 "
              f"{[q['k1'] for q in reqs]}, K2 {[q['k2'] for q in reqs]}, peak memory "
              f"{[round(q['peak_gib'], 2) for q in reqs]} GiB")
    phase("seq-parallel", f"{world} process(es), {wall:.1f} s with start-up")
    return reports[0]["requests"][1]["k3"]


@contextlib.contextmanager
def plain_studies(probe_dtype=torch.float32):
    """Inside: every study module of tpdm_tpu_torch.experiments calls the
    plain versions (on the card, in fp32; K9's in ``probe_dtype``) where it
    calls K1 and K6-K9. The kernels' counts are set to 0 on entry, and it
    fails if any moved, so a study that reaches a kernel by another name
    cannot pass as its own plain version."""
    import pkgutil

    from tpdm_tpu_torch import experiments
    from tpdm_tpu_torch.ops import attention_studies as st
    from tpdm_tpu_torch.ops.attention import attention_reference, flash_attention

    plain = {
        "attention_strided": lambda *a, streams=1, **kw: st.attention_strided_reference(*a, **kw),
        "attention_maxfree": st.attention_maxfree_reference,
        "attention_int8qk": st.attention_int8qk_reference,
        "attention_probe": functools.partial(st.attention_probe_reference, dtype=probe_dtype),
        "flash_attention": attention_reference,
    }
    kernels = (st.attention_strided, st.attention_maxfree, st.attention_int8qk,
               st.attention_probe, flash_attention)
    for fn in kernels:
        fn.launches = 0
    saved = []
    for info in pkgutil.iter_modules(experiments.__path__):
        mod = importlib.import_module(f"{experiments.__name__}.{info.name}")
        for name, fn in plain.items():
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    moved = {fn.__name__: fn.launches for fn in kernels if fn.launches}
    if moved:
        fail(f"the plain pass launched kernels {moved}: a study reaches one by another name")


def study_bound(terms, nbytes):
    """(bound_ms, bound_by): the larger of the operations, each term
    (count, peak) at its type's rate, and ``nbytes`` over the memory rate."""
    t_ops = sum(count / peak for count, peak in terms)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def studies_phase(g, dev):
    """Phase 10: the K1 layout and tuning studies (tpdm_tpu_torch.experiments)
    at the SD3-medium 1024 px study shape. Every study function (the 23
    kernel bodies of experiments/attn_*.py) and the three attention blocks
    at width 1536 run once with the counts at 0, each against the same
    function with the plain versions swapped in; then the median time of
    each, of each kernel mode called alone, and of K6-K9 beside their plain
    versions and scaled_dot_product_attention. Returns the kernels' entries."""
    from torch.nn.functional import scaled_dot_product_attention

    from tpdm_tpu_torch.experiments import (
        _common,
        attn_block_layout,
        attn_kernel_floor,
        attn_layout,
        attn_natural_operands,
        attn_nocopy,
        attn_overlap,
        attn_round3,
        attn_round3b,
        attn_round4,
        attn_transpose_cost,
        attn_variants,
    )
    from tpdm_tpu_torch.ops import attention_studies as st

    b, h, n, d, kv_len, c = _common.B, _common.H, _common.N, _common.D, _common.N_REAL, _common.C
    bh = b * h
    rand = lambda *shape, std=1.0: (torch.randn(shape, generator=g, device=dev) * std).to(
        torch.bfloat16)
    q, k, v = (rand(b, h, n, d) for _ in range(3))  # 4480 tokens, the valid 4429 masked
    qr, kr, vr = (t[:, :, :kv_len].contiguous() for t in (q, k, v))  # 4429, padded by the study
    q2, k2, v2 = (t.transpose(1, 2).reshape(b, n, c) for t in (q, k, v))  # (b, n, h*d)
    # the transposed studies' operands: qt (bh, d, n) prescaled, k3, vt_ext
    # (bh, 80, n) with the ones row
    qt = (rand(bh, d, n).float() * (_common.LOG2E / d**0.5)).to(torch.bfloat16)
    k3 = k.reshape(bh, n, d)
    vt_ext = torch.cat([v.reshape(bh, n, d).transpose(1, 2), _common.ones_rows(bh, n, v)], dim=1)
    x = rand(b, n, c)
    ws = [rand(c, c, std=WEIGHT_STD) for _ in range(4)]
    bf = torch.bfloat16
    K6, K7, K8, K9 = (st.attention_strided, st.attention_maxfree, st.attention_int8qk,
                      st.attention_probe)
    # (row of the study table, name, kernel, call). Row 7, the noexp probe,
    # divides by acc[:, 64] + 1, which comes near zero on some rows: it is
    # held by its RMS error instead of its max error, and against its plain
    # version in fp64, since in fp32 that plain version moves by up to 0.025
    # of the RMS with the order of its sums (scripts/k9_noexp_conditioning.py)
    rows = [
        (1, "attn_variants.attn_v1", K6, lambda: attn_variants.attn_v1(qr, kr, vr)),
        (2, "attn_variants.attn_v2", K6, lambda: attn_variants.attn_v2(qr, kr, vr)),
        (3, "attn_variants.attn_v3", K7, lambda: attn_variants.attn_v3(qr, kr, vr)),
        (4, "attn_variants.attn_v4", K6, lambda: attn_variants.attn_v4(qr, kr, vr)),
        (5, "attn_overlap prefetch", K6, lambda: attn_overlap.make_runner("prefetch")(qr, kr, vr)),
        (6, "attn_overlap qk_only", K9, lambda: attn_overlap.make_runner("qk_only")(qr, kr, vr)),
        (7, "attn_overlap noexp", K9, lambda: attn_overlap.make_runner("noexp")(qr, kr, vr)),
        (8, "attn_layout.attn_kt", K6, lambda: attn_layout.attn_kt(qr, kr, vr)),
        (9, "attn_layout.attn_kt kt_qkonly", K9,
         lambda: attn_layout.attn_kt(qr, kr, vr, kernel="kt_qkonly")),
        (10, "attn_nocopy.attn_vsum", K6, lambda: attn_nocopy.attn_vsum(q, k, v, kv_len)),
        (11, "attn_nocopy.attn_packed2", K6, lambda: attn_nocopy.attn_packed2(q2, k2, v2, kv_len)),
        (12, "attn_round3.attn_T fp32 (vT)", K6, lambda: attn_round3.attn_T(q, k, v)),
        (12, "attn_round3.attn_T bf16 (vTb)", K6, lambda: attn_round3.attn_T(q, k, v, bf)),
        (13, "attn_round3.attn_I", K8, lambda: attn_round3.attn_I(q, k, v)),
        (14, "attn_round3.attn_TI", K8, lambda: attn_round3.attn_TI(q, k, v)),
        (15, "attn_round3b.attn_T fp32 (vT)", K6, lambda: attn_round3b.attn_T(q, k, v)),
        (15, "attn_round3b.attn_T bf16 (vTc)", K6, lambda: attn_round3b.attn_T(q, k, v, bf)),
        (16, "attn_round3b.attn_Tm fp32 (vTm)", K7, lambda: attn_round3b.attn_Tm(q, k, v)),
        (16, "attn_round3b.attn_Tm bf16 (vTmc)", K7, lambda: attn_round3b.attn_Tm(q, k, v, bf)),
        (17, "attn_natural_operands.flash_nat", K6,
         lambda: attn_natural_operands.flash_nat(q, k, v)),
        (18, "attn_round4.kernel_call", K6, lambda: attn_round4.kernel_call(qt, k3, vt_ext)),
        (19, "attn_round4.split_call", K6, lambda: attn_round4.split_call(qt, k3, vt_ext)),
        (20, "attn_block_layout._kernel_call", K6,
         lambda: attn_block_layout._kernel_call(qt, k3, vt_ext)),
        (21, "attn_transpose_cost.kernel_only", K6,
         lambda: attn_transpose_cost.kernel_only(qt, k3, vt_ext)),
        (22, "attn_kernel_floor.kernel_call", K6,
         lambda: attn_kernel_floor.kernel_call(qt, k3, vt_ext)),
        (23, "attn_kernel_floor.kernel_call_inT", K6,
         lambda: attn_kernel_floor.kernel_call_inT(qt.transpose(1, 2), k3, vt_ext)),
        ("block", "attn_natural_operands.block_standard (K1)", None,
         lambda: attn_natural_operands.block_standard(x, *ws)),
        ("block", "attn_natural_operands.block_nat", K6,
         lambda: attn_natural_operands.block_nat(x, *ws)),
        ("block", "attn_block_layout.block_transposed", K6,
         lambda: attn_block_layout.block_transposed(x, *ws)),
    ]
    counters = (K6, K7, K8, K9)
    # the studies' path: every function once, the counts read around it
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [call() for _, _, _, call in rows]
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {fn: fn.launches for fn in counters}
    want = {fn: sum(kernel is fn for _, _, kernel, _ in rows) for fn in counters}
    if launches != want:
        fail(f"the studies launched K6-K9 {list(launches.values())} times, expected "
             f"{list(want.values())} (one launch a study function)")
    errs = {fn: 0.0 for fn in counters}
    lines = []
    for (row, name, kernel, call), out in zip(rows, outs):
        with plain_studies(torch.float64 if row == 7 else torch.float32):
            ref = call()
        torch.cuda.synchronize()
        if row == 7:
            gap = rel_rms(out, ref)
            if not (bool(torch.isfinite(out.float()).all()) and gap <= KERNEL_REL_TOL):
                fail(f"{name} disagrees with its plain version in fp64: RMS err {gap} of the "
                     f"plain output's RMS (bound {KERNEL_REL_TOL})")
            err = (out.float() - ref.float()).abs().max().item()
            check = (f"against the fp64 plain version RMS err {gap:.3e} of RMS |o| (bound "
                     f"{KERNEL_REL_TOL}), max abs err {err:.3e}")
        else:
            e = output_error(name, out, ref)
            err, check = e[0], fmt_err(e)
        if kernel is not None:
            errs[kernel] = max(errs[kernel], err)
        lines.append((row, name, check))
        del ref
    del outs
    torch.cuda.empty_cache()
    for (row, name, check), (_, _, _, call) in zip(lines, rows):
        phase("study", f"row {row} {name}: {check}; {median_ms(call, reps=5):.3f} ms")

    # each kernel mode alone at the study shape, on the views the studies pass
    tok = lambda t: t.transpose(-1, -2).contiguous().transpose(-1, -2)  # token axis contiguous
    packed = lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)  # (b, n, h*d) storage
    qs = _common.prescale(q)
    # V_ext: the ones column, zeroed at or past kv_len where the mode masks
    v65 = torch.cat([v, (torch.arange(n, device=dev) < kv_len).to(bf).expand(b, h, n)[..., None]],
                    dim=-1)
    extra = torch.zeros(b, h, n, 16, dtype=bf, device=dev)
    extra[..., 0] = 1
    v80 = torch.cat([v, extra], dim=-1)
    v80t = tok(v80)
    ot = tok(torch.empty_like(q))
    rb = (torch.linalg.vector_norm(qs.float(), dim=-1)
          * torch.linalg.vector_norm(k.float(), dim=-1).amax(-1)[..., None])
    qi, sq = attn_round3._quant_rows(qs)
    ki, sk = attn_round3._quant_rows(k)
    sq, sk = sq[..., 0].contiguous(), sk[..., 0].contiguous()
    qs_t, k_t, qs_p, k_p, v_p, o_p = tok(qs), tok(k), packed(qs), packed(k), packed(v), packed(q)
    qi_t = tok(qi)
    n_chunks = -(-n // 640)  # the probes' kv chunks

    def work(kv, qk_peak=PEAK_BF16_FLOPS, qk_bytes=2, v_cols=d, extra=0):
        """The bound of an attention call over kv valid columns: QK^T at
        qk_peak and PV at the bf16 peak (4*bh*n*kv*d operations); q and k
        (qk_bytes an element), V's v_cols columns, o and ``extra`` bytes
        moved once."""
        return study_bound([(2 * bh * n * kv * d, qk_peak), (2 * bh * n * kv * d, PEAK_BF16_FLOPS)],
                           qk_bytes * bh * d * (n + kv) + 2 * bh * (kv * v_cols + n * d) + extra)

    bf16_nat, bf16_ext, bf16_all = work(kv_len), work(kv_len, v_cols=d + 1), work(n, v_cols=d + 1)
    k7_nat, k7_ext, k7_all = (work(kv, v_cols=w, extra=4 * bh * n)
                              for kv, w in ((kv_len, d), (kv_len, d + 1), (n, d + 1)))
    k8_nat, k8_ext, k8_all = (work(kv, PEAK_INT8_OPS, 1, w, 4 * bh * (n + kv))
                              for kv, w in ((kv_len, d), (kv_len, d + 1), (n, d + 1)))
    # the probes' own functions. qk_only's output needs only the first 64
    # columns of each chunk's QK^T and their PV against 64 rows of V: q, o
    # and those k and V rows moved once. The kernel runs every chunk's whole
    # QK^T as the probe did; that work is reported beside it as probe_work,
    # never as its bound. noexp: QK^T and PV over V's 65 columns
    used = 64 * n_chunks
    qk_only = study_bound([(2 * bh * n * used * d, PEAK_BF16_FLOPS)] * 2,
                          2 * bh * d * (2 * n + 2 * used))
    probe_work = study_bound([(2 * bh * n * n * d, PEAK_BF16_FLOPS),
                              (2 * bh * n * used * d, PEAK_BF16_FLOPS)],
                             2 * bh * d * (3 * n + used))
    noexp = study_bound([(2 * bh * n * n * d, PEAK_BF16_FLOPS),
                         (2 * bh * n * n * (d + 1), PEAK_BF16_FLOPS)],
                        2 * bh * (3 * n * d + n * (d + 1)))
    o_nat = torch.empty_like(q)  # the output a call without out= allocates
    # (name, call, bound, the (q, k, v, o) views for its load routes)
    modes = [
        ("K6 natural, V 64 wide, kv_len (vsum)", lambda: K6(qs, k, v, kv_len), bf16_nat,
         (qs, k, v, o_nat)),
        ("K6 natural, V_ext 65, kv_len (v1, v2, prefetch)",
         lambda: K6(qs, k, v65, kv_len), bf16_ext, (qs, k, v65, o_nat)),
        ("K6 natural, V_ext 65, no mask (v4)", lambda: K6(qs, k, v65), bf16_all,
         (qs, k, v65, o_nat)),
        ("K6 K^T, V_ext 65, kv_len (kt)", lambda: K6(qs, k_t, v65, kv_len), bf16_ext,
         (qs, k_t, v65, o_nat)),
        ("K6 packed (b, n, h*d), kv_len (packed2)",
         lambda: K6(qs_p, k_p, v_p, kv_len, out=o_p), bf16_nat, (qs_p, k_p, v_p, o_p)),
        ("K6 q^T, V^T_ext 80, o^T (vT, round4, kernel_floor)",
         lambda: K6(qs_t, k, v80t, out=ot), bf16_all, (qs_t, k, v80t, ot)),
        ("K6 q^T, V^T_ext 80, o^T, bf16 scores (vTb, vTc)",
         lambda: K6(qs_t, k, v80t, score_bf16=True, out=ot), bf16_all, (qs_t, k, v80t, ot)),
        ("K6 q^T, V^T_ext 80, o^T, two streams (split)",
         lambda: K6(qs_t, k, v80t, streams=2, out=ot), bf16_all, (qs_t, k, v80t, ot)),
        ("K6 natural, V_ext 80, o^T (nat)", lambda: K6(qs, k, v80, out=ot), bf16_all,
         (qs, k, v80, ot)),
        ("K6 q natural, V^T_ext 80, o^T (inT)", lambda: K6(qs, k, v80t, out=ot), bf16_all,
         (qs, k, v80t, ot)),
        ("K7 natural, V_ext 65, kv_len (v3)", lambda: K7(qs, k, v65, rb, kv_len), k7_ext,
         (qs, k, v65, o_nat)),
        ("K7 q^T, V^T_ext 80, o^T (vTm)", lambda: K7(qs_t, k, v80t, rb, out=ot), k7_all,
         (qs_t, k, v80t, ot)),
        ("K7 q^T, V^T_ext 80, o^T, bf16 softmax (vTmc)",
         lambda: K7(qs_t, k, v80t, rb, soft_bf16=True, out=ot), k7_all, (qs_t, k, v80t, ot)),
        ("K7 q natural, V^T_ext 80 (attn_round3b.attn_Tm's views)",
         lambda: K7(qs, k, v80t, rb), k7_all, (qs, k, v80t, o_nat)),
        ("K8 natural, V_ext 65, kv_len (vI)", lambda: K8(qi, ki, v65, sq, sk, kv_len), k8_ext,
         (qi, ki, v65, o_nat)),
        ("K8 q^T, V^T_ext 80, o^T (vTI)",
         lambda: K8(qi_t, ki, v80t, sq, sk, k_scale_first=True, out=ot), k8_all,
         (qi_t, ki, v80t, ot)),
        ("K9 qk_only, chunk 640 (qk_only)", lambda: K9(qs, k, v65, "qk_only"), qk_only,
         (qs, k, v65, o_nat)),
        ("K9 qk_only, K^T, chunk 640 (kt_qkonly)",
         lambda: K9(qs, k_t, v65, "qk_only"), qk_only, (qs, k_t, v65, o_nat)),
        ("K9 noexp, chunk 640 (noexp)", lambda: K9(qs, k, v65, "noexp"), noexp,
         (qs, k, v65, o_nat)),
    ]
    for name, call, bound, views in modes:
        ms = median_ms(call)
        work_s = (f"; the probe's work (every chunk's whole QK^T) {probe_work[0]:.4f} ms, "
                  f"{probe_work[0] / ms * 100:.1f} % of it" if bound is qk_only else "")
        routes = "; load routes " + ", ".join(
            f"{op} {route}" for op, route in st.studies_routes(*views).items())
        phase("study mode", f"{name}: {ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
                            f"{bound[0] / ms * 100:.1f} % of it{work_s}{routes}")

    # K6-K9 beside their plain versions and PyTorch's attention: natural
    # operands at kv_len 4429, V 64 wide (K9: its qk_only probe)
    sdpa = lambda: scaled_dot_product_attention(qs, k[:, :, :kv_len], v[:, :, :kv_len],
                                                scale=math.log(2.0))
    timed = {
        "K6": (lambda: K6(qs, k, v, kv_len),
               lambda: st.attention_strided_reference(qs, k, v, kv_len), sdpa, bf16_nat),
        "K7": (lambda: K7(qs, k, v, rb, kv_len),
               lambda: st.attention_maxfree_reference(qs, k, v, rb, kv_len), sdpa,
               k7_nat),
        "K8": (lambda: K8(qi, ki, v, sq, sk, kv_len),
               lambda: st.attention_int8qk_reference(qi, ki, v, sq, sk, kv_len), sdpa, k8_nat),
        "K9": (lambda: K9(qs, k, v, "qk_only"),
               lambda: st.attention_probe_reference(qs, k, v, "qk_only"), None, qk_only),
    }
    res = {}
    k9_work = f", the probe's work (every chunk's whole QK^T) {probe_work[0]:.4f} ms"
    for (key, (kernel, plain, lib, bound)), fn in zip(timed.items(), counters):
        e = output_error(f"{key} (natural, V 64 wide)", kernel(), plain())
        ms, plain_ms = median_ms(kernel), median_ms(plain)
        lib_ms = None if lib is None else median_ms(lib)
        phase(key, f"{(b, h, n, d)} natural, V 64 wide{f', kv_len {kv_len}' if key != 'K9' else ''}: "
                   f"{fmt_err(e)}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                   f"scaled_dot_product_attention "
                   f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound {bound[0]:.4f} ms "
                   f"({bound[1]}), {bound[0] / ms * 100:.1f} % of it"
                   f"{k9_work if key == 'K9' else ''}; launches on the studies' path "
                   f"{launches[fn]}")
        res[key] = dict(launches=launches[fn], max_abs_err=max(errs[fn], e[0]), ms=ms,
                        plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                        library_ms=lib_ms)
        if key == "K9":  # labelled apart: the probe's work is not what its output needs
            res[key]["probe_work_ms"] = probe_work[0]
    phase("studies", f"{len(rows)} study functions at {(b, h, n, d)}, blocks at width {c}: "
                     f"one pass {path_s:.2f} s, K6-K9 launches {list(launches.values())}")
    torch.cuda.empty_cache()
    return res


def write_vocab(path, prompts):
    """A WordPiece vocab.txt for ``prompts``: BERT's special tokens, their
    lower-cased words and every ASCII letter, digit and punctuation mark
    alone and as a "##" piece, so no word of them is unknown."""
    import string

    from tpdm_tpu_torch.utils.bert_tokenizer import BertTokenizer

    special = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    basic = BertTokenizer({t: i for i, t in enumerate(special)})
    words = sorted({w for p in prompts for w in basic.basic_tokenize(p)})
    chars = string.ascii_lowercase + string.digits + string.punctuation
    vocab = special + [w for w in words if w not in special]
    vocab += [c for c in chars if c not in words] + ["##" + c for c in chars]
    Path(path).write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return len(vocab)


class UpdateRecorder:
    """Timers around an agent's rollouts and a reward, and a trainer
    callback that closes each update: its metrics, seconds (rollout, reward
    and PPO, each ended by a synchronize), peak memory, the memory allocated
    when the reward was called beside the bytes of the rollout's time-major
    caches (and where they were), and the K1/K2 launches counted since the
    previous update (the counters zeroed before the first), split into
    those of the last rollout, of the reward and of what followed it (the
    PPO epochs). ``samples`` lists every rollout (batch, steps), an eval's
    too; with ``keep_last`` the last rollout and its batch are kept (which
    keeps its caches alive)."""

    def __init__(self, dev, keep_last=False):
        from tpdm_tpu_torch.ops.attention import flash_attention, flash_attention_streaming

        self.dev, self.keep_last = dev, keep_last
        self.rows, self.samples, self.last, self.reward_calls = [], [], None, 0
        self.counters = (flash_attention, flash_attention_streaming)
        self.seen = [0, 0]  # the caller zeroes the counters before training

    def wrap_agent(self, agent):
        sample = agent.sample

        def timed_sample(tpm, batch, generator, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(self.dev)
            before = self.launches()
            self.t0 = time.perf_counter()
            out = sample(tpm, batch, generator, **kw)
            torch.cuda.synchronize()
            self.t1 = time.perf_counter()
            self.rollout_k = [n - b for n, b in zip(self.launches(), before)]
            self.samples.append((batch["prompt_embeds"].shape[0], out.num_steps))
            if self.keep_last:
                self.last = (batch, out)
            return out

        agent.sample = timed_sample
        return agent

    def wrap_reward(self, reward_fn):
        from tpdm_tpu_torch.train.rloo import _TIME_MAJOR_FIELDS

        def timed_reward(prompts, outputs):
            self.reward_calls += 1
            caches = [v for k, v in outputs._asdict().items()
                      if k in _TIME_MAJOR_FIELDS and v is not None]
            self.at_reward = dict(
                allocated=torch.cuda.memory_allocated(self.dev),
                cache_bytes=sum(v.numel() * v.element_size() for v in caches),
                cache_on=sorted({v.device.type for v in caches}))
            before = self.launches()
            scores, last = reward_fn(prompts, outputs)
            torch.cuda.synchronize()
            self.t2 = time.perf_counter()
            self.at_reward_end = self.launches()
            self.reward_k = [n - b for n, b in zip(self.at_reward_end, before)]
            return scores, last

        return timed_reward

    def launches(self):
        return [fn.launches for fn in self.counters]

    def on_step_end(self, trainer, update, metrics, eval_state):
        torch.cuda.synchronize()
        now = self.launches()
        k1, k2 = (n - s for n, s in zip(now, self.seen))
        self.seen = now
        self.rows.append(dict(
            update=update, metrics=metrics, steps=self.samples[-1][1], k1=k1, k2=k2,
            rollout_k=self.rollout_k, reward_k=self.reward_k,
            ppo_k=[n - r for n, r in zip(now, self.at_reward_end)],
            rollout_s=self.t1 - self.t0, reward_s=self.t2 - self.t1,
            ppo_s=time.perf_counter() - self.t2, at_reward=self.at_reward,
            peak_gib=torch.cuda.max_memory_allocated(self.dev) / 2**30))


def print_update(label, row, layers):
    """One UpdateRecorder row: its metrics, seconds, peak memory and K1/K2
    launches, checked (finite metrics, no skipped step, one K1 a layer a
    rollout step and one K2 decode)."""
    keys = ("policy/steps_avg", "objective/scores", "objective/kl", "loss/policy_avg",
            "policy/grad_norm_avg", "policy/approxkl_avg", "val/ratio", "val/num_skipped")
    m = row["metrics"]
    phase(label, ", ".join(f"{k} {m[k]:.6g}" for k in keys)
          + f"; rollout {row['steps']} steps {row['rollout_s']:.3f} s, reward (decode + score) "
          f"{row['reward_s']:.3f} s, PPO {row['ppo_s']:.3f} s, total "
          f"{row['rollout_s'] + row['reward_s'] + row['ppo_s']:.3f} s; peak memory "
          f"{row['peak_gib']:.2f} GiB; K1 launches {row['k1']}, K2 launches {row['k2']}")
    if not all(math.isfinite(v) for v in m.values()):
        fail(f"{label} has non-finite metrics: {m}")
    if m["val/num_skipped"] != 0:
        fail(f"{label} skipped a PPO step")
    if row["k1"] != layers * row["steps"] or row["k2"] != 1:
        fail(f"{label}: K1 {row['k1']}, K2 {row['k2']} launches for {row['steps']} rollout "
             "steps and one decode")


class FamilyRLOO:
    """Phase 21: one update of RLOOTrainer over each non-SD3 family's agent
    at full width, run by phases 18-20 on the backbones and VAEs they hold
    (``update``), each agent built anew over them with phase 11's training
    configuration: 2 prompts x rloo_k 2, one PPO epoch of 2 micro-batches
    with gradient accumulation 2 (one Adam step), lr RLOO_LR, the TPM at
    RLOOConfig's head bias with fp32 parameters computing in bf16, and the
    reward the family's own VAE decode (K2) and then phase 11's
    random-weight ImageReward (built once, at the first update). Each
    update's launches are checked exactly: K1 a forward times each stage's
    loop iterations around the rollout, one K2 around the reward's decode,
    none in the PPO epochs (they replay the TPM alone)."""

    def __init__(self, seed, dev, smi):
        self.seed, self.dev, self.smi = seed, dev, smi
        self.totals = [0, 0]
        self.seconds = 0.0
        self.lines = []
        self._reward = None

    def config(self, max_steps):
        from tpdm_tpu_torch.train import RLOOConfig

        return RLOOConfig(
            per_device_train_batch_size=2, gradient_accumulation_steps=2, rloo_k=2,
            num_ppo_epochs=1, num_mini_batches=1, total_episodes=4,
            max_inference_steps=max_steps, learning_rate=RLOO_LR, kl_coef=0.05, gamma=0.9,
            seed=self.seed)

    def reward(self):
        """(ImageRewardModel, BertTokenizer, prompts) as phase 11 builds them."""
        if self._reward is None:
            from tpdm_tpu_torch.rewards import ImageRewardModel
            from tpdm_tpu_torch.utils.bert_tokenizer import BertTokenizer

            with open(REPO / "example" / "prompts.jsonl") as f:
                prompts = [json.loads(line)["prompt"] for line in f if line.strip()]
            with tempfile.TemporaryDirectory() as tmp:
                write_vocab(Path(tmp) / "vocab.txt", prompts)
                tokenizer = BertTokenizer.from_pretrained(tmp)
            model = ImageRewardModel.create(seed=self.seed + 30, device=self.dev)
            self._reward = (model, tokenizer, prompts)
        return self._reward

    def update(self, label, agent, stages, vae, collate):
        """One update of ``agent`` (its TPM drawn from the seed), the reward
        ``vae``'s decode and ImageReward, the batch from ``collate(rows)``;
        ``stages`` maps each agent that runs a loop in the rollout (the
        agent, or the ensemble's base and refiner) to its K1 launches a
        forward. Prints and checks the update."""
        from tpdm_tpu_torch.train import RLOOTrainer
        from tpdm_tpu_torch.train.builders import build_image_reward_fn

        start = time.perf_counter()
        reward_model, tokenizer, prompts = self.reward()
        recorder = UpdateRecorder(self.dev)
        outs, restore = recorded_samples(*stages)
        recorder.wrap_agent(agent)
        trainer = RLOOTrainer(agent.config, agent,
                              recorder.wrap_reward(build_image_reward_fn(vae, reward_model,
                                                                         tokenizer)),
                              [{"prompt": p} for p in prompts], collate_fn=collate,
                              callbacks=[recorder])
        tpm = agent.init_tpm_params(torch.Generator(device=self.dev).manual_seed(self.seed + 210))
        p0 = {k: v.clone() for k, v in tpm.state_dict().items()}
        torch.cuda.synchronize()
        recorder.seen = recorder.launches()
        try:
            tpm, optimizer = trainer.train(tpm=tpm)
        finally:
            restore()
        row = recorder.rows[-1]
        m = row["metrics"]
        stage_steps = [(stages[a], out.num_steps) for a, out in outs]
        want_k1 = sum(k1 * n for k1, n in stage_steps)
        moved = {}
        for k, v in tpm.state_dict().items():
            head = k.split(".", 1)[0] if isinstance(tpm, torch.nn.ModuleDict) else "tpm"
            moved[head] = max(moved.get(head, 0.0), (v - p0[k]).abs().max().item())
        bound = ADAM_STEP_FACTOR * RLOO_LR * optimizer.count
        self.totals[0] += row["k1"]
        self.totals[1] += row["k2"]
        steps = " + ".join(str(n) for _, n in stage_steps)
        keys = ("policy/steps_avg", "objective/scores", "loss/policy_avg", "policy/grad_norm_avg",
                "val/ratio", "val/num_skipped")
        seconds = time.perf_counter() - start
        self.seconds += seconds
        phase(f"family rloo {label}", ", ".join(f"{k} {m[k]:.6g}" for k in keys)
              + f"; rollout {steps} steps (batch {recorder.samples[-1][0]}) "
              f"{row['rollout_s']:.3f} s, reward (decode + score) {row['reward_s']:.3f} s, PPO "
              f"{row['ppo_s']:.3f} s; peak memory {row['peak_gib']:.2f} GiB; activation caches "
              f"{row['at_reward']['cache_bytes'] / 2**30:.3f} GiB; K1 {row['rollout_k'][0]} in "
              f"the rollout ({' + '.join(f'{k1} x {n}' for k1, n in stage_steps)}), K2 "
              f"{row['reward_k'][1]} in the reward, {row['ppo_k']} in PPO; TPM moved "
              + ", ".join(f"{h} {v:.4e}" for h, v in moved.items())
              + f" (bound {bound:.4e}) in {optimizer.count} Adam step; {seconds:.1f} s; {self.smi}")
        if not all(math.isfinite(v) for v in m.values()) or m["val/num_skipped"] != 0:
            fail(f"family rloo {label}: non-finite metrics or a skipped step: {m}")
        if not abs(m["val/ratio"] - 1.0) < RATIO_TOL:
            fail(f"family rloo {label}: val/ratio {m['val/ratio']} is not within {RATIO_TOL} of "
                 "1: the replay does not reproduce the rollout's log-probs")
        if optimizer.count != 1 or not all(0 < v <= bound for v in moved.values()):
            fail(f"family rloo {label}: the TPM moved {moved} in {optimizer.count} Adam steps "
                 f"(bound {bound})")
        if (row["rollout_k"] != [want_k1, 0] or row["reward_k"] != [0, 1]
                or row["ppo_k"] != [0, 0] or row["k1"] != want_k1 or row["k2"] != 1):
            fail(f"family rloo {label}: launches (K1, K2) rollout {row['rollout_k']}, reward "
                 f"{row['reward_k']}, PPO {row['ppo_k']}; expected [{want_k1}, 0], [0, 1], "
                 "[0, 0]")
        self.lines.append(f"{label} {row['rollout_s'] + row['reward_s'] + row['ppo_s']:.3f} s")
        del trainer, recorder, tpm, optimizer, outs
        gc.collect()
        torch.cuda.empty_cache()

    def summary(self):
        if len(self.lines) != 4:
            fail(f"family rloo: {len(self.lines)} of the 4 updates ran")
        phase("family rloo", f"{'; '.join(self.lines)} an update; {self.seconds:.1f} s with the "
                             f"agents' set-up; K1 {self.totals[0]}, K2 {self.totals[1]} launches; "
                             f"{self.smi}")


def rloo_phase(seed, dev):
    """Phase 11: two RLOO updates at full width; returns the K1 and K2
    launches of the training run."""
    from tpdm_tpu_torch.models.mmdit import MMDiTConfig
    from tpdm_tpu_torch.ops.attention import flash_attention, flash_attention_streaming
    from tpdm_tpu_torch.rewards import ImageRewardModel
    from tpdm_tpu_torch.train import RLOOConfig, RLOOTrainer, TPDMAgent
    from tpdm_tpu_torch.train import checkpoint as ckpt
    from tpdm_tpu_torch.train.builders import build_image_reward_fn, make_prompt_encoder
    from tpdm_tpu_torch.train.rloo import subset_inputs, subset_outputs
    from tpdm_tpu_torch.utils.bert_tokenizer import BertTokenizer

    t0 = time.perf_counter()
    mmdit, _, vae = build_models(dev, seed, MMDiTConfig.sd3_medium())
    reward_model = ImageRewardModel.create(seed=seed + 30, device=dev)
    n_reward = sum(p.numel() for p in reward_model.net.parameters())
    with open(REPO / "example" / "prompts.jsonl") as f:
        prompts = [json.loads(line)["prompt"] for line in f if line.strip()]
    with tempfile.TemporaryDirectory() as tmp:
        n_vocab = write_vocab(Path(tmp) / "vocab.txt", prompts)
        tokenizer = BertTokenizer.from_pretrained(tmp)
        config = RLOOConfig(
            per_device_train_batch_size=2, gradient_accumulation_steps=2, rloo_k=2,
            num_ppo_epochs=1, num_mini_batches=1, total_episodes=8,
            max_inference_steps=T_MAX, guidance_scale=7.0, learning_rate=RLOO_LR,
            kl_coef=0.05, gamma=0.9, save_steps=1, save_total_limit=1,
            output_dir=str(Path(tmp) / "run"), seed=seed)
        agent = TPDMAgent(mmdit, config)
        # the latents of every step too, for the recompute replay below
        agent.sampler_cfg = dataclasses.replace(agent.sampler_cfg, keep_history=True)
        recorder = UpdateRecorder(dev, keep_last=True)
        recorder.wrap_agent(agent)
        trainer = RLOOTrainer(config, agent,
                              recorder.wrap_reward(build_image_reward_fn(vae, reward_model,
                                                                         tokenizer)),
                              [{"prompt": p} for p in prompts],
                              collate_fn=make_prompt_encoder(agent, n_txt=N_CTX, seed=seed),
                              callbacks=[recorder])
        tpm = agent.init_tpm_params(torch.Generator(device=dev).manual_seed(seed + 31))
        p0 = {k: v.clone() for k, v in tpm.state_dict().items()}
        torch.cuda.synchronize()
        phase("rloo models", f"SD3-medium MMDiT (frozen) + SD3 VAE decoder bf16, TPM "
              f"{sum(v.numel() for v in p0.values()) / 1e6:.3f} M params fp32 computing in "
              f"{tpm.dtype}, ImageReward ViT-L/16 + BERT-med {n_reward / 1e9:.3f} B params fp32, "
              f"all from seed {seed}; {len(prompts)} prompts, vocab {n_vocab} entries, "
              f"{trainer.sizes['num_total_batches']} updates of {trainer.sizes['batch_size']} "
              f"samples; {time.perf_counter() - t0:.1f} s")

        flash_attention.launches = flash_attention_streaming.launches = 0
        tpm, optimizer = trainer.train(tpm=tpm)
        launches = flash_attention.launches, flash_attention_streaming.launches
        for row in recorder.rows:
            print_update(f"rloo update {row['update']}", row, mmdit.config.num_layers)
        ratio = recorder.rows[0]["metrics"]["val/ratio"]
        if not abs(ratio - 1.0) < RATIO_TOL:
            fail(f"update 1's val/ratio {ratio} is not within {RATIO_TOL} of 1: the replay "
                 "does not reproduce the rollout's log-probs")
        moved = max((tpm.state_dict()[k] - v).abs().max().item() for k, v in p0.items())
        bound = ADAM_STEP_FACTOR * RLOO_LR * optimizer.count
        phase("rloo params", f"TPM {next(tpm.parameters()).dtype} after {optimizer.count} Adam "
              f"steps: largest move {moved:.4e} (bound {bound:.4e} = {ADAM_STEP_FACTOR} x lr x "
              f"steps); update 1 val/ratio {ratio:.6f} (bound |val/ratio - 1| < {RATIO_TOL})")
        if not 0 < moved <= bound or optimizer.count != 2:
            fail(f"the TPM moved {moved} in {optimizer.count} Adam steps (bound {bound})")
        path = ckpt.latest_checkpoint(config.output_dir)
        if path is None or not path.endswith("checkpoint-2"):
            fail(f"the last checkpoint is {path}, expected checkpoint-2")
        saved = ckpt.restore_checkpoint(path)["tpm"]
        if not all(torch.equal(saved[k].to(dev), v) for k, v in tpm.state_dict().items()):
            fail(f"{path} does not restore to the trained TPM")
        phase("rloo checkpoint", f"{Path(path).name} ({sorted(os.listdir(path))}) restores to "
                                 "the trained TPM bit for bit")

        # update 2's rollout replayed with the trained TPM: the backbone
        # re-run on the recorded chain (recompute) against the cached
        # activations, one micro-batch of 2 at a time
        batch, out = recorder.last
        rec_agent = TPDMAgent(mmdit, config, replay_mode="recompute")
        gap = rollout_gap = 0.0
        flash_attention.launches = 0
        active = 0
        for inds in ([0, 1], [2, 3]):
            mo = subset_outputs(out, inds)
            valid = ~mo.prob_masks
            lp_c = agent.logprobs(tpm, mo)
            lp_r = rec_agent.logprobs(tpm, mo, subset_inputs(batch, inds))
            gap = max(gap, (lp_r - lp_c)[valid].abs().max().item())
            rollout_gap = max(rollout_gap, (lp_c - mo.logprobs)[valid].abs().max().item())
            active += int((~mo.prob_masks).any(dim=0).sum())
        k1_rec = flash_attention.launches
        phase("rloo recompute", f"update 2's rollout ({out.num_steps} steps), replayed with the "
              f"trained TPM: recompute vs cached largest |log-prob gap| {gap:.4e} (bound "
              f"{RECOMPUTE_LP_TOL}); cached replay vs the rollout's log-probs {rollout_gap:.4e}; "
              f"K1 launches {k1_rec} ({mmdit.config.num_layers} x {active} active steps)")
        if not gap < RECOMPUTE_LP_TOL or k1_rec != mmdit.config.num_layers * active:
            fail(f"recompute replay: log-prob gap {gap} (bound {RECOMPUTE_LP_TOL}), K1 "
                 f"launches {k1_rec} for {active} active steps")
    del agent, rec_agent, trainer, recorder, mmdit, vae, reward_model, batch, out, tpm
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def cache_launches(ladder, interval, window, layers, front):
    """K1 launches of a fixed Δ-cache run over the host ladder: a full
    forward (or a reuse step promoted to one, entering the window over a
    stale uncond cache) runs every layer, a reuse step the front ones."""
    from tpdm_tpu_torch.pipeline.denoise import in_window

    launches, uncond_valid = 0, False
    for i, sigma in enumerate(ladder.tolist()):
        guided = window is None or bool(in_window(torch.tensor(sigma).to(torch.bfloat16), window))
        if i % interval == 0 or (guided and not uncond_valid):
            launches += layers
            uncond_valid = guided
        else:
            launches += front
    return launches


def fixed_phase(seed, dev, adaptive):
    """Phase 12: the fixed-schedule baseline and the sampling options at
    full width (phase 5's weights, from the same seed); returns the K1 and
    K2 launches counted over its requests."""
    from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    from tpdm_tpu_torch.ops.attention import flash_attention, flash_attention_streaming
    from tpdm_tpu_torch.ops.schedules import uniform_flow_sigmas
    from tpdm_tpu_torch.pipeline import TPDMPipeline, solver_nfe
    from tpdm_tpu_torch.pipeline.denoise import in_window

    t_phase = time.perf_counter()
    mmdit, tpm, vae = build_models(dev, seed, MMDiTConfig.sd3_medium())
    layers, front = mmdit.config.num_layers, mmdit.config.cache_front_blocks
    pipe, raw = TPDMPipeline(mmdit, tpm, vae), TPDMPipeline(mmdit, tpm)
    decode_s = {}
    timed_decoder(pipe, decode_s)
    counters = (flash_attention, flash_attention_streaming)
    totals = [0, 0]
    rows = []  # the batch of each MMDiT forward in the last run
    mmdit.register_forward_pre_hook(lambda _module, inputs: rows.append(inputs[0].shape[0]))

    def embeds(b, req_seed):
        eg = torch.Generator(device=dev).manual_seed(req_seed)
        emb = lambda *shape: torch.randn(shape, generator=eg, device=dev, dtype=torch.bfloat16)
        return emb(b, N_CTX, 4096), emb(b, 2048), emb(b, N_CTX, 4096), emb(b, 2048)

    def run(call):
        """call() timed, its K1 and K2 launches counted from 0."""
        for fn in counters:
            fn.launches = 0
        rows.clear()
        decode_s["last"] = 0.0
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        k1, k2 = (fn.launches for fn in counters)
        totals[0] += k1
        totals[1] += k2
        return out, seconds, k1, k2

    def check_images(images, b):
        if images.dtype.name != "uint8" or images.shape != (b, 1024, 1024, 3):
            fail(f"images {images.dtype} {images.shape}, expected uint8 ({b}, 1024, 1024, 3)")

    def report(name, seconds, evals, k1, k2, want_k1, want_k2=1, extra=""):
        ms = 1000 * (seconds - decode_s["last"]) / evals
        phase(name, f"{seconds:.3f} s, {ms:.1f} ms a model evaluation ({evals} evaluations), "
                    f"decode {1000 * decode_s['last']:.1f} ms; K1 launches {k1}, K2 launches "
                    f"{k2}{extra}")
        if (k1, k2) != (want_k1, want_k2):
            fail(f"{name}: K1 {k1}, K2 {k2} launches, expected K1 {want_k1}, K2 {want_k2}")
        return ms

    ladder = uniform_flow_sigmas(T_MAX)
    args = {b: embeds(b, seed + 40 + b) for b in (1, 2)}
    fixed = lambda b, **kw: (lambda: pipe.generate_fixed(*args[b], num_steps=T_MAX,
                                                         seed=seed + b, **kw))
    generate = lambda b, **kw: (lambda: pipe.generate(*args[b], max_inference_steps=T_MAX,
                                                      guidance_scale=7.0, predict=True,
                                                      seed=seed + b, **kw))
    # 1. fixed 28-step Euler against the adaptive schedule, warm: the first
    # call of each path at a batch size pays a one-time cost (0.7-0.9 s at
    # the adaptive path's first batch 1 and 2 requests on the H100)
    full_ms = {}
    for b in (1, 2):
        run(lambda: pipe.generate_fixed(*args[b], num_steps=1, seed=seed))  # warm-ups
        run(lambda: pipe.generate(*args[b], max_inference_steps=1, seed=seed))
        images, seconds, k1, k2 = run(fixed(b))
        check_images(images, b)
        full_ms[b] = report(f"fixed euler b{b}", seconds, T_MAX, k1, k2, T_MAX * layers)
        res, ad_s, k1, k2 = run(generate(b))
        check_schedule(res, b, 1024)
        n5, s5 = adaptive[b]
        report(f"adaptive b{b}", ad_s, res.num_steps, k1, k2, layers * res.num_steps,
               extra=f"; {res.num_steps} steps against the fixed 28, {ad_s / seconds:.3f} of "
                     f"its time; phase 5's request at batch {b}: {n5} steps, {s5:.3f} s "
                     "(random weights: the adaptive step count follows only from the TPM head "
                     f"bias {TPM_HEAD_BIAS})")
    # 2. the other solvers
    for solver in ("heun", "midpoint", "ab2"):
        nfe = solver_nfe(T_MAX, solver)
        images, seconds, k1, k2 = run(fixed(1, solver=solver))
        check_images(images, 1)
        report(f"fixed {solver} b1", seconds, nfe, k1, k2, nfe * layers)
    # 3. the caches and the window
    images, seconds, k1, k2 = run(fixed(1, cache_interval=2))
    check_images(images, 1)
    n_reuse = T_MAX // 2
    reuse_ms = (1000 * (seconds - decode_s["last"]) - (T_MAX - n_reuse) * full_ms[1]) / n_reuse
    report("fixed cache_interval 2 b1", seconds, T_MAX, k1, k2,
           cache_launches(ladder, 2, None, layers, front),
           extra=f"; a reuse step ({front} of {layers} blocks) {reuse_ms:.1f} ms against a "
                 f"full step's {full_ms[1]:.1f} ms (fixed euler b1)")
    images, seconds, k1, k2 = run(fixed(1, cache_tau=0.1))
    check_images(images, 1)
    n_full, rest = divmod(k1 - front * T_MAX, layers - front)
    report("fixed cache_tau 0.1 b1", seconds, T_MAX, k1, k2, k1,
           extra=f"; {n_full} full forwards and {T_MAX - n_full} reuse steps by the launches")
    if rest or not 1 <= n_full <= T_MAX:
        fail(f"cache_tau: {k1} K1 launches are no count of full and reuse steps")
    window = (0.15, 0.95)

    def window_rows(sigmas):
        """The MMDiT batch of each step of a batch-1 request: 2 (CFG) where
        the step's sigma, in bf16 as the samplers compare it, is in the
        window, else 1 (conditional only)."""
        return [2 if in_window(torch.tensor(s).to(torch.bfloat16), window) else 1
                for s in sigmas]

    want_rows = window_rows(ladder.tolist())
    guided = want_rows.count(2)
    images, seconds, k1, k2 = run(fixed(1, guidance_interval=window))
    check_images(images, 1)
    report(f"fixed window {window} b1", seconds, T_MAX, k1, k2, T_MAX * layers,
           extra=f"; {guided} guided steps (CFG batch 2), {T_MAX - guided} conditional-only "
                 "(batch 1), from the host ladder, as the forwards ran")
    if rows != want_rows:
        fail(f"fixed window: the forwards ran at batches {rows}, expected {want_rows}")
    images, seconds, k1, k2 = run(fixed(1, cache_interval=2, guidance_interval=window))
    check_images(images, 1)
    report(f"fixed cache_interval 2 + window {window} b1", seconds, T_MAX, k1, k2,
           cache_launches(ladder, 2, window, layers, front))
    # 4. the window's equivalences, on the final latents
    lat = lambda **kw: run(lambda: raw.generate_fixed(*args[1], num_steps=T_MAX, seed=seed + 1,
                                                      **kw))[0]
    gaps = {}
    for name, kw, ref_kw in (("every sigma", dict(guidance_interval=(0.0, 2.0)), {}),
                             ("no sigma", dict(guidance_interval=(2.0, 3.0)),
                              dict(guidance_scale=None))):
        out, ref = torch.from_numpy(lat(**kw)).float(), torch.from_numpy(lat(**ref_kw)).float()
        gaps[name] = ((out - ref).abs().max().item(), rel_to_range(out, ref))
    phase("window equivalence", "; ".join(
        f"a window holding {k}: max abs diff {a:.3e} ({r:.3e} of the range)"
        for k, (a, r) in gaps.items()) + " (against plain CFG and guidance_scale=None; bound "
        f"{KERNEL_REL_TOL} of the range)")
    if not all(r <= KERNEL_REL_TOL for _, r in gaps.values()):
        fail(f"the guidance window's equivalences do not hold: {gaps}")
    # 5. the adaptive loop with the options
    for name, kw in (("ab2", dict(solver="ab2")), ("cache_interval 2", dict(cache_interval=2)),
                     ("cache_tau 0.1", dict(cache_tau=0.1)),
                     (f"window {window}", dict(guidance_interval=window))):
        res, seconds, k1, k2 = run(generate(1, **kw))
        check_schedule(res, 1, 1024)
        n = res.num_steps
        if not n < T_MAX:
            fail(f"adaptive {name}: {n} steps, the schedule did not stop itself")
        want = {"cache_interval 2": layers * -(-n // 2) + front * (n // 2)}.get(name, layers * n)
        n_full, rest = divmod(k1 - front * n, layers - front)
        if name.startswith("cache_tau"):
            if rest or not 1 <= n_full <= n:
                fail(f"adaptive {name}: {k1} K1 launches are no count of full and reuse steps")
            want = k1
        extra = f"; {n} steps"
        if name.startswith("cache"):
            extra += f", {n_full} full forwards by the launches"
        if name.startswith("window"):
            # the steps' sigmas: 1, then each step's sigma_next
            want_rows = window_rows([1.0] + res.sigmas[0, : n - 1].tolist())
            if rows != want_rows:
                fail(f"adaptive {name}: the forwards ran at batches {rows}, expected {want_rows}")
            extra += (f", {want_rows.count(2)} guided (CFG batch 2) and {want_rows.count(1)} "
                      "conditional-only (batch 1), as the forwards ran")
        report(f"adaptive {name} b1", seconds, n, k1, k2, want, extra=extra)
    # 6. the history images
    res, seconds, k1, k2 = run(generate(1, return_full_process_images=True))
    n, hist = res.num_steps, res.history_images
    check_schedule(res, 1, 1024)
    same = hist is not None and np.array_equal(hist[-1], res.images)
    phase("history images b1", f"{n} steps, history {None if hist is None else hist.shape} "
          f"{None if hist is None else hist.dtype}, {seconds:.3f} s; K1 launches {k1}, K2 "
          f"launches {k2}; last frame equals the image: {same}")
    if (hist is None or hist.shape != (n, 1, 1024, 1024, 3) or hist.dtype.name != "uint8"
            or not same or (k1, k2) != (layers * n, n + 1)):
        fail("the history images are wrong, or K1/K2 launched other counts than "
             f"{layers * n} / {n + 1}")
    del mmdit, tpm, vae, pipe, raw, res, hist, images
    gc.collect()
    torch.cuda.empty_cache()
    # 7. the Δ-cache forward's numerics: phase 4's 2-layer MMDiT, bf16
    # through K1 on the card against fp32 on the CPU
    small = MMDiTConfig.sd3_medium(num_layers=2, num_attention_heads=4,
                                   caption_projection_dim=256, sample_size=16,
                                   cache_front_blocks=1)
    cpu_gen = torch.Generator().manual_seed(seed)
    m_cpu = MMDiT(small).init_weights(cpu_gen, WEIGHT_STD).to(torch.bfloat16).float()
    m_card = MMDiT(small).to(dev)
    m_card.load_state_dict(m_cpu.state_dict())
    m_card.to(torch.bfloat16)
    inputs = (torch.randn(2, 16, 16, 16, generator=cpu_gen), torch.tensor([1000.0, 420.0]),
              torch.randn(2, 77, 4096, generator=cpu_gen), torch.randn(2, 2048, generator=cpu_gen))
    # each side's reuse forward takes its own recorded Δ. Δ is the
    # difference of two bf16 residual-stream values, of order 1, while Δ
    # itself is of order 0.02 here: its error against its own range is
    # bf16's step on the stream, so it is printed, and it is held through
    # the reuse forward's outputs, which take the card's Δ
    outs = {}
    with torch.no_grad():
        for name, model, xs in (("cpu", m_cpu, inputs),
                                ("card", m_card, [x.to(dev, torch.bfloat16) for x in inputs])):
            rec = model(*xs, cache_mode="record")
            later = (xs[0], xs[1] * 0.5, *xs[2:])
            outs[name] = (rec, model(*later, delta=rec[4], cache_mode="reuse"))
    errs = [max(rel_to_range(c.cpu(), r) for c, r in zip(card[:4], cpu[:4]))
            for card, cpu in zip(outs["card"], outs["cpu"])]
    delta_err = rel_to_range(outs["card"][0][4].cpu(), outs["cpu"][0][4])
    phase("cache forward", f"2-layer MMDiT, record then reuse (1 front block) at half the "
                           f"timestep, card bf16 vs CPU fp32, max rel err of (velocity, temb, "
                           f"h1, h2): record {errs[0]:.3e}, reuse {errs[1]:.3e} (bound "
                           f"{MODULE_REL_TOL}); Δ {delta_err:.3e} of its own range")
    if not max(errs) < MODULE_REL_TOL:
        fail("the card's Δ-cache forward disagrees with its CPU fp32 reference")
    phase("fixed phase", f"{time.perf_counter() - t_phase:.1f} s")
    return tuple(totals)


# Phase 13's YAMLs name the builders below (chip_smoke.<name>, resolved by
# the port's instantiate). The models are built on the first call and shared
# by the phase's three runs; "recorder" is the UpdateRecorder of the run
# under way and "decodes" counts the eval's image decodes
_CLI: dict = {}


def _cli_models(seed, dev):
    """Phase 11's models from ``seed``, built once: the frozen SD3-medium
    MMDiT and SD3 VAE decoder in bf16, the fp32 ImageReward and a tokenizer
    over the example prompts' words."""
    if "models" not in _CLI:
        from tpdm_tpu_torch.models.mmdit import MMDiTConfig
        from tpdm_tpu_torch.rewards import ImageRewardModel
        from tpdm_tpu_torch.utils.bert_tokenizer import BertTokenizer

        mmdit, _, vae = build_models(dev, seed, MMDiTConfig.sd3_medium())
        reward_model = ImageRewardModel.create(seed=seed + 30, device=dev)
        with open(REPO / "example" / "prompts.jsonl") as f:
            prompts = [json.loads(line)["prompt"] for line in f if line.strip()]
        with tempfile.TemporaryDirectory() as tmp:
            write_vocab(Path(tmp) / "vocab.txt", prompts)
            tokenizer = BertTokenizer.from_pretrained(tmp)
        _CLI["models"] = (mmdit, vae, reward_model, tokenizer)
    return _CLI["models"]


def cli_agent(config, device="cuda", seed=0):
    """The model YAML's builder: a TPDMAgent over the shared MMDiT (its TPM
    from ``config``: fp32 weights, the paper's head bias, computing in
    bf16), with a ``decode_fn`` for the eval's images; the current recorder
    times its rollouts."""
    from tpdm_tpu_torch.pipeline.pipeline import decode_latents
    from tpdm_tpu_torch.train import TPDMAgent

    mmdit, vae, _, _ = _cli_models(seed, torch.device(device))
    agent = TPDMAgent(mmdit, config)

    def decode_fn(latents):
        _CLI["decodes"] += 1
        return decode_latents(vae, latents)

    agent.decode_fn = decode_fn
    return _CLI["recorder"].wrap_agent(agent)


def cli_reward(device="cuda", seed=0):
    """The reward YAML's builder: phase 11's ImageReward over the shared
    VAE's decode, timed by the current recorder."""
    from tpdm_tpu_torch.train.builders import build_image_reward_fn

    _, vae, reward_model, tokenizer = _cli_models(seed, torch.device(device))
    return _CLI["recorder"].wrap_reward(build_image_reward_fn(vae, reward_model, tokenizer))


def cli_collator(device="cuda", seed=0):
    """The collator YAML's builder: phase 11's prompt embedder (333 tokens,
    bf16, on the card) for the shared MMDiT."""
    import types

    from tpdm_tpu_torch.train.builders import make_prompt_encoder

    mmdit = _cli_models(seed, torch.device(device))[0]
    shape = types.SimpleNamespace(mmdit=mmdit, device=next(mmdit.parameters()).device,
                                  dtype=torch.bfloat16)
    return make_prompt_encoder(shape, n_txt=N_CTX, seed=seed)


def png_pixels(data: bytes, name: str) -> np.ndarray:
    """The uint8 pixels of a PNG (the port's stdlib reader); a malformed one
    fails the run."""
    from tpdm_tpu_torch.utils.image import read_png

    try:
        return read_png(data)
    except ValueError as e:
        fail(f"{name}: {e}")


def png_shape(path):
    """(height, width, channels) of png_pixels' PNG at ``path``."""
    return png_pixels(Path(path).read_bytes(), str(path)).shape


def trace_kernels(path):
    """The device events (kernels, copies, fills) of a Chrome trace: (name,
    start us, end us)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def cli_phase(seed, dev):
    """Phase 13: RLOO training through the port's command line, in-process:
    run A (two updates with the eval, TensorBoard and the profiler), run B
    (resumed from A for update 3), run C (update 1 again, its cache
    offloaded to the host). Returns the K1 and K2 launches of the three."""
    from tpdm_tpu_torch.ops.attention import flash_attention, flash_attention_streaming
    from tpdm_tpu_torch.train import rloo
    from tpdm_tpu_torch.train.callbacks import EvalVisualizationCallback, ProfilerCallback
    from tpdm_tpu_torch.train.main import main as train_main
    from tpdm_tpu_torch.utils.tb_writer import read_scalar_events

    # chip_smoke.<builder> resolves to this module, not to a second copy
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    profile_script = load_profile_script()

    t_phase = time.perf_counter()
    counters = (flash_attention, flash_attention_streaming)
    totals = [0, 0]

    def run(argv):
        recorder = UpdateRecorder(dev)
        _CLI.update(recorder=recorder, decodes=0)
        for fn in counters:
            fn.launches = 0
        with contextlib.chdir(REPO):  # the dataset YAML names example/prompts.jsonl
            trainer = train_main(argv, callbacks=[recorder])
        torch.cuda.synchronize()
        got = [fn.launches for fn in counters]
        totals[0], totals[1] = totals[0] + got[0], totals[1] + got[1]
        return trainer, recorder, got

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        yamls = {}
        for name in ("agent", "reward", "collator"):
            yamls[name] = tmp / f"{name}.yaml"
            partial = "_partial_: true\n" if name == "agent" else ""
            yamls[name].write_text(f"_target_: chip_smoke.cli_{name}\n{partial}seed: {seed}\n")
        common = [
            "--model_config", str(yamls["agent"]), "--reward_model_config", str(yamls["reward"]),
            "--train_dataset", str(REPO / "configs" / "torch" / "datasets" / "jsonl_prompts.yaml"),
            "--data_collator", str(yamls["collator"]),
            "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "2",
            "--rloo_k", "2", "--learning_rate", str(RLOO_LR), "--kl_coef", "0.05",
            "--gamma", "0.9", "--max_inference_steps", str(T_MAX), "--guidance_scale", "7.0",
            "--seed", str(seed), "--save_steps", "1", "--logging_steps", "1"]
        out_a, out_c = tmp / "run_a", tmp / "run_c"

        # run A: two updates, the eval at update 2, TensorBoard, update 2 profiled
        trainer, rec_a, (k1_a, k2_a) = run(common + [
            "--output_dir", str(out_a), "--total_episodes", "8", "--eval_steps", "2",
            "--report_to", "tensorboard", "--profile_updates", "1", "--profile_start", "1"])
        layers = _CLI["models"][0].config.num_layers
        phase("cli models", f"phase 11's models from seed {seed}, built in run A; "
                            f"{trainer.sizes['num_total_batches']} updates of "
                            f"{trainer.sizes['batch_size']} samples")
        for row in rec_a.rows:
            print_update(f"cli A update {row['update']}", row, layers)
        if [r["update"] for r in rec_a.rows] != [1, 2]:
            fail(f"run A ran updates {[r['update'] for r in rec_a.rows]}, expected 1 and 2")
        jsonl = [json.loads(line) for line in (out_a / "metrics.jsonl").read_text().splitlines()]
        if [r["update"] for r in jsonl] != [1, 2]:
            fail(f"run A's metrics.jsonl holds updates {[r['update'] for r in jsonl]}")
        tb_files = sorted((out_a / "tb").glob("events.out.tfevents.*"))
        events = [e for f in tb_files for e in read_scalar_events(str(f))]
        for (step, scalars), row in zip(events, jsonl):
            want = {k: np.float32(v) for k, v in row.items() if k != "update"}
            if (step != row["update"] or scalars.keys() != want.keys()
                    or any(np.float32(scalars[k]) != want[k] for k in want)):
                fail(f"the TensorBoard event of update {step} differs from metrics.jsonl")
        if len(events) != len(jsonl):
            fail(f"{len(events)} TensorBoard events for {len(jsonl)} metrics.jsonl rows")
        phase("cli tensorboard", f"{len(tb_files)} event file(s), {len(events)} events of "
                                 f"{len(events[0][1])} tags, equal (float32) to metrics.jsonl")

        ev = next(cb for cb in trainer.callbacks if isinstance(cb, EvalVisualizationCallback))
        eval_b, eval_steps = rec_a.samples[-1]
        if len(ev.history) != 1 or ev.history[0]["update"] != 2 or eval_b != 10:
            fail(f"eval history {[r['update'] for r in ev.history]}, last rollout batch {eval_b}")
        rec = ev.history[0]
        img_shape = png_shape(out_a / "eval" / "eval_images_2.png")
        phase("cli eval", f"update 2: {eval_b} prompts (CFG batch {2 * eval_b}), {eval_steps} "
                          f"steps, NFE {rec['nfe'].tolist()} (mean {rec['nfe'].mean():.2f}), "
                          f"rewards mean {rec['rewards'].mean():.4f}; image strip "
                          f"{img_shape}; {rec['seconds']:.3f} s (rollout, reward, decode, PNG)")
        if (not 1 <= rec["nfe"].min() <= rec["nfe"].max() <= 40
                or rec["nfe"].max() != eval_steps
                or rec["rewards"].shape != (eval_b,) or not np.isfinite(rec["rewards"]).all()):
            fail(f"eval record: nfe {rec['nfe']}, {eval_steps} steps, rewards {rec['rewards']}")
        if img_shape != (1024, eval_b * 1024, 3):
            fail(f"the eval's image strip is {img_shape}, expected (1024, {eval_b * 1024}, 3)")
        want_k1 = layers * (sum(r["steps"] for r in rec_a.rows) + eval_steps)
        want_k2 = rec_a.reward_calls + _CLI["decodes"]
        phase("cli launches", f"run A: K1 {k1_a} ({layers} x ({' + '.join(str(r['steps']) for r in rec_a.rows)}"
                              f" rollout + {eval_steps} eval steps) = {want_k1}), K2 {k2_a} "
                              f"({rec_a.reward_calls} reward decodes + {_CLI['decodes']} eval "
                              f"image decode)")
        if (k1_a, k2_a) != (want_k1, want_k2):
            fail(f"run A launched K1 {k1_a} and K2 {k2_a} times, expected {want_k1} and {want_k2}")

        prof = next(cb for cb in trainer.callbacks if isinstance(cb, ProfilerCallback))
        kernels = trace_kernels(prof.trace_path)
        groups, busy_ms, idle, _ = profile_script.summarise(kernels)
        k1_trace = groups.get("K1 flash_attn_sm90_kernel<false>", (0.0, 0))[1]
        k2_trace = groups.get("K2 flash_attn_d512_kernel", (0.0, 0))[1]
        phase("cli profile", f"{Path(prof.trace_path).name}: {len(kernels)} device events, "
                             f"{busy_ms:.1f} ms busy, idle share {idle:.4f}; K1 {k1_trace} "
                             f"launches ({layers} x update 2's {rec_a.rows[1]['steps']} steps), K2 "
                             f"{k2_trace}")
        total_ms = sum(ms for ms, _ in groups.values())
        for label, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            phase("cli profile", f"| {label} | {ms:.2f} | {100 * ms / total_ms:.2f} % | {n} |")
        if k1_trace != layers * rec_a.rows[1]["steps"] or k2_trace != 1:
            fail(f"the trace holds {k1_trace} K1 and {k2_trace} K2 kernels, not update 2's")
        del trainer, ev, prof, kernels
        gc.collect()

        # run B: resumed from checkpoint-2 for update 3 alone
        trainer, rec_b, _ = run(common + [
            "--output_dir", str(out_a), "--total_episodes", "12", "--report_to", "tensorboard",
            "--resume_from_checkpoint", "true"])
        for row in rec_b.rows:
            print_update(f"cli B update {row['update']}", row, layers)
        jsonl = [json.loads(line) for line in (out_a / "metrics.jsonl").read_text().splitlines()]
        if ([r["update"] for r in rec_b.rows] != [3] or [r["update"] for r in jsonl] != [1, 2, 3]
                or not (out_a / "checkpoint-3").is_dir()):
            fail(f"run B: updates {[r['update'] for r in rec_b.rows]}, metrics.jsonl "
                 f"{[r['update'] for r in jsonl]}, checkpoints {sorted(os.listdir(out_a))}")
        phase("cli resume", f"run B resumed from checkpoint-2: update 3 only; metrics.jsonl "
                            f"{len(jsonl)} rows; {sorted(p.name for p in out_a.glob('checkpoint-*'))}")
        del trainer
        gc.collect()

        # run C: update 1 again with the cache offloaded to the host, the
        # offload timed on its own (it runs between the rollout and the reward)
        offload = rloo.offload_outputs_to_host

        def timed_offload(outputs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = offload(outputs)
            torch.cuda.synchronize()
            offload_s.append(time.perf_counter() - start)
            return out

        offload_s = []
        rloo.offload_outputs_to_host = timed_offload
        try:
            trainer, rec_c, _ = run(common + [
                "--output_dir", str(out_c), "--total_episodes", "4", "--offload_cache", "host"])
        finally:
            rloo.offload_outputs_to_host = offload
        del trainer
        row_a, row_c = rec_a.rows[0], rec_c.rows[0]
        print_update("cli C update 1", row_c, layers)
        ma, mc = row_a["metrics"], row_c["metrics"]
        rel = max((0.0 if ma[k] == mc[k] else abs(ma[k] - mc[k]) / max(abs(ma[k]), abs(mc[k])))
                  for k in ma if k != "eps")  # eps: episodes a second
        at_a, at_c = row_a["at_reward"], row_c["at_reward"]
        drop = at_a["allocated"] - at_c["allocated"]
        cache = at_c["cache_bytes"]
        phase("cli offload", f"update 1 with offload_cache host against run A's: largest "
                             f"relative metric difference {rel:.3e} (bound 1e-6); at the reward "
                             f"call {at_a['allocated'] / 2**30:.3f} GiB allocated (cache on "
                             f"{at_a['cache_on']}) against {at_c['allocated'] / 2**30:.3f} GiB "
                             f"(cache on {at_c['cache_on']}): {drop / 2**30:.3f} GiB less, the "
                             f"cache {cache / 2**30:.3f} GiB; peaks {row_a['peak_gib']:.2f} / "
                             f"{row_c['peak_gib']:.2f} GiB; update 1 {row_a['rollout_s'] + row_a['reward_s'] + row_a['ppo_s']:.3f}"
                             f" / {row_c['rollout_s'] + row_c['reward_s'] + row_c['ppo_s']:.3f} s, "
                             f"the offload {offload_s[0]:.3f} s of run C's reward time, PPO "
                             f"{row_a['ppo_s']:.3f} / {row_c['ppo_s']:.3f} s")
        if not rel <= 1e-6:
            fail(f"the offloaded update 1 differs from run A's by {rel:.3e}")
        if (len(offload_s) != 1 or at_a["cache_on"] != ["cuda"] or at_c["cache_on"] != ["cpu"]
                or drop < 0.9 * cache):
            fail(f"{len(offload_s)} offloads freed {drop} bytes of a {cache}-byte cache")
    _CLI.clear()
    gc.collect()
    torch.cuda.empty_cache()
    phase("cli phase", f"{time.perf_counter() - t_phase:.1f} s")
    return tuple(totals)


def write_clip_vocab(path, prompts):
    """A CLIP BPE vocabulary (vocab.json, merges.txt) for ``prompts`` in
    ``path``: every byte symbol alone and with "</w>", the merges that
    build each of their words whole from left to right, and CLIP's special
    tokens at their ids, <|startoftext|> 49406 and <|endoftext|> 49407
    (the ids between them unused). Returns the number of entries."""
    import html

    from tpdm_tpu_torch.utils import tokenizer as clip_tokenizer

    b2u = clip_tokenizer._bytes_to_unicode()
    syms = sorted(set(b2u.values()))
    vocab = {s: i for i, s in enumerate(syms)}
    vocab.update({s + "</w>": len(syms) + i for i, s in enumerate(syms)})
    merges = ["#version: 0.2"]
    for prompt in prompts:
        text = clip_tokenizer._whitespace_clean(html.unescape(html.unescape(prompt))).lower()
        for word in clip_tokenizer._PAT.findall(text):
            pieces = [b2u[b] for b in word.encode("utf-8")]
            pieces[-1] += "</w>"
            head = pieces[0]
            for nxt in pieces[1:]:
                if head + nxt not in vocab:
                    vocab[head + nxt] = len(vocab)
                    merges.append(f"{head} {nxt}")
                head += nxt
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    Path(path).mkdir(parents=True)
    (Path(path) / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (Path(path) / "merges.txt").write_text("\n".join(merges) + "\n", encoding="utf-8")
    return len(vocab)


def write_t5_vocab(path, prompts):
    """A T5 Unigram vocabulary for ``prompts`` as ``path``/spiece.model:
    pad 0, eos 1, unk 2, "▁", every character of their words, and each
    word after "▁" (scored above its characters). Returns its size."""
    from tpdm_tpu_torch.utils import t5_tokenizer

    words = sorted({w for p in prompts for w in t5_tokenizer._normalize(p).split()})
    chars = sorted({c for w in words for c in w})
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -5.0, 1)]
    pieces += [(c, -10.0, 1) for c in chars] + [("▁" + w, -1.0, 1) for w in words]
    Path(path).mkdir(parents=True)
    (Path(path) / "spiece.model").write_bytes(t5_tokenizer.serialize_spm_model(pieces))
    return len(pieces)


def text_reference_phase(seed, dev):
    """Phase 14, step 1: a 2-layer CLIP-G and a 2-layer T5 at full width,
    bf16 on the card, against the same (bf16-rounded) weights in fp32 on
    the CPU. The same weights in bf16 on the CPU give the gap that bf16
    alone opens, without the card."""
    from tpdm_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from tpdm_tpu_torch.models.t5 import T5Config, T5Encoder

    from tpdm_tpu_torch.models.layers import init_weights_by_rank

    cpu_gen = torch.Generator().manual_seed(seed + 42)
    clip_ids = torch.randint(0, 49406, (2, 77), generator=cpu_gen)
    clip_ids[0, 30] = 49407  # row 1 has no EOS: pooled at position 0
    t5_ids = torch.randint(3, 32128, (2, 256), generator=cpu_gen)
    clip_g = lambda: CLIPTextModel(CLIPTextConfig.sd3_clip_g(num_hidden_layers=2))
    t5 = lambda: T5Encoder(T5Config.t5_xxl(num_layers=2))
    errs, cpu_errs = {}, {}
    # T5 at its own init (q N(0, 1/(d_model d_kv)), ...: scores of order
    # one), as the tower below; then, reported without a bound, at N(0,
    # 0.02²) everywhere, where its unscaled scores reach a std of ~13 and a
    # near-argmax softmax turns bf16's rounding of q and k into a few %
    for name, make, ids, init in (
            ("CLIP-G", clip_g, clip_ids, lambda m: m.init_weights(cpu_gen, WEIGHT_STD)),
            ("T5", t5, t5_ids, lambda m: m.init_weights(cpu_gen)),
            ("T5 N(0, 0.02^2)", t5, t5_ids,
             lambda m: init_weights_by_rank(m, cpu_gen, WEIGHT_STD))):
        m_cpu = init(make()).to(torch.bfloat16).float()
        with torch.device(dev):
            m_card = make()
        m_card.load_state_dict(m_cpu.state_dict())
        m_card.to(torch.bfloat16)
        with torch.no_grad():
            ref, out = m_cpu(ids), m_card(ids.to(dev))
        if not isinstance(ref, tuple):
            ref, out = (ref,), (out,)
        if not all(bool(torch.isfinite(o).all()) for o in out):
            fail(f"the 2-layer {name} gave non-finite values on the card")
        errs[name] = max(rel_to_range(o.cpu(), r) for o, r in zip(out, ref))
        del m_card
        m_cpu.to(torch.bfloat16)
        with torch.no_grad():
            out_cpu = m_cpu(ids)
        if not isinstance(out_cpu, tuple):
            out_cpu = (out_cpu,)
        cpu_errs[name] = max(rel_to_range(o.float(), r) for o, r in zip(out_cpu, ref))
        del m_cpu
        torch.cuda.empty_cache()
    phase("serve reference", f"2-layer CLIP-G (1280 wide, 20 heads, 77 tokens; all four "
          f"outputs, a row without EOS) max rel err {errs['CLIP-G']:.3e}; 2-layer T5 (4096 wide, "
          f"64 heads, 256 tokens) {errs['T5']:.3e}; card bf16 against CPU fp32 (bound "
          f"{MODULE_REL_TOL}); T5 with N(0, {WEIGHT_STD}^2) weights everywhere "
          f"{errs['T5 N(0, 0.02^2)']:.3e} (no bound); the same weights in bf16 on the CPU "
          f"against CPU fp32: " + ", ".join(f"{k} {v:.3e}" for k, v in cpu_errs.items()))
    if not max(errs["CLIP-G"], errs["T5"]) < MODULE_REL_TOL:
        fail("the card's text towers disagree with their CPU fp32 reference")


def serve_models(seed, dev):
    """Phase 14's models: CLIP-L, CLIP-G and T5-XXL in bf16 from the seed
    beside phase 5's MMDiT, TPM and VAE (rebuilt from the seed, as phase 12
    does), and toy CLIP, T5 and BERT tokenizers of the example prompts.
    Returns a namespace of the pipeline, towers, tokenizers and prompts."""
    from tpdm_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from tpdm_tpu_torch.models.mmdit import MMDiTConfig
    from tpdm_tpu_torch.models.t5 import T5Config, T5Encoder
    from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline
    from tpdm_tpu_torch.pipeline.text_encoding import SD3TextEncoders
    from tpdm_tpu_torch.utils.bert_tokenizer import BertTokenizer
    from tpdm_tpu_torch.utils.t5_tokenizer import T5Tokenizer
    from tpdm_tpu_torch.utils.tokenizer import CLIPTokenizer

    t0 = time.perf_counter()
    mmdit, tpm, vae = build_models(dev, seed, MMDiTConfig.sd3_medium())
    gen = torch.Generator(device=dev).manual_seed(seed + 40)
    towers = {}
    for name, make in (("CLIP-L", lambda: CLIPTextModel(CLIPTextConfig.sd3_clip_l())),
                       ("CLIP-G", lambda: CLIPTextModel(CLIPTextConfig.sd3_clip_g())),
                       ("T5-XXL", lambda: T5Encoder(T5Config.t5_xxl()))):
        with torch.device(dev):
            tower = make()
        # T5 at its own init (text_reference_phase), CLIP at N(0, 0.02²)
        if name == "T5-XXL":
            tower.init_weights(gen)
        else:
            tower.init_weights(gen, WEIGHT_STD)
        towers[name] = tower.to(torch.bfloat16)
        torch.cuda.empty_cache()  # the fp32 draw
    te = SD3TextEncoders(towers["CLIP-L"], towers["CLIP-G"], towers["T5-XXL"],
                         t5_width=mmdit.config.joint_attention_dim)
    pipe = TPDMPipeline(mmdit, tpm, vae, text_encoders=te)
    with open(REPO / "example" / "prompts.jsonl") as f:
        prompts = [json.loads(line)["prompt"] for line in f if line.strip()]
    with tempfile.TemporaryDirectory() as tmp:
        n_clip = write_clip_vocab(Path(tmp) / "clip", prompts)
        n_t5 = write_t5_vocab(Path(tmp) / "t5", prompts)
        (Path(tmp) / "bert").mkdir()
        write_vocab(Path(tmp) / "bert" / "vocab.txt", prompts)
        clip_tok = CLIPTokenizer.from_pretrained(str(Path(tmp) / "clip"), max_length=77)
        t5_tok = T5Tokenizer.from_pretrained(str(Path(tmp) / "t5"), max_length=256)
        bert_tok = BertTokenizer.from_pretrained(str(Path(tmp) / "bert"))

    def tokenize(prompt):
        return (clip_tok([prompt], max_length=77)["input_ids"],
                t5_tok([prompt], max_length=256)["input_ids"])

    torch.cuda.synchronize()
    return argparse.Namespace(pipe=pipe, te=te, towers=towers, tokenize=tokenize,
                              prompts=prompts, bert_tok=bert_tok, n_clip=n_clip, n_t5=n_t5,
                              seconds=time.perf_counter() - t0)


def serve_phase(seed, dev, smi):
    """Phase 14: text prompts through the port's serving path at full width.
    The 2-layer reference check; ``serve_models``' pipeline and tokenizers;
    generate from ids against generate from embeds; a BatchingEngine (max_batch 2,
    25 ms window, 35 steps, 512 px served too) answering concurrent,
    repeated (embed-cache hit), capped, guided with a negative, and 512 px
    requests, a batch of two against a direct generate; then the HTTP
    server's endpoints. K1 and K2 launches are checked around every call.
    Returns the K1 and K2 launches of the phase and ``serve_models``'
    namespace, for phase 15."""
    import http.client
    import threading

    from tpdm_tpu_torch import serve
    from tpdm_tpu_torch.models.vae import vae_scale_factor
    from tpdm_tpu_torch.ops.attention import flash_attention, flash_attention_streaming
    from tpdm_tpu_torch.rewards import ImageRewardModel
    from tpdm_tpu_torch.serving import BatchingEngine
    from tpdm_tpu_torch.train.builders import build_inference_ranker
    from tpdm_tpu_torch.utils.image import png_bytes

    t_phase = time.perf_counter()
    text_reference_phase(seed, dev)  # 1

    # 2. the towers, phase 5's models and the tokenizers
    served = serve_models(seed, dev)
    pipe, te, towers, tokenize = served.pipe, served.te, served.towers, served.tokenize
    prompts, bert_tok, n_clip, n_t5 = served.prompts, served.bert_tok, served.n_clip, served.n_t5
    mmdit, vae = pipe.mmdit, pipe.vae
    layers = mmdit.config.num_layers
    mcfg = mmdit.config
    factor = vae_scale_factor(vae.config)
    px = mcfg.sample_size * factor
    sizes = {name: (sum(p.numel() for p in t.parameters()), module_bytes(t))
             for name, t in towers.items()}
    allocated = torch.cuda.memory_allocated(dev)
    phase("serve models", "; ".join(f"{name} {n / 1e9:.4f} B params, {b / 1e9:.3f} GB bf16"
                                    for name, (n, b) in sizes.items())
          + f"; towers {sum(n for n, _ in sizes.values()) / 1e9:.4f} B params, "
          f"{sum(b for _, b in sizes.values()) / 1e9:.3f} GB; with phase 5's MMDiT, TPM and VAE "
          f"{allocated / 2**30:.2f} GiB allocated; weights from seed {seed} (CLIP N(0, "
          f"{WEIGHT_STD}^2), T5 at its own init); {served.seconds:.1f} s")

    tok_ms = {}
    for label in ("first", "again"):  # the CLIP tokenizer caches each word's BPE
        times = []
        for p in prompts:
            start = time.perf_counter()
            c, t5 = tokenize(p)
            times.append(1e3 * (time.perf_counter() - start))
            if c.max() >= 49408 or t5.max() >= 32128 or (c == 49407).sum() < 1:
                fail(f"tokenize({p!r}): ids out of the vocabulary or no EOS")
        tok_ms[label] = (float(np.median(times)), max(times))
    c1, t1 = tokenize(prompts[0])
    phase("serve tokenize", f"CLIP BPE ({n_clip} entries, 77 ids) + T5 Unigram ({n_t5} pieces, "
          f"256 ids) of the {len(prompts)} example prompts, on the host: median "
          f"{tok_ms['first'][0]:.3f} ms (max {tok_ms['first'][1]:.3f}) a prompt, again "
          f"{tok_ms['again'][0]:.3f} ms; {prompts[0]!r}: {int((c1 != 49407).sum()) + 1} CLIP and "
          f"{int((t1 != 0).sum())} T5 tokens")

    # the encode at batch 2, towers run: the first call, then warm
    p1, p2, p3 = prompts[0], prompts[2], prompts[4]
    ids = [tokenize(p) for p in (p1, p2)]
    c2, t2 = np.concatenate([c for c, _ in ids]), np.concatenate([t for _, t in ids])
    torch.cuda.synchronize()
    start = time.perf_counter()
    pe, pp = te.encode(c2, t2)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - start)
    if pe.shape != (2, N_CTX, mcfg.joint_attention_dim) or pp.shape != (
            2, mcfg.pooled_projection_dim) or not bool(
            torch.isfinite(pe).all()) or pe.requires_grad:
        fail(f"encode gave {tuple(pe.shape)} / {tuple(pp.shape)} embeds (finite, no grad?)")
    encode_ms = median_ms(lambda: te.encode(c2, t2), reps=5)
    c2_dev = torch.as_tensor(c2, device=dev).long()
    t2_dev = torch.as_tensor(t2, device=dev).long()
    with torch.no_grad():
        tower_ms = {"CLIP-L": median_ms(lambda: te.clip_l(c2_dev), reps=5),
                    "CLIP-G": median_ms(lambda: te.clip_g(c2_dev), reps=5),
                    "T5-XXL": median_ms(lambda: te.t5(t2_dev), reps=5)}
    t5_blocks = sum(p.numel() for n_, p in towers["T5-XXL"].named_parameters()
                    if n_.startswith("block.") and p.dim() == 2 and "relative" not in n_)
    t5_flop = 2 * 512 * t5_blocks + 4 * 2 * 64 * 256 * 256 * 64 * 24
    phase("serve encode", f"batch 2 (prompts 1 and 3), towers run: first call {first_ms:.2f} ms, "
          f"warm {encode_ms:.3f} ms (median of 5; CLIP-L {tower_ms['CLIP-L']:.3f}, CLIP-G "
          f"{tower_ms['CLIP-G']:.3f}, T5-XXL {tower_ms['T5-XXL']:.3f} ms, "
          f"{t5_flop / 1e12:.3f} TFLOP, {t5_flop / tower_ms['T5-XXL'] / 1e9:.1f} TFLOP/s); "
          f"{smi}")

    # launches: K1 layers x the steps of each generate call (every forward
    # at CFG batch), K2 one a decode
    calls = []
    plain_generate = pipe.generate

    def counted_generate(*a, **kw):
        res = plain_generate(*a, **kw)
        calls.append(res.num_steps)
        return res

    pipe.generate = counted_generate
    flash_attention.launches = flash_attention_streaming.launches = 0

    def run(label, fn):
        """fn() timed, the K1 and K2 launches during it checked."""
        n_calls = len(calls)
        k1, k2 = flash_attention.launches, flash_attention_streaming.launches
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        steps = calls[n_calls:]
        got = (flash_attention.launches - k1, flash_attention_streaming.launches - k2)
        if not steps or got != (layers * sum(steps), len(steps)):
            fail(f"{label}: K1 {got[0]} and K2 {got[1]} launches over generate calls of "
                 f"{steps} steps, expected K1 {layers * sum(steps)} and K2 {len(steps)}")
        return out, seconds, steps, got

    # 3. generate from ids against generate from the same ids' embeds
    zc, zt = np.zeros_like(c2), np.zeros_like(t2)
    lat = torch.randn((2, mcfg.in_channels, mcfg.sample_size, mcfg.sample_size),
                      generator=torch.Generator(device=dev).manual_seed(
        seed + 41), device=dev, dtype=next(mmdit.parameters()).dtype)
    torch.cuda.reset_peak_memory_stats(dev)
    from_ids, s_ids, _, n_ids = run("generate from ids", lambda: pipe.generate(
        clip_ids=c2, t5_ids=t2, negative_clip_ids=zc, negative_t5_ids=zt, latents=lat,
        max_inference_steps=T_MAX))
    npe, npp = te.encode(zc, zt)
    from_embeds, s_emb, _, _ = run("generate from embeds", lambda: pipe.generate(
        pe, pp, npe, npp, latents=lat, max_inference_steps=T_MAX))
    check_schedule(from_ids, 2, px)
    if not (np.array_equal(from_ids.images, from_embeds.images)
            and np.array_equal(from_ids.last_valid_index, from_embeds.last_valid_index)):
        fail("generate(clip_ids=, t5_ids=) differs from generate(prompt_embeds=encode(...))")
    phase("serve parity", f"generate(clip_ids=, t5_ids=) at batch 2 equals generate on "
          f"encode()'s embeds to the bit: {from_ids.num_steps} steps, {s_ids:.3f} s from ids "
          f"(encode included) against {s_emb:.3f} s from embeds; K1 {n_ids[0]}, K2 {n_ids[1]}")

    # 4. the engine
    engine = BatchingEngine(pipe, tokenize, max_batch=2, window_ms=25, max_steps=35,
                            resolutions=[SERVE_EXTRA_PX], vae_scale_factor=factor)
    _, s_warm, steps_warm, _ = run("warmup", engine.warmup)
    phase("serve warmup", f"BatchingEngine(max_batch=2, window_ms=25, max_steps=35, "
          f"resolutions=[{SERVE_EXTRA_PX}]).warmup(): {steps_warm[0]} steps, {s_warm:.3f} s")
    s1, s2, s3 = seed + 51, seed + 52, seed + 53
    rows = []  # (label, seconds, steps of the engine's generate calls, launches, results)

    def request(label, *submits, via=None):
        via = via or engine
        results, seconds, steps, got = run(label, lambda: [
            r.result(timeout=600) for r in [via.submit(*a, **kw) for a, kw in submits]])
        for res in results:
            if res["image"].dtype != np.uint8 or res["image"].ndim != 3:
                fail(f"{label}: image {res['image'].dtype} {res['image'].shape}")
        rows.append((label, seconds, steps, got, results))
        phase(f"serve request {label}", f"{seconds:.3f} s, "
              f"{[r['inference_steps'] for r in results]} steps a request, {len(steps)} "
              f"batch(es) of {steps} loop steps, K1 {got[0]}, K2 {got[1]}")
        return results

    engine.start()
    try:
        batches = engine.batches_run
        ra, rb = request("2 concurrent", ((p1,), dict(seed=s1)), ((p2,), dict(seed=s2)))
        if engine.batches_run - batches != 1:
            fail(f"2 concurrent requests ran in {engine.batches_run - batches} batches")
        hits = engine.embed_hits
        (rc,) = request("repeat (cache hit)", ((p1,), dict(seed=s1)))
        if engine.embed_hits - hits != 2 or not np.array_equal(rc["image"], ra["image"]):
            fail(f"the repeated request: {engine.embed_hits - hits} embed-cache hits, image "
                 f"equal {np.array_equal(rc['image'], ra['image'])}")
        (rd,) = request("steps=5", ((p3,), dict(seed=s3, steps=5)))
        if not 1 <= rd["inference_steps"] <= 5:
            fail(f"a steps=5 request ran {rd['inference_steps']} steps")
        negative = "blurry, low quality"
        (re_,) = request("guidance 4.0 + negative",
                         ((p1,), dict(seed=s1, guidance_scale=4.0, negative_prompt=negative)))
        if ("\x00neg", negative) not in engine._embed_cache:
            fail("the negative prompt's embeds are not in the engine's cache")
        (rf,) = request(f"{SERVE_EXTRA_PX} px", ((p2,), dict(seed=s2, resolution=SERVE_EXTRA_PX)))
        if rf["image"].shape != (SERVE_EXTRA_PX, SERVE_EXTRA_PX, 3):
            fail(f"the {SERVE_EXTRA_PX} px request gave {rf['image'].shape}")
    finally:
        engine.stop()
    stats = engine.stats()
    stage = list(engine._stage_times)
    # split_stages: the decode runs on the worker thread outside generate,
    # K2 still once a batch; the batch of two equal to the fused engine's
    split_engine = BatchingEngine(pipe, tokenize, max_batch=2, window_ms=25, max_steps=35,
                                  split_stages=True)
    split_engine.start()
    try:
        rg, rh = request("2 concurrent, split_stages", ((p1,), dict(seed=s1)),
                         ((p2,), dict(seed=s2)), via=split_engine)
    finally:
        split_engine.stop()
    split_stats = split_engine.stats()
    if not (np.array_equal(rg["image"], ra["image"]) and np.array_equal(rh["image"], rb["image"])):
        fail("the split_stages engine's batch of two differs from the fused engine's")
    phase("serve split_stages", f"the batch of two equal to the bit to the fused engine's; "
          f"denoise_s_p50 {split_stats['denoise_s_p50']:.4f}, decode_s_p50 "
          f"{split_stats['decode_s_p50']:.4f}")

    # the engine's batch of two against a direct generate on its latents
    # and embeds (the negative the towers on zero ids at batch 1)
    ne1, npp1 = te.encode(zc[:1], zt[:1])
    direct, s_direct, _, _ = run("direct generate", lambda: pipe.generate(
        pe, pp, ne1.expand(2, -1, -1), npp1.expand(2, -1),
        latents=engine._latents([s1, s2], mcfg.sample_size), max_inference_steps=35,
        guidance_scale=np.full(2, 7.0, np.float32), step_caps=np.full(2, 35, np.int32)))
    for res, img in zip((ra, rb), direct.images):
        if not np.array_equal(res["image"], img):
            fail("the engine's batch of two differs from a direct generate on its latents "
                 "and embeds")
    # the guided request against a direct generate on the engine's cached
    # rows of its prompt and negative, at guidance 4.0
    cache = engine._embed_cache
    row, neg_row = cache[p1], cache[("\x00neg", negative)]
    pair = lambda t: torch.stack([t, t])
    guided, s_guided, _, _ = run("direct guided generate", lambda: pipe.generate(
        pair(row[0]), pair(row[1]), pair(neg_row[0]), pair(neg_row[1]),
        latents=engine._latents([s1, s1], mcfg.sample_size), max_inference_steps=35,
        guidance_scale=np.full(2, 4.0, np.float32), step_caps=np.full(2, 35, np.int32)))
    if not np.array_equal(re_["image"], guided.images[0]):
        fail("the guided request with a negative prompt differs from a direct generate at "
             "guidance 4.0 on its prompt's and negative's embeds")
    moved = np.abs(re_["image"].astype(np.int16) - ra["image"].astype(np.int16))
    solo, s_solo, _, _ = run("batch 1", lambda: serve.generate(pipe, tokenize, p1, s1, 35))
    gap = np.abs(solo.images[0].astype(np.int16) - ra["image"].astype(np.int16))
    phase("serve batch of two", f"equal to the bit to a direct generate on its latents and "
          f"embeds ({s_direct:.3f} s); the guided request with a negative equal to the bit to "
          f"a direct generate at guidance 4.0 on the cached rows ({s_guided:.3f} s), against "
          f"the default request's image max |diff| {int(moved.max())} levels, "
          f"{100 * (moved > 0).mean():.3f} % of pixels; prompt 1 at batch 1 through serve.generate (the --cli "
          f"path, {int(solo.last_valid_index[0]) + 1} steps, {s_solo:.3f} s) against the engine's "
          f"batch of two: max |diff| {int(gap.max())} levels, {100 * (gap > 0).mean():.3f} % "
          f"of pixels differ (no bound: another batch shape)")
    phase("serve stats", ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in stats.items())
        + f"; encode s (miss, hit) {stage[0].get('encode_s', 0):.4f}, "
          f"{stage[1].get('encode_s', 0):.4f}")

    # 5. HTTP
    reward_model = ImageRewardModel.create(seed=seed + 30, device=dev)
    ranker = build_inference_ranker(reward_model=reward_model, tokenizer=bert_tok)
    args = argparse.Namespace(max_steps=35, max_batch=2, batch_window_ms=25.0, prompt=p1,
                              seed=s1, port=0, max_rank_n=4)
    h_engine, server = serve.make_http_server(pipe, tokenize, args, ranker=ranker)
    h_engine.start()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=600)
        try:
            conn.request(method, path, body=None if body is None else json.dumps(body))
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    try:
        (status, body), s_http, _, n_http = run(
            "POST /generate", lambda: call("POST", "/generate", {"prompt": p1, "seed": s1}))
        if status != 200:
            fail(f"POST /generate: {status} {body[:200]}")
        reply = json.loads(body)
        png = base64.b64decode(reply["image_png_base64"])
        if not np.array_equal(png_pixels(png, "/generate's PNG"), ra["image"]):
            fail("/generate's PNG differs from the engine's image of the same request")
        png_s = []
        for _ in range(3):
            start = time.perf_counter()
            png_bytes(ra["image"])
            png_s.append(time.perf_counter() - start)
        png_ms = 1e3 * min(png_s)
        gets = {path: call("GET", path) for path in ("/stats", "/metrics", "/healthz")}
        if ({path: st for path, (st, _) in gets.items()} != dict.fromkeys(gets, 200)
                or b"tpdm_batches_run" not in gets["/metrics"][1]):
            fail(f"GET endpoints: {[(p, st) for p, (st, _) in gets.items()]}")
        (status, body), s_rank, steps_rank, n_rank = run(
            "POST /rank", lambda: call("POST", "/rank", {"prompt": p2, "seed": s2, "n": 2}))
        ranked = json.loads(body) if status == 200 else {}
        if not ranked.get("ranked") or sorted(ranked["ranking"]) != [1, 2]:
            fail(f"POST /rank: {status} {body[:200]}")
        bad = call("POST", "/generate", {"prompt": 42})[0]
        if bad != 400:
            fail(f"a bad request got {bad}, not 400")
    finally:
        server.shutdown()
        h_engine.stop()
        server.server_close()
    phase("serve http", f"POST /generate round trip {s_http:.3f} s ({reply['inference_steps']} "
          f"steps; the PNG equal to the engine's image; png_bytes at {px} px {png_ms:.1f} ms, "
          f"{len(png)} bytes); GET /stats, /metrics, /healthz 200; POST /rank n=2 {s_rank:.3f} "
          f"s ({len(steps_rank)} batch(es) of {steps_rank} steps): ranking {ranked['ranking']}, "
          f"rewards {[round(r, 4) for r in ranked['rewards']]} (random ImageReward from seed "
          f"{seed + 30}); a bad request 400; K1 {n_http[0] + n_rank[0]}, K2 "
          f"{n_http[1] + n_rank[1]}")
    totals = flash_attention.launches, flash_attention_streaming.launches
    phase("serve phase", f"{time.perf_counter() - t_phase:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB over the requests; K1 "
          f"{totals[0]}, K2 {totals[1]} launches over {len(calls)} generate calls")
    pipe.generate = plain_generate
    del engine, split_engine, h_engine, reward_model, ranker
    gc.collect()
    torch.cuda.empty_cache()
    return totals, served


class ErrorRecords(logging.Handler):
    """Collects the records at ERROR or above of one logger."""

    def __init__(self, name):
        super().__init__(logging.ERROR)
        self.records = []
        self.logger = logging.getLogger(name)
        self.logger.addHandler(self)

    def emit(self, record):
        self.records.append(record)

    def close(self):
        self.logger.removeHandler(self)
        super().close()


def continuous_phase(seed, dev, served):
    """Phase 15: a mixed-cap burst through the continuous engine at full
    width on phase 14's models (``served``): runs A-G of item 15 of this
    file's docstring, each request checked, every run's K1 and K2
    launches checked exactly. Returns the K1 and K2 launches of the runs."""
    import http.client
    import threading

    from tpdm_tpu_torch import serve
    from tpdm_tpu_torch.models.vae import vae_scale_factor
    from tpdm_tpu_torch.ops.attention import flash_attention, flash_attention_streaming
    from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline
    from tpdm_tpu_torch.serving import BatchingEngine
    from tpdm_tpu_torch.serving_continuous import (
        ContinuousBatchingEngine,
        MultiResContinuousRouter,
    )
    from tpdm_tpu_torch.utils.image import postprocess_images

    t_phase = time.perf_counter()
    pipe, tokenize, prompts = served.pipe, served.tokenize, served.prompts
    mcfg = pipe.mmdit.config
    layers, front = mcfg.num_layers, mcfg.cache_front_blocks
    factor = vae_scale_factor(pipe.vae.config)
    # the same models without the VAE: the fixed engine's final latents,
    # decoded here at batch 1 as the continuous engine decodes a slot
    raw = TPDMPipeline(pipe.mmdit, pipe.tpm, None, text_encoders=pipe.text_encoders)
    mix = [(prompts[i], i, CONT_CAPS[i % len(CONT_CAPS)]) for i in range(CONT_REQUESTS)]
    errors = ErrorRecords("tpdm_tpu_torch.serving_continuous")
    totals = [0, 0]
    batches = []  # the MMDiT forwards' batch sizes
    hook = pipe.mmdit.register_forward_pre_hook(lambda m, a: batches.append(a[0].shape[0]))

    dtype = pipe._device_dtype()[1]
    as_latents = lambda lats: torch.as_tensor(np.stack(lats)).to(dev, dtype)

    def decode1(latents):
        """Final latents (fp32 of bf16 values) decoded one at a time."""
        return [postprocess_images(pipe._decode_impl(as_latents([lat])))[0] for lat in latents]

    def drive(label, engine, jobs, submit=None):
        """``jobs`` at once through a started ``engine`` (or ``submit``):
        results, and the run's makespan, latencies, segment times and
        launches."""
        submit = submit or engine.submit
        seg_events = []
        if isinstance(engine, ContinuousBatchingEngine):
            real = engine._segment

            def timed(st, live):
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = real(st, live)
                ev[1].record()
                seg_events.append(ev)
                return out

            engine._segment = timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        flash_attention.launches = flash_attention_streaming.launches = 0
        del batches[:]
        engine.start()
        try:
            start = time.monotonic()
            reqs = [submit(p, seed=s, steps=c) for p, s, c in jobs]
            done = [None] * len(reqs)
            while not all(done):
                for i, r in enumerate(reqs):
                    if done[i] is None and r._event.is_set():
                        done[i] = time.monotonic()
                time.sleep(0.001)
            results = [r.result(timeout=0) for r in reqs]
        finally:
            engine.stop()
        torch.cuda.synchronize()
        launches = (flash_attention.launches, flash_attention_streaming.launches)
        totals[0] += launches[0]
        totals[1] += launches[1]
        lat = sorted(t - r.submitted_at for t, r in zip(done, reqs))
        run = argparse.Namespace(
            label=label, results=results, launches=launches, batches=list(batches),
            makespan=max(done) - start, p50=lat[len(lat) // 2],
            p95=lat[min(len(lat) - 1, int(0.95 * len(lat)))],
            seg_ms=(float(np.mean([a.elapsed_time(b) for a, b in seg_events]))
                    if seg_events else None),
            peak=torch.cuda.max_memory_allocated(dev) / 2**30, stats=engine.stats())
        for (p, s, c), res in zip(jobs, results):
            if res["image"].dtype != np.uint8 or res["image"].ndim != 3:
                fail(f"{label}: ({p!r}, {s}) gave an image {res['image'].dtype} "
                     f"{res['image'].shape}")
            if c is not None and res["inference_steps"] != c:
                fail(f"{label}: a request capped at {c} ran {res['inference_steps']} steps")
        if errors.records:
            fail(f"{label}: serving_continuous logged {errors.records[0].getMessage()!r}")
        return run

    def report(run, engine=None):
        st = run.stats
        parts = [f"makespan {run.makespan:.3f} s, {len(run.results) / run.makespan:.3f} images/s",
                 f"latency p50 / p95 {run.p50:.3f} / {run.p95:.3f} s"]
        if engine is not None:
            parts += [f"stats() latency_s_p50 / p95 {st['latency_s_p50']:.3f} / "
                      f"{st['latency_s_p95']:.3f} s",
                      f"slot_utilization {st['slot_utilization']:.4f}",
                      f"segments_run {st['segments_run']} (host syncs: one readback a segment)",
                      f"{run.seg_ms:.2f} ms a segment ({run.seg_ms / engine.seg_steps:.2f} ms "
                      f"a step)", f"segment_traces {st['segment_traces']}"]
        else:
            parts += [f"stats() total_s_p50 / p95 {st['total_s_p50']:.3f} / "
                      f"{st['total_s_p95']:.3f} s", f"batches_run {st['batches_run']}"]
        parts += [f"NFE {[r['inference_steps'] for r in run.results]}",
                  f"peak memory {run.peak:.2f} GiB",
                  f"K1 {run.launches[0]}, K2 {run.launches[1]}"]
        phase(f"continuous {run.label}", "; ".join(parts))

    def check_continuous(run, engine, k1_segment):
        """segment_traces 1, every forward at CFG batch 2 x slots, K1
        ``k1_segment`` a segment, K2 one a decode call."""
        st = run.stats
        want = (k1_segment * st["segments_run"], engine.decode_calls)
        if st["segment_traces"] != 1:
            fail(f"{run.label}: segment_traces {st['segment_traces']}")
        if set(run.batches) != {2 * engine.slots}:
            fail(f"{run.label}: MMDiT forwards at batches {sorted(set(run.batches))}, "
                 f"expected {2 * engine.slots}")
        if run.launches != want:
            fail(f"{run.label}: K1 {run.launches[0]}, K2 {run.launches[1]} launches, expected "
                 f"K1 {want[0]} ({k1_segment} x {st['segments_run']} segments), K2 {want[1]} "
                 f"(one a decode call)")

    def continuous(**kw):
        """A continuous engine over the phase's pipeline, counting its decode
        calls."""
        engine = ContinuousBatchingEngine(pipe, tokenize, max_steps=35, **kw)
        engine.decode_calls = 0
        real = engine._decode_rows

        def counted(lats):
            engine.decode_calls += 1
            return real(lats)

        engine._decode_rows = counted
        return engine

    def same(a, b):
        return all(np.array_equal(x["image"], y["image"])
                   and x["inference_steps"] == y["inference_steps"] for x, y in zip(a, b))

    def gap(a, b):
        """(largest uint8 gap, % of pixels that differ) of two image lists."""
        d = np.stack([np.abs(x.astype(np.int16) - y.astype(np.int16)) for x, y in zip(a, b)])
        return int(d.max()), 100 * float((d > 0).mean())

    images = lambda run: [r["image"] for r in run.results]

    def reference(engine, texts, max_batch, resolutions=None):
        """BatchingEngine(max_batch) on ``raw``, given ``engine``'s batch-1
        embed rows of ``texts`` and its negative: rows encoded at another
        batch shape round differently."""
        ref = BatchingEngine(raw, tokenize, max_batch=max_batch, max_steps=35,
                             resolutions=resolutions, vae_scale_factor=factor)
        for text in texts:
            ref._embed_cache[text] = engine._prompt_embeds(text)
        ref._neg_embed = engine._neg_rows
        return ref

    try:
        # A: slots 4, seg_steps 4, depth 1, decode batch 1, warmed up
        eng_a = continuous(slots=4, seg_steps=4)
        start = time.perf_counter()
        eng_a.warmup()
        torch.cuda.synchronize()
        s_warm = time.perf_counter() - start
        eng_a.decode_calls = 0
        run_a = drive("A", eng_a, mix)
        check_continuous(run_a, eng_a, layers * eng_a.seg_steps)
        report(run_a, eng_a)
        # the fixed engine at the same CFG batch 8, its final latents decoded
        # at batch 1
        ref = reference(eng_a, {p for p, _, _ in mix}, 4)
        start = time.perf_counter()
        want, lat_ref = [], []
        for i in range(0, len(mix), 4):
            group = mix[i:i + 4]
            out = ref.generate_batch([p for p, _, _ in group], [s for _, s, _ in group],
                                     steps=[c for _, _, c in group])
            lat_ref += [o["image"] for o in out]
            want += out
        decoded = decode1(lat_ref)
        s_ref = time.perf_counter() - start
        for (p, s, c), got, w, img in zip(mix, run_a.results, want, decoded):
            if not (np.array_equal(got["image"], img)
                    and got["inference_steps"] == w["inference_steps"]
                    and got["sigmas"] == w["sigmas"]):
                fail(f"run A's ({p!r}, seed {s}, cap {c}) differs from BatchingEngine(max_batch"
                     f"=4).generate_batch: {got['inference_steps']} against "
                     f"{w['inference_steps']} steps, images equal "
                     f"{np.array_equal(got['image'], img)}")
        batch_decoded = [
            im for i in range(0, len(lat_ref), 4)
            for im in postprocess_images(pipe._decode_impl(as_latents(lat_ref[i:i + 4])))]
        level, share = gap(images(run_a), batch_decoded)
        phase("continuous A reference", f"warmup {s_warm:.3f} s; each of the {len(mix)} "
              f"requests equal to the bit to BatchingEngine(max_batch=4).generate_batch at CFG "
              f"batch 8 (its final latents decoded at batch 1, as the engine decodes; "
              f"{s_ref:.3f} s): images, steps and sigmas; decoded at batch 4 instead: max "
              f"|diff| {level} levels on {share:.3f} % of pixels (no bound)")

        # B: depth 2
        eng_b = continuous(slots=4, seg_steps=4, pipeline_depth=2)
        run_b = drive("B", eng_b, mix)
        check_continuous(run_b, eng_b, layers * eng_b.seg_steps)
        report(run_b, eng_b)
        if not same(run_b.results, run_a.results):
            fail("run B (pipeline_depth 2) differs from run A")

        # C: decode batch 4
        eng_c = continuous(slots=4, seg_steps=4, decode_batch=4)
        run_c = drive("C", eng_c, mix)
        check_continuous(run_c, eng_c, layers * eng_c.seg_steps)
        report(run_c, eng_c)
        coalesced = run_c.stats["decode_rows_coalesced"]
        if coalesced < 2:
            fail(f"run C coalesced {coalesced} rows")
        level, share = gap(images(run_c), images(run_a))
        phase("continuous C decode", f"decode_rows_coalesced {coalesced} of {len(mix)} in "
              f"{eng_c.decode_calls} decode calls; against run A max |diff| {level} levels on "
              f"{share:.3f} % of pixels (no bound: another decode batch)")

        # D: the per-segment Δ-cache and AB2, 4 requests twice each
        seg = eng_a.seg_steps
        per_seg = {"cache_interval 2": layers * -(-seg // 2) + front * (seg // 2),
                   "ab2": layers * seg}
        for name, kw in (("cache_interval 2", dict(cache_interval=2)),
                         ("ab2", dict(solver="ab2"))):
            runs = []
            for rep in (1, 2):  # a fresh engine each time
                eng_d = continuous(slots=4, seg_steps=seg, **kw)
                runs.append(drive(f"D {name} run {rep}", eng_d, mix[:4]))
                check_continuous(runs[-1], eng_d, per_seg[name])
                report(runs[-1], eng_d)
            if not same(runs[0].results, runs[1].results):
                fail(f"run D {name}: the two runs differ")
            level, share = gap(images(runs[0]), images(run_a)[:4])
            phase(f"continuous D {name}", f"the two runs equal to the bit; NFE "
                  f"{[r['inference_steps'] for r in runs[0].results]} against A's "
                  f"{[r['inference_steps'] for r in run_a.results[:4]]}; "
                  f"{runs[1].seg_ms / seg:.2f} ms a step against A's {run_a.seg_ms / seg:.2f}; "
                  f"against A max |diff| {level} levels on {share:.3f} % of pixels")
            del eng_d, runs

        # E: the router, 1024 px and 512 px, slots 2
        calls = []

        def counting(prompt):
            calls.append(prompt)
            return tokenize(prompt)

        router = MultiResContinuousRouter(pipe, counting, resolutions=[SERVE_EXTRA_PX], slots=2,
                                          seg_steps=seg, max_steps=35,
                                          vae_scale_factor=factor)
        n_probe = len(calls)
        two = mix[:2]
        runs_e = {}
        for res in (router.default_resolution, SERVE_EXTRA_PX):
            eng = router._engines[res]
            real = eng._decode_rows
            eng.decode_calls = 0

            def counted(lats, eng=eng, real=real):
                eng.decode_calls += 1
                return real(lats)

            eng._decode_rows = counted
            runs_e[res] = drive(f"E {res} px", eng, two, submit=lambda *a, res=res, **k:
                                router.submit(*a, resolution=res, **k))
            check_continuous(runs_e[res], eng, layers * seg)
            report(runs_e[res], eng)
        encodes = calls[n_probe:]
        if encodes != [p for p, _, _ in two]:
            fail(f"run E: the router's engines encoded {encodes} after their build")
        ref_e = reference(router._engines[router.default_resolution],
                          [p for p, _, _ in two], 2, resolutions=[SERVE_EXTRA_PX])
        for res, run in runs_e.items():
            out = ref_e.generate_batch([p for p, _, _ in two], [s for _, s, _ in two],
                                       steps=[c for _, _, c in two], resolution=res)
            for o, img, got in zip(out, decode1([o["image"] for o in out]), run.results):
                if not (np.array_equal(got["image"], img)
                        and got["inference_steps"] == o["inference_steps"]):
                    fail(f"run E at {res} px differs from BatchingEngine(max_batch=2, "
                         f"resolutions=[{SERVE_EXTRA_PX}])")
        phase("continuous E router", f"{len(two)} requests at {router.default_resolution} px then "
              f"the same at {SERVE_EXTRA_PX} px: each equal to the bit to BatchingEngine("
              f"max_batch=2, resolutions=[{SERVE_EXTRA_PX}]) at its resolution (decoded at "
              f"batch 1); the {SERVE_EXTRA_PX} px engine encoded nothing ({len(encodes)} encodes "
              f"after the build, both at {router.default_resolution} px)")

        # F: the fixed-batch engine on the same mix
        steps_f = []
        plain_generate = pipe.generate

        def counted_generate(*a, **k):
            res = plain_generate(*a, **k)
            steps_f.append(res.num_steps)
            return res

        eng_f = BatchingEngine(pipe, tokenize, max_batch=4, window_ms=25, max_steps=35)
        eng_f.warmup()
        pipe.generate = counted_generate
        try:
            run_f = drive("F BatchingEngine(max_batch=4, window_ms=25)", eng_f, mix)
        finally:
            pipe.generate = plain_generate
        want_f = (layers * sum(steps_f), len(steps_f))
        if run_f.launches != want_f or set(run_f.batches) != {8}:
            fail(f"run F: K1 {run_f.launches[0]}, K2 {run_f.launches[1]} over batches of "
                 f"{steps_f} steps at MMDiT batches {sorted(set(run_f.batches))}")
        report(run_f)
        level, share = gap(images(run_f), images(run_a))
        phase("continuous F against A", f"{len(steps_f)} batches of {steps_f} steps; makespan "
              f"{run_f.makespan:.3f} s against A {run_a.makespan:.3f} s and B "
              f"{run_b.makespan:.3f} s; images against A max |diff| {level} levels on "
              f"{share:.3f} % of pixels (no bound: embeds encoded and decodes at batch 4)")

        # G: serve --continuous over HTTP
        args = serve.parse_args(["--continuous", "--max_batch", "4", "--seg_steps", str(seg),
                                 "--max_steps", "35", "--port", "0", "--prompt", mix[0][0],
                                 "--seed", "0"])
        h_engine, server = serve.make_http_server(pipe, tokenize, args)
        if not isinstance(h_engine, ContinuousBatchingEngine):
            fail(f"serve --continuous built a {type(h_engine).__name__}")
        h_engine.start()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()

        def call(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                              timeout=600)
            try:
                conn.request(method, path, body=None if body is None else json.dumps(body))
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()

        flash_attention.launches = flash_attention_streaming.launches = 0
        try:
            start = time.perf_counter()
            p1, s1, c1 = mix[1]  # a capped request of run A
            status, body = call("POST", "/generate", {"prompt": p1, "seed": s1, "steps": c1})
            s_http = time.perf_counter() - start
            if status != 200:
                fail(f"continuous POST /generate: {status} {body[:200]}")
            reply = json.loads(body)
            direct = h_engine.submit(p1, seed=s1, steps=c1).result(timeout=600)
            if not np.array_equal(png_pixels(base64.b64decode(reply["image_png_base64"]),
                                             "/generate's PNG"), direct["image"]):
                fail("continuous /generate's PNG differs from the engine's image")
            if not np.array_equal(direct["image"], run_a.results[1]["image"]):
                fail("the HTTP engine's image differs from run A's of the same request")
            gets = {path: call("GET", path) for path in ("/stats", "/metrics", "/healthz")}
            stats_g = json.loads(gets["/stats"][1])
            if ({path: st for path, (st, _) in gets.items()} != dict.fromkeys(gets, 200)
                    or not {"segments_run", "slot_utilization", "segment_traces"} <= set(stats_g)
                    or b"tpdm_segments_run" not in gets["/metrics"][1]):
                fail(f"continuous GET endpoints: {[(p, st) for p, (st, _) in gets.items()]}")
            bad = call("POST", "/generate", {"prompt": 42})[0]
            if bad != 400:
                fail(f"a bad continuous request got {bad}, not 400")
        finally:
            server.shutdown()
            h_engine.stop()
            server.server_close()
        n_g = (flash_attention.launches, flash_attention_streaming.launches)
        totals[0] += n_g[0]
        totals[1] += n_g[1]
        want_g = (layers * seg * stats_g["segments_run"], 2)
        if n_g != want_g or stats_g["segment_traces"] != 1:
            fail(f"continuous http: K1 {n_g[0]}, K2 {n_g[1]}, expected {want_g}")
        phase("continuous G http", f"POST /generate (steps {c1}) round trip {s_http:.3f} s, its PNG "
              f"equal to the engine's image and to run A's; GET /stats (segments_run "
              f"{stats_g['segments_run']}, slot_utilization {stats_g['slot_utilization']:.4f}), "
              f"/metrics, /healthz 200; a bad request 400; K1 {n_g[0]}, K2 {n_g[1]}")
    finally:
        hook.remove()
        errors.close()
    phase("continuous phase", f"{time.perf_counter() - t_phase:.1f} s; K1 {totals[0]}, K2 "
          f"{totals[1]} launches over runs A-G")
    gc.collect()
    torch.cuda.empty_cache()
    return tuple(totals)


def img2img_phase(seed, dev, served, smi):
    """Phase 17: image-to-image and inpainting on phase 14's models
    (``served``), item 17 of this file's docstring. Returns the K1 and K2
    launches of the phase."""
    import copy
    import http.client
    import threading

    from tpdm_tpu_torch import serve
    from tpdm_tpu_torch.models import vae as vae_module
    from tpdm_tpu_torch.models.vae import vae_scale_factor
    from tpdm_tpu_torch.ops.attention import attention_reference
    from tpdm_tpu_torch.pipeline import pipeline as pipeline_module
    from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline, latent_mask
    from tpdm_tpu_torch.serving import BatchingEngine
    from tpdm_tpu_torch.serving_continuous import ContinuousBatchingEngine
    from tpdm_tpu_torch.utils.image import png_bytes, preprocess_images

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    pipe, tokenize, prompts = served.pipe, served.tokenize, served.prompts
    layers = pipe.mmdit.config.num_layers
    cfg = pipe.vae.config
    factor = vae_scale_factor(cfg)
    px = pipe.mmdit.config.sample_size * factor
    totals = [0, 0]
    counted = launch_counter("img2img", totals)

    def ids(texts):
        rows = [tokenize(p) for p in texts]
        c, t5 = np.concatenate([r[0] for r in rows]), np.concatenate([r[1] for r in rows])
        return dict(clip_ids=c, t5_ids=t5, negative_clip_ids=np.zeros_like(c),
                    negative_t5_ids=np.zeros_like(t5))

    gen_kw = dict(max_inference_steps=T_MAX, guidance_scale=7.0, predict=True)
    steps_k = lambda n_k2: lambda r: (layers * r.num_steps, n_k2)
    same = lambda a, b: np.array_equal(a, b)

    # 1. a text-to-image image to start from, and its same request at strength 1.0
    s0 = seed + 170
    t2i, _ = counted("text-to-image", lambda: pipe.generate(**ids(prompts[:1]), seed=s0,
                                                               **gen_kw), steps_k(1))
    check_schedule(t2i, 1, px)
    img_a = t2i.images[0]
    img_b = np.ascontiguousarray(img_a[::-1])  # a second init image: A upside down
    one, _ = counted("strength 1.0", lambda: pipe.generate(
        **ids(prompts[:1]), seed=s0, init_image=img_b[None], strength=1.0, **gen_kw), steps_k(2))
    if not (same(one.images, t2i.images) and same(one.sigmas, t2i.sigmas)
            and one.num_steps == t2i.num_steps):
        fail("generate(init_image, strength=1.0) differs from text-to-image at the same seed")
    again, s_t2i = counted("text-to-image again", lambda: pipe.generate(
        **ids(prompts[:1]), seed=s0, **gen_kw), steps_k(1))
    i2i, s_i2i = counted("request", lambda: pipe.generate(
        **ids(prompts[:1]), seed=s0, init_image=img_b[None], strength=0.6, **gen_kw), steps_k(2))
    check_schedule(i2i, 1, px)
    phase("img2img request", f"{px} px, batch 1, prompt 0, CFG 7.0: text-to-image {t2i.num_steps} "
          f"steps in {s_t2i:.3f} s (its second call); img2img at strength 0.6 from its image upside down "
          f"{i2i.num_steps} steps in {s_i2i:.3f} s (encode + denoise + decode); at strength 1.0 "
          f"equal to text-to-image to the bit (images, sigmas, {one.num_steps} steps); {smi}")

    # 2. encode_image at batch 1 and 4: one K2 a call, ms by CUDA events
    x1, x4 = img_a[None], np.stack([img_a, img_b, img_a[:, ::-1], img_b[:, ::-1]])
    enc_ms, latents = {}, {}
    for b, x in ((1, x1), (4, x4)):
        latents[b], _ = counted(f"encode batch {b}", lambda: pipe.encode_image(x),
                                lambda z: (0, 1))
        z = latents[b]
        if z.shape != (b, cfg.latent_channels, px // factor, px // factor) \
                or z.dtype != torch.float32 \
                or not bool(torch.isfinite(z).all()):
            fail(f"encode_image at batch {b}: {tuple(z.shape)} {z.dtype}, finite "
                 f"{bool(torch.isfinite(z).all())}")
        enc_ms[b], _ = counted(f"encode batch {b} timed", lambda: median_ms(
            lambda: pipe.encode_image(x), reps=5, warmup=1), lambda _: (0, 6))
    rows_equal = same(latents[4][0].cpu().numpy(), latents[1][0].cpu().numpy())
    # the fp32 reference: the same (bf16-valued) weights in fp32, the plain
    # attention (K2 takes bf16 only), full fp32 convs (main() turns TF32 off)
    vae32 = copy.deepcopy(pipe.vae).float()
    real_attention = vae_module.joint_attention
    vae_module.joint_attention = attention_reference
    try:
        with torch.no_grad():
            mean32, _ = vae32.encode(preprocess_images(torch.as_tensor(x1, device=dev)))
    finally:
        vae_module.joint_attention = real_attention
    z32 = (mean32 - cfg.shift_factor) * cfg.scaling_factor
    del vae32, mean32
    enc_rel = float((latents[1] - z32).abs().mean() / z32.abs().mean())
    if not enc_rel < ENCODE_REL_BOUND:
        fail(f"the bf16 encode is {enc_rel:.4e} from the fp32 one (mean |dz| / mean |z|), bound "
             f"{ENCODE_REL_BOUND}")
    phase("img2img encode", f"encode_image (VAE encoder bf16, K2 at (b, 1, {(px // factor) ** 2}, "
          f"512)): batch 1 "
          f"{enc_ms[1]:.3f} ms, batch 4 {enc_ms[4]:.3f} ms ({enc_ms[4] / 4:.3f} ms an image; "
          f"medians of 5, CUDA events), one K2 launch a call; bf16 against an fp32 encode of the "
          f"same weights (plain attention): mean |dz| / mean |z| {enc_rel:.4e} (bound "
          f"{ENCODE_REL_BOUND}); batch 4's first row equal to batch 1's to the bit: {rows_equal}; "
          f"{smi}")
    del z32
    clean_a = latents[1]

    # 3. per-sample strengths at batch 2 from one image, each starting there
    starts = []
    real_sample = pipeline_module.adaptive_sample

    def recording(*a, **kw):
        starts.append(kw["init_sigma"])
        return real_sample(*a, **kw)

    pipeline_module.adaptive_sample = recording
    try:
        pair, s_pair = counted("batch 2", lambda: pipe.generate(
            **ids([prompts[0]] * 2), seed=s0, init_image=np.stack([img_a, img_a]),
            strength=list(I2I_STRENGTHS), decode=False, **gen_kw), steps_k(1))
    finally:
        pipeline_module.adaptive_sample = real_sample
    want_start = torch.tensor(I2I_STRENGTHS, dtype=torch.float32)
    clean_np = clean_a.cpu().numpy()[0]
    dist_init = [float(np.abs(pair.images[i] - clean_np).mean()) for i in (0, 1)]
    if not torch.equal(starts[0].cpu(), want_start) or not dist_init[0] < dist_init[1]:
        fail(f"batch 2 at strengths {I2I_STRENGTHS}: started at {starts[0].tolist()}, mean "
             f"|latents - init latents| {dist_init}")
    phase("img2img batch 2", f"strengths {I2I_STRENGTHS} from one image: the loop started at "
          f"sigmas {starts[0].tolist()}, first steps to {pair.sigmas[:, 0].tolist()}; "
          f"{[int(i) + 1 for i in pair.last_valid_index]} steps in {s_pair:.3f} s (no decode); "
          f"mean |final - init| latents {dist_init[0]:.4f} and {dist_init[1]:.4f}; K2 1 (the "
          f"encode)")

    # 4. inpainting: the right half regenerated, the left half kept
    mask = np.zeros((1, px, px), np.float32)
    mask[:, :, px // 2:] = 1.0
    inp, s_inp = counted("inpaint", lambda: pipe.generate(
        **ids(prompts[:1]), seed=s0, init_image=x1, strength=0.8, mask=mask, decode=False,
        **gen_kw), steps_k(1))
    kept = (latent_mask(torch.from_numpy(mask[:, None]), clean_a.shape[-2:], "cpu") == 0)
    kept = kept.expand(clean_a.shape).numpy()
    want_kept = clean_a.to(pipe._device_dtype()[1]).float().cpu().numpy()  # the model's bf16
    moved = float(np.abs(inp.images - want_kept)[~kept].mean())
    if not (same(inp.images[kept], want_kept[kept]) and moved > 1e-3):
        fail(f"inpainting: the kept latents differ from the encoded ones, or the regenerated "
             f"ones did not move (mean |d| {moved:.3e})")
    phase("img2img inpaint", f"half mask at strength 0.8: {inp.num_steps} steps in {s_inp:.3f} s "
          f"(no decode); the {int(kept[0, 0].sum())} latent cells whose mask is 0 equal the "
          f"encoded init latents (in bf16) to the bit in all {clean_a.shape[1]} channels; the "
          f"others moved by {moved:.4f} on mean")

    # 5. BatchingEngine: two text and two img2img rows
    eng = BatchingEngine(pipe, tokenize, max_batch=4, max_steps=35, vae_scale_factor=factor)
    texts, seeds = prompts[2:6], [seed + 172 + i for i in range(4)]
    nfe_k = lambda n_k2: lambda out: (layers * max(o["inference_steps"] for o in out), n_k2)
    mixed, s_mixed = counted("engine mixed batch", lambda: eng.generate_batch(
        texts, seeds, init_images=[None, None, img_a, img_b],
        strengths=[None, None, *I2I_STRENGTHS]), nfe_k(2))
    text_only, _ = counted("engine text batch", lambda: eng.generate_batch(texts, seeds),
                           nfe_k(1))
    embeds = eng._embeds_for(texts, ids(texts)["clip_ids"], ids(texts)["t5_ids"], [""] * 4)
    blank = np.zeros((px, px, 3), np.uint8)
    direct, _ = counted("engine direct", lambda: pipe.generate(
        *embeds, init_image=np.stack([blank, blank, img_a, img_b]),
        strength=[1.0, 1.0, *I2I_STRENGTHS], seed=seeds, max_inference_steps=35,
        guidance_scale=7.0, step_caps=[35] * 4), steps_k(2))
    for i, res in enumerate(mixed):
        if not (same(res["image"], direct.images[i])
                and res["inference_steps"] == int(direct.last_valid_index[i]) + 1):
            fail(f"engine row {i} differs from the direct generate(init_image=, seed=[...])")
        if i < 2 and not (same(res["image"], text_only[i]["image"])
                          and res["sigmas"] == text_only[i]["sigmas"]):
            fail(f"engine text row {i} differs from the text-only batch's")
    phase("img2img engine", f"BatchingEngine(max_batch=4): prompts 2-5, rows 2 and 3 img2img at "
          f"{I2I_STRENGTHS}: {[o['inference_steps'] for o in mixed]} steps in {s_mixed:.3f} s "
          f"(one encode of the batch, K2 2); the text rows equal a text-only batch's to the bit "
          f"({[o['inference_steps'] for o in text_only]} steps); all four equal a direct "
          f"generate(init_image=[blank, blank, A, B], strength=[1, 1, 0.4, 0.8], seed=[...]) to "
          f"the bit")

    # 6. ContinuousBatchingEngine: a burst of 8, half img2img
    class RowByRow(TPDMPipeline):
        """Encodes and decodes one image at a time, as the continuous engine
        encodes a slot's image and decodes a finished slot."""

        def encode_image(self, images, **kw):
            return torch.cat([super().encode_image(images[i:i + 1], **kw)
                              for i in range(len(images))])

        def _decode_impl(self, lat):
            self.decoded = lat  # the final latents, compared below
            return torch.cat([super(RowByRow, self)._decode_impl(lat[i:i + 1])
                              for i in range(lat.shape[0])])

    burst = [(prompts[6 + i], seed + 180 + i, CONT_CAPS[i % 4],
              (img_a, img_b)[i // 2 % 2] if i % 2 == 0 else None,
              (None, 0.5, 0.8, 0.4)[i // 2] if i % 2 == 0 else None) for i in range(8)]
    cont = ContinuousBatchingEngine(pipe, tokenize, slots=4, seg_steps=4, max_steps=35,
                                    vae_scale_factor=factor)
    decodes = []
    real_rows = cont._decode_rows
    cont._decode_rows = lambda lats: (decodes.append(lats.shape[0]), real_rows(lats))[1]
    counted("continuous warmup", cont.warmup, None)  # its segments are not counted after
    del decodes[:]
    finals = {}  # each request's final latents
    real_complete = cont._complete

    def complete(req, lat_row, nfe, sigmas):
        finals[id(req)] = lat_row
        real_complete(req, lat_row, nfe, sigmas)

    cont._complete = complete
    n_i2i = sum(im is not None for *_, im, _ in burst)

    def run_burst():
        cont.start()
        try:
            start = time.monotonic()
            reqs = [cont.submit(p, seed=s, steps=c, init_image=im, strength=st)
                    for p, s, c, im, st in burst]
            out = [r.result(timeout=600) for r in reqs]
            return out, time.monotonic() - start, reqs
        finally:
            cont.stop()

    (got, makespan, reqs), _ = counted("continuous burst", run_burst, lambda _: (
        layers * cont.seg_steps * cont.segments_run, len(decodes) + n_i2i))
    ref = BatchingEngine(RowByRow(pipe.mmdit, pipe.tpm, pipe.vae, text_encoders=pipe.text_encoders),
                         tokenize, max_batch=4, max_steps=35, vae_scale_factor=factor)
    for text in {p for p, *_ in burst}:
        ref._embed_cache[text] = cont._prompt_embeds(text)
    ref._neg_embed = cont._neg_rows
    want, want_lat = [], []
    for i in range(0, len(burst), 4):
        group = burst[i:i + 4]
        has_i2i = any(im is not None for *_, im, _ in group)
        out, _ = counted("continuous reference", lambda: ref.generate_batch(
            [g[0] for g in group], [g[1] for g in group], steps=[g[2] for g in group],
            init_images=[g[3] for g in group], strengths=[g[4] for g in group]),
            lambda out: (layers * max(o["inference_steps"] for o in out),
                         4 * has_i2i + 4))
        want += out
        want_lat += list(ref.pipe.decoded)
    for (p, s, c, im, st), req, g, w, w_lat in zip(burst, reqs, got, want, want_lat):
        if not (torch.equal(finals[id(req)][0], w_lat) and same(g["image"], w["image"])
                and g["inference_steps"] == w["inference_steps"] and g["sigmas"] == w["sigmas"]):
            fail(f"continuous ({p!r}, seed {s}, cap {c}, img2img {im is not None}, strength {st}) "
                 f"differs from BatchingEngine(max_batch=4): {g['inference_steps']} against "
                 f"{w['inference_steps']} steps, images equal {same(g['image'], w['image'])}")
    if cont.segment_traces != 1:
        fail(f"continuous: segment_traces {cont.segment_traces}")
    phase("img2img continuous", f"ContinuousBatchingEngine(slots=4, seg_steps=4): 8 requests, "
          f"4 img2img (strengths 0.6, 0.5, 0.8, 0.4), caps {CONT_CAPS} in turn: makespan "
          f"{makespan:.3f} s, NFE {[g['inference_steps'] for g in got]}, "
          f"{cont.segments_run} segments; each request equal to the bit to BatchingEngine("
          f"max_batch=4) (final latents, images, steps, sigmas; its images encoded and decoded "
          f"at batch 1); "
          f"K2 {len(decodes)} decodes + {n_i2i} encodes")

    # 7. /generate with init_image_png_base64
    args = serve.parse_args(["--max_batch", "2", "--max_steps", "35", "--port", "0",
                             "--prompt", prompts[0], "--seed", "0"])
    h_engine, server = serve.make_http_server(pipe, tokenize, args)
    h_engine.start()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(body):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=600)
        try:
            conn.request("POST", "/generate", body=json.dumps(body))
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    png_a = base64.b64encode(png_bytes(img_a)).decode()
    try:
        (status, body), s_http = counted("http", lambda: call(
            {"prompt": prompts[1], "seed": s0, "strength": 0.5, "init_image_png_base64": png_a}),
            lambda r: (layers * len(json.loads(r[1])["sigmas"]) if r[0] == 200 else 0, 2))
        if status != 200:
            fail(f"img2img POST /generate: {status} {body[:200]}")
        reply = json.loads(body)
        direct_h, _ = counted("http direct", lambda: h_engine.generate_batch(
            [prompts[1]], [s0], init_images=[img_a], strengths=[0.5])[0],
            lambda r: (layers * r["inference_steps"], 2))
        if not same(png_pixels(base64.b64decode(reply["image_png_base64"]), "/generate's PNG"),
                    direct_h["image"]):
            fail("img2img /generate's PNG differs from the engine's image")
        bad = call({"prompt": prompts[1], "init_image_png_base64":
                    base64.b64encode(b"\x89PNG not really").decode()})[0]
        if bad != 400:
            fail(f"a malformed init image got {bad}, not 400")
    finally:
        server.shutdown()
        h_engine.stop()
        server.server_close()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    phase("img2img http", f"POST /generate with init_image_png_base64 ({px} px, strength 0.5): "
          f"round trip {s_http:.3f} s, {len(reply['sigmas'])} steps, its PNG equal to the "
          f"engine's image; a malformed PNG 400")
    phase("img2img phase", f"{time.perf_counter() - t_phase:.1f} s; peak memory {peak:.2f} GiB; "
          f"K1 {totals[0]}, K2 {totals[1]} launches; {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    return tuple(totals)


def warm_request(pipe, dev, b, req_seed, counters, decode_s):
    """One 1024 px request of batch b through ``pipe.generate`` (prompt
    embeds drawn from ``req_seed``), after a one-step request at the same
    batch outside the counts; each counter set to 0 just before it and read
    after, its schedule checked. Returns (result, wall ms by CUDA events,
    decode ms, launches, peak GiB)."""
    eg = torch.Generator(device=dev).manual_seed(req_seed)
    emb = lambda *shape: torch.randn(shape, generator=eg, device=dev, dtype=torch.bfloat16)
    pe, npe = emb(b, N_CTX, 4096), emb(b, N_CTX, 4096)
    pp, npp = emb(b, 2048), emb(b, 2048)
    run = lambda steps: pipe.generate(pe, pp, npe, npp, max_inference_steps=steps,
                                      guidance_scale=7.0, predict=True, seed=req_seed)
    run(1)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = run(T_MAX)
    end.record()
    end.synchronize()
    check_schedule(res, b, 1024)
    return (res, start.elapsed_time(end), 1000 * decode_s["last"],
            [fn.launches for fn in counters], torch.cuda.max_memory_allocated(dev) / 2**30)


def quantize_in_place(pipe, bits):
    """``pipe.mmdit`` replaced by its quant_matmuls form holding the same
    tensors (built on the meta device and given them by assign), then
    prequantised: each bf16 weight is freed as its int copy replaces it, so
    the card never holds the model twice."""
    from tpdm_tpu_torch.models.mmdit import MMDiT
    from tpdm_tpu_torch.ops.quant import prequantize_

    mmdit = pipe.mmdit
    with torch.device("meta"):
        qm = MMDiT(dataclasses.replace(mmdit.config, quant_matmuls=True, quant_bits=bits))
    qm.load_state_dict(mmdit.state_dict(), assign=True)
    qm.pos_embed.pos_embed = mmdit.pos_embed.pos_embed  # not in the state dict
    pipe.mmdit = qm.eval()
    del mmdit
    gc.collect()
    return prequantize_(qm)


def sd35_phase(seed, dev):
    """Phase 16: SD3.5 at 1024 px (CFG 7.0, predict=True, TPM head bias
    TPM_HEAD_BIAS), weights drawn on the card from the seed. (a)
    SD3.5-medium at full width, requests at batch 1 and 2; (b) SD3.5-large
    at full width, a bf16 request, then the same model prequantised W8A8 in
    place and the same request; (c) a synthetic diffusers-layout directory
    (a 2-layer SD3.5-medium-width transformer in two shards, the SD3 VAE, a
    TPM file) loaded by load_pipeline_from_pretrained, its request equal to
    the bit to the same weights built in memory. The W8A8 forward is held to
    QUANT_REL_BOUND[8] of the bf16 one. K1, K2 and K4 launches are
    checked exactly a request. Returns the phase's (K1, K2, K4) launches."""
    from tpdm_tpu_torch.models.layers import get_2d_sincos_pos_embed
    from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    from tpdm_tpu_torch.models.tpm import TimePredictor
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig
    from tpdm_tpu_torch.ops.attention import flash_attention, flash_attention_streaming
    from tpdm_tpu_torch.ops.gemm import int8_gemm
    from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline, load_pipeline_from_pretrained
    from tpdm_tpu_torch.utils import convert, safetensors

    t_phase = time.perf_counter()
    counters = (flash_attention, flash_attention_streaming, int8_gemm)
    totals = [0, 0, 0]
    decode_s = {}

    def request(label, pipe, b, req_seed, want):
        """``want``: K1 launches a step, K4 launches a step."""
        res, wall, dec, n, peak = warm_request(pipe, dev, b, req_seed, counters, decode_s)
        steps = res.num_steps
        expect = [want[0] * steps, 1, want[1] * steps]
        if n != expect:
            fail(f"{label}: K1 {n[0]}, K2 {n[1]}, K4 {n[2]} launches in {steps} steps, "
                 f"expected {expect}")
        for i, v in enumerate(n):
            totals[i] += v
        phase(label, f"batch {b}: {steps} steps, sigmas "
              f"{[round(float(x), 5) for x in res.sigmas[0, :steps]]}, warm wall {wall:.1f} ms "
              f"(CUDA events), {(wall - dec) / steps:.1f} ms/step (CFG batch {2 * b}), decode "
              f"{dec:.1f} ms, peak memory {peak:.2f} GiB, K1 {n[0]} ({want[0]} a step), K2 "
              f"{n[1]}, K4 {n[2]} ({want[1]} a step)")
        return res

    # (a) SD3.5-medium: its sincos table is 384 x 384 x 1536
    t0 = time.perf_counter()
    get_2d_sincos_pos_embed(1536, 384, 64)
    t_table = time.perf_counter() - t0
    t0 = time.perf_counter()
    mcfg = MMDiTConfig.sd35_medium()
    mmdit, tpm, vae = build_models(dev, seed + 30, mcfg)
    pipe = TPDMPipeline(mmdit, tpm, vae)
    timed_decoder(pipe, decode_s)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in mmdit.parameters())
    table = mmdit.pos_embed.pos_embed
    phase("sd35 medium models", f"SD3.5-medium MMDiT ({mcfg.num_layers} layers, "
          f"{mcfg.num_attention_heads} x {mcfg.attention_head_dim} heads, dual attention in "
          f"layers {min(mcfg.dual_attention_layers)}-{max(mcfg.dual_attention_layers)}, qk "
          f"{mcfg.qk_norm}) {n_params / 1e9:.3f} B params + TPM + SD3 VAE decoder, bf16, built in "
          f"{time.perf_counter() - t0:.1f} s; sincos table {tuple(table.shape)} {table.dtype} "
          f"{table.nbytes / 2**20:.1f} MiB on the card (fp32 {4 * table.numel() / 2**20:.1f} "
          f"MiB at build), made on the host in {t_table:.3f} s")
    per_step = (mcfg.num_layers + len(mcfg.dual_attention_layers), 0)
    request("sd35 medium request 1", pipe, 1, seed + 31, per_step)
    request("sd35 medium request 2", pipe, 2, seed + 32, per_step)
    del mmdit, tpm, vae, pipe, table
    gc.collect()
    torch.cuda.empty_cache()

    # (b) SD3.5-large, bf16 then W8A8 in place
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lcfg = MMDiTConfig.sd35_large()
    mmdit, tpm, vae = build_models(dev, seed + 33, lcfg)
    pipe = TPDMPipeline(mmdit, tpm, vae)
    timed_decoder(pipe, decode_s)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in mmdit.parameters())
    phase("sd35 large models", f"SD3.5-large MMDiT ({lcfg.num_layers} layers, "
          f"{lcfg.num_attention_heads} x {lcfg.attention_head_dim} heads, qk {lcfg.qk_norm}) "
          f"{n_params / 1e9:.3f} B params, {module_bytes(mmdit) / 1e9:.3f} GB bf16, + TPM "
          f"(in_channels {2 * lcfg.inner_dim}) + SD3 VAE decoder, built in "
          f"{time.perf_counter() - t0:.1f} s (peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
          f"GiB with the fp32 draw)")
    del mmdit
    per_step_q = (lcfg.num_layers - 1) * 12 + 9
    bf16_res = request("sd35 large request bf16", pipe, 1, seed + 34, (lcfg.num_layers, 0))
    # one CFG-batch 1024 px forward, bf16 now and W8A8 after the quantisation,
    # held to phase 6's bound
    eg = torch.Generator(device=dev).manual_seed(seed + 37)
    rand = lambda *shape: torch.randn(shape, generator=eg, device=dev, dtype=torch.bfloat16)
    inputs = (rand(2, 16, 128, 128), torch.tensor([1000.0, 420.0], device=dev, dtype=torch.bfloat16),
              rand(2, N_CTX, 4096), rand(2, 2048))
    with torch.no_grad():
        v_ref = pipe.mmdit(*inputs)[0].float()
    t0 = time.perf_counter()
    quantize_in_place(pipe, 8)
    torch.cuda.synchronize()
    phase("sd35 large W8A8", f"prequantised in place in {time.perf_counter() - t0:.1f} s: MMDiT "
          f"weights {module_bytes(pipe.mmdit) / 1e9:.3f} GB, card memory "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    with torch.no_grad():
        v = pipe.mmdit(*inputs)[0].float()
    if not bool(torch.isfinite(v).all()):
        fail("the SD3.5-large W8A8 MMDiT forward gave non-finite values")
    v_gap = ((v - v_ref).abs().mean() / v_ref.abs().mean()).item()
    phase("sd35 large W8A8", f"1024 px forward (CFG batch 2), mean |dv| / mean |v| against the "
          f"bf16 forward on the same weights: {v_gap:.4e} (bound {QUANT_REL_BOUND[8]})")
    if not v_gap < QUANT_REL_BOUND[8]:
        fail(f"the SD3.5-large W8A8 forward is {v_gap} from the bf16 one "
             f"(bound {QUANT_REL_BOUND[8]})")
    del inputs, v_ref, v
    q_res = request("sd35 large request W8A8", pipe, 1, seed + 34, (lcfg.num_layers, per_step_q))
    gap = np.abs(q_res.images.astype(np.int16) - bf16_res.images.astype(np.int16))
    phase("sd35 large W8A8", f"the same request as bf16: {q_res.num_steps} steps against "
          f"{bf16_res.num_steps}, image mean |d| {gap.mean():.2f} levels, max {gap.max()}")
    del tpm, vae, pipe, bf16_res, q_res
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the loader on a synthetic diffusers-layout directory
    ccfg = MMDiTConfig.sd35_medium(num_layers=2, dual_attention_layers=(0,))
    gen = torch.Generator(device=dev).manual_seed(seed + 35)
    with torch.device(dev):
        mmdit = MMDiT(ccfg)
        tpm = TimePredictor(conv_out_channels=128, in_channels=2 * ccfg.inner_dim,
                            temb_dim=ccfg.inner_dim, init_alpha=TPM_HEAD_BIAS[0],
                            init_beta=TPM_HEAD_BIAS[1], dtype=torch.bfloat16)
        vae = VAE(VAEConfig.sd3())
    for module in (mmdit, tpm, vae):
        module.init_weights(gen, WEIGHT_STD).eval()
    mmdit.to(device=dev, dtype=torch.bfloat16)
    vae.to(torch.bfloat16)  # the TPM keeps fp32 weights computing in bf16, as the loader's
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = Path(tmp)
        for sub in ("transformer", "vae"):
            (root / sub).mkdir()
        sd = convert.export_mmdit(mmdit.state_dict(), ccfg)
        names = sorted(sd)
        for i in range(2):
            safetensors.save_file({k: sd[k] for k in names[i::2]}, str(
                root / "transformer" / f"diffusion_pytorch_model-{i + 1:05d}-of-00002.safetensors"),
                metadata={"format": "pt"})
        safetensors.save_file(convert.export_vae(vae.state_dict(), vae.config),
                              str(root / "vae" / "diffusion_pytorch_model.safetensors"))
        safetensors.save_file(convert.export_tpm(tpm.state_dict()), str(root / "tpm.safetensors"))
        n_bytes = sum(f.stat().st_size for f in root.rglob("*.safetensors"))
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_pipeline_from_pretrained(str(root), mmdit_config=ccfg,
                                               load_text_encoders=False,
                                               tpm_checkpoint=str(root / "tpm.safetensors"))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    for name, ours, ref in (("MMDiT", loaded.mmdit, mmdit), ("VAE", loaded.vae, vae),
                            ("TPM", loaded.tpm, tpm)):
        a, b = ours.state_dict(), ref.state_dict()
        if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
            fail(f"the loaded {name} differs from the one in memory")
    if not torch.equal(loaded.mmdit.pos_embed.pos_embed, mmdit.pos_embed.pos_embed):
        fail("the loaded MMDiT's sincos table differs from the one in memory")
    phase("sd35 loader", f"wrote {n_bytes / 2**20:.1f} MiB (2-layer SD3.5-medium-width "
          f"transformer in 2 shards, SD3 VAE, TPM) in {t_write:.2f} s, "
          f"load_pipeline_from_pretrained in {t_load:.2f} s; every tensor equal to the models "
          f"in memory")
    timed_decoder(loaded, decode_s)
    res = request("sd35 loader request", loaded, 1, seed + 36, (3, 0))
    mem_pipe = TPDMPipeline(mmdit, tpm, vae)
    timed_decoder(mem_pipe, decode_s)
    ref = request("sd35 in-memory request", mem_pipe, 1, seed + 36, (3, 0))
    if not (np.array_equal(res.images, ref.images) and np.array_equal(res.sigmas, ref.sigmas)):
        fail("the loaded pipeline's request differs from the in-memory one's")
    phase("sd35 loader", f"the loaded pipeline's request equals the in-memory one's to the bit "
          f"({res.num_steps} steps, images and sigmas)")
    del mmdit, tpm, vae, loaded, mem_pipe
    gc.collect()
    torch.cuda.empty_cache()
    phase("sd35 phase", f"{time.perf_counter() - t_phase:.1f} s; K1 {totals[0]}, K2 {totals[1]}, "
          f"K4 {totals[2]} launches over its requests")
    return tuple(totals)


def sd15_kernel_phase(seed, dev):
    """Phase 18's kernels: K1 at each SD1.5 shape of SD15_K1_SHAPES
    (k1_check), from a generator of their own. Returns the kernels line's
    K1 entries."""
    g = torch.Generator(device=dev).manual_seed(seed + 18)
    out = {key: k1_check(g, dev, key, *shape) for key, shape in SD15_K1_SHAPES.items()}
    torch.cuda.empty_cache()
    return out


def sd15_models(seed, dev):
    """Phase 18's models, N(0, WEIGHT_STD²) weights from ``seed`` on the
    card in bf16: the SD1.5 UNet (UNetConfig.sd15(), 860 M parameters),
    CLIP-L (12 x 768) with a toy CLIP vocabulary of the example prompts,
    the SD1.5 VAE with its encoder, and an SD15Agent whose TPM (128
    channels over 2 x 320, bf16 compute) has head bias TPM_HEAD_BIAS.
    Returns a namespace of them, the tokenizer, encode and the prompts."""
    from tpdm_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from tpdm_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig
    from tpdm_tpu_torch.train import RLOOConfig
    from tpdm_tpu_torch.train.sd15_agent import SD15Agent
    from tpdm_tpu_torch.utils.tokenizer import CLIPTokenizer

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 180)
    with torch.device(dev):
        unet = UNetSD15(UNetConfig.sd15())
        clip = CLIPTextModel(CLIPTextConfig.sd3_clip_l())
        vae = VAE(VAEConfig.sd15())
    for module in (unet, clip, vae):
        module.init_weights(gen, WEIGHT_STD)
        module.to(dtype=torch.bfloat16).eval()
        torch.cuda.empty_cache()  # the fp32 draw
    agent = SD15Agent(unet, RLOOConfig(max_inference_steps=SD15_T_MAX,
                                       init_alpha=TPM_HEAD_BIAS[0], init_beta=TPM_HEAD_BIAS[1]),
                      guidance_scale=SD15_GS)
    tpm = agent.init_tpm_params(gen).eval()
    with open(REPO / "example" / "prompts.jsonl") as f:
        prompts = [json.loads(line)["prompt"] for line in f if line.strip()]
    with tempfile.TemporaryDirectory() as tmp:
        write_clip_vocab(Path(tmp) / "clip", prompts)
        tok = CLIPTokenizer.from_pretrained(str(Path(tmp) / "clip"), max_length=77)

    def clip_ids(texts):
        return tok(list(texts), max_length=77)["input_ids"]

    @torch.no_grad()
    def encode(texts):
        ids = torch.as_tensor(clip_ids(texts), device=dev).long()
        return clip(ids)[1], clip(torch.zeros_like(ids))[1]

    torch.cuda.synchronize()
    return argparse.Namespace(unet=unet, clip=clip, vae=vae, agent=agent, tpm=tpm,
                              clip_ids=clip_ids, encode=encode, prompts=prompts,
                              seconds=time.perf_counter() - t0)


def check_sd15_schedule(res, b, px, t0=999, t_max=SD15_T_MAX):
    """uint8 images of (b, px, px, 3) and integer timesteps that start at
    ``t0`` and fall strictly over each sample's valid steps, at most
    ``t_max`` of them."""
    n = res.num_steps
    if res.images.dtype.name != "uint8" or res.images.shape != (b, px, px, 3):
        fail(f"sd15 images {res.images.dtype} {res.images.shape}, expected uint8 "
             f"({b}, {px}, {px}, 3)")
    if not 1 <= n <= t_max:
        fail(f"sd15: {n} steps, expected 1..{t_max}")
    for i in range(b):
        last = int(res.last_valid_index[i])
        ts = [int(x) for x in res.schedule[i, : last + 2]]
        if last < 0 or ts[0] != t0 or not all(a > c for a, c in zip(ts, ts[1:])):
            fail(f"sd15 sample {i}: timesteps not falling from {t0} over valid steps: {ts}")


def sd15_phase(seed, dev, smi, family_rloo, lora):
    """Phase 18: SD1.5 at 512 px, item 18 of this file's docstring, then
    phase 22's SD1.5 part (``lora``, a LoraPhase) and phase 21's SD1.5
    update (``family_rloo``, a FamilyRLOO) on its models. Returns (K1 launches, K2 launches, the kernels line's K1 entries) of
    phase 18."""
    import copy

    from tpdm_tpu_torch.models import unet_sd15
    from tpdm_tpu_torch.ops.attention import attention_reference
    from tpdm_tpu_torch.pipeline.variants import SD15Pipeline
    from tpdm_tpu_torch.serving import BatchingEngine
    from tpdm_tpu_torch.serving_families import make_sd15_runner, make_vae_decoder

    t_phase = time.perf_counter()
    k1_entries = sd15_kernel_phase(seed, dev)
    m = sd15_models(seed, dev)
    n_params = sum(p.numel() for p in m.unet.parameters())
    ucfg = m.unet.config
    # transformer blocks: depth x layers_per_block down, x (layers_per_block
    # + 1) up, and the mid block's; two K1 calls a block
    blocks = sum(ucfg.depths) * (2 * ucfg.layers_per_block + 1) + ucfg.mid_transformer_layers
    k1_a_forward = 2 * blocks
    phase("sd15 models", f"UNet {n_params / 1e6:.2f} M parameters ({blocks} transformer blocks, "
                         f"K1 {k1_a_forward} a forward), CLIP-L 12 x 768, the SD1.5 VAE with its "
                         f"encoder, TPM head bias {TPM_HEAD_BIAS}, bf16, drawn in "
                         f"{m.seconds:.1f} s; {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    px = ucfg.sample_size * 8
    totals = [0, 0]
    counted = launch_counter("sd15", totals)

    # 1. one UNet forward at CFG batch 2 against an fp32 copy of the same
    # (bf16-valued) weights on the card, whose attention is the plain version
    # (K1 takes bf16 only)
    g = torch.Generator(device=dev).manual_seed(seed + 181)
    lat = torch.randn(2, 4, ucfg.sample_size, ucfg.sample_size, generator=g, device=dev)
    ctx, nctx = m.encode(m.prompts[:1])
    ctx = torch.cat([nctx, ctx])
    tt = torch.tensor([999.0, 999.0], device=dev)
    with torch.no_grad():
        out, _ = counted("forward", lambda: m.unet(lat.to(torch.bfloat16), tt, ctx),
                         lambda _: (k1_a_forward, 0))
        f32 = copy.deepcopy(m.unet).float()
        real_attention = unet_sd15.joint_attention
        unet_sd15.joint_attention = attention_reference
        try:
            ref = f32(lat, tt, ctx.float())
        finally:
            unet_sd15.joint_attention = real_attention
        del f32
        torch.cuda.empty_cache()
    errs = [rel_to_range(a, b) for a, b in zip(out, ref)]
    if not all(bool(torch.isfinite(a.float()).all()) for a in out) or max(errs) > MODULE_REL_TOL:
        fail(f"sd15 forward: bf16 against fp32, max error / range {errs} (bound {MODULE_REL_TOL})")
    # warm forwards at CFG batch 2 and 4: the median of 10 by CUDA events,
    # then a profiler trace of three back to back: the device's busy time a
    # forward, K1's part of it, and the device's idle share of the trace's
    # window (a forward whose launches outlast its kernels leaves it idle)
    summarise = load_profile_script().summarise
    fwd = []
    for b in (1, 2):
        x, c = lat.to(torch.bfloat16).repeat(b, 1, 1, 1), ctx.repeat(b, 1, 1)
        calls = []  # a session that records nothing is run again

        def forward():
            calls.append(b)
            return m.unet(x, tt.repeat(b), c)

        (ms, events), _ = counted(
            f"forward timed, batch {b}",
            lambda: (median_ms(forward, reps=10, warmup=2), trace_device_events(forward, 3)),
            lambda _: (k1_a_forward * len(calls), 0))
        text = f"CFG batch {2 * b}: {ms:.2f} ms (CUDA events, median of 10)"
        if events:
            _, busy, idle, _ = summarise(events)
            k1_dev = sum(t1 - t0 for name, t0, t1 in events if "flash_attn_sm90_kernel" in name)
            text += (f", device busy {busy / 3:.2f} ms a forward, K1 {k1_dev / 3e3:.2f} ms of "
                     f"it, idle share {idle:.4f} (profiler, 3 forwards)")
        else:
            text += ", its trace not measured (the profiler recorded no device event)"
        fwd.append(text)
    # the cost of convolving each row alone (unet_sd15.RowConv2d): the same
    # warm forwards with every convolution over the whole batch in one cuDNN
    # call, as before, in the same run
    whole = []
    row_forward = unet_sd15.RowConv2d.forward
    unet_sd15.RowConv2d.forward = torch.nn.Conv2d.forward
    try:
        for b in (1, 2):
            x, c = lat.to(torch.bfloat16).repeat(b, 1, 1, 1), ctx.repeat(b, 1, 1)
            ms, _ = counted(f"forward whole-batch convolutions, batch {b}",
                            lambda: median_ms(lambda: m.unet(x, tt.repeat(b), c), reps=10,
                                              warmup=2),
                            lambda _: (k1_a_forward * 12, 0))
            whole.append(f"CFG batch {2 * b} {ms:.2f} ms")
    finally:
        unet_sd15.RowConv2d.forward = row_forward
    phase("sd15 forward", f"{px} px, CFG batch 2: eps, t_feat, h1, h2 against fp32 on the card "
                          f"{', '.join(f'{e:.3e}' for e in errs)} of their range (bound "
                          f"{MODULE_REL_TOL}); K1 {k1_a_forward} launches; warm forward, each "
                          f"convolution a row at a time: {'; '.join(fwd)}; with every "
                          f"convolution over the whole batch instead: {', '.join(whole)} "
                          f"(CUDA events, median of 10); {smi}")

    # 2. requests through SD15Pipeline.generate at batch 1 and 2, each warmed
    # by a one-step request at its batch
    pipe = SD15Pipeline(m.agent, m.vae, m.clip)
    steps_k = lambda n_k2: lambda r: (k1_a_forward * r.num_steps, n_k2)

    def request(texts, seed_, **kw):
        ids = m.clip_ids(texts)
        return pipe.generate(clip_ids=ids, negative_clip_ids=np.zeros_like(ids), seed=seed_,
                             tpm_params=m.tpm, **kw)

    results = {}
    for b in (1, 2):
        texts = m.prompts[:b]
        pe, npe = m.encode(texts)
        counted(f"warm-up, batch {b}", lambda: m.agent.sample(
            m.tpm, {"prompt_embeds": pe, "negative_prompt_embeds": npe},
            torch.Generator(device=dev).manual_seed(0), predict=True,
            sampler_cfg=dataclasses.replace(m.agent.sampler_cfg, num_inference_steps=1,
                                            predict=True)),
            lambda r: (k1_a_forward, 0))
        torch.cuda.reset_peak_memory_stats(dev)
        res, sec = counted(f"request, batch {b}", lambda: request(texts, seed + 182 + b),
                           steps_k(1))
        check_sd15_schedule(res, b, px)
        results[b] = res
        phase("sd15 request", f"{px} px, batch {b}, CFG {SD15_GS}: {res.num_steps} steps "
                              f"(timesteps {res.schedule[0, :res.num_steps + 1].tolist()}), "
                              f"{sec:.3f} s ({1000 * sec / res.num_steps:.1f} ms a step with "
                              f"the text encode and the decode); K1 {k1_a_forward} a step, K2 "
                              f"1; peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
                              f"{smi}")

    # 3. img2img from the batch-1 image upside down at SD15_STRENGTH
    init = np.ascontiguousarray(results[1].images[:, ::-1])
    t0 = int(round(SD15_STRENGTH * 999))
    i2i, sec = counted("img2img", lambda: request(m.prompts[:1], seed + 183, init_image=init,
                                                  strength=SD15_STRENGTH), steps_k(2))
    check_sd15_schedule(i2i, 1, px, t0=t0)
    phase("sd15 img2img", f"strength {SD15_STRENGTH}: the loop starts at t {t0}, "
                          f"{i2i.num_steps} steps (text-to-image: {results[1].num_steps}) in "
                          f"{sec:.3f} s (encode + denoise + decode); K2 2 (encode, decode)")

    # 4. the fixed-batch engine over the SD1.5 runner: three requests with
    # mixed caps in one batch padded to four, each row equal to a direct
    # runner call on the same padded batch to the bit
    # the loop's iterations (a row whose t fell below min_time takes one
    # masked step more than its valid ones), read from each rollout
    loops = []
    sample = m.agent.sample
    m.agent.sample = lambda *a, **kw: loops.append(sample(*a, **kw)) or loops[-1]
    runner = make_sd15_runner(m.agent, m.tpm, m.encode, make_vae_decoder(m.vae))
    engine = BatchingEngine(None, lambda p, _n=None: (None, None), max_batch=4,
                            window_ms=500.0, max_steps=SD15_T_MAX, runner=runner)
    texts, seeds = m.prompts[:3], [seed + 190 + i for i in range(3)]
    engine.start()
    try:
        def burst():
            reqs = [engine.submit(p, seed=sd, steps=c)
                    for p, sd, c in zip(texts, seeds, SD15_ENGINE_CAPS)]
            return [r.result(timeout=600) for r in reqs]

        got, sec_engine = counted("engine", burst,
                                  lambda r: (k1_a_forward * loops[-1].num_steps, 1))
    finally:
        engine.stop()
    caps = [c or SD15_T_MAX for c in SD15_ENGINE_CAPS]
    direct, _ = counted("engine's direct call", lambda: runner(
        texts + texts[-1:], seeds + seeds[-1:], caps + caps[-1:]),
        lambda r: (k1_a_forward * loops[-1].num_steps, 1))
    m.agent.sample = sample
    for i, (a, b) in enumerate(zip(got, direct)):
        if not (np.array_equal(a["image"], b["image"]) and a["sigmas"] == b["sigmas"]
                and a["inference_steps"] == b["inference_steps"]):
            fail(f"sd15 engine row {i} differs from the direct call: steps "
                 f"{a['inference_steps']} / {b['inference_steps']}")
        if SD15_ENGINE_CAPS[i] is not None and a["inference_steps"] != SD15_ENGINE_CAPS[i]:
            fail(f"sd15 engine row {i}: {a['inference_steps']} steps under cap "
                 f"{SD15_ENGINE_CAPS[i]}")
    stats = engine.stats()
    phase("sd15 engine", f"BatchingEngine(max_batch=4, runner=make_sd15_runner(...)): 3 requests, "
                         f"caps {SD15_ENGINE_CAPS}, steps {[x['inference_steps'] for x in got]}, "
                         f"{sec_engine:.3f} s; each row equal to a direct runner call of the "
                         f"padded batch to the bit; stats batches_run {stats['batches_run']}, "
                         f"padded_slots {stats['padded_slots']}")
    phase("sd15 phase", f"{time.perf_counter() - t_phase:.1f} s; K1 {totals[0]}, K2 {totals[1]} "
                        f"launches; {smi}")
    del pipe, runner, engine

    # phase 22's SD1.5 part: a fused adapter on the continuous engine
    lora.family("sd15", m.agent, m.unet, m.tpm, m.encode, make_vae_decoder(m.vae),
                k1_a_forward, m.prompts, seed + 2230)

    # phase 21's SD1.5 update, CFG batch 8 at 512 px
    from tpdm_tpu_torch.train.sd15_agent import SD15Agent

    def collate(rows):
        texts = [r["prompt"] for r in rows]
        pe, npe = m.encode(texts)
        return {"prompt": texts, "prompt_embeds": pe, "negative_prompt_embeds": npe}

    agent = SD15Agent(m.unet, family_rloo.config(SD15_T_MAX), guidance_scale=SD15_GS)
    family_rloo.update("sd15", agent, {agent: k1_a_forward}, m.vae, collate)
    del m, agent
    gc.collect()
    torch.cuda.empty_cache()
    return totals[0], totals[1], k1_entries


# phase 19: SDXL at 1024 px (the base, the refiner, the ensemble) and the
# UNet families' continuous engines. The sampler's step cap and CFG
# (SDXLAgent's default), the refiner's strength on a decoded image, the
# ensemble's denoising_end, each continuous burst's size and caps, and
# K1's new shapes at d 64: the base's 10 heads over the level-1 grid's
# 4096 tokens and 20 over level 2's and the mid block's 1024 (CFG batch 2,
# 4 and 8: a batch-1 and a batch-2 request, the engines' four slots), the
# refiner's 12 over 4096, 24 over 1024 and 24 over its mid block's 256
# (CFG batch 2 and 4: a refined image, the ensemble's batch of two), each
# beside its cross-attention against 77 text tokens; and K1 at the toy
# worlds' head dims below 64 (padded to 64 columns: the toy UNets' 4, 6
# and 8 at CFG batch 4, the toy VAE's 16), which the CLI runs serve
SDXL_T_MAX = 25
SDXL_GS = 5.0
SDXL_REFINE_STRENGTH = 0.3
SDXL_DENOISING_END = 0.8
SDXL_ENSEMBLE_CAPS = (None, 10)
FAMILY_BURST = 8  # each continuous engine's burst: example prompts, seeds
FAMILY_CAPS = (None, 4, None, 8)  # its caps, in turn
_SDXL_LEVELS = (("l1", 10, 4096), ("l2", 20, 1024))
_SDXL_REFINER_LEVELS = (("refiner_l1", 12, 4096), ("refiner_l2", 24, 1024),
                        ("refiner_mid", 24, 256))
_batch_key = lambda b: "" if b == 2 else f"_batch_{b}"
SDXL_K1_SHAPES = {
    **{f"sdxl_{level}_{kind}{_batch_key(b)}": (b, h, n, n if kind == "self" else 77, 64)
       for b in (2, 4, 8) for level, h, n in _SDXL_LEVELS for kind in ("self", "cross")},
    **{f"sdxl_{level}_{kind}{_batch_key(b)}": (b, h, n, n if kind == "self" else 77, 64)
       for b in (2, 4, 8) for level, h, n in _SDXL_REFINER_LEVELS for kind in ("self", "cross")},
    "toy_d4": (4, 2, 256, 256, 4), "toy_d6": (4, 2, 64, 64, 6), "toy_d8": (4, 2, 16, 16, 8),
    "toy_xl_d4": (4, 3, 64, 64, 4), "toy_vae_d16": (2, 1, 256, 256, 16),
}


def unet_k1_a_forward(ucfg):
    """K1 calls of one UNet forward: two a transformer block (depth x
    layers_per_block down, x (layers_per_block + 1) up, and the mid
    block's)."""
    return 2 * (sum(ucfg.depths) * (2 * ucfg.layers_per_block + 1)
                + ucfg.mid_transformer_layers)


def sdxl_models(seed, dev):
    """Phase 19's SDXL models, N(0, WEIGHT_STD²) weights from ``seed`` on
    the card in bf16: the base UNet (UNetConfig.sdxl(), 2.6 B parameters),
    the refiner (sdxl_refiner(), 2.3 B), CLIP-L (12 x 768) and bigG (32 x
    1280) with a toy CLIP vocabulary of the example prompts (bigG's ids
    padded with 0 past the first EOS, as its tokenizer pads), the SDXL VAE
    with its encoder, and SDXLAgent / SDXLRefinerAgent whose TPMs (128
    channels, bf16 compute) have head bias TPM_HEAD_BIAS. Returns a
    namespace of them and the encode functions."""
    from tpdm_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from tpdm_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig
    from tpdm_tpu_torch.pipeline.text_encoding import SDXLTextEncoders
    from tpdm_tpu_torch.train import RLOOConfig
    from tpdm_tpu_torch.train.sdxl_agent import SDXLAgent, SDXLRefinerAgent
    from tpdm_tpu_torch.utils.tokenizer import CLIPTokenizer

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 190)
    modules = []
    for build in (lambda: UNetSD15(UNetConfig.sdxl()),
                  lambda: UNetSD15(UNetConfig.sdxl_refiner()),
                  lambda: CLIPTextModel(CLIPTextConfig.sd3_clip_l()),
                  lambda: CLIPTextModel(CLIPTextConfig.sd3_clip_g()),
                  lambda: VAE(VAEConfig.sdxl())):
        with torch.device(dev):
            module = build()
        module.init_weights(gen, WEIGHT_STD)
        modules.append(module.to(dtype=torch.bfloat16).eval())
        torch.cuda.empty_cache()  # the fp32 draw
    unet, refiner, clip_l, clip_g, vae = modules
    config = RLOOConfig(max_inference_steps=SDXL_T_MAX, init_alpha=TPM_HEAD_BIAS[0],
                        init_beta=TPM_HEAD_BIAS[1])
    agent = SDXLAgent(unet, config, guidance_scale=SDXL_GS)
    ragent = SDXLRefinerAgent(refiner, config, guidance_scale=SDXL_GS)
    tpm, rtpm = agent.init_tpm_params(gen).eval(), ragent.init_tpm_params(gen).eval()
    text = SDXLTextEncoders(clip_l, clip_g)
    with open(REPO / "example" / "prompts.jsonl") as f:
        prompts = [json.loads(line)["prompt"] for line in f if line.strip()]
    with tempfile.TemporaryDirectory() as tmp:
        write_clip_vocab(Path(tmp) / "clip", prompts)
        tok = CLIPTokenizer.from_pretrained(str(Path(tmp) / "clip"), max_length=77)

    def clip_ids(texts):
        return np.asarray(tok(list(texts), max_length=77)["input_ids"])

    def g_ids(texts):
        ids = clip_ids(texts).copy()
        eos = ids == 49407
        ids[(np.cumsum(eos, axis=1) - eos) > 0] = 0  # past the first EOS
        return ids

    def pairs(pos, neg):
        return (pos.prompt_embeds, pos.pooled_prompt_embeds, neg.prompt_embeds,
                neg.pooled_prompt_embeds)

    def encode(texts):
        ids = clip_ids(texts)
        return pairs(text.encode(ids, g_ids(texts)), text.encode(np.zeros_like(ids)))

    def encode_refiner(texts):
        ids = g_ids(texts)
        return pairs(text.encode_refiner(ids), text.encode_refiner(np.zeros_like(ids)))

    torch.cuda.synchronize()
    return argparse.Namespace(unet=unet, refiner=refiner, text=text, vae=vae, agent=agent,
                              ragent=ragent, tpm=tpm, rtpm=rtpm, clip_ids=clip_ids,
                              g_ids=g_ids, encode=encode, encode_refiner=encode_refiner,
                              prompts=prompts, seconds=time.perf_counter() - t0)


def recorded_samples(*agents):
    """Each agent's sample() wrapped to append its outputs to the list
    returned (the loops' iterations: a row whose t fell below min_time
    takes one masked step past its valid ones); restore() undoes it."""
    outs, real = [], [a.sample for a in agents]
    for agent, sample in zip(agents, real):
        agent.sample = (lambda *a, _s=sample, _agent=agent, **kw:
                        outs.append((_agent, _s(*a, **kw))) or outs[-1][1])

    def restore():
        for agent, sample in zip(agents, real):
            agent.sample = sample

    return outs, restore


def burst(engine, jobs):
    """``jobs`` (prompt, seed, cap[, adapter]) at once through a started
    ``engine``: results, makespan and latency p50 on the host clock (each
    request's completion polled)."""
    engine.start()
    try:
        start = time.monotonic()
        reqs = [engine.submit(p, seed=s, steps=c, **({"lora": a[0]} if a and a[0] else {}))
                for p, s, c, *a in jobs]
        done = [None] * len(reqs)
        while not all(done):
            for i, r in enumerate(reqs):
                if done[i] is None and r._event.is_set():
                    done[i] = time.monotonic()
            time.sleep(0.001)
        results = [r.result(timeout=0) for r in reqs]
    finally:
        engine.stop()
    lat = sorted(t - r.submitted_at for t, r in zip(done, reqs))
    return results, max(done) - start, lat[len(lat) // 2]


def family_continuous(label, counted, agent, tpm, encode, decode, k1_fwd, prompts, seed, smi):
    """A burst of FAMILY_BURST requests with FAMILY_CAPS through the
    family's continuous engine (4 slots, seg_steps 4), then through
    BatchingEngine(max_batch=4) over the family's runner given the
    continuous engine's embed rows and decoding a row at a time as the
    continuous engine does (a decode's batch changes its rounding):
    makespans and p50 side by side, each request's schedule (integer t,
    or FLUX's sigmas) and steps equal. A request's final latents and image
    are then held to the runner at the same CFG batch with the request in
    its slot's row (runner calls of 4 rows, the requests placed by slot):
    equal, or the image
    within the 1-level uint8 seam on under 1 % of pixels; the share equal
    to the fixed engine's own row is printed. K1 and K2 checked exactly
    around each burst."""
    from tpdm_tpu_torch.serving import BatchingEngine
    from tpdm_tpu_torch.serving_continuous import (
        ContinuousFluxEngine,
        ContinuousSD15Engine,
        ContinuousSDXLEngine,
    )
    from tpdm_tpu_torch.serving_families import (
        make_flux_runner,
        make_sd15_runner,
        make_sdxl_runner,
    )

    sdxl, flux = label == "sdxl", label.startswith("flux")
    cls = ContinuousFluxEngine if flux else ContinuousSDXLEngine if sdxl else ContinuousSD15Engine
    cont = cls(agent, encode, decode=decode, tpm_params=tpm, slots=4, seg_steps=4)
    cont.warmup()
    slot_of, finals = {}, {}
    assign, complete = cont._assign, cont._complete

    def assign_rec(slot, req):
        slot_of[req.seed] = slot
        assign(slot, req)

    def complete_rec(req, lat_row, nfe, sigmas):
        finals[req.seed] = lat_row.clone()
        complete(req, lat_row, nfe, sigmas)

    cont._assign, cont._complete = assign_rec, complete_rec
    jobs = [(prompts[i % len(prompts)], seed + i, FAMILY_CAPS[i % len(FAMILY_CAPS)])
            for i in range(FAMILY_BURST)]
    (got, span_c, p50_c), _ = counted(
        f"{label} continuous", lambda: burst(cont, jobs),
        lambda _: (k1_fwd * cont.seg_steps * cont.segments_run, FAMILY_BURST))
    stats = cont.stats()

    def rows_encode(texts):
        rows = [cont._prompt_embeds(t) for t in texts]
        if flux:
            return torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows])
        pe, npe = torch.stack([r[0] for r in rows]), cont._neg_pe.expand(len(texts), -1, -1)
        if not sdxl:
            return pe, npe
        return (pe, torch.stack([r[1] for r in rows]), npe,
                cont._neg_pp.expand(len(texts), -1))

    calls_z = []  # [seeds, final latents] of each runner call

    def decode_rows(z):
        calls_z[-1][1] = z
        return np.concatenate([decode(z[i:i + 1]) for i in range(z.shape[0])])

    make = make_flux_runner if flux else make_sdxl_runner if sdxl else make_sd15_runner
    inner = make(agent, tpm, rows_encode, decode_rows)

    def runner(texts, seeds, caps):
        calls_z.append([list(seeds), None])
        return inner(texts, seeds, caps)

    T = agent.sampler_cfg.max_inference_steps if flux else agent.sampler_cfg.num_inference_steps
    warm = [p for p, _, _ in jobs[:4]]
    counted(f"{label} fixed warm-up", lambda: runner(warm, [seed] * 4, [1] * 4), None)
    decodes = FAMILY_BURST + -FAMILY_BURST % 4  # a batch's padded rows decode too
    outs, restore = recorded_samples(agent)
    fixed = BatchingEngine(None, lambda p, _n=None: (None, None), max_batch=4, window_ms=100.0,
                           max_steps=T, runner=runner)
    try:
        (want, span_f, p50_f), _ = counted(
            f"{label} fixed", lambda: burst(fixed, jobs),
            lambda _: (k1_fwd * sum(o.num_steps for _, o in outs), decodes))
    finally:
        restore()
    for (p, s, c), a, b in zip(jobs, got, want):
        same = (a["sigmas"] if flux else [int(v) for v in a["sigmas"]]) == b["sigmas"]
        if not same or a["inference_steps"] != b["inference_steps"]:
            fail(f"{label} continuous ({p!r}, {s}, cap {c}): schedule {a['sigmas']} against the "
                 f"fixed runner's {b['sigmas']}")
        if c is not None and a["inference_steps"] != min(c, T):
            fail(f"{label} continuous: a request capped at {c} ran {a['inference_steps']} steps")
    fixed_latents = {}
    for seeds, z in calls_z[1:]:  # the burst's batches (padding repeats a request)
        for k, s in enumerate(seeds):
            fixed_latents.setdefault(s, z[k:k + 1])
    fixed_rows = sum(1 for _, s, _ in jobs if torch.equal(finals[s], fixed_latents[s]))
    # the runner with each request in its slot's row, the other rows filled
    # with the burst's first request
    calls = []
    for i, (p, s, c) in enumerate(jobs):
        call = next((k for k in calls if k[slot_of[s]] is None), None)
        if call is None:
            call = [None] * 4
            calls.append(call)
        call[slot_of[s]] = i
    images = {}
    for call in calls:
        rows = [jobs[0 if i is None else i] for i in call]
        res, _ = counted(f"{label} reference", lambda: runner(
            [r[0] for r in rows], [r[1] for r in rows], [r[2] or T for r in rows]), None)
        for k, i in enumerate(call):
            if i is not None:
                images[jobs[i][1]] = (res[k]["image"], calls_z[-1][1][k:k + 1])
    seams, exact = [], 0
    for (p, s, c), a in zip(jobs, got):
        ref_image, ref_latents = images[s]
        exact += torch.equal(finals[s], ref_latents)
        d = np.abs(a["image"].astype(np.int16) - ref_image.astype(np.int16))
        seams.append((int(d.max()), float((d > 0).mean())))
        if seams[-1][0] > 1 or seams[-1][1] >= 0.01:
            fail(f"{label} continuous ({p!r}, {s}, slot {slot_of[s]}): image against the runner's "
                 f"at its slot's row: largest gap {seams[-1][0]} levels on {seams[-1][1]:.4f} of "
                 f"the pixels; final latents max |d| "
                 f"{(finals[s].float() - ref_latents.float()).abs().max().item():.3e}, against "
                 f"the fixed engine's row "
                 f"{(finals[s].float() - fixed_latents[s].float()).abs().max().item():.3e}")
    same = sum(1 for m, _ in seams if m == 0)
    seam = ("" if same == len(seams) else f", the rest within one level on at most "
            f"{max(sh for _, sh in seams):.4f} of the pixels")
    phase(f"{label} continuous",
          f"{type(cont).__name__}(slots=4, seg_steps=4): {FAMILY_BURST} requests, caps "
          f"{FAMILY_CAPS}, steps {[r['inference_steps'] for r in got]}; makespan {span_c:.3f} s, "
          f"p50 {p50_c:.3f} s, slot_utilization {stats['slot_utilization']:.4f}, segments_run "
          f"{stats['segments_run']}; BatchingEngine(max_batch=4) over the runner: makespan "
          f"{span_f:.3f} s, p50 {p50_f:.3f} s (its decode a row at a time); every schedule equal "
          f"to the fixed engine's; at the request's slot row ({len(calls)} runner calls) "
          f"{exact} of {len(jobs)} final latents and {same} images equal to the bit{seam}; "
          f"{fixed_rows} of {len(jobs)} final latents equal to the fixed engine's own row; {smi}")
    del cont, fixed, runner, inner
    gc.collect()
    torch.cuda.empty_cache()


def family_cli(label, argv, counted):
    """``serve`` on the card (no --cpu) with ``argv``: its toy world behind
    the HTTP server, one POST /generate answered with a PNG and the schedule
    (integer t, or FLUX's sigmas); K1 (the toy UNet's or FLUX's forwards and
    the toy VAE's attention, d 16) checked exactly, K2 none. Returns the
    round trip's seconds."""
    import http.client
    import threading

    from tpdm_tpu_torch import serve
    from tpdm_tpu_torch.ops.attention import flash_attention, flash_attention_streaming

    args = serve.parse_args(["--toy", "--port", "0", "--max_steps", "8", *argv])
    world = serve.build_family_world(args)
    agent = world["agent"]
    flux = hasattr(agent, "flux")
    k1_fwd = flux_k1_a_forward(agent.flux.config) if flux else unet_k1_a_forward(agent.unet.config)
    outs, restore = recorded_samples(world["agent"])
    engine, server = serve.make_http_server(None, None, args, runner=world["runner"],
                                            world=world)
    continuous = args.continuous
    engine.start()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call():
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=600)
        try:
            conn.request("POST", "/generate", body=json.dumps({"prompt": "a cat", "seed": 1}))
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def want(_):
        if continuous:
            return k1_fwd * engine.seg_steps * engine.segments_run + 1, 0
        return k1_fwd * sum(o.num_steps for _, o in outs) + 1, 0

    try:
        (status, body), sec = counted(f"cli {label}", call, want)
        got = (flash_attention.launches, flash_attention_streaming.launches)
    finally:
        server.shutdown()
        engine.stop()
        server.server_close()
        restore()
    if status != 200:
        fail(f"serve {' '.join(argv)}: POST /generate {status} {body[:200]}")
    reply = json.loads(body)
    image = png_pixels(base64.b64decode(reply["image_png_base64"]), f"serve {label}'s PNG")
    if image.dtype != np.uint8 or image.ndim != 3 or not reply["sigmas"]:
        fail(f"serve {label}: image {image.shape}, sigmas {reply['sigmas']}")
    phase(f"cli {label}", f"python -m tpdm_tpu_torch.serve {' '.join(argv)} --toy on the card: "
                          f"{type(engine).__name__}, POST /generate {status} in {sec:.3f} s, "
                          f"{reply['inference_steps']} steps, {'sigmas' if flux else 'timesteps'} "
                          f"{reply['sigmas']}, a "
                          f"{image.shape[0]} x {image.shape[1]} PNG; K1 {got[0]} launches "
                          f"({k1_fwd} a toy forward at head dims below 64, one a toy decode), K2 0")
    return got


def sdxl_phase(seed, dev, smi, family_rloo):
    """Phase 19: SDXL at 1024 px and the families' continuous engines, item
    19 of this file's docstring, with phase 21's SDXL and ensemble updates
    (``family_rloo``) on its models. Returns (K1 launches, K2 launches, the
    kernels line's K1 entries) of phase 19."""
    import copy

    from tpdm_tpu_torch.models import unet_sd15
    from tpdm_tpu_torch.ops.attention import (
        attention_reference,
        flash_attention,
        flash_attention_streaming,
    )
    from tpdm_tpu_torch.pipeline.variants import SDXLPipeline, SDXLRefinerPipeline
    from tpdm_tpu_torch.serving import BatchingEngine
    from tpdm_tpu_torch.serving_families import make_sdxl_ensemble_runner, make_vae_decoder
    from tpdm_tpu_torch.train.sdxl_agent import SDXLAgent, SDXLEnsembleAgent, SDXLRefinerAgent

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 19)
    k1_entries = {key: k1_check(g, dev, key, *shape) for key, shape in SDXL_K1_SHAPES.items()}
    torch.cuda.empty_cache()
    totals = [0, 0]
    counted = launch_counter("sdxl", totals)

    # 1. the SD1.5 continuous engine at 512 px on phase 18's models, built anew
    m15 = sd15_models(seed, dev)
    family_continuous("sd15", counted, m15.agent, m15.tpm, m15.encode,
                      make_vae_decoder(m15.vae), unet_k1_a_forward(m15.unet.config),
                      m15.prompts, seed + 1900, smi)
    del m15
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the SDXL models
    m = sdxl_models(seed, dev)
    ucfg, rcfg = m.unet.config, m.refiner.config
    k1_base, k1_ref = unet_k1_a_forward(ucfg), unet_k1_a_forward(rcfg)
    n_base = sum(p.numel() for p in m.unet.parameters())
    n_ref = sum(p.numel() for p in m.refiner.parameters())
    phase("sdxl models", f"base UNet {n_base / 1e9:.3f} B parameters (K1 {k1_base} a forward), "
                         f"refiner {n_ref / 1e9:.3f} B (K1 {k1_ref}), CLIP-L 12 x 768, bigG 32 x "
                         f"1280, the SDXL VAE with its encoder, TPM head bias {TPM_HEAD_BIAS}, "
                         f"bf16, drawn in {m.seconds:.1f} s; "
                         f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    px = ucfg.sample_size * 8

    # 3. one base forward at CFG batch 2 against an fp32 copy of the same
    # (bf16-valued) weights on the card, its attention the plain version
    lat = torch.randn(2, 4, ucfg.sample_size, ucfg.sample_size, generator=g, device=dev)
    pe, pooled, npe, npooled = m.encode(m.prompts[:1])
    ctx, pp = torch.cat([npe, pe]), torch.cat([npooled, pooled])
    added = {"text_embeds": pp, "time_ids": m.agent.default_time_ids(2)}
    tt = torch.tensor([999.0, 999.0], device=dev)
    with torch.no_grad():
        out, _ = counted("forward", lambda: m.unet(lat.to(torch.bfloat16), tt, ctx, added),
                         lambda _: (k1_base, 0))
        f32 = copy.deepcopy(m.unet).float()
        real_attention = unet_sd15.joint_attention
        unet_sd15.joint_attention = attention_reference
        try:
            ref = f32(lat, tt, ctx.float(), {k: v.float() for k, v in added.items()})
        finally:
            unet_sd15.joint_attention = real_attention
        del f32
        torch.cuda.empty_cache()
        errs = [rel_to_range(a, b) for a, b in zip(out, ref)]
        if (not all(bool(torch.isfinite(a.float()).all()) for a in out)
                or max(errs) > MODULE_REL_TOL):
            fail(f"sdxl forward: bf16 against fp32, max error / range {errs} (bound "
                 f"{MODULE_REL_TOL})")
        # the warm forward: the median of 10 by CUDA events, then a profiler
        # trace of three back to back (as phase 18's)
        x = lat.to(torch.bfloat16)
        calls = []

        def forward():
            calls.append(1)
            return m.unet(x, tt, ctx, added)

        (ms, events), _ = counted(
            "forward timed",
            lambda: (median_ms(forward, reps=10, warmup=2), trace_device_events(forward, 3)),
            lambda _: (k1_base * len(calls), 0))
    trace = ", its trace not measured (the profiler recorded no device event)"
    if events:
        _, busy, idle, _ = load_profile_script().summarise(events)
        k1_dev = sum(t1 - t0 for name, t0, t1 in events if "flash_attn_sm90_kernel" in name)
        trace = (f", device busy {busy / 3:.2f} ms a forward, K1 {k1_dev / 3e3:.2f} ms of it, "
                 f"idle share {idle:.4f} (profiler, 3 forwards)")
    phase("sdxl forward", f"{px} px, CFG batch 2: eps, t_feat, h1, h2 against fp32 on the card "
                          f"{', '.join(f'{e:.3e}' for e in errs)} of their range (bound "
                          f"{MODULE_REL_TOL}); K1 {k1_base} launches a forward; warm forward "
                          f"{ms:.2f} ms (CUDA events, median of 10){trace}; {smi}")

    # 4. SDXLPipeline.generate from text at batch 1 and 2, each warmed by a
    # one-step rollout at its batch
    pipe = SDXLPipeline(m.agent, m.vae, m.text)
    results = {}
    for b in (1, 2):
        texts = m.prompts[:b]
        pe, pooled, npe, npooled = m.encode(texts)
        counted(f"warm-up, batch {b}", lambda: m.agent.sample(
            m.tpm, {"prompt_embeds": pe, "pooled_prompt_embeds": pooled,
                    "negative_prompt_embeds": npe, "negative_pooled_prompt_embeds": npooled},
            torch.Generator(device=dev).manual_seed(0), predict=True,
            sampler_cfg=dataclasses.replace(m.agent.sampler_cfg, num_inference_steps=1,
                                            predict=True)),
            lambda r: (k1_base, 0))
        ids = m.clip_ids(texts)
        torch.cuda.reset_peak_memory_stats(dev)
        res, sec = counted(f"request, batch {b}", lambda: pipe.generate(
            clip_ids=ids, negative_clip_ids=np.zeros_like(ids), seed=seed + 191 + b,
            tpm_params=m.tpm), lambda r: (k1_base * r.num_steps, 1))
        check_sd15_schedule(res, b, px, t_max=SDXL_T_MAX)
        results[b] = res
        phase("sdxl request", f"{px} px, batch {b}, CFG {SDXL_GS}: {res.num_steps} steps "
                              f"(timesteps {res.schedule[0, :res.num_steps + 1].tolist()}), "
                              f"{sec:.3f} s ({1000 * sec / res.num_steps:.1f} ms a step with "
                              f"the text encode and the decode); K1 {k1_base} a step, K2 1; "
                              f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; {smi}")

    # 5. the refiner on the batch-1 image at SDXL_REFINE_STRENGTH
    rpipe = SDXLRefinerPipeline(m.ragent, m.vae, m.text)
    t0 = int(round(SDXL_REFINE_STRENGTH * 999))
    gi = m.g_ids(m.prompts[:1])
    refined, sec = counted("refiner", lambda: rpipe.refine(
        init_image=results[1].images, strength=SDXL_REFINE_STRENGTH, clip_g_ids=gi,
        negative_clip_g_ids=np.zeros_like(gi), seed=seed + 194, tpm_params=m.rtpm),
        lambda r: (k1_ref * r.num_steps, 2))
    check_sd15_schedule(refined, 1, px, t0=t0, t_max=SDXL_T_MAX)
    phase("sdxl refiner", f"SDXLRefinerPipeline.refine of the batch-1 image at strength "
                          f"{SDXL_REFINE_STRENGTH}: the loop starts at t {t0}, {refined.num_steps} "
                          f"steps (timesteps {refined.schedule[0, :refined.num_steps + 1].tolist()})"
                          f" in {sec:.3f} s (encode + denoise + decode); K1 {k1_ref} a step, K2 2")

    # 6. the ensemble behind the fixed-batch engine
    runner = make_sdxl_ensemble_runner(m.agent, m.tpm, m.ragent, m.rtpm, m.encode,
                                       m.encode_refiner, make_vae_decoder(m.vae),
                                       denoising_end=SDXL_DENOISING_END)
    outs, restore = recorded_samples(m.agent, m.ragent)
    engine = BatchingEngine(None, lambda p, _n=None: (None, None), max_batch=2,
                            window_ms=500.0, max_steps=SDXL_T_MAX, runner=runner)

    def loops_k1(_):
        return (sum((k1_base if a is m.agent else k1_ref) * o.num_steps for a, o in outs),
                sum(1 for a, _ in outs if a is m.agent))  # one decode a batch

    try:
        (got, span, _), _ = counted("ensemble", lambda: burst(engine, [
            (p, seed + 195 + i, c) for i, (p, c) in enumerate(zip(m.prompts, SDXL_ENSEMBLE_CAPS))]),
            loops_k1)
    finally:
        restore()
    t_cut = int(round(999 * (1.0 - SDXL_DENOISING_END)))
    for r, cap in zip(got, SDXL_ENSEMBLE_CAPS):
        ts = r["sigmas"]
        if (r["base_steps"] + r["refiner_steps"] != r["inference_steps"]
                or r["handoff_t"] >= t_cut or r["refiner_steps"] < 1
                or ts[r["base_steps"] - 1] != r["handoff_t"]
                or (cap is not None and r["inference_steps"] > cap)
                or r["image"].shape != (px, px, 3)):
            fail(f"sdxl ensemble: steps {r['base_steps']} + {r['refiner_steps']} = "
                 f"{r['inference_steps']} (cap {cap}), handoff t {r['handoff_t']} (cutoff "
                 f"{t_cut}), timesteps {ts}")
    phase("sdxl ensemble", f"BatchingEngine(max_batch=2) over make_sdxl_ensemble_runner("
                           f"denoising_end={SDXL_DENOISING_END}): caps {SDXL_ENSEMBLE_CAPS}, base "
                           f"+ refiner steps {[(r['base_steps'], r['refiner_steps']) for r in got]}"
                           f", handoff t {[r['handoff_t'] for r in got]} (below the cutoff "
                           f"{t_cut}), {span:.3f} s; K1 {k1_base} a base step, {k1_ref} a "
                           f"refiner step, K2 1")
    del rpipe, pipe, engine, runner

    # 7. the SDXL continuous engine at 1024 px
    family_continuous("sdxl", counted, m.agent, m.tpm, m.encode, make_vae_decoder(m.vae),
                      k1_base, m.prompts, seed + 1910, smi)
    t_rloo = time.perf_counter()

    # phase 21's SDXL base update (CFG batch 8 at 1024 px), then the
    # ensemble's at SDXL_DENOISING_END (both heads in one Adam step)
    keys = ("prompt_embeds", "pooled_prompt_embeds", "negative_prompt_embeds",
            "negative_pooled_prompt_embeds")

    def collate(rows):
        texts = [r["prompt"] for r in rows]
        return {"prompt": texts, **dict(zip(keys, m.encode(texts)))}

    def ensemble_collate(rows):
        batch = collate(rows)
        batch.update(zip((f"refiner_{k}" for k in keys), m.encode_refiner(batch["prompt"])))
        return batch

    train_cfg = family_rloo.config(SDXL_T_MAX)
    base = SDXLAgent(m.unet, train_cfg, guidance_scale=SDXL_GS)
    family_rloo.update("sdxl", base, {base: k1_base}, m.vae, collate)
    ensemble = SDXLEnsembleAgent(SDXLAgent(m.unet, train_cfg, guidance_scale=SDXL_GS),
                                 SDXLRefinerAgent(m.refiner, train_cfg, guidance_scale=SDXL_GS),
                                 denoising_end=SDXL_DENOISING_END)
    family_rloo.update("sdxl ensemble", ensemble,
                       {ensemble.base: k1_base, ensemble.refiner: k1_ref}, m.vae,
                       ensemble_collate)
    t_phase += time.perf_counter() - t_rloo  # phase 19's seconds leave phase 21's out
    del m, base, ensemble
    gc.collect()
    torch.cuda.empty_cache()

    # 8. the command line on the card
    for label, argv in (("sdxl", ["--family", "sdxl"]),
                        ("sd15 continuous", ["--family", "sd15", "--continuous"])):
        family_cli(label, argv, counted)
    phase("sdxl phase", f"{time.perf_counter() - t_phase:.1f} s; K1 {totals[0]}, K2 {totals[1]} "
                        f"launches; {smi}")
    flash_attention.launches = flash_attention_streaming.launches = 0
    return totals[0], totals[1], k1_entries


FLUX_T_MAX = 28
FLUX_N_TXT = 512  # FLUX.1-dev's T5 sequence length
FLUX_STRENGTH = 0.6
FLUX_FIXED_STEPS = 28
FLUX_ENGINE_PX = 512
# FLUX.1-dev's VAE: SD3's 16-channel geometry with its own published factors
FLUX_VAE_FACTORS = dict(scaling_factor=0.3611, shift_factor=0.1159)
# K1 at head dim 128: the joint [512 T5, image] sequence at 1024 px (4096
# image tokens) at batch 1 and 2 and at phase 21's RLOO batch 4, and at 512
# px (1024) at the engine's 4 slots
FLUX_K1_SHAPES = {
    "flux_1024px": (1, 24, 4608, 4608, 128),
    "flux_1024px_batch_2": (2, 24, 4608, 4608, 128),
    "flux_512px_batch_4": (4, 24, 1536, 1536, 128),
    "flux_1024px_batch_4": (4, 24, 4608, 4608, 128),
}


def flux_k1_a_forward(fcfg):
    """K1 calls of one full FLUX forward: one a double and a single block."""
    return fcfg.depth_double + fcfg.depth_single


def flux_backbone(cfg, dev, seed):
    """A ``Flux(cfg)`` built on the meta device and given bf16 storage on the
    card, its N(0, WEIGHT_STD²) weights drawn there from a generator seeded
    ``seed``: 12 B parameters never pass through fp32 (48 GB)."""
    from tpdm_tpu_torch.models.flux import Flux

    with torch.device("meta"):
        flux = Flux(cfg).to(torch.bfloat16)
    flux = flux.to_empty(device=dev)
    return flux.init_weights(torch.Generator(device=dev).manual_seed(seed), WEIGHT_STD).eval()


def flux_quantize_in_place(agent, bits):
    """``agent.flux`` replaced by its quant_matmuls form holding the same
    tensors (built on the meta device and given them by assign), then
    prequantised: each bf16 weight is freed as its int copy replaces it."""
    from tpdm_tpu_torch.models.flux import Flux
    from tpdm_tpu_torch.ops.quant import prequantize_

    flux = agent.flux
    with torch.device("meta"):
        qm = Flux(dataclasses.replace(flux.config, quant_matmuls=True, quant_bits=bits))
    qm.load_state_dict(flux.state_dict(), assign=True)
    agent.flux = qm.requires_grad_(False).eval()
    del flux
    gc.collect()
    return prequantize_(qm)


def flux_embeds(texts, dev):
    """T5-shaped rows (b, FLUX_N_TXT, 4096) and pooled vectors (b, 768), bf16,
    drawn per text from a generator seeded by its crc32: the same text gives
    the same rows in every batch."""
    import zlib

    rows, pooled = [], []
    for text in texts:
        gen = torch.Generator(device=dev).manual_seed(zlib.crc32(text.encode()))
        rows.append(torch.randn(FLUX_N_TXT, 4096, generator=gen, device=dev))
        pooled.append(torch.randn(768, generator=gen, device=dev))
    return torch.stack(rows).to(torch.bfloat16), torch.stack(pooled).to(torch.bfloat16)


def check_flux_result(label, res, b, px, s0=1.0):
    """Finite uint8 images (b, px, px, 3), 1 to FLUX_T_MAX steps, each
    sample's sigmas falling from below ``s0``."""
    img = res.images
    sig = res.schedule[:, :res.num_steps]
    if (img.dtype != np.uint8 or img.shape != (b, px, px, 3)
            or not 1 <= res.num_steps <= FLUX_T_MAX or not np.isfinite(sig).all()
            or not (sig[:, 0] < s0).all() or not (np.diff(sig, axis=1) <= 0).all()):
        fail(f"flux {label}: images {img.dtype} {img.shape}, {res.num_steps} steps, sigmas "
             f"{sig.tolist()}")


def flux_phase(seed, dev, smi, family_rloo, lora):
    """Phase 20: FLUX.1-dev at 1024 px, item 20 of this file's docstring,
    with phase 22's FLUX part (``lora``, at 512 px) and phase 21's FLUX
    update (``family_rloo``) on the bf16 model before the quantised modes. Returns (K1, K2, K4, K5 launches, the kernels
    line's K1 entries) of phase 20."""
    import copy

    from tpdm_tpu_torch.models import flux as flux_module
    from tpdm_tpu_torch.models.flux import Flux, FluxConfig, pack_latents
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig
    from tpdm_tpu_torch.ops.attention import (
        attention_reference,
        flash_attention,
        flash_attention_streaming,
    )
    from tpdm_tpu_torch.ops.gemm import bf16_gemm, int8_gemm
    from tpdm_tpu_torch.pipeline.sampler import cache_reuse_schedule
    from tpdm_tpu_torch.pipeline.variants import FluxPipeline
    from tpdm_tpu_torch.serving_families import make_vae_decoder
    from tpdm_tpu_torch.train import RLOOConfig
    from tpdm_tpu_torch.train.flux_agent import FluxAgent

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    k1_entries = {key: k1_check(g, dev, key, *shape) for key, shape in FLUX_K1_SHAPES.items()}
    torch.cuda.empty_cache()
    totals = [0, 0]
    counted = launch_counter("flux", totals)
    gemm_totals = [0, 0]

    def counted_gemms(label, fn, want):
        """counted() with K4's and K5's launches also set to 0 before and
        checked after: want(out) -> (K1, K2, K4, K5)."""
        int8_gemm.launches = bf16_gemm.launches = 0
        out, sec = counted(label, fn, lambda o: want(o)[:2])
        got = (int8_gemm.launches, bf16_gemm.launches)
        gemm_totals[0] += got[0]
        gemm_totals[1] += got[1]
        if got != want(out)[2:]:
            fail(f"flux {label}: K4 {got[0]}, K5 {got[1]} launches, expected {want(out)[2:]}")
        return out, sec

    # 1. full width, 2 double + 2 single blocks: bf16 through the kernels
    # against an fp32 copy of the same (bf16-valued) weights on the card,
    # whose attention is the plain version (K1 takes bf16 only)
    small_cfg = FluxConfig.flux_dev(depth_double=2, depth_single=2)
    with torch.device(dev):
        f32 = Flux(small_cfg).init_weights(g, WEIGHT_STD).eval()
    f32 = f32.to(torch.bfloat16).float()
    bf16 = copy.deepcopy(f32).to(torch.bfloat16)
    lat = torch.randn(1, 16, 128, 128, generator=g, device=dev)
    tokens, img_ids = pack_latents(lat)
    txt, pooled = flux_embeds(["a lighthouse on a cliff at dusk"], dev)
    txt_ids = torch.zeros(1, FLUX_N_TXT, 3, device=dev)
    ts, gs = torch.tensor([0.7], device=dev), torch.tensor([3.5], device=dev)
    with torch.no_grad():
        out, _ = counted("forward 2+2", lambda: bf16(tokens, img_ids, txt, txt_ids, ts, pooled, gs),
                         lambda _: (4, 0))
        real_attention = flux_module.joint_attention
        flux_module.joint_attention = attention_reference
        try:
            ref = f32(tokens, img_ids, txt.float(), txt_ids, ts, pooled.float(), gs)
        finally:
            flux_module.joint_attention = real_attention
    errs = [rel_to_range(a, b) for a, b in zip(out, ref)]
    if not all(bool(torch.isfinite(a.float()).all()) for a in out) or max(errs) > MODULE_REL_TOL:
        fail(f"flux forward 2+2: bf16 against fp32, max error / range {errs} (bound "
             f"{MODULE_REL_TOL})")
    phase("flux forward", f"FLUX.1-dev width (3072, 24 heads of 128), 2 double + 2 single "
                          f"blocks, 1024 px batch 1 (4096 image + {FLUX_N_TXT} text tokens): "
                          f"velocity, vec, h1, h2 in bf16 against fp32 on the card "
                          f"{', '.join(f'{e:.3e}' for e in errs)} of their range (bound "
                          f"{MODULE_REL_TOL}); K1 4 launches")
    del f32, bf16, out, ref
    torch.cuda.empty_cache()

    # 2. the full-depth model, its TPM and the VAE
    t0 = time.perf_counter()
    fcfg = FluxConfig.flux_dev()
    flux = flux_backbone(fcfg, dev, seed + 200)
    k1_fwd = flux_k1_a_forward(fcfg)
    config = RLOOConfig(max_inference_steps=FLUX_T_MAX, init_alpha=TPM_HEAD_BIAS[0],
                        init_beta=TPM_HEAD_BIAS[1])
    agent = FluxAgent(flux, config)
    gen = torch.Generator(device=dev).manual_seed(seed + 201)
    tpm = agent.init_tpm_params(gen).eval()
    with torch.device(dev):
        vae = VAE(VAEConfig(**FLUX_VAE_FACTORS)).init_weights(gen, WEIGHT_STD)
    vae = vae.to(torch.bfloat16).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in flux.parameters())
    phase("flux models", f"FLUX.1-dev {n_params / 1e9:.3f} B parameters ({fcfg.depth_double} "
                         f"double + {fcfg.depth_single} single blocks, K1 {k1_fwd} a forward), "
                         f"TPM head bias {TPM_HEAD_BIAS}, VAE {FLUX_VAE_FACTORS} with its "
                         f"encoder, bf16, drawn on the card in {time.perf_counter() - t0:.1f} s; "
                         f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    pipe = FluxPipeline(agent, vae)
    prompts = ["a red fox in fresh snow", "a city street at night in the rain"]

    # 3. generate at batch 1 and 2, each warmed by a one-step rollout at its batch
    results = {}
    for b in (1, 2):
        txt, pooled = flux_embeds(prompts[:b], dev)
        one = dataclasses.replace(agent.sampler_cfg, max_inference_steps=1, predict=True,
                                  cache_activations=False)
        counted(f"warm-up, batch {b}", lambda: agent.sample(
            tpm, {"prompt_embeds": txt, "pooled_prompt_embeds": pooled},
            torch.Generator(device=dev).manual_seed(0), sampler_cfg=one), lambda _: (k1_fwd, 0))
        torch.cuda.reset_peak_memory_stats(dev)
        res, sec = counted(f"request, batch {b}", lambda: pipe.generate(
            txt, pooled, seed=seed + 202 + b, tpm_params=tpm), lambda r: (k1_fwd * r.num_steps, 1))
        check_flux_result(f"request, batch {b}", res, b, 1024)
        results[b] = res
        phase("flux request", f"1024 px, batch {b}, guidance 3.5 embedded: {res.num_steps} steps "
                              f"(sigmas {[round(float(x), 5) for x in res.schedule[0, :res.num_steps]]})"
                              f", {sec:.3f} s ({sec / b:.3f} s an image, "
                              f"{1000 * sec / res.num_steps:.1f} ms a step with the decode); K1 "
                              f"{k1_fwd} a step, K2 1; peak "
                              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; {smi}")

    # 4. the fixed-schedule baseline, 28 Euler steps at batch 1
    txt, pooled = flux_embeds(prompts[:1], dev)
    fixed, sec = counted("fixed", lambda: pipe.generate_fixed(
        txt, pooled, num_steps=FLUX_FIXED_STEPS, seed=seed + 203),
        lambda _: (k1_fwd * FLUX_FIXED_STEPS, 1))
    if fixed.dtype != np.uint8 or fixed.shape != (1, 1024, 1024, 3):
        fail(f"flux fixed: images {fixed.dtype} {fixed.shape}")
    phase("flux fixed", f"generate_fixed, {FLUX_FIXED_STEPS} Euler steps on uniform_flow_sigmas, "
                        f"batch 1: {sec:.3f} s ({1000 * sec / FLUX_FIXED_STEPS:.1f} ms a step "
                        f"with the decode) against the adaptive request's "
                        f"{results[1].num_steps} steps; K1 {k1_fwd} a step, K2 1")

    # 5. image-to-image at FLUX_STRENGTH on the batch-1 image
    i2i, sec = counted("img2img", lambda: pipe.generate(
        txt, pooled, seed=seed + 204, tpm_params=tpm, init_image=results[1].images,
        strength=FLUX_STRENGTH), lambda r: (k1_fwd * r.num_steps, 2))
    check_flux_result("img2img", i2i, 1, 1024, s0=FLUX_STRENGTH)
    phase("flux img2img", f"strength {FLUX_STRENGTH}: {i2i.num_steps} steps from sigma "
                          f"{FLUX_STRENGTH} (sigmas "
                          f"{[round(float(x), 5) for x in i2i.schedule[0, :i2i.num_steps]]}) in "
                          f"{sec:.3f} s (encode + denoise + decode); K1 {k1_fwd} a step, K2 2")

    # 6. the Δ-cache every 2 steps: a reuse step runs the first
    # cache_front_blocks double blocks
    front = fcfg.cache_front_blocks

    def cache_k1(r):
        reuse = cache_reuse_schedule(FLUX_T_MAX, 2)[:r.num_steps]
        return k1_fwd * reuse.count(False) + front * reuse.count(True), 1

    cached, sec = counted("cache_interval 2", lambda: pipe.generate(
        txt, pooled, seed=seed + 203, tpm_params=tpm, cache_interval=2), cache_k1)
    check_flux_result("cache_interval 2", cached, 1, 1024)
    gap = np.abs(cached.images.astype(np.int16) - results[1].images.astype(np.int16)).mean()
    phase("flux cache", f"cache_interval 2: {cached.num_steps} steps in {sec:.3f} s against "
                        f"{results[1].num_steps} uncached; K1 {k1_fwd} a full step, {front} a "
                        f"reuse step; mean |d| against the uncached batch-1 image {gap:.2f} "
                        f"uint8 levels")

    # 7. the continuous engine at 512 px against the fixed-batch runner
    agent512 = FluxAgent(flux, config, latent_size=FLUX_ENGINE_PX // 8)
    with open(REPO / "example" / "prompts.jsonl") as f:
        burst_prompts = [json.loads(line)["prompt"] for line in f if line.strip()]
    family_continuous("flux 512px", counted, agent512, tpm,
                      lambda texts: flux_embeds(texts, dev), make_vae_decoder(vae), k1_fwd,
                      burst_prompts, seed + 2000, smi)
    # phase 22's FLUX part: a fused adapter over the attention projections
    t_lora = time.perf_counter()
    lora.family("flux", agent512, flux, tpm, lambda texts: flux_embeds(texts, dev),
                make_vae_decoder(vae), k1_fwd, burst_prompts, seed + 2240,
                keep=FLUX_LORA_LAYERS)
    t_phase += time.perf_counter() - t_lora  # phase 20's seconds leave phase 22's out
    del agent512

    # 8. the toy world's command line on the card
    for label, argv in (("flux", ["--family", "flux"]),
                        ("flux continuous", ["--family", "flux", "--continuous"])):
        family_cli(label, argv, counted)

    # phase 21's FLUX update on the bf16 backbone: 4 samples at 1024 px
    # (no CFG doubling), before step 9 quantises it in place
    t_rloo = time.perf_counter()

    def collate(rows):
        texts = [r["prompt"] for r in rows]
        txt, pooled = flux_embeds(texts, dev)
        return {"prompt": texts, "prompt_embeds": txt, "pooled_prompt_embeds": pooled}

    train_agent = FluxAgent(flux, family_rloo.config(FLUX_T_MAX))
    family_rloo.update("flux", train_agent, {train_agent: k1_fwd}, vae, collate)
    del train_agent
    t_phase += time.perf_counter() - t_rloo  # phase 20's seconds leave phase 21's out

    # 9. W8A8 in place, then int4 on the backbone drawn again from the seed:
    # one 1024 px forward of each against the bf16 forward, then a request
    rand = lambda *shape: torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    tokens, img_ids = pack_latents(rand(1, 16, 128, 128))
    fwd_in = (tokens, img_ids, txt, torch.zeros(1, FLUX_N_TXT, 3, device=dev),
              torch.tensor([0.7], device=dev), pooled)
    with torch.no_grad():
        v_ref, _ = counted("forward bf16", lambda: agent.flux(*fwd_in)[0].float(),
                           lambda _: (k1_fwd, 0))
    n_w8a8 = fcfg.depth_double * 12 + fcfg.depth_single * 2  # K4: the blocks' matmuls
    n_mod = fcfg.depth_double * 2 + fcfg.depth_single + 1  # the modulations
    gaps, quant_lines = {}, []
    for bits in (8, 4):
        if bits == 4:
            agent.flux = None
            del flux
            gc.collect()
            torch.cuda.empty_cache()
            agent.flux = flux_backbone(fcfg, dev, seed + 200)
        t0 = time.perf_counter()
        qm = flux_quantize_in_place(agent, bits)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        per_fwd = (n_w8a8, n_mod) if bits == 8 else (0, n_w8a8 + n_mod)
        with torch.no_grad():
            v, _ = counted_gemms(f"forward int{bits}", lambda: qm(*fwd_in)[0].float(),
                                 lambda _: (k1_fwd, 0) + per_fwd)
        if not bool(torch.isfinite(v).all()):
            fail(f"flux int{bits}: the forward gave non-finite values")
        gaps[bits] = ((v - v_ref).abs().mean() / v_ref.abs().mean()).item()
        torch.cuda.reset_peak_memory_stats(dev)
        res, sec = counted_gemms(f"request int{bits}", lambda: pipe.generate(
            txt, pooled, seed=seed + 203, tpm_params=tpm),
            lambda r: (k1_fwd * r.num_steps, 1) + tuple(n * r.num_steps for n in per_fwd))
        check_flux_result(f"request int{bits}", res, 1, 1024)
        mode = "W8A8" if bits == 8 else "int4"
        quant_lines.append(
            f"{mode}: weights {module_bytes(qm) / 1e9:.3f} GB, prequantised in {quant_s:.1f} s, "
            f"mean |dv| / mean |v| {gaps[bits]:.4e} (bound {QUANT_REL_BOUND[bits]}); request "
            f"{res.num_steps} steps in {sec:.3f} s ({1000 * sec / res.num_steps:.1f} ms a step "
            f"with the decode), K4 {per_fwd[0]} and K5 {per_fwd[1]} a step, peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        del qm, v
    for bits, gap_q in gaps.items():
        if not gap_q < QUANT_REL_BOUND[bits]:
            fail(f"flux int{bits} forward is {gap_q} from the bf16 one (bound "
                 f"{QUANT_REL_BOUND[bits]})")
    phase("flux quant", f"1024 px batch 1, against the bf16 forward on the same weights (bf16 "
                        f"{n_params * 2 / 1e9:.3f} GB): {'; '.join(quant_lines)}; {smi}")
    del agent, pipe, tpm, vae, v_ref
    gc.collect()
    torch.cuda.empty_cache()
    phase("flux phase", f"{time.perf_counter() - t_phase:.1f} s; K1 {totals[0]}, K2 {totals[1]}, "
                        f"K4 {gemm_totals[0]}, K5 {gemm_totals[1]} launches; {smi}")
    flash_attention.launches = flash_attention_streaming.launches = 0
    return totals[0], totals[1], gemm_totals[0], gemm_totals[1], k1_entries


# phase 22: LoRA adapters on the serving engines and the weight-only
# quantised T5 tower. The adapters' rank and the std of their b factor (a
# fresh b is zero: an identity that would prove nothing), the requests'
# step cap, FLUX's targeted layers (its attention projections: a merged
# copy of every dense weight of the 12 B model would not fit beside it),
# and the bounds: the image seam, and the fused path against the merged
# solo run (tests/test_serving_continuous.py:781-834)
LORA_RANK = 16
LORA_B_STD = 0.02
LORA_CAP = 4
FLUX_LORA_LAYERS = ("_attn_", "linear1")
SEAM_LEVELS, SEAM_SHARE = 1, 0.01
FUSED_MAX_LEVELS, FUSED_MEAN_LEVELS = 24, 3.0


def image_gap(a, b):
    """(largest uint8 gap, mean gap, share of pixels that differ)."""
    d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    return int(d.max()), float(d.mean()), float((d > 0).mean())


def first_place_dependent(module, inputs):
    """The first submodule of ``module``, in the order their forwards
    return, whose output row 0 at the batch ``inputs`` (two rows) differs
    from its row 1 with the two input rows exchanged: where a row's result
    starts to depend on its place in the batch. None if no output does."""
    records, handles, swapped = ([], []), [], [False]

    def hook(name):
        def record(mod, args, out):
            o = out[0] if isinstance(out, (tuple, list)) else out
            if isinstance(o, torch.Tensor) and o.dim() and o.shape[0] == 2:
                records[swapped[0]].append((name, type(mod).__name__, o.detach().clone()))
        return record

    for name, m in module.named_modules():
        if name:
            handles.append(m.register_forward_hook(hook(name)))
    try:
        with torch.no_grad():
            module(*inputs)
            swapped[0] = True
            module(*(x.flip(0) for x in inputs))
    finally:
        for h in handles:
            h.remove()
    for (name, kind, a), (_, _, b) in zip(*records):
        if not torch.equal(a[0], b[1]):
            return f"{name} ({kind})"
    return None


def recorded_generate(pipe, steps):
    """``pipe.generate`` wrapped (on the instance; ``del pipe.generate``
    undoes it) to append each call's loop iterations to ``steps``."""
    real = pipe.generate

    def generate(*a, **kw):
        res = real(*a, **kw)
        steps.append(res.num_steps)
        return res

    pipe.generate = generate


class LoraPhase:
    """Phase 22: LoRA adapters on the serving engines at full width and the
    weight-only quantised T5-XXL tower, run by phases 14-17 (``sd3``, on
    their models before they are freed), 18 (``family``, SD1.5) and 20
    (``family``, FLUX at 512 px, on the bf16 model). Every request is capped
    at LORA_CAP steps; every adapter is rank LORA_RANK with a non-zero b,
    drawn on the card from the seed. K1, K2, K4 and K5 are counted around
    every call and checked exactly."""

    def __init__(self, seed, dev, smi):
        self.seed, self.dev, self.smi = seed, dev, smi
        self.totals = [0, 0, 0, 0]  # K1, K2, K4, K5
        self.seconds = 0.0
        self.parts = []
        self.row_checks = {}  # label: the row check's (levels, mean, share) by place

    def counted(self, label, fn, want):
        """fn() between synchronizes, the four kernels' launch counts set to
        0 just before and read just after, added to the totals and checked
        against ``want(out)``, (K1, K2, K4, K5); returns (out, seconds)."""
        from tpdm_tpu_torch.ops.attention import flash_attention, flash_attention_streaming
        from tpdm_tpu_torch.ops.gemm import bf16_gemm, int8_gemm

        kernels = (flash_attention, flash_attention_streaming, int8_gemm, bf16_gemm)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        got = tuple(k.launches for k in kernels)
        self.totals = [a + b for a, b in zip(self.totals, got)]
        if got != tuple(want(out)):
            fail(f"lora {label}: K1, K2, K4, K5 launches {got}, expected {tuple(want(out))}")
        return out, seconds

    def adapter(self, module, seed, keep=None):
        """A rank-LORA_RANK adapter over ``module``'s dense layers (those
        whose name holds one of ``keep``, or all): init_lora's a from the
        seed, b ~ N(0, LORA_B_STD²)."""
        from tpdm_tpu_torch.models.lora import default_match, init_lora

        g = torch.Generator(device=self.dev).manual_seed(seed)
        match = (None if keep is None else
                 lambda n, m: default_match(n, m) and any(k in n for k in keep))
        lora = init_lora(module, LORA_RANK, g, match=match)
        for f in lora.values():
            f["b"].normal_(0.0, LORA_B_STD, generator=g)
        return lora

    def done(self, label, start):
        seconds = time.perf_counter() - start
        self.seconds += seconds
        self.parts.append(f"{label} {seconds:.1f} s")

    def sd3(self, served):
        """The SD3 part on phase 14's models at 1024 px (items 1-4 of phase
        22 in this file's docstring)."""
        from tpdm_tpu_torch.models.lora import (
            apply_lora,
            call_merged,
            lora_interceptor,
            stack_adapters,
        )
        from tpdm_tpu_torch.ops.quant import DenseMaybeQuant
        from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline
        from tpdm_tpu_torch.serving import BatchingEngine
        from tpdm_tpu_torch.serving_continuous import ContinuousBatchingEngine
        from tpdm_tpu_torch.utils.image import postprocess_images

        start = time.perf_counter()
        pipe, tokenize, prompts, dev = served.pipe, served.tokenize, served.prompts, self.dev
        mmdit = pipe.mmdit
        layers = mmdit.config.num_layers
        la, lb = self.adapter(mmdit, self.seed + 2200), self.adapter(mmdit, self.seed + 2201)
        steps = []  # each generate call's loop iterations

        # 1. BatchingEngine at batch 1: two merged adapters
        text, sd = prompts[0], self.seed + 2210
        fixed = lambda p: BatchingEngine(p, tokenize, max_batch=1, window_ms=1.0, max_steps=35)
        one = lambda eng, lora=None: eng.generate_batch([text], [sd], steps=[LORA_CAP],
                                                        lora=lora)[0]["image"]
        per_call = lambda _: (layers * steps[-1], 1, 0, 0)
        plain, eng = fixed(pipe), fixed(pipe)
        recorded_generate(pipe, steps)
        try:
            want_base, _ = self.counted("plain base", lambda: one(plain), per_call)
            eng.register_adapter("a", la, merged_cache=2)
            eng.register_adapter("b", lb)
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            merged_a, merge_s = self.counted("merge", lambda: eng._params_for("a"),
                                             lambda _: (0, 0, 0, 0))
            grown = torch.cuda.memory_allocated(dev) - before
            merged_bytes = sum(t.nbytes for t in merged_a.values())
            img_a, sec_a = self.counted("adapter a", lambda: one(eng, "a"), per_call)
            img_b, _ = self.counted("adapter b", lambda: one(eng, "b"), per_call)
            again, _ = self.counted("base after adapters", lambda: one(eng), per_call)
            peak = torch.cuda.max_memory_allocated(dev)
            direct, _ = self.counted("manual merge", lambda: call_merged(
                mmdit, apply_lora(mmdit, la), one, plain), per_call)
        finally:
            del pipe.generate
        if not np.array_equal(img_a, direct):
            fail(f"lora fixed: the adapter request differs from the manually merged backbone's "
                 f"by {image_gap(img_a, direct)[:2]} levels")
        if not np.array_equal(again, want_base):
            fail(f"lora fixed: a base request after adapter traffic differs from the adapter-free "
                 f"engine's by {image_gap(again, want_base)[:2]} levels")
        moved = (image_gap(img_a, want_base)[0], image_gap(img_b, want_base)[0])
        if min(moved) <= SEAM_LEVELS or eng.adapter_merges != 2:
            fail(f"lora fixed: the adapters move the image {moved} levels; "
                 f"{eng.adapter_merges} merges")
        phase("lora fixed", f"BatchingEngine(max_batch=1), 1024 px, two rank-{LORA_RANK} adapters "
              f"over all {len(la)} dense layers of the MMDiT, merged_cache 2: a merge "
              f"{1e3 * merge_s:.1f} ms, its copy {merged_bytes / 1e9:.3f} GB ({grown / 1e9:.3f} GB "
              f"allocated), peak {peak / 2**30:.2f} GiB with both; an adapter request "
              f"({LORA_CAP} steps, {sec_a:.3f} s) equal to the bit to an adapter-free engine on "
              f"the manually merged backbone; a base request after adapter traffic equal to the "
              f"bit to the adapter-free engine's; the adapters move the image {moved[0]} and "
              f"{moved[1]} levels at most; adapter_merges {eng.adapter_merges}; {self.smi}")
        del eng, plain, merged_a
        gc.collect()
        torch.cuda.empty_cache()

        # 2-3. a burst of six through the continuous engine: two prompts,
        # each on the base and under a and b
        jobs = [(prompts[k], self.seed + 2220 + k, LORA_CAP, lora)
                for k in (1, 2) for lora in (None, "a", "b")]
        base_of = {i: 3 * (i // 3) for i in range(len(jobs))}
        rows_of = lambda name: [i for i, j in enumerate(jobs) if j[3] == name]
        dtype = pipe._device_dtype()[1]

        def decode1(latents):
            """Final latents decoded a row at a time, as the engine decodes."""
            return [postprocess_images(pipe._decode_impl(
                torch.as_tensor(lat[None]).to(dev, dtype)))[0] for lat in latents]

        def engine(label, p, fused, n_quant=0, bits=8):
            """The burst through a continuous engine with both adapters:
            (engine, results, makespan, a segment's mean ms by CUDA events
            around each ``_segment``, under its adapters)."""
            eng = ContinuousBatchingEngine(p, tokenize, slots=4, seg_steps=LORA_CAP,
                                           max_steps=35, fused_lora=fused)
            eng.register_adapter("a", la, merged_cache=2)
            eng.register_adapter("b", lb, merged_cache=2)
            events, real = [], eng._segment

            def timed(st, live):
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = real(st, live)
                ev[1].record()
                events.append(ev)
                return out

            eng._segment = timed
            gemms = lambda n: (n, 0) if bits == 8 else (0, n)
            (res, span, _), _ = self.counted(label, lambda: burst(eng, jobs), lambda _: (
                layers * LORA_CAP * eng.segments_run, len(jobs),
                *gemms(n_quant * LORA_CAP * eng.segments_run)))
            return eng, res, span, float(np.mean([a.elapsed_time(b) for a, b in events]))

        def references(eng, p, rows, under=None, n_quant=0, bits=8):
            """``rows`` of the burst through BatchingEngine(max_batch=4) on
            ``p`` (no VAE) at the engine's CFG batch 8, given its batch-1
            embed rows, under(fn) running it under an adapter; decoded a row
            at a time."""
            ref = BatchingEngine(p, tokenize, max_batch=4, max_steps=35)
            for text_ in {jobs[i][0] for i in rows}:
                ref._embed_cache[text_] = eng._prompt_embeds(text_)
            ref._neg_embed = eng._neg_rows
            call = lambda: ref.generate_batch([jobs[i][0] for i in rows],
                                              [jobs[i][1] for i in rows],
                                              steps=[LORA_CAP] * len(rows))
            gemms = lambda n: (n, 0) if bits == 8 else (0, n)
            recorded_generate(p, steps)
            try:
                out, _ = self.counted(f"reference {rows}", lambda: (under or (lambda f: f()))(call),
                                      lambda _: (layers * steps[-1], 0,
                                                 *gemms(n_quant * steps[-1])))
            finally:
                del p.generate
            images, _ = self.counted("reference decode", lambda: decode1(
                [o["image"] for o in out]), lambda _: (0, len(rows), 0, 0))
            return dict(zip(rows, images))

        raw = TPDMPipeline(mmdit, pipe.tpm, None, text_encoders=pipe.text_encoders)
        t0 = time.perf_counter()
        mux, res_m, span_m, seg_m = engine("multiplexed", pipe, fused=False)
        st = mux.stats()
        want = references(mux, raw, rows_of(None))
        for name, lora in (("a", la), ("b", lb)):
            merged = apply_lora(mmdit, lora)
            want.update(references(mux, raw, rows_of(name),
                                   under=lambda f, m=merged: call_merged(mmdit, m, f)))
            del merged
        unequal = [i for i, r in enumerate(res_m) if not np.array_equal(r["image"], want[i])]
        if unequal:
            fail(f"lora multiplexed: requests {unequal} differ from their merged solo runs by "
                 f"{[image_gap(res_m[i]['image'], want[i])[:2] for i in unequal]} levels")
        moves = [image_gap(res_m[i]["image"], res_m[base_of[i]]["image"])[0]
                 for i in rows_of("a") + rows_of("b")]
        if min(moves) <= SEAM_LEVELS:
            fail(f"lora multiplexed: the adapters move their images {moves} levels from the base")
        phase("lora multiplexed", f"ContinuousBatchingEngine(slots=4, seg_steps={LORA_CAP}), "
              f"1024 px, {len(jobs)} requests (two prompts, each on the base, a and b): makespan "
              f"{span_m:.3f} s, {seg_m:.1f} ms a segment (CUDA events), slot_utilization "
              f"{st['slot_utilization']:.4f}, segments_run {st['segments_run']}, "
              f"adapter_segments {st['adapter_segments']}, adapter_merges "
              f"{st['adapter_merges']}; every request equal to the bit to its merged solo run "
              f"(BatchingEngine(max_batch=4) at the same CFG batch 8 on the manually merged "
              f"backbone, decoded a row at a time), the adapter requests {moves} levels from "
              f"their prompt's base image; {time.perf_counter() - t0:.1f} s; {self.smi}")
        del mux

        merged_gap = {}  # adapter request -> the bf16 fused path's gap to its merged solo run

        def check_fused(label, eng, res, span, seg_ms, base_ref, adapter_ref, extra=""):
            """Base rows within the seam of ``base_ref``, adapter rows within
            the fused bound of ``adapter_ref`` and further from their
            prompt's base image than the bf16 fused-merged gap."""
            st, cells = eng.stats(), []
            for i, (r, j) in enumerate(zip(res, jobs)):
                if j[3] is None:
                    level, _, share = image_gap(r["image"], base_ref[i])
                    if level > SEAM_LEVELS or share >= SEAM_SHARE:
                        fail(f"lora {label}: base request {i} is {level} levels from its solo "
                             f"run on {share:.4f} of the pixels")
                    continue
                level, mean, _ = image_gap(r["image"], adapter_ref[i])
                if level > FUSED_MAX_LEVELS or mean >= FUSED_MEAN_LEVELS:
                    fail(f"lora {label}: adapter request {i} is {level} levels (mean "
                         f"{mean:.3f}) from its reference")
                merged_gap.setdefault(i, level)
                moved = image_gap(r["image"], base_ref[base_of[i]])[0]
                if moved <= max(merged_gap[i], SEAM_LEVELS):
                    fail(f"lora {label}: adapter request {i} moves its image {moved} levels from "
                         f"the base, not more than the fused-merged gap {merged_gap[i]}")
                cells.append(f"{level} / {mean:.3f} / {moved}")
            if st["adapter_merges"] != 0 or st["lora_mode"] != "fused":
                fail(f"lora {label}: stats {st}")
            phase(f"lora {label}", f"the burst: makespan {span:.3f} s, {seg_ms:.1f} ms a segment "
                  f"(CUDA events), slot_utilization "
                  f"{st['slot_utilization']:.4f}, segments_run {st['segments_run']}, "
                  f"adapter_segments {st['adapter_segments']}, adapter_merges 0; base requests "
                  f"within {SEAM_LEVELS} level of their solo run on under {SEAM_SHARE} of the "
                  f"pixels; each adapter request's largest / mean gap to its reference and "
                  f"largest move from its prompt's base image, in levels: {', '.join(cells)} "
                  f"(bounds {FUSED_MAX_LEVELS} / {FUSED_MEAN_LEVELS}; the move above the bf16 "
                  f"fused-merged gap){extra}; {self.smi}")

        t0 = time.perf_counter()
        eng, res_f, span_f, seg_f = engine("fused bf16", pipe, fused=True)
        check_fused("fused bf16", eng, res_f, span_f, seg_f, want, want,
                    f"; against the multiplexed makespan {span_m:.3f} s and {seg_m:.1f} ms a "
                    f"segment ({seg_f / seg_m:.3f} x); {time.perf_counter() - t0:.1f} s")
        del eng
        adapters = rows_of("a") + rows_of("b")
        bank = stack_adapters({"a": (la, 1.0), "b": (lb, 1.0)})[0]
        ids = torch.tensor([1 if jobs[i][3] == "a" else 2 for i in adapters], device=dev)
        for bits in (8, 4):
            t0 = time.perf_counter()
            qm = quantized_copy(mmdit, bits, dev)
            quant_s = time.perf_counter() - t0
            n_quant = sum(isinstance(m, DenseMaybeQuant) for m in qm.modules())
            qpipe = TPDMPipeline(qm, pipe.tpm, pipe.vae, text_encoders=pipe.text_encoders)
            qraw = TPDMPipeline(qm, pipe.tpm, None, text_encoders=pipe.text_encoders)
            mode = "W8A8" if bits == 8 else "int4"
            eng, res_q, span_q, seg_q = engine(f"fused {mode}", qpipe, True, n_quant, bits)
            qbase = references(eng, qraw, rows_of(None), n_quant=n_quant, bits=bits)

            def fused_fixed(f, qm=qm):
                with lora_interceptor(qm, bank, torch.cat([ids, ids])):
                    return f()

            qtuned = references(eng, qraw, adapters, fused_fixed, n_quant, bits)
            check_fused(f"fused {mode}", eng, res_q, span_q, seg_q, qbase, qtuned,
                        f"; adapter requests against the same rows through BatchingEngine("
                        f"max_batch=4) under the interceptor (nothing float to merge into); "
                        f"{module_bytes(qm) / 1e9:.3f} GB of weights prequantised in "
                        f"{quant_s:.1f} s, K{4 if bits == 8 else 5} {n_quant} a forward; "
                        f"{time.perf_counter() - t0:.1f} s")
            del eng, qm, qpipe, qraw
            gc.collect()
            torch.cuda.empty_cache()
        self.done("SD3", start)
        self.quant_text(served)

    def quant_text(self, served):
        """Phase 14's T5-XXL tower at weight-only int8, then int4, on the
        example prompts' ids against the bf16 tower: relative error, encode
        ms, bytes and K5 launches (7 a block)."""
        from tpdm_tpu_torch.models.t5 import T5Encoder
        from tpdm_tpu_torch.ops.quant import prequantize_

        start = time.perf_counter()
        t5 = served.towers["T5-XXL"]
        ids = torch.as_tensor(np.concatenate([served.tokenize(p)[1] for p in served.prompts]),
                              device=self.dev).long()
        with torch.no_grad():
            ref, _ = self.counted("T5 bf16", lambda: t5(ids), lambda _: (0, 0, 0, 0))
            bf16_ms = median_ms(lambda: t5(ids), reps=5)
        cells = []
        for bits in (8, 4):
            with torch.device("meta"):
                qt5 = T5Encoder(dataclasses.replace(t5.config, quant_matmuls=True,
                                                    quant_bits=bits))
            qt5.load_state_dict(t5.state_dict(), assign=True)
            prequantize_(qt5.eval())
            n = 7 * t5.config.num_layers
            with torch.no_grad():
                out, _ = self.counted(f"T5 int{bits}", lambda: qt5(ids), lambda _: (0, 0, 0, n))
                ms = median_ms(lambda: qt5(ids), reps=5)
            if not bool(torch.isfinite(out.float()).all()):
                fail(f"lora quant_text int{bits}: non-finite embeds")
            err = (out.float() - ref.float()).abs()
            rel_max = (err.max() / ref.float().abs().max()).item()
            rel_mean = (err.mean() / ref.float().abs().mean()).item()
            dense = sum(t.nbytes for name, t in qt5.state_dict().items()
                        if name.startswith("block.") and "relative" not in name
                        and "ln_" not in name)
            cells.append(f"int{bits}: max |d| / max |bf16| {rel_max:.4e}, mean |d| / mean |bf16| "
                         f"{rel_mean:.4e}, encode {ms:.3f} ms, block matmul weights and scales "
                         f"{dense / 1e9:.3f} GB, K5 {n} an encode")
            del qt5, out
            torch.cuda.empty_cache()
        t5_dense = sum(p.nbytes for name, p in t5.named_parameters()
                       if name.startswith("block.") and p.dim() == 2 and "relative" not in name)
        phase("lora quant_text", f"T5-XXL ({t5.config.num_layers} blocks of d {t5.config.d_model}, "
              f"ff {t5.config.d_ff}) on the {ids.shape[0]} example prompts x {ids.shape[1]} ids, "
              f"weight-only, against the bf16 tower ({bf16_ms:.3f} ms, block matmul weights "
              f"{t5_dense / 1e9:.3f} GB): {'; '.join(cells)}; no bound (the CPU parity holds the "
              f"tower to JAX's); {self.smi}")
        self.done("quant_text", start)

    def family(self, label, agent, backbone, tpm, encode, decode, k1_fwd, prompts, seed,
               keep=None):
        """A base and an adapter request (one prompt and seed) through the
        family's continuous engine, fused (2 slots, one segment): the base
        within the seam of the runner at the engine's batch with each request
        in its slot's row, the adapter within the fused bound of the same
        runner on the merged backbone and further from the base than that
        gap; steps (and SD1.5's integer schedule) equal. Then the row check,
        reported against the seam bound: the engine's base row against the
        same request in the runner's other row (both rows of the base call
        hold it) and alone through BatchingEngine(max_batch=1) over the
        runner; and, for a UNet, the first op whose output row depends on
        its place in a batch of two (``first_place_dependent``)."""
        from tpdm_tpu_torch.models.lora import apply_lora, call_merged
        from tpdm_tpu_torch.serving import BatchingEngine
        from tpdm_tpu_torch.serving_continuous import ContinuousFluxEngine, ContinuousSD15Engine
        from tpdm_tpu_torch.serving_families import make_flux_runner, make_sd15_runner

        start = time.perf_counter()
        flux = label == "flux"
        lora = self.adapter(backbone, seed, keep)
        cls = ContinuousFluxEngine if flux else ContinuousSD15Engine
        eng = cls(agent, encode, decode=decode, tpm_params=tpm, slots=2, seg_steps=LORA_CAP,
                  fused_lora=True)
        eng.register_adapter("a", lora)
        slot_of, assign = {}, eng._assign
        eng._assign = lambda slot, req: slot_of.__setitem__(req.lora, slot) or assign(slot, req)
        jobs = [(prompts[0], seed, LORA_CAP, None), (prompts[0], seed, LORA_CAP, "a")]
        (res, span, _), _ = self.counted(f"{label} fused", lambda: burst(eng, jobs), lambda _: (
            k1_fwd * LORA_CAP * eng.segments_run, len(jobs), 0, 0))
        st = eng.stats()

        def rows_encode(texts):
            rows = [eng._prompt_embeds(t) for t in texts]
            if flux:
                return torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows])
            return torch.stack([r[0] for r in rows]), eng._neg_pe.expand(len(texts), -1, -1)

        rows_decode = lambda z: np.concatenate([decode(z[i:i + 1]) for i in range(z.shape[0])])
        runner = (make_flux_runner if flux else make_sd15_runner)(agent, tpm, rows_encode,
                                                                  rows_decode)
        order = sorted(jobs, key=lambda j: slot_of[j[3]])  # each request at its slot's row
        call = lambda: runner([j[0] for j in order], [j[1] for j in order], [LORA_CAP] * 2)
        outs, restore = recorded_samples(agent)
        per_call = lambda rows: lambda _: (k1_fwd * outs[-1][1].num_steps, rows, 0, 0)
        try:
            ref_base, _ = self.counted(f"{label} reference", call, per_call(2))
            merged = apply_lora(backbone, lora)
            ref_tuned, _ = self.counted(f"{label} merged reference",
                                        lambda: call_merged(backbone, merged, call), per_call(2))
            del merged
            solo_engine = BatchingEngine(None, lambda p, _n=None: (None, None), max_batch=1,
                                         window_ms=1.0, max_steps=eng.max_steps, runner=runner)
            solo, _ = self.counted(f"{label} batch 1", lambda: solo_engine.generate_batch(
                [jobs[0][0]], [jobs[0][1]], steps=[LORA_CAP])[0], per_call(1))
        finally:
            restore()
        base, tuned = res
        want_base, want_tuned = ref_base[slot_of[None]], ref_tuned[slot_of["a"]]
        level_b, _, share_b = image_gap(base["image"], want_base["image"])
        level, mean, _ = image_gap(tuned["image"], want_tuned["image"])
        moved = image_gap(tuned["image"], base["image"])[0]
        schedule = lambda r: r["sigmas"] if flux else [int(v) for v in r["sigmas"]]
        if (schedule(base) != schedule(want_base) or schedule(tuned) != schedule(want_tuned)
                or tuned["inference_steps"] != want_tuned["inference_steps"]):
            fail(f"lora {label}: schedules {base['sigmas']} / {tuned['sigmas']} against the "
                 f"runner's {want_base['sigmas']} / {want_tuned['sigmas']}")
        if level_b > SEAM_LEVELS or share_b >= SEAM_SHARE:
            fail(f"lora {label}: the base request is {level_b} levels from the runner's row on "
                 f"{share_b:.4f} of the pixels")
        if level > FUSED_MAX_LEVELS or mean >= FUSED_MEAN_LEVELS or moved <= max(level, 1):
            fail(f"lora {label}: the adapter request is {level} levels (mean {mean:.3f}) from the "
                 f"merged runner's and moves the image {moved} levels")
        other = ref_base[1 - slot_of[None]]["image"]  # the same request at the other row
        rows = {"in the other row": image_gap(base["image"], other),
                "alone at batch 1": image_gap(base["image"], solo["image"])}
        row_check = "; ".join(
            f"{where}: {lv} levels, mean {mn:.4f}, on {sh:.4f} of the pixels ("
            f"{'within' if lv <= SEAM_LEVELS and sh < SEAM_SHARE else 'misses'} the seam)"
            for where, (lv, mn, sh) in rows.items())
        if not flux:
            g = torch.Generator(device=self.dev).manual_seed(seed)
            ucfg = backbone.config
            inputs = (torch.randn(2, ucfg.in_channels, ucfg.sample_size, ucfg.sample_size,
                                  generator=g, device=self.dev).to(torch.bfloat16),
                      torch.tensor([999.0, 500.0], device=self.dev),
                      rows_encode(prompts[:2])[0])
            op, _ = self.counted(f"{label} row places", lambda: first_place_dependent(
                backbone, inputs), lambda _: (2 * k1_fwd, 0, 0, 0))
            row_check += (f"; the first op whose output row depends on its place in a UNet "
                          f"forward at batch 2: {op or 'none'}")
        self.row_checks[label] = rows
        phase(f"lora {label}", f"{cls.__name__}(slots=2, seg_steps={LORA_CAP}, fused_lora=True), "
              f"a rank-{LORA_RANK} adapter over {len(lora)} dense layers: a base and an adapter "
              f"request, makespan {span:.3f} s, slot_utilization {st['slot_utilization']:.4f}, "
              f"segments_run {st['segments_run']}; against the runner at the engine's batch with "
              f"each request at its slot's row: base {level_b} levels on {share_b:.4f} of the "
              f"pixels, adapter {level} / mean {mean:.3f} levels from the merged runner's "
              f"(bounds {FUSED_MAX_LEVELS} / {FUSED_MEAN_LEVELS}), moving the image {moved} "
              f"levels from the base; schedules equal; row check, the engine's base row against "
              f"the same request {row_check} (seam: {SEAM_LEVELS} level on under {SEAM_SHARE} "
              f"of the pixels); {self.smi}")
        level_o, _, share_o = rows["in the other row"]
        if not flux and (level_o > SEAM_LEVELS or share_o >= SEAM_SHARE):
            fail(f"lora {label}: the same request in the other row of its batch is {level_o} "
                 f"levels away on {share_o:.4f} of the pixels (seam {SEAM_LEVELS} on under "
                 f"{SEAM_SHARE})")
        del eng, runner, solo_engine
        gc.collect()
        torch.cuda.empty_cache()
        self.done(label, start)

    def summary(self):
        if len(self.parts) != 4:
            fail(f"lora: {len(self.parts)} of the 4 parts ran")
        phase("lora phase", f"{'; '.join(self.parts)}; {self.seconds:.1f} s in all; K1 "
              f"{self.totals[0]}, K2 {self.totals[1]}, K4 {self.totals[2]}, K5 "
              f"{self.totals[3]} launches; {self.smi}")


def lora_only(seed, dev, smi):
    """``--lora-only``: phase 22 alone, on its models built as phases 14,
    18 and 20 build them (no kernels line)."""
    from tpdm_tpu_torch.models.flux import FluxConfig
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig
    from tpdm_tpu_torch.serving_families import make_vae_decoder
    from tpdm_tpu_torch.train import RLOOConfig
    from tpdm_tpu_torch.train.flux_agent import FluxAgent

    lora = LoraPhase(seed, dev, smi)
    served = serve_models(seed, dev)
    lora.sd3(served)
    del served
    gc.collect()
    torch.cuda.empty_cache()
    m = sd15_models(seed, dev)
    lora.family("sd15", m.agent, m.unet, m.tpm, m.encode, make_vae_decoder(m.vae),
                unet_k1_a_forward(m.unet.config), m.prompts, seed + 2230)
    del m
    gc.collect()
    torch.cuda.empty_cache()
    fcfg = FluxConfig.flux_dev()
    flux = flux_backbone(fcfg, dev, seed + 200)
    config = RLOOConfig(max_inference_steps=FLUX_T_MAX, init_alpha=TPM_HEAD_BIAS[0],
                        init_beta=TPM_HEAD_BIAS[1])
    gen = torch.Generator(device=dev).manual_seed(seed + 201)
    tpm = FluxAgent(flux, config).init_tpm_params(gen).eval()
    with torch.device(dev):
        vae = VAE(VAEConfig(**FLUX_VAE_FACTORS)).init_weights(gen, WEIGHT_STD)
    vae = vae.to(torch.bfloat16).eval()
    with open(REPO / "example" / "prompts.jsonl") as f:
        prompts = [json.loads(line)["prompt"] for line in f if line.strip()]
    lora.family("flux", FluxAgent(flux, config, latent_size=FLUX_ENGINE_PX // 8), flux, tpm,
                lambda texts: flux_embeds(texts, dev), make_vae_decoder(vae),
                flux_k1_a_forward(fcfg), prompts, seed + 2240, keep=FLUX_LORA_LAYERS)
    lora.summary()


# ---------------------------------------------------------------------------
# Phase 23: LoRA training through the SD3 backbone
# ---------------------------------------------------------------------------

LORA_TRAIN_LR = 1e-4
LORA_TRAIN_RANK = 4
DRAFT_PROMPTS = 1  # DRaFT's batch: one prompt, CFG batch 2
DPO_PAIRS = 2  # DPO's batch: two pairs, [w; l] batch 4 without CFG
DISTILL_BATCH = 2
GRAD_COS_BOUND = 0.99
GRAD_CHECK_STEPS = 2  # the gradient check's ladder: one step without grad, one with


def kernel_counts():
    """The launch counts of K1's forward, K1's backward and K2."""
    from tpdm_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_backward,
        flash_attention_streaming,
    )

    return (flash_attention, flash_attention_backward, flash_attention_streaming)


def plain_attention_grads(q, k, v, do, kv_len, rows=1120):
    """(dq, dk, dv) by autograd through attention_reference in fp32, over
    blocks of ``rows`` query rows (dk and dv summed over them)."""
    from tpdm_tpu_torch.ops.attention import attention_reference

    dq, dk, dv = [], 0.0, 0.0
    for i in range(0, q.shape[2], rows):
        leaves = [q[:, :, i:i + rows].float().requires_grad_(), k.float().requires_grad_(),
                  v.float().requires_grad_()]
        g = torch.autograd.grad(attention_reference(*leaves, kv_len), leaves,
                                do[:, :, i:i + rows].float())
        dq.append(g[0])
        dk, dv = dk + g[1], dv + g[2]
    return torch.cat(dq, dim=2), dk, dv


def k1_backward_check(g, dev, label, b, h, n, d, kv_len, timed=True):
    """K1's backward at q = k = v (b, h, n, d) bf16 and a random dO, drawn
    from ``g``: flash_attention under autograd against the blocked plain
    gradients in fp32 (each of dQ, dK, dV within KERNEL_REL_TOL of its max
    |plain|; dK = dV = 0 at kv rows >= kv_len). With ``timed`` (d 64): the
    backward alone (flash_attention_backward on the forward's o and row
    statistics), the plain gradients, and SDPA's backward (its forward and
    backward on the valid kv rows, less its forward), CUDA events, median
    of 10 (the plain one of 3). Returns (kernels-line entry or None,
    max abs error)."""
    from tpdm_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_backward,
        flash_attention_with_stats,
    )
    from torch.nn.functional import scaled_dot_product_attention

    q, k, v, do = (torch.randn(b, h, n, d, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention_backward.launches
    flash_attention(*leaves, kv_len).backward(do)
    torch.cuda.synchronize()
    if flash_attention_backward.launches != before + 1:
        fail(f"K1 backward {label}: {flash_attention_backward.launches - before} launches for "
             "one backward")
    plain = plain_attention_grads(q, k, v, do, kv_len)
    errs = []
    for name, leaf, ref in zip(("dQ", "dK", "dV"), leaves, plain):
        got = leaf.grad.float()
        err, top = (got - ref).abs().max().item(), ref.abs().max().item()
        if not (bool(torch.isfinite(got).all()) and err <= KERNEL_REL_TOL * top):
            fail(f"K1 backward {label}: {name} max abs err {err}, max |plain| {top} (bound "
                 f"{KERNEL_REL_TOL} of it)")
        errs.append((name, err, err / top))
    if kv_len is not None and (leaves[1].grad[:, :, kv_len:].any()
                               or leaves[2].grad[:, :, kv_len:].any()):
        fail(f"K1 backward {label}: dK or dV is not zero at kv rows >= kv_len {kv_len}")
    text = ", ".join(f"{name} {err:.3e} ({share:.3e} of max |plain|)" for name, err, share in errs)
    max_err = max(e for _, e, _ in errs)
    n_valid = n if kv_len is None else kv_len
    if not timed:
        phase("K1 backward", f"{label} ({b}, {h}, {n}, {d}), kv_len {kv_len}, bf16 (padded to "
                             f"64 columns): {text} (bound {KERNEL_REL_TOL} of each); dK = dV = 0 "
                             f"past kv_len; {b * h} x one backward launch")
        return None, max_err
    o, m, l = flash_attention_with_stats(q, k, v, kv_len)
    lse = m + torch.log2(l)
    ms = median_ms(lambda: flash_attention_backward(q, k, v, o, do, lse, kv_len))
    plain_ms = median_ms(lambda: plain_attention_grads(q, k, v, do, kv_len), reps=3, warmup=1)
    lib = [t[:, :, :n_valid].contiguous().requires_grad_() if i else t.clone().requires_grad_()
           for i, t in enumerate((q, k, v))]
    with torch.no_grad():
        lib_fwd_ms = median_ms(lambda: scaled_dot_product_attention(*lib))
    lib_ms = median_ms(lambda: torch.autograd.grad(scaled_dot_product_attention(*lib), lib,
                                                   do)) - lib_fwd_ms
    flop = 2.5 * 4 * b * h * n * n_valid * d
    nbytes = 2 * b * h * d * (4 * n + 4 * n_valid) + 8 * b * h * n  # 5 reads, 3 writes, lse, D
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    bound, by = 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    phase("K1 backward", f"{label} ({b}, {h}, {n}, {d}), kv_len {kv_len}, bf16: {text} (bound "
                         f"{KERNEL_REL_TOL} of each); dK = dV = 0 past kv_len; backward "
                         f"{ms:.3f} ms (two kernels and D = rowsum(dO o O)), "
                         f"{flop / ms / 1e9:.1f} TFLOP/s at 2.5 x the forward's operations, "
                         f"{100 * bound / ms:.1f} % of bound {bound:.3f} ms ({by}); plain "
                         f"{plain_ms:.3f} ms (autograd through the fp32 plain version, 1120-row "
                         f"query blocks); scaled_dot_product_attention's backward {lib_ms:.3f} "
                         f"ms (forward and backward {lib_ms + lib_fwd_ms:.3f} less forward "
                         f"{lib_fwd_ms:.3f})")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms), max_err


def k2_backward_check(g, dev):
    """K2's chunked backward at the 1024 px decode's (1, 1, 16384, 512) on
    K2's output, against autograd through the dense plain version in fp32:
    each of dQ, dK, dV within KERNEL_REL_TOL of its max |plain|."""
    from tpdm_tpu_torch.ops.attention import (
        attention_backward_chunked,
        attention_reference,
        flash_attention_streaming,
        streaming_block_kv,
    )

    q, k, v, do = (torch.randn(1, 1, 16384, 512, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    with torch.no_grad():
        o = flash_attention_streaming(q, k, v)
    chunk = streaming_block_kv(512, 2)
    got = attention_backward_chunked(q, k, v, o, do, None, chunk)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    plain = torch.autograd.grad(attention_reference(*leaves), leaves, do.float())
    torch.cuda.synchronize()
    errs = []
    for name, a, ref in zip(("dQ", "dK", "dV"), got, plain):
        err, top = (a.float() - ref).abs().max().item(), ref.abs().max().item()
        if not (bool(torch.isfinite(a.float()).all()) and err <= KERNEL_REL_TOL * top):
            fail(f"K2 backward: {name} max abs err {err}, max |plain| {top}")
        errs.append(f"{name} {err:.3e} ({err / top:.3e} of max |plain|)")
    ms = median_ms(lambda: attention_backward_chunked(q, k, v, o, do, None, chunk), reps=3)
    phase("K2 backward", f"(1, 1, 16384, 512) bf16, attention_backward_chunked over {chunk}-row "
                         f"kv chunks (plain tensor code) against autograd through the dense "
                         f"fp32 plain version: {', '.join(errs)} (bound {KERNEL_REL_TOL} of "
                         f"each); {ms:.3f} ms (CUDA events, median of 3)")


def lora_agent(config, device="cuda", seed=0, guidance=True, remat=False):
    """The LoRA trainers' agent YAML builder: a TPDMAgent over phase 13's
    shared SD3-medium MMDiT (bf16), at the config's guidance scale or
    without CFG, its blocks rematerialised or not."""
    from tpdm_tpu_torch.train import TPDMAgent

    mmdit = _cli_models(seed, torch.device(device))[0]
    mmdit.remat = remat
    if not guidance:
        config = dataclasses.replace(config, guidance_scale=None)
    return TPDMAgent(mmdit, config)


def lora_reward(device="cuda", seed=0):
    """The DRaFT reward YAML's builder: ImageReward through score_grad on
    the decode under autograd (build_image_reward_grad_fn) over phase 13's
    VAE decoder, ImageReward and tokenizer."""
    from tpdm_tpu_torch.train.builders import build_image_reward_grad_fn

    _, vae, reward_model, tokenizer = _cli_models(seed, torch.device(device))
    return build_image_reward_grad_fn(vae, reward_model, tokenizer, device=device)


class LoraRecorder:
    """A trainer callback closing each update: its metrics, seconds since
    the last (synchronized), peak memory, and the launches of K1's forward,
    K1's backward and K2 (the counters zeroed at ``start`` and after every
    update)."""

    def __init__(self, dev):
        self.dev, self.rows, self.lora = dev, [], None

    def start(self):
        torch.cuda.synchronize()
        for fn in kernel_counts():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.t = time.perf_counter()

    def on_step_end(self, trainer, update, metrics, lora):
        torch.cuda.synchronize()
        self.rows.append(dict(update=update, metrics=metrics,
                              seconds=time.perf_counter() - self.t,
                              launches=tuple(fn.launches for fn in kernel_counts()),
                              peak_gib=torch.cuda.max_memory_allocated(self.dev) / 2**30))
        self.lora = lora
        self.start()


def base_checksum(module):
    """Per parameter, the sum and the sum of squares of its bits as
    integers: a checksum that any change of a weight moves."""
    sums = []
    for p in module.parameters():
        bits = p.detach().view(torch.int16 if p.element_size() == 2 else torch.int32).long()
        sums.append((int(bits.sum()), int((bits * bits).sum())))
    return sums


def check_lora_moved(label, lora, lr, updates, unreached):
    """Every b factor moved from zero, by at most ADAM_STEP_FACTOR x lr x
    updates, except those of the layers in ``unreached``, which no loss
    reaches and which must stay zero; returns the smallest and the largest
    move."""
    moves = {k: f["b"].detach().abs().max().item() for k, f in lora.items()}
    still = sorted(k for k, m in moves.items() if m == 0)
    reached = [m for k, m in moves.items() if k not in unreached]
    if still != sorted(unreached) or max(reached) > ADAM_STEP_FACTOR * lr * updates:
        fail(f"{label}: b factors moved by {min(reached):.3e}..{max(reached):.3e}, expected at "
             f"most {ADAM_STEP_FACTOR} x lr x {updates} updates; unmoved {still}, expected "
             f"{sorted(unreached)}")
    return min(reached), max(reached)


def print_lora_update(label, row, keys, want):
    """One LoraRecorder row, checked: finite metrics, nothing skipped, the
    launches ``want`` (K1 forward, K1 backward, K2)."""
    m = row["metrics"]
    phase(label, ", ".join(f"{k} {m[k]:.6g}" for k in keys)
          + f"; {row['seconds']:.3f} s; peak memory {row['peak_gib']:.2f} GiB; K1 forward "
          f"{row['launches'][0]}, K1 backward {row['launches'][1]}, K2 {row['launches'][2]} "
          f"launches (expected {want})")
    if not all(math.isfinite(v) for v in m.values()):
        fail(f"{label}: non-finite metrics {m}")
    skipped = [v for k, v in m.items() if k.endswith("num_skipped")]
    if skipped != [0.0]:
        fail(f"{label}: skipped {skipped}")
    if row["launches"] != want:
        fail(f"{label}: launches {row['launches']}, expected {want}")


def lora_train_phase(seed, dev, smi, lora_phase=None):
    """Phase 23 (item 23 of this file's docstring); with ``lora_phase``
    (phase 22's LoraPhase, after its SD1.5 part) its SD1.5 row check is
    reported. Returns (K1 forward, K1 backward, K2 launches of the training
    runs, the kernels line's entry for K1's backward)."""
    from tpdm_tpu_torch.models import mmdit as mmdit_module, vae as vae_module
    from tpdm_tpu_torch.models.lora import init_lora
    from tpdm_tpu_torch.ops.attention import attention_reference
    from tpdm_tpu_torch.train import RLOOConfig, TPDMAgent
    from tpdm_tpu_torch.train.builders import build_image_reward_grad_fn
    from tpdm_tpu_torch.train.distill import DistillConfig, DistillTrainer
    from tpdm_tpu_torch.train.draft import (
        DraftConfig,
        DraftTrainer,
        trainable_lora,
        value_and_grad,
    )
    from tpdm_tpu_torch.train.main import main as train_main

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    t_phase = time.perf_counter()
    totals = [0, 0, 0]  # K1 forward, K1 backward, K2

    # 1-2. the backwards against their plain versions
    g = torch.Generator(device=dev).manual_seed(seed + 230)
    entries = {}
    for label, b in (("DRaFT's CFG batch", 2), ("DPO's [w; l]", 4)):
        entries[b], _ = k1_backward_check(g, dev, label, b, 24, 4480, 64, 4429)
        gc.collect()
        torch.cuda.empty_cache()
    _, padded_err = k1_backward_check(g, dev, "the toy MMDiT's head dim", 2, 4, 128, 16, 69,
                                      timed=False)
    k2_backward_check(g, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # 3. DRaFT and DPO through the command line, two updates each
    mmdit, vae, reward_model, tokenizer = _cli_models(seed, dev)
    layers = mmdit.config.num_layers
    checksum = base_checksum(mmdit)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "reward.yaml").write_text(f"_target_: chip_smoke.lora_reward\nseed: {seed}\n")
        (tmp / "collator.yaml").write_text(f"_target_: chip_smoke.cli_collator\nseed: {seed}\n")
        for trainer_name, guidance, dataset, batch in (
                ("draft", True, "jsonl_prompts.yaml", DRAFT_PROMPTS),
                ("dpo", False, "sd3_preference_pairs.yaml", DPO_PAIRS)):
            agent_yaml = tmp / f"{trainer_name}_agent.yaml"
            agent_yaml.write_text(f"_target_: chip_smoke.lora_agent\n_partial_: true\nseed: "
                                  f"{seed}\nguidance: {str(guidance).lower()}\nremat: false\n")
            argv = ["--trainer", trainer_name, "--model_config", str(agent_yaml),
                    "--train_dataset", str(REPO / "configs" / "torch" / "datasets" / dataset),
                    "--data_collator", str(tmp / "collator.yaml"),
                    "--per_device_train_batch_size", str(batch), "--draft_updates", "2",
                    "--learning_rate", str(LORA_TRAIN_LR), "--lora_rank", str(LORA_TRAIN_RANK),
                    "--max_inference_steps", str(T_MAX), "--k_backprop", "1",
                    "--guidance_scale", "7.0", "--dpo_beta", "500",
                    "--seed", str(seed), "--output_dir", str(tmp / trainer_name)]
            if trainer_name == "draft":
                argv += ["--reward_model_config", str(tmp / "reward.yaml")]
            recorder = LoraRecorder(dev)
            recorder.start()
            with contextlib.chdir(REPO):  # the prompt dataset names example/prompts.jsonl
                trainer = train_main(argv, callbacks=[recorder])
            runs[trainer_name] = (trainer, recorder)
            gc.collect()
            torch.cuda.empty_cache()
    draft_rows, dpo_rows = runs["draft"][1].rows, runs["dpo"][1].rows
    want_draft = (layers * T_MAX, layers, 1)  # 27 steps without grad, one with; one decode
    want_dpo = (2 * layers, layers, 0)  # the reference and the policy forward
    for i, row in enumerate(draft_rows):
        print_lora_update(f"draft update {i + 1}", row, ("draft/reward", "draft/loss",
                                                        "draft/grad_norm", "draft/num_skipped"),
                          want_draft)
    for i, row in enumerate(dpo_rows):
        print_lora_update(f"dpo update {i + 1}", row, (
            "dpo/loss", "dpo/margin", "dpo/implicit_acc", "dpo/err_w", "dpo/err_l",
            "dpo/grad_norm", "dpo/num_skipped"), want_dpo)
    # the last block's text queries give outputs that it drops (no
    # to_add_out): its add_q_proj takes no gradient
    unreached = {f"transformer_blocks.{layers - 1}.attn.add_q_proj"}
    moved = {name: check_lora_moved(name, rec.lora, LORA_TRAIN_LR, 2, unreached)
             for name, (_, rec) in runs.items()}
    for row in draft_rows + dpo_rows:
        totals = [a + b for a, b in zip(totals, row["launches"])]
    if base_checksum(mmdit) != checksum:
        fail("lora training changed a base weight of the MMDiT")
    phase("lora cli", f"python -m tpdm_tpu_torch.train.main --trainer draft (batch "
                      f"{DRAFT_PROMPTS}, CFG 7.0, {T_MAX} steps, K = 1, ImageReward through "
                      f"score_grad on the 1024 px decode under autograd) and --trainer dpo "
                      f"({DPO_PAIRS} pairs of SyntheticPreferencePairs(channels=16, size=128), no "
                      f"CFG, beta 500), rank {LORA_TRAIN_RANK}, lr {LORA_TRAIN_LR}, remat off: "
                      f"warm update {draft_rows[1]['seconds']:.3f} s / "
                      f"{dpo_rows[1]['seconds']:.3f} s, peak memory "
                      f"{max(r['peak_gib'] for r in draft_rows):.2f} / "
                      f"{max(r['peak_gib'] for r in dpo_rows):.2f} GiB; every b factor but "
                      f"{sorted(unreached)[0]}'s (no gradient reaches it: zero) moved "
                      f"{moved['draft'][0]:.3e}..{moved['draft'][1]:.3e} / "
                      f"{moved['dpo'][0]:.3e}..{moved['dpo'][1]:.3e} (bound "
                      f"{ADAM_STEP_FACTOR} x lr x 2); the MMDiT's {len(checksum)} base tensors "
                      f"unchanged to the bit; {smi}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the gradient check: one DRaFT loss's LoRA gradient with the kernels
    # (bf16) against the plain versions in fp32 and in bf16, remat on for the
    # plain runs (their fp32 scores would take 3.85 GB a layer)
    import copy

    gen = torch.Generator(device=dev).manual_seed(seed + 231)
    lora0 = init_lora(mmdit, LORA_TRAIN_RANK, gen)
    for f in lora0.values():
        f["b"] = 1e-3 * torch.randn(f["b"].shape, generator=gen, device=dev)
    latents = torch.randn((1, 16, 128, 128), generator=gen, device=dev)
    with open(REPO / "example" / "prompts.jsonl") as fh:
        prompt = json.loads(fh.readline())["prompt"]
    batch = cli_collator(seed=seed)([{"prompt": prompt}])
    cfg = DraftConfig(num_steps=GRAD_CHECK_STEPS, k_backprop=1, lora_rank=LORA_TRAIN_RANK)
    config = RLOOConfig(max_inference_steps=T_MAX, guidance_scale=7.0)

    def draft_grad(model, vae_m, plain):
        model.remat = plain
        agent = TPDMAgent(model, config)
        reward = build_image_reward_grad_fn(vae_m, reward_model, tokenizer, device=dev)
        trainer = DraftTrainer(cfg, agent, reward, [])
        lora = trainable_lora(lora0)
        patched = [(mmdit_module, "joint_attention"), (vae_module, "joint_attention")]
        saved = [getattr(mod, name) for mod, name in patched]
        if plain:
            for mod, name in patched:
                setattr(mod, name, attention_reference)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            start = time.perf_counter()
            loss, _, grads, _, finite = value_and_grad(
                lambda: trainer._loss(lora, latents.to(agent.dtype), batch), lora)
            torch.cuda.synchronize()
        finally:
            for (mod, name), fn in zip(patched, saved):
                setattr(mod, name, fn)
            model.remat = False
        if not finite:
            fail(f"draft gradient check: a non-finite loss or gradient (plain versions: {plain})")
        flat = torch.cat([gr.float().flatten() for gr in grads])
        return flat, loss.item(), time.perf_counter() - start, \
            torch.cuda.max_memory_allocated(dev) / 2**30

    kern, loss_k, s_k, peak_k = draft_grad(mmdit, vae, False)
    plain16, loss_16, s_16, _ = draft_grad(mmdit, vae, True)
    f32, vae32 = copy.deepcopy(mmdit).float(), copy.deepcopy(vae).float()
    plain32, loss_32, s_32, peak_32 = draft_grad(f32, vae32, True)
    del f32, vae32
    gc.collect()
    torch.cuda.empty_cache()
    cos = lambda a, b: torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    gap = lambda a, b: abs(a.norm().item() - b.norm().item()) / b.norm().item()
    cos_k, cos_16 = cos(kern, plain32), cos(plain16, plain32)
    bound = min(GRAD_COS_BOUND, cos_16)
    phase("lora gradient", f"one DRaFT loss ({GRAD_CHECK_STEPS} steps, K = 1, CFG 7.0, the "
                           f"1024 px decode and ImageReward) over rank-{LORA_TRAIN_RANK} factors "
                           f"(b ~ N(0, 1e-6)), {kern.numel()} gradient entries: the kernels (bf16) "
                           f"against the plain versions in fp32: cosine {cos_k:.6f}, norm gap "
                           f"{gap(kern, plain32):.3e}; a plain bf16 run against the same: cosine "
                           f"{cos_16:.6f}, norm gap {gap(plain16, plain32):.3e}; bound {bound:.6f}"
                           f" (the smaller of {GRAD_COS_BOUND} and the plain bf16 run's); losses "
                           f"{loss_k:.6f} / {loss_16:.6f} / {loss_32:.6f}; {s_k:.2f} / {s_16:.2f}"
                           f" / {s_32:.2f} s, peak {peak_k:.2f} / {peak_32:.2f} GiB (kernels / "
                           f"fp32 with remat)")
    if not cos_k >= bound:
        fail(f"draft gradient check: cosine {cos_k} with the kernels, under the bound {bound}")

    # 5. one DistillTrainer update at batch 2 (CFG 7.0, the 28-step ladder)
    recorder = LoraRecorder(dev)
    agent = TPDMAgent(mmdit, config)
    dcfg = DistillConfig(total_updates=1, batch_size=DISTILL_BATCH, learning_rate=LORA_TRAIN_LR,
                         lora_rank=LORA_TRAIN_RANK, num_ladder_steps=T_MAX, seed=seed)
    with open(REPO / "example" / "prompts.jsonl") as fh:
        rows = [{"prompt": json.loads(line)["prompt"]} for line in fh if line.strip()]
    distill = DistillTrainer(dcfg, agent, rows, collate_fn=cli_collator(seed=seed),
                             callbacks=[recorder])
    recorder.start()
    lora, ema, _ = distill.train()
    print_lora_update("distill update 1", recorder.rows[0], (
        "distill/loss", "distill/mse", "distill/grad_norm", "distill/num_skipped"),
        (3 * layers, layers, 0))
    ema_move = max(f["b"].abs().max().item() for f in ema.values())
    if not ema_move > 0:
        fail("distill: the EMA target did not move")
    totals = [a + b for a, b in zip(totals, recorder.rows[0]["launches"])]
    if base_checksum(mmdit) != checksum:
        fail("distillation changed a base weight of the MMDiT")
    phase("distill", f"DistillTrainer, batch {DISTILL_BATCH}, ladder {T_MAX}, skip 1, EMA "
                     f"{dcfg.ema_decay}: the EMA target's b moved by up to {ema_move:.3e}; base "
                     f"weights unchanged")
    del lora, ema, distill
    gc.collect()
    torch.cuda.empty_cache()
    # 6. phase 22's SD1.5 row check (it fails there beyond the seam)
    rows = (lora_phase.row_checks.get("sd15") if lora_phase is not None else None) or {}
    phase("lora row check", "SD1.5, each convolution a row at a time: " + (
        "; ".join(f"the same request {where}: {lv} levels, mean {mn:.4f}, on {sh:.4f} of the "
                  f"pixels" for where, (lv, mn, sh) in rows.items())
        or "not run (phase 22 did not run)") + f" (seam {SEAM_LEVELS} level on under {SEAM_SHARE})")
    phase("lora train phase", f"{time.perf_counter() - t_phase:.1f} s; K1 forward {totals[0]}, "
                              f"K1 backward {totals[1]}, K2 {totals[2]} launches; K1's backward "
                              f"on the padded head dim max abs err {padded_err:.3e}; {smi}")
    entry = dict(entries[2])
    entry["shapes"] = {"(2, 24, 4480, 64)": entries[2], "(4, 24, 4480, 64)": entries[4]}
    return totals, entry


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq-parallel-only", action="store_true",
                    help="run only the device, build and sequence-parallel phases")
    ap.add_argument("--lora-only", action="store_true",
                    help="run only the device, build and LoRA / quant_text phases")
    ap.add_argument("--lora-train-only", action="store_true",
                    help="run only the device, build and LoRA training phases")
    args = ap.parse_args()

    # 1. the device
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on a CUDA card")
    if not (REPO / "tpdm_tpu_torch").is_dir():
        fail(f"tpdm_tpu_torch not found beside {Path(__file__).name}: run from the repository")
    sys.path.insert(0, str(REPO))
    global median_ms  # the phases time with the port's CUDA-event median
    from tpdm_tpu_torch.experiments._common import median_ms
    from tpdm_tpu_torch.ops import _build

    # fp32 products in the comparisons below run in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    world = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}, {world} device(s)")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    phase("build", f"{lib_path.name} ready in {time.perf_counter() - t0:.2f} s")
    wgmma_phase(lib_path)

    if args.seq_parallel_only:
        seq_parallel_phase(args.seed, world)
    elif args.lora_only:
        lora_only(args.seed, dev, smi)
    elif args.lora_train_only:
        lora_train_phase(args.seed, dev, smi)
    else:
        g = torch.Generator(device=dev).manual_seed(args.seed)
        kernels = kernel_phase(g, dev, args.seed)  # 3
        kernels.update(gemm_phase(g, dev))
        sd35_kernels = sd35_kernel_phase(args.seed, dev)
        reference_phase(args.seed, dev)  # 4
        k1_total, k2_total, modules, adaptive = slice_1024_phase(args.seed, dev)  # 5
        k4_total, k5_total = quant_phase(args.seed, dev, modules)  # 6
        kernels["K3"] = k3_phase(g, dev, world)  # 7
        merge_phase(g, dev)  # 8
        k3_total = seq_parallel_phase(args.seed, world)  # 9
        studies = studies_phase(g, dev)  # 10
        k1_train, k2_train = rloo_phase(args.seed, dev)  # 11
        k1_fixed, k2_fixed = fixed_phase(args.seed, dev, adaptive)  # 12
        k1_cli, k2_cli = cli_phase(args.seed, dev)  # 13
        lora = LoraPhase(args.seed, dev, smi)  # 22, run by phases 14-20
        (k1_serve, k2_serve), served = serve_phase(args.seed, dev, smi)  # 14
        k1_cont, k2_cont = continuous_phase(args.seed, dev, served)  # 15
        k1_i2i, k2_i2i = img2img_phase(args.seed, dev, served, smi)  # 17
        lora.sd3(served)  # 22's SD3 part and quant_text, on phase 14's models
        del served
        gc.collect()
        torch.cuda.empty_cache()
        k1_sd35, k2_sd35, k4_sd35 = sd35_phase(args.seed, dev)  # 16
        for name, entries in sd35_kernels.items():
            kernels[name].update(entries)
        gc.collect()
        torch.cuda.empty_cache()
        family_rloo = FamilyRLOO(args.seed, dev, smi)  # 21, run by phases 18-20
        k1_sd15, k2_sd15, sd15_k1 = sd15_phase(args.seed, dev, smi, family_rloo, lora)  # 18
        kernels["K1"].update(sd15_k1)
        k1_sdxl, k2_sdxl, sdxl_k1 = sdxl_phase(args.seed, dev, smi, family_rloo)  # 19
        kernels["K1"].update(sdxl_k1)
        k1_flux, k2_flux, k4_flux, k5_flux, flux_k1 = flux_phase(args.seed, dev, smi,
                                                                 family_rloo, lora)  # 20
        kernels["K1"].update(flux_k1)
        family_rloo.summary()
        k1_frl, k2_frl = family_rloo.totals
        del family_rloo
        lora.summary()
        k1_lora, k2_lora, k4_lora, k5_lora = lora.totals
        gc.collect()
        torch.cuda.empty_cache()
        (k1_lt, k1_bwd, k2_lt), k1_bwd_entry = lora_train_phase(args.seed, dev, smi, lora)  # 23

        k2_src = "tpdm_tpu_torch/csrc/attn_d512_sm90.cu"
        k1_src = "tpdm_tpu_torch/csrc/attn_sm90.cu"
        gemm_src = "tpdm_tpu_torch/csrc/gemm_sm90.cu"
        studies_src = "tpdm_tpu_torch/csrc/attn_studies_sm90.cu"
        sites = lambda script, lines: "; ".join(f"experiments/{script}.py:{n}" for n in lines)
        print(json.dumps({"kernels": [
            {"name": "flash_attention (K1)", "route": "cuda", "source": k1_src,
             "replaces": "tpdm_tpu/ops/attention.py:58",
             "launches": (k1_total + k1_train + k1_fixed + k1_cli + k1_serve + k1_cont + k1_sd35
                          + k1_i2i + k1_sd15 + k1_sdxl + k1_flux + k1_frl + k1_lora + k1_lt),
             **kernels["K1"]},
            {"name": "flash_attention_backward (K1's backward)", "route": "cuda",
             "source": "tpdm_tpu_torch/csrc/attn_bwd_sm90.cu",
             "replaces": "tpdm_tpu/ops/attention.py:449 (_bwd, JAX's dense recompute VJP of "
                         "K1: no Pallas kernel)",
             "launches": k1_bwd, **k1_bwd_entry},
            {"name": "flash_attention_streaming (K2)", "route": "cuda", "source": k2_src,
             "replaces": "tpdm_tpu/ops/attention.py:193",
             "launches": (k2_total + k2_train + k2_fixed + k2_cli + k2_serve + k2_cont + k2_sd35
                          + k2_i2i + k2_sd15 + k2_sdxl + k2_flux + k2_frl + k2_lora + k2_lt),
             **kernels["K2"]},
            {"name": "flash_attention_with_stats (K3)", "route": "cuda", "source": k1_src,
             "replaces": "tpdm_tpu/ops/attention.py:123", "launches": k3_total,
             **kernels["K3"]},
            {"name": "int8_gemm (K4)", "route": "cuda", "source": gemm_src,
             "replaces": "experiments/attn_round3.py:301",
             "launches": k4_total + k4_sd35 + k4_flux + k4_lora,
             **kernels["K4"]},
            {"name": "bf16_gemm (K5)", "route": "cuda", "source": gemm_src,
             "replaces": "experiments/attn_round3.py:266",
             "launches": k5_total + k5_flux + k5_lora,
             **kernels["K5"]},
            {"name": "attention_strided (K6)", "route": "cuda", "source": studies_src,
             "replaces": "; ".join([
                 sites("attn_variants", (36, 54, 190)), sites("attn_overlap", (64,)),
                 sites("attn_layout", (35,)), sites("attn_nocopy", (56, 103)),
                 sites("attn_round3", (39,)), sites("attn_round3b", (33,)),
                 sites("attn_natural_operands", (42,)), sites("attn_round4", (44, 61)),
                 sites("attn_block_layout", (40,)), sites("attn_transpose_cost", (32,)),
                 sites("attn_kernel_floor", (38, 55))]),
             **studies["K6"]},
            {"name": "attention_maxfree (K7)", "route": "cuda", "source": studies_src,
             "replaces": f"{sites('attn_variants', (86,))}; {sites('attn_round3b', (63,))}",
             **studies["K7"]},
            {"name": "attention_int8qk (K8)", "route": "cuda", "source": studies_src,
             "replaces": sites("attn_round3", (117, 195)), **studies["K8"]},
            {"name": "attention_probe (K9)", "route": "cuda", "source": studies_src,
             "replaces": f"{sites('attn_overlap', (97, 109))}; {sites('attn_layout', (59,))}",
             **studies["K9"]},
        ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
