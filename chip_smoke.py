#!/usr/bin/env python3
"""Drive the PyTorch port (tpdm_tpu_torch) once on the visible CUDA cards (one is enough).

Run from the repository root on a machine with sm_90a (Hopper) cards:

    python3 chip_smoke.py [--seed N] [--seq-parallel-only]

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
   2, the RLOO rollout's 8 and replay's 4, and the conditional-only batch
   1 of a guidance window), K2 (at the
   1024 px decode's (1, 1, 16384, 512), (2, 1, 16384, 512) and the RLOO
   reward's (4, 1, 16384, 512), at 2048 px's
   (1, 1, 65536, 512) against the plain version in 4096-row query blocks,
   every 64-column block of O held on its own, and with strongly negative
   scores), and the
   GEMMs K4 (int8, bit for bit on its int32 accumulator) and K5 (bf16) at
   every matmul shape of the batch 1 and batch 2 requests, beside
   torch._int_mm and cuBLAS's bf16 product; K1's, K4's and K5's TFLOP/s
   (TOP/s) and share of their bound;
4. a reference check: a 2-layer MMDiT (float, W8A8 and int4) and a VAE
   decoder with a 512-wide mid block, on the card in bf16 through the
   kernels, against the same weights run in fp32 on the CPU through the
   plain versions;
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
   on the card against fp32 on the CPU.

It then prints a JSON line of the kernels' results and, last, one JSON
object naming the device. There is no CPU path: without a CUDA card it
exits with an error and prints no result. ``--seq-parallel-only`` runs
phases 1, 2 and 9 alone (for a machine with several cards) and prints no
kernels line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import math
import os
import re
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
# the wgmma kernels' instantiations, each by a piece of its mangled name
# (template arguments between I and E: Lb0 / Lb1 kStats off / on; 'a'
# int8_t, then the epilogue: Li0 bf16 rounding, Li1 dequant, Li2 int32;
# K2's kernel is not a template: E closes its name)
WGMMA_KERNELS = (
    ("K1", "flash_attn_sm90_kernelILb0E"),
    ("K2", "flash_attn_d512_kernelE"),
    ("K3", "flash_attn_sm90_kernelILb1E"),
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
    # conditional-only forward outside a guidance window (phase 12). They
    # draw from a generator of their own, so every later phase keeps its
    # inputs; the plain version runs over 1120-row query blocks (its fp32
    # scores would take 15 GB at batch 8)
    k1_train = {}
    g_k1 = torch.Generator(device=dev).manual_seed(seed + 8)
    for b in (8, 4, 1):
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
    # K2 at the decode's shapes: 1024 px at batch 1 (the kernels line), 2
    # and 4 (the RLOO reward's decode), and 2048 px, where the plain version
    # runs over 4096-row query blocks (its fp32 scores would take 17 GB).
    # All but the first draw from a generator of their own, so every later
    # phase keeps the inputs that it had before they were added
    k2 = {}
    g_k2 = torch.Generator(device=dev).manual_seed(seed + 7)
    for b, n in ((1, 16384), (2, 16384), (1, N_VAE_2048), (4, 16384)):
        gen = g if (b, n) == (1, 16384) else g_k2
        q, k, v = (torch.randn(b, 1, n, 512, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        plain = attention_reference if n == 16384 else blocked_reference
        out, ref = flash_attention_streaming(q, k, v), plain(q, k, v)
        torch.cuda.synchronize()
        err = output_error(f"K2 ({b}, 1, {n}, 512)", out, ref)
        block = block_error(f"K2 ({b}, 1, {n}, 512)", out, ref)
        del out, ref
        reps = 10 if n == 16384 else 3
        ms = median_ms(lambda: flash_attention_streaming(q, k, v))
        plain_ms = median_ms(lambda: plain(q, k, v), reps=reps)
        lib_ms = median_ms(lambda: scaled_dot_product_attention(q, k, v), reps=reps)
        bound, by = attention_bound(b, n, n, 512)
        phase("K2", f"({b}, 1, {n}, 512) bf16: {fmt_err(err)}; worst 64-column block "
                    f"{block:.3e} of its max |o| (bound {KERNEL_REL_TOL}); kernel {ms:.3f} ms, "
                    f"{4 * b * n * n * 512 / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.1f} % of "
                    f"bound; plain {plain_ms:.3f} ms"
                    f"{'' if n == 16384 else ' (4096-row query blocks)'}, "
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
                   batch_8=k1_train[8], batch_4=k1_train[4], batch_1=k1_train[1]),
        "K2": dict(**k2[(1, 16384)], batch_2=k2[(2, 16384)], at_2048px=k2[(1, N_VAE_2048)],
                   batch_4=k2[(4, 16384)]),
    }


def gemm_phase(g, dev):
    """Phase 3, the GEMMs: K4 (both epilogues) and K5 against their plain
    versions at every quantised matmul shape of the 1024 px path, with
    their times, bounds and PyTorch's own products on the same operands
    (torch._int_mm and torch.matmul in bf16, both on b_t.t())."""
    from tpdm_tpu_torch.ops.gemm import (
        bf16_gemm,
        bf16_gemm_reference,
        int8_gemm,
        int8_gemm_reference,
    )

    res = {}
    k4_err = k5_err = 0.0
    for m, k, n in GEMM_SHAPES:
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        b_t = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        acc, acc_ref = int8_gemm(a, b_t), int8_gemm_reference(a, b_t)
        lib_acc = torch._int_mm(a, b_t.t())
        torch.cuda.synchronize()
        if not torch.equal(acc, acc_ref):
            fail(f"K4 int32 ({m}, {k}) x ({n}, {k}) is not bit-identical to its plain version: "
                 f"{int((acc != acc_ref).sum())} elements differ")
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
        k4_err = max(k4_err, gap.max().item())
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device=dev) * WEIGHT_STD).to(torch.bfloat16)
        k5 = output_error(f"K5 ({m}, {k}) x ({n}, {k})", bf16_gemm(x, w), bf16_gemm_reference(x, w))
        k5_err = max(k5_err, k5[0])
        times = dict(
            k4=median_ms(lambda: int8_gemm(a, b_t, x_scale, w_scale, bias)),
            k4_plain=median_ms(lambda: int8_gemm_reference(a, b_t, x_scale, w_scale, bias)),
            k4_lib=median_ms(lambda: torch._int_mm(a, b_t.t())),
            k5=median_ms(lambda: bf16_gemm(x, w)),
            k5_plain=median_ms(lambda: bf16_gemm_reference(x, w)),
            k5_lib=median_ms(lambda: torch.matmul(x, w.t())),
        )
        k4_bound = gemm_bound(m, k, n, 1, 2, PEAK_INT8_OPS, extra_bytes=4 * m + 6 * n)
        k5_bound = gemm_bound(m, k, n, 2, 2, PEAK_BF16_FLOPS)
        phase("K4/K5", f"({m}, {k}) x ({n}, {k}): K4 int32 bit-identical (torch._int_mm "
              f"{'equal' if torch.equal(lib_acc, acc_ref) else 'DIFFERS'}), dequant max abs err "
              f"{gap.max().item():.3e} (bound one bf16 step), {times['k4']:.4f} ms, plain "
              f"{times['k4_plain']:.4f} ms, torch._int_mm {times['k4_lib']:.4f} ms, bound "
              f"{k4_bound[0]:.4f} ms ({k4_bound[1]}), {2 * m * n * k / times['k4'] / 1e9:.1f} "
              f"TOP/s, {100 * k4_bound[0] / times['k4']:.1f} % of bound; K5 {fmt_err(k5)}, {times['k5']:.4f} ms, plain {times['k5_plain']:.4f} ms, "
              f"torch.matmul {times['k5_lib']:.4f} ms, bound {k5_bound[0]:.4f} ms "
              f"({k5_bound[1]}), {2 * m * n * k / times['k5'] / 1e9:.1f} TFLOP/s, "
              f"{100 * k5_bound[0] / times['k5']:.1f} % of bound")
        if (m, k, n) == TIMED_GEMM:
            res["K4"] = dict(ms=times["k4"], plain_ms=times["k4_plain"], bound_ms=k4_bound[0],
                             bound_by=k4_bound[1], library_ms=times["k4_lib"])
            res["K5"] = dict(ms=times["k5"], plain_ms=times["k5_plain"], bound_ms=k5_bound[0],
                             bound_by=k5_bound[1], library_ms=times["k5_lib"])
        del a, b_t, acc, acc_ref, lib_acc, out, ref, gap, x, w
    res["K4"]["max_abs_err"] = k4_err
    res["K5"]["max_abs_err"] = k5_err
    torch.cuda.empty_cache()
    return res


def reference_phase(seed, dev):
    """Phase 4: card (bf16, kernels) vs CPU (fp32, plain versions)."""
    from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig
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
    v_cpu = VAE(vcfg_small).init_weights(cpu_gen, WEIGHT_STD).to(torch.bfloat16).float()
    v_card = VAE(vcfg_small).to(dev)
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
    if not max(mmdit_err, vae_err, *quant_errs.values()) < MODULE_REL_TOL:
        fail("the card's modules disagree with their CPU fp32 reference")


def build_models(dev, seed, mmdit_config):
    """Full-width SD3-medium MMDiT, TPM and SD3 VAE decoder in bf16 with
    N(0, WEIGHT_STD²) weights from ``seed``, on ``dev``."""
    from tpdm_tpu_torch.models.mmdit import MMDiT
    from tpdm_tpu_torch.models.tpm import TimePredictor
    from tpdm_tpu_torch.models.vae import VAE, VAEConfig

    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        mmdit = MMDiT(mmdit_config)
        tpm = TimePredictor(conv_out_channels=128, in_channels=3072, temb_dim=1536,
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
    """Timers around the agent's rollout and the reward, and a trainer
    callback that closes each update: its metrics, seconds (rollout, reward
    and PPO, each ended by a synchronize), peak memory and the K1/K2
    launches counted since the previous update. Keeps the last rollout and
    its batch."""

    def __init__(self, agent, reward_fn, dev):
        from tpdm_tpu_torch.ops.attention import flash_attention, flash_attention_streaming

        self.dev, self.rows, self.last = dev, [], None
        self.counters = (flash_attention, flash_attention_streaming)
        self.seen = [0, 0]
        self.sample, self.reward = agent.sample, reward_fn
        agent.sample = self._sample
        self.reward_fn = self._reward

    def _sample(self, tpm, batch, generator, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.t0 = time.perf_counter()
        out = self.sample(tpm, batch, generator, **kw)
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.last = (batch, out)
        return out

    def _reward(self, prompts, outputs):
        scores, last = self.reward(prompts, outputs)
        torch.cuda.synchronize()
        self.t2 = time.perf_counter()
        return scores, last

    def on_step_end(self, trainer, update, metrics, eval_state):
        torch.cuda.synchronize()
        now = [fn.launches for fn in self.counters]
        k1, k2 = (n - s for n, s in zip(now, self.seen))
        self.seen = now
        self.rows.append(dict(
            update=update, metrics=metrics, steps=self.last[1].num_steps, k1=k1, k2=k2,
            rollout_s=self.t1 - self.t0, reward_s=self.t2 - self.t1,
            ppo_s=time.perf_counter() - self.t2,
            peak_gib=torch.cuda.max_memory_allocated(self.dev) / 2**30))


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
        recorder = UpdateRecorder(agent, build_image_reward_fn(vae, reward_model, tokenizer),
                                  dev)
        trainer = RLOOTrainer(config, agent, recorder.reward_fn,
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
        keys = ("policy/steps_avg", "objective/scores", "objective/kl", "loss/policy_avg",
                "policy/grad_norm_avg", "policy/approxkl_avg", "val/ratio", "val/num_skipped")
        for row in recorder.rows:
            m = row["metrics"]
            phase(f"rloo update {row['update']}", ", ".join(f"{k} {m[k]:.6g}" for k in keys)
                  + f"; rollout {row['steps']} steps {row['rollout_s']:.3f} s, reward (decode + "
                  f"score) {row['reward_s']:.3f} s, PPO {row['ppo_s']:.3f} s, total "
                  f"{row['rollout_s'] + row['reward_s'] + row['ppo_s']:.3f} s; peak memory "
                  f"{row['peak_gib']:.2f} GiB; K1 launches {row['k1']}, K2 launches {row['k2']}")
            if not all(math.isfinite(v) for v in m.values()):
                fail(f"update {row['update']} has non-finite metrics: {m}")
            if m["val/num_skipped"] != 0:
                fail(f"update {row['update']} skipped a PPO step")
            if row["k1"] != mmdit.config.num_layers * row["steps"] or row["k2"] != 1:
                fail(f"update {row['update']}: K1 {row['k1']}, K2 {row['k2']} launches for "
                     f"{row['steps']} rollout steps and one decode")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq-parallel-only", action="store_true",
                    help="run only the device, build and sequence-parallel phases")
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
    else:
        g = torch.Generator(device=dev).manual_seed(args.seed)
        kernels = kernel_phase(g, dev, args.seed)  # 3
        kernels.update(gemm_phase(g, dev))
        reference_phase(args.seed, dev)  # 4
        k1_total, k2_total, modules, adaptive = slice_1024_phase(args.seed, dev)  # 5
        k4_total, k5_total = quant_phase(args.seed, dev, modules)  # 6
        kernels["K3"] = k3_phase(g, dev, world)  # 7
        merge_phase(g, dev)  # 8
        k3_total = seq_parallel_phase(args.seed, world)  # 9
        studies = studies_phase(g, dev)  # 10
        k1_train, k2_train = rloo_phase(args.seed, dev)  # 11
        k1_fixed, k2_fixed = fixed_phase(args.seed, dev, adaptive)  # 12

        k2_src = "tpdm_tpu_torch/csrc/attn_d512_sm90.cu"
        k1_src = "tpdm_tpu_torch/csrc/attn_sm90.cu"
        gemm_src = "tpdm_tpu_torch/csrc/gemm_sm90.cu"
        studies_src = "tpdm_tpu_torch/csrc/attn_studies_sm90.cu"
        sites = lambda script, lines: "; ".join(f"experiments/{script}.py:{n}" for n in lines)
        print(json.dumps({"kernels": [
            {"name": "flash_attention (K1)", "route": "cuda", "source": k1_src,
             "replaces": "tpdm_tpu/ops/attention.py:58",
             "launches": k1_total + k1_train + k1_fixed,
             **kernels["K1"]},
            {"name": "flash_attention_streaming (K2)", "route": "cuda", "source": k2_src,
             "replaces": "tpdm_tpu/ops/attention.py:193",
             "launches": k2_total + k2_train + k2_fixed,
             **kernels["K2"]},
            {"name": "flash_attention_with_stats (K3)", "route": "cuda", "source": k1_src,
             "replaces": "tpdm_tpu/ops/attention.py:123", "launches": k3_total,
             **kernels["K3"]},
            {"name": "int8_gemm (K4)", "route": "cuda", "source": gemm_src,
             "replaces": "experiments/attn_round3.py:301", "launches": k4_total,
             **kernels["K4"]},
            {"name": "bf16_gemm (K5)", "route": "cuda", "source": gemm_src,
             "replaces": "experiments/attn_round3.py:266", "launches": k5_total,
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
