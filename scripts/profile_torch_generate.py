#!/usr/bin/env python3
"""Where the time of a tpdm_tpu_torch request goes on the card.

Builds chip_smoke.py's full-width SD3-medium models (random weights from
the seed), answers one warm-up request, then profiles one more request
with torch.profiler on every rank and prints, for rank 0, the device time
by kernel group, the launches, the device's idle share between its first
and last kernel, and the request's wall time (with the profiler on).

    python3 scripts/profile_torch_generate.py --px 1024 [--batch 1] [--quant 8|4]
    python3 scripts/profile_torch_generate.py --px 1024 --model sd35_large [--quant 8]
    python3 scripts/profile_torch_generate.py --px 2048

At 2048 px the MMDiT is sequence-parallel over one process per visible
card (a ring of 1 on a single card); at 1024 px it runs unsharded on
cuda:0, ``--model`` picks SD3-medium (the default), SD3.5-medium or
SD3.5-large at full width, and ``--quant`` prequantises it (W8A8 int8 on
K4, or int4 weight-only on K5). Between the warm-up and the profiled request one more
request runs with the profiler off, for its wall time. ``--out FILE`` also
writes every rank's table as JSON.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    N_CTX,
    T_MAX,
    build_models,
    from_rank0,
    quantized_copy,
    seq_parallel_rank,
)

# kernel-name patterns, first match wins
GROUPS = (
    ("K3 flash_attn_sm90_kernel<true>", r"flash_attn_sm90_kernel<true"),
    ("K1 flash_attn_sm90_kernel<false>", r"flash_attn_sm90_kernel"),
    ("K2 flash_attn_d512_kernel", r"flash_attn_d512_kernel"),
    ("K5 gemm_sm90_kernel<bf16>", r"gemm_sm90_kernel<__nv_bfloat16"),
    ("K4 gemm_sm90_kernel<int8>", r"gemm_sm90_kernel<"),
    ("NCCL", r"nccl"),
    ("GEMM (cuBLAS)", r"gemm|nvjet|xmma|cutlass|Kernel2"),
    ("convolution (cuDNN)", r"conv|cudnn|implicit|winograd|fft"),
    ("LayerNorm / GroupNorm", r"layer_norm|group_norm|LayerNorm|GroupNorm|welford"),
    ("cat", r"[Cc]at"),
    ("copies and casts", r"copy|Memcpy|memcpy|to_copy"),
    ("reductions", r"reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def group_of(name: str) -> str:
    for label, pattern in GROUPS:
        if re.search(pattern, name):
            return label
    return "other"


def device_table(prof, device_index: int):
    """``summarise`` over the profiler's device events on one card."""
    return summarise([(ev.name, ev.time_range.start, ev.time_range.end) for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA
                      and ev.device_index == device_index])


def summarise(events):
    """(rows by group: (ms, launches), device busy ms, idle share, window
    ms) from device events (name, start us, end us)."""
    rows, spans = {}, []
    for name, t0, t1 in events:
        if t1 <= t0:
            continue
        spans.append((t0, t1))
        label = group_of(name)
        ms, n = rows.get(label, (0.0, 0))
        rows[label] = (ms + (t1 - t0) / 1e3, n + 1)
    if not spans:
        raise SystemExit("the profiler recorded no device time: nothing to report")
    spans.sort()
    busy, cur0, cur1 = 0.0, *spans[0]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    window = spans[-1][1] - spans[0][0]
    return rows, busy / 1e3, 1.0 - busy / window, window / 1e3


def _rank(rank, world, store, args, out_dir):
    from torch.profiler import ProfilerActivity, profile

    import torch.distributed as dist

    from tpdm_tpu_torch.models.mmdit import MMDiTConfig
    from tpdm_tpu_torch.pipeline.pipeline import TPDMPipeline

    group = None
    if args.px > 1024:
        group, models = seq_parallel_rank(rank, world, store, args.seed)
        dev = group.device
    else:
        dev = torch.device("cuda", rank)
        models = build_models(dev, args.seed, getattr(MMDiTConfig, args.model)())
        if args.quant:
            models = (quantized_copy(models[0], args.quant, dev), *models[1:])
            torch.cuda.empty_cache()
    pipe = TPDMPipeline(*models)
    eg = torch.Generator(device=dev).manual_seed(args.seed + 1)
    b = args.batch
    emb = lambda *shape: torch.randn(shape, generator=eg, device=dev, dtype=torch.bfloat16)
    embeds = (emb(b, N_CTX, 4096), emb(b, 2048), emb(b, N_CTX, 4096), emb(b, 2048))
    if group is not None:
        from_rank0(group, embeds)

    def request():
        return pipe.generate(*embeds, max_inference_steps=T_MAX, guidance_scale=7.0,
                             predict=True, seed=args.seed + 1, height=args.px, width=args.px)

    request()  # warm-up: cuBLAS and cuDNN pick their kernels for these shapes
    torch.cuda.synchronize()
    start = time.perf_counter()
    request()
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - start
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        res = request()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    rows, busy_ms, idle, window_ms = device_table(prof, rank)
    report = dict(rank=rank, world=world, px=args.px, batch=b, steps=res.num_steps,
                  wall_ms=1e3 * wall, warm_wall_ms=1e3 * warm_wall, kernel_ms=busy_ms, window_ms=window_ms,
                  idle_share=idle, groups={k: dict(ms=v[0], launches=v[1])
                                           for k, v in rows.items()})
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(report))
    if group is not None:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--px", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", type=int, choices=(8, 4), default=None,
                    help="prequantise the 1024 px MMDiT: 8 = W8A8 int8, 4 = int4 weight-only")
    ap.add_argument("--model", default="sd3_medium",
                    choices=("sd3_medium", "sd35_medium", "sd35_large"),
                    help="the MMDiT of the unsharded 1024 px path")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if (args.quant or args.model != "sd3_medium") and args.px > 1024:
        raise SystemExit("--quant and --model are for the unsharded 1024 px path")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile is of the card")
    world = torch.cuda.device_count() if args.px > 1024 else 1
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="profile_") as tmp:
        mp.spawn(_rank, args=(world, f"{tmp}/store", args, tmp), nprocs=world, join=True)
        reports = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(world)]
    r0 = reports[0]
    mode = {None: "bf16", 8: "W8A8 int8", 4: "int4 weight-only"}[args.quant]
    print(f"{smi}; {args.model}, {args.px} px, {mode}, batch {args.batch}, {world} rank(s); rank 0: "
          f"{r0['steps']} steps, {r0['warm_wall_ms']:.1f} ms wall warm with the profiler off, "
          f"{r0['wall_ms']:.1f} ms wall with the profiler on, "
          f"{r0['kernel_ms']:.1f} ms of device busy time over a {r0['window_ms']:.1f} ms window, "
          f"idle share {r0['idle_share']:.4f}")
    total = sum(g["ms"] for g in r0["groups"].values())
    print(f"| kernel group | ms | share of kernel time | launches |")
    print(f"| --- | --- | --- | --- |")
    for label, g in sorted(r0["groups"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"| {label} | {g['ms']:.2f} | {100 * g['ms'] / total:.2f} % | {g['launches']} |")
    for rep in reports[1:]:
        print(f"rank {rep['rank']}: {rep['steps']} steps, {rep['kernel_ms']:.1f} ms busy, idle "
              f"share {rep['idle_share']:.4f}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(reports, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
