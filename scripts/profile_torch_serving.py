#!/usr/bin/env python3
"""Where the time of a burst through the port's serving engines goes on the card.

Builds chip_smoke.py's phase 14 models (``serve_models``: SD3-medium, its
TPM and VAE, CLIP-L, CLIP-G and T5-XXL in bf16, random weights from the
seed) and sends phase 15's burst (12 requests at once, step caps cycling
none, 4, none, 8) through each engine, each warmed up first:

- ``continuous``: ContinuousBatchingEngine(slots=4, seg_steps=4);
- ``continuous depth 2``: the same with pipeline_depth=2;
- ``fixed``: BatchingEngine(max_batch=4, window_ms=25).

Each engine serves the burst twice. The first run, with the profiler
off, gives the makespan and the host seconds of each stage: for the
continuous engine the segment worker's dispatches (launching the
segments), readbacks (mostly the wait for a segment's event), refills
(prompt encodes and slot writes, and the wait for the burst's first
request) and the decode worker's decodes (each ends in the image's copy
to the host); for the fixed engine its stage times. The second run is
under torch.profiler (CPU and CUDA activity): the device's busy time and
idle share between its first and last event, and its time by kernel
group (``profile_torch_generate.group_of``). Every burst starts with an
empty prompt-embed cache.

    python3 scripts/profile_torch_serving.py [--seed 0] [--out FILE]

``--out`` also writes the tables as JSON. Without a CUDA card it exits
with an error.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke  # noqa: E402
from profile_torch_generate import summarise  # noqa: E402


def timed_stages(engine, names):
    """Wrap each named method of ``engine`` to add its host seconds to the
    returned dict (per name)."""
    seconds = dict.fromkeys(names, 0.0)
    for name in names:
        real = getattr(engine, name)

        def timed(*a, _real=real, _name=name, **k):
            start = time.perf_counter()
            try:
                return _real(*a, **k)
            finally:
                seconds[_name] += time.perf_counter() - start

        setattr(engine, name, timed)
    return seconds


def burst(engine, jobs):
    """Submit ``jobs`` at once to a started engine, its prompt-embed cache
    emptied first (every prompt encoded, as in phase 15); the makespan."""
    cache = engine._embed_cache
    (cache._d if hasattr(cache, "_d") else cache).clear()
    start = time.perf_counter()
    reqs = [engine.submit(p, seed=s, steps=c) for p, s, c in jobs]
    for r in reqs:
        r.result(timeout=600)
    torch.cuda.synchronize()
    return time.perf_counter() - start


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the card")
    from torch.profiler import ProfilerActivity, profile

    from tpdm_tpu_torch.ops import _build
    from tpdm_tpu_torch.serving import BatchingEngine
    from tpdm_tpu_torch.serving_continuous import ContinuousBatchingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    served = chip_smoke.serve_models(args.seed, dev)
    pipe, tokenize, prompts = served.pipe, served.tokenize, served.prompts
    caps = chip_smoke.CONT_CAPS
    jobs = [(prompts[i], i, caps[i % len(caps)]) for i in range(chip_smoke.CONT_REQUESTS)]
    print(f"{torch.cuda.get_device_name(0)}; {len(jobs)} requests, caps {caps}", flush=True)

    makers = {
        "continuous": lambda: ContinuousBatchingEngine(pipe, tokenize, slots=4, seg_steps=4,
                                                       max_steps=35),
        "continuous depth 2": lambda: ContinuousBatchingEngine(
            pipe, tokenize, slots=4, seg_steps=4, max_steps=35, pipeline_depth=2),
        "fixed": lambda: BatchingEngine(pipe, tokenize, max_batch=4, window_ms=25,
                                        max_steps=35),
    }
    tables = {}
    for label, make in makers.items():
        engine = make()
        engine.warmup()
        continuous = isinstance(engine, ContinuousBatchingEngine)
        stages = timed_stages(engine, ("_dispatch_segment", "_process_readback", "_refill",
                                       "_complete", "_complete_batch") if continuous else ())
        engine.start()
        try:
            makespan = burst(engine, jobs)
            stats, first = engine.stats(), dict(stages)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                profiled = burst(engine, jobs)
        finally:
            engine.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            groups, busy_ms, idle, window_ms = summarise(chip_smoke.trace_kernels(path))
        if continuous:
            host = {k.strip("_"): round(v, 4) for k, v in first.items()}
            detail = (f"segments {stats['segments_run']} (first run), slot_utilization "
                      f"{stats['slot_utilization']:.4f}; host seconds of the first run: "
                      + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))
        else:
            host = {k: stats[k] for k in ("device_s_p50", "encode_s_p50", "total_s_p50")
                    if k in stats}
            detail = (f"batches {stats['batches_run']} (first run); "
                      + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))
        print(f"[{label}] makespan {makespan:.3f} s (profiled run {profiled:.3f} s); device "
              f"busy {busy_ms:.1f} of {window_ms:.1f} ms, idle share {idle:.4f}; {detail}",
              flush=True)
        total = sum(ms for ms, _ in groups.values())
        for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"[{label}] | {name} | {ms:.2f} | {100 * ms / total:.2f} % | {n} |", flush=True)
        tables[label] = dict(makespan_s=makespan, profiled_s=profiled, busy_ms=busy_ms,
                             window_ms=window_ms, idle_share=idle, host_s=host,
                             groups={k: list(v) for k, v in groups.items()})
        del engine, prof
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(tables, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
