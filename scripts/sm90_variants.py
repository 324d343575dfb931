#!/usr/bin/env python3
"""Design variants of the two wgmma kernels, K1 and K5, timed on the card.

Each variant is the checked-in source (``tpdm_tpu_torch/csrc/attn_sm90.cu``
or ``gemm_sm90.cu``) with one constant or line replaced, built by nvcc into
``build/tpdm_tpu_torch/variants/`` (one nvcc a variant, started together)
and called through its own C entry beside the others, in turns, on the same
inputs:

- K1: two or three consumer warp groups (BQ 128 or 192), two or three ring
  stages, at the 1024 px shape (2, 24, 4480, 64) kv_len 4429 and at a
  2048 px joint sequence with two heads (1, 2, 16768, 64) kv_len 16717;
- K5: the kernel as built (TMA-store epilogue); the accumulators stored
  directly from registers (the path for N not a multiple of 8); and two
  probes that compute wrong values to price a part: ``no_store`` drops the
  epilogue's stores, ``no_b_reload`` loads each ring stage's B tile once
  and never again (two thirds of a stage's operand bytes gone). At FF
  proj_in (8192, 1536) x (6144, 1536) and the text rows (666, 1536) x
  (6144, 1536).

Every variant that computes the function is checked against the plain
version (max error within 2e-2 of the output's largest magnitude, as
``chip_smoke.py`` holds the kernels). Needs an sm_90a card:

    python3 scripts/sm90_variants.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tpdm_tpu_torch.experiments._common import median_ms  # noqa: E402
from tpdm_tpu_torch.ops import _build  # noqa: E402
from tpdm_tpu_torch.ops.attention import attention_reference  # noqa: E402
from tpdm_tpu_torch.ops.gemm import bf16_gemm_reference  # noqa: E402

TOL = 2e-2


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"sm90_variants: {old!r} is no longer in the source")
    return text.replace(old, new)


def k1_variants(src: str) -> dict:
    out = {}
    for consumers, regs in ((2, 240), (3, 160)):
        for stages in (2, 3):
            s = _sub(src, "kConsumers = 3;", f"kConsumers = {consumers};")
            s = _sub(s, "kConsumerRegs = 160;", f"kConsumerRegs = {regs};")
            out[f"consumers {consumers}, stages {stages}"] = _sub(
                s, "constexpr int kStages = 2;", f"constexpr int kStages = {stages};")
    return out


def k5_variants(src: str) -> dict:
    no_store = _sub(src, "      if (tma_store) {\n", "      if (tma_store && m < 0) {\n")
    direct = "for (int half = 0; half < 2; ++half) {\n          const int row = tile.m0"
    no_store = _sub(no_store, direct, direct.replace("half < 2;", "half < 2 * (m < 0);"))
    load_b = "          sm90::tma_load_2d(stage + kTileA, &map_b, &full[s], kb * kBK, tile.n0);\n"
    expect = "          sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);\n"
    no_b = _sub(src, load_b, "          if (it < kStages) " + load_b.lstrip())
    no_b = _sub(no_b, expect, "          sm90::mbar_arrive_expect_tx(&full[s], "
                              "it < kStages ? kStageBytes : kTileA);\n")
    return {
        "as built (TMA-store epilogue)": src,
        "direct stores": _sub(src, "const int tma_store = n % 8 == 0;", "const int tma_store = 0;"),
        "probe no_store": no_store,
        "probe no_b_reload": no_b,
    }


def build(variants: dict, stem: str, entry: str) -> dict:
    """{name: ctypes function} of each variant's C entry."""
    root = _build.BUILD_DIR / "variants"
    root.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        src = root / f"{stem}_{i}.cu"
        src.write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-shared", "-o",
               str(root / f"{stem}_{i}.so"), str(src)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True))
    fns = {}
    for name, (i, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"sm90_variants: nvcc failed on {stem} {name}:\n{err[-3000:]}")
        report = [line.strip() for line in (out + err).splitlines()
                  if "registers" in line or "spill" in line or "C75" in line]
        print(f"[build] {stem} {name}: {' | '.join(report)}", flush=True)
        fn = getattr(ctypes.CDLL(str(root / f"{stem}_{i}.so")), entry)
        fn.argtypes = _build.ENTRIES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def rel_err(out, ref):
    ref = ref.float()
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


def time_in_turns(calls: dict) -> dict:
    """Median ms of each call, timed in the order given and then reversed."""
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        times[name].append(median_ms(calls[name], reps=20))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sm90_variants: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    csrc = _build.CSRC_DIR
    k1 = build(k1_variants((csrc / "attn_sm90.cu").read_text()), "k1",
               "tpdm_flash_attention_d64")
    k5 = build(k5_variants((csrc / "gemm_sm90.cu").read_text()), "k5", "tpdm_bf16_gemm")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    for (b, h, n), kv_len in (((2, 24, 4480), 4429), ((1, 2, 16768), 16717)):
        q, k, v = (torch.randn(b, h, n, 64, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        ref = attention_reference(q[:, :1], k[:, :1], v[:, :1], kv_len)
        calls = {}
        for name, fn in k1.items():
            o = torch.empty_like(q)
            call = (lambda fn=fn, o=o: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                          b * h, n, n, kv_len, stream()))
            if call() != 0:
                raise SystemExit(f"sm90_variants: K1 {name} launch failed")
            torch.cuda.synchronize()
            err = rel_err(o[:, :1], ref)
            if not err <= TOL:
                raise SystemExit(f"sm90_variants: K1 {name} disagrees: {err}")
            calls[name] = call
        calls["scaled_dot_product_attention"] = (
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k[:, :, :kv_len], v[:, :, :kv_len]))
        flop = 4 * b * h * n * kv_len * 64
        for name, ms in time_in_turns(calls).items():
            print(f"[K1] {(b, h, n, 64)} kv_len {kv_len}, {name}: {ms:.4f} ms, "
                  f"{flop / ms / 1e9:.1f} TFLOP/s", flush=True)
        del q, k, v, ref

    for m, kk, n in ((8192, 1536, 6144), (666, 1536, 6144)):
        a = torch.randn(m, kk, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(n, kk, generator=g, device=dev) * 0.02).to(torch.bfloat16)
        ref = bf16_gemm_reference(a, w)
        calls = {}
        for name, fn in k5.items():
            c = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
            call = (lambda fn=fn, c=c: fn(a.data_ptr(), w.data_ptr(), c.data_ptr(), m, n, kk,
                                          stream()))
            if call() != 0:
                raise SystemExit(f"sm90_variants: K5 {name} launch failed")
            torch.cuda.synchronize()
            if not name.startswith("probe") and not rel_err(c, ref) <= TOL:
                raise SystemExit(f"sm90_variants: K5 {name} disagrees: {rel_err(c, ref)}")
            calls[name] = call
        calls["torch.matmul"] = lambda: torch.matmul(a, w.t())
        for name, ms in time_in_turns(calls).items():
            print(f"[K5] ({m}, {kk}) x ({n}, {kk}), {name}: {ms:.4f} ms, "
                  f"{2 * m * n * kk / ms / 1e9:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
