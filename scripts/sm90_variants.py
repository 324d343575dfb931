#!/usr/bin/env python3
"""Design variants of the wgmma kernels' instantiations, timed on the card.

Each variant is the checked-in source (``tpdm_tpu_torch/csrc/attn_sm90.cu``,
``gemm_sm90.cu`` or ``attn_studies_sm90.cu``) with one constant or line
replaced, built by nvcc into ``build/tpdm_tpu_torch/variants/`` (one nvcc a
variant, started together) and called through its own C entry beside the
others, in turns, on the same inputs:

- K1: two or three consumer warp groups (BQ 128 or 192), two or three ring
  stages, at the 1024 px shape (2, 24, 4480, 64) kv_len 4429 and at a
  2048 px joint sequence with two heads (1, 2, 16768, 64) kv_len 16717;
- K3: two or three consumer warp groups at the two ring shapes of 2048 px
  generation, q (2, 24, 16717, 64) x kv (2, 24, 16384, 64) (a ring of one)
  and q (2, 24, 4429, 64) x kv (2, 24, 4096, 64) (rank 0 of four), beside
  ``_scaled_dot_product_flash_attention``; o and log2(l) + m checked on
  one head (atol 1e-3 / rtol 1e-4, as ``chip_smoke.py`` holds K3);
- K6-K9 (``attn_studies_sm90.cu``): two or three consumer warp groups at
  the studies' shape (2, 24, 4480, 64) on twelve of their modes: K6 natural
  with V 64 wide or V_ext 65 and q^T / V^T_ext 80 / o^T (kv_len 4429 but
  there), K8 natural with V 64 wide or V_ext 65, K7's v3, vTm and vTmc, K9
  qk_only with V 64 wide, V_ext 65 or K^T and noexp (chunk 640); and three
  probes of K8's extra work (on K6's and K8's modes) (``no_scale`` replaces
  its two scale products by x + 0 * sk, ``no_convert`` drops its int32
  conversion too, ``no_sk`` leaves K's full barrier to its TMA load alone,
  with sk staged as zeros by the producer threads that no longer arrive); beside
  ``scaled_dot_product_attention`` and K1; each variant that computes the
  function checked on one head against its plain version;
- K5 and K4 (its dequant epilogue), the two instantiations of one
  persistent kernel: as built (TMA-store epilogue); the accumulators
  stored directly from registers (the path for N not a multiple of 8); and
  two probes that compute wrong values to price a part: ``no_store`` drops
  the epilogue's stores, ``no_b_reload`` loads each ring stage's B tile
  once and never again (two thirds of a stage's operand bytes gone). At FF
  proj_in (8192, 1536) x (6144, 1536) and the text rows (666, 1536) x
  (6144, 1536), beside ``torch.matmul`` and ``torch._int_mm``.

Every variant that computes the function is checked against the plain
version as ``chip_smoke.py`` holds the kernels: max error within 2e-2 of
the output's largest magnitude (K1, K3's o, K5, K6-K9; the K9 noexp probe
by its RMS error against its plain version in fp64), log2(l) + m within
atol 1e-3 / rtol 1e-4 (K3), one bf16 step at every element (K4). Needs an
sm_90a card:

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
from tpdm_tpu_torch.experiments.attn_round3 import _quant_rows  # noqa: E402
from tpdm_tpu_torch.ops import attention_studies as st  # noqa: E402
from tpdm_tpu_torch.ops.attention import (  # noqa: E402
    attention_reference,
    attention_reference_stats,
    flash_attention,
)
from tpdm_tpu_torch.ops.gemm import bf16_gemm_reference, int8_gemm_reference  # noqa: E402

TOL = 2e-2
LSE_ATOL, LSE_RTOL = 1e-3, 1e-4
STUDIES_ENTRIES = ("tpdm_attention_strided_d64", "tpdm_attention_int8qk_d64",
                   "tpdm_attention_maxfree_d64", "tpdm_attention_probe_d64")


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"sm90_variants: {old!r} is no longer in the source")
    return text.replace(old, new)


def k1_variants(src: str) -> dict:
    out = {}
    for consumers in (2, 3):
        for stages in (2, 3):
            s = _sub(src, "kK1Consumers = 3;", f"kK1Consumers = {consumers};")
            out[f"consumers {consumers}, stages {stages}"] = _sub(
                s, "constexpr int kStages = 2;", f"constexpr int kStages = {stages};")
    return out


def k3_variants(src: str) -> dict:
    return {f"consumers {c}": _sub(src, "kK3Consumers = 3;", f"kK3Consumers = {c};")
            for c in (2, 3)}


def studies_variants(src: str) -> dict:
    out = {f"consumers {c}": _sub(src, "kStudiesConsumers = 2;", f"kStudiesConsumers = {c};")
           for c in (2, 3)}
    # probes that price K8's per-score work (they compute wrong values):
    # without the two scale products, and without the conversion too
    scale = ("        put(si[i], p.k_scale_first ? __fmul_rn(__fmul_rn(x, s), sq[r])\n"
             "                                   : __fmul_rn(__fmul_rn(x, sq[r]), s));\n")
    out["probe no_scale"] = _sub(src, scale, "        put(si[i], x + 0.f * s);\n")
    out["probe no_convert"] = _sub(
        out["probe no_scale"], "const float x = static_cast<float>(si[i]);",
        "const float x = __int_as_float(si[i] & 0x007fffff);")
    # and a probe of K8's sk staging: the producer stages no sk, so K's full
    # barrier waits for its TMA load alone, as K6's does
    no_sk = _sub(src, "const bool all_k = !(prm.tma >> kK & 1) || kInt8;",
                 "const bool all_k = !(prm.tma >> kK & 1);")
    out["probe no_sk"] = _sub(no_sk, "        const int col = kv0 + pt;\n",
                              "        const int col = kv0 + pt + (1 << 30);\n")
    return out


def gemm_variants(src: str) -> dict:
    no_store = _sub(src, "      } else if (tma_store) {\n",
                    "      } else if (tma_store && m < 0) {\n")
    direct = "stored directly\n#pragma unroll\n        for (int half = 0; half < 2; ++half) {"
    no_store = _sub(no_store, direct, direct.replace("half < 2;", "half < 2 * (m < 0);"))
    k4_direct = "                        if (row < m) {\n                          store_pair("
    no_store = _sub(no_store, k4_direct, k4_direct.replace("row < m", "row < m && m < 0"))
    load_b = ("          sm90::tma_load_2d(stage + kTileA, &map_b, &full[s], kb * kBK<T>, "
              "tile.n0);\n")
    expect = "          sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);\n"
    no_b = _sub(src, load_b, "          if (it < kStages) " + load_b.lstrip())
    no_b = _sub(no_b, expect, "          sm90::mbar_arrive_expect_tx(&full[s], "
                              "it < kStages ? kStageBytes : kTileA);\n")
    return {
        "as built (TMA-store epilogue)": src,
        "direct stores": _sub(src, "const int tma_store = kEpi != kInt32 && n % 8 == 0;",
                              "const int tma_store = 0;"),
        "probe no_store": no_store,
        "probe no_b_reload": no_b,
    }


def build(variants: dict, stem: str, *entries: str) -> dict:
    """{name: ctypes function} of each variant's C entry, or with several
    entries {name: {entry: ctypes function}}."""
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
        lib = ctypes.CDLL(str(root / f"{stem}_{i}.so"))
        fns[name] = {}
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = _build.ENTRIES[entry]
            fn.restype = ctypes.c_int
            fns[name][entry] = fn
        if len(entries) == 1:
            fns[name] = fns[name][entries[0]]
    return fns


def rel_err(out, ref):
    ref = ref.float()
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


def time_in_turns(calls: dict, rounds: int = 2) -> dict:
    """(median, lowest, highest) of each call's per-round median ms over
    ``rounds`` rounds, the calls timed in the order given, then reversed,
    and so on."""
    times = {name: [] for name in calls}
    for r in range(rounds):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            times[name].append(median_ms(calls[name], reps=20))
    return {name: (sorted(t)[len(t) // 2], min(t), max(t)) for name, t in times.items()}


def spread(t) -> str:
    return f"{t[0]:.4f} ms (rounds {t[1]:.4f}-{t[2]:.4f})"


def studies_section(g, dev, stream, fns):
    """K6-K9 with two or three consumer warp groups at the studies' shape,
    on the views the studies pass; K8's probes on K8's modes."""
    b, h, n, kv_len = 2, 24, 4480, 4429
    bf = torch.bfloat16
    tok = lambda t: t.transpose(-1, -2).contiguous().transpose(-1, -2)
    q, k, v = (torch.randn(b, h, n, 64, generator=g, device=dev).to(bf) for _ in range(3))
    qs = (q.float() * (1.4426950408889634 / 8.0)).to(bf)
    ones = (torch.arange(n, device=dev) < kv_len).to(bf).expand(b, h, n)[..., None]
    v65 = torch.cat([v, ones], dim=-1)
    extra = torch.zeros(b, h, n, 16, dtype=bf, device=dev)
    extra[..., 0] = 1
    v80t = tok(torch.cat([v, extra], dim=-1))
    qi, sq = _quant(qs)
    ki, sk = _quant(k)
    rb = (torch.linalg.vector_norm(qs.float(), dim=-1)
          * torch.linalg.vector_norm(k.float(), dim=-1).amax(-1)[..., None])
    o, ot = torch.empty_like(q), tok(torch.empty_like(q))
    sl = (slice(0, 1), slice(0, 1))
    one = lambda *xs: [x[sl] for x in xs]
    # name, the variants' prefix it runs on ("" all), its entry, its
    # arguments after the four views' pointers and strides, the (q, k, v,
    # o) views, kv_len, the plain version on head 0 and how it is held
    # ("max": 2e-2 of max |plain|; "rms": 2e-2 of the RMS, against fp64)
    modes = [
        ("K6 natural, V 64 wide", "", "strided", (0, 1), (qs, k, v, o), kv_len,
         lambda: st.attention_strided_reference(*one(qs, k, v), kv_len), "max"),
        ("K6 natural, V_ext 65", "", "strided", (0, 1), (qs, k, v65, o), kv_len,
         lambda: st.attention_strided_reference(*one(qs, k, v65), kv_len), "max"),
        ("K6 q^T, V^T_ext 80, o^T", "", "strided", (0, 1), (tok(qs), k, v80t, ot), n,
         lambda: st.attention_strided_reference(*one(qs, k, v80t)), "max"),
        ("K8 natural, V_ext 65", "", "int8qk", (0,), (qi, ki, v65, o), kv_len,
         lambda: st.attention_int8qk_reference(*one(qi, ki, v65, sq, sk), kv_len), "max"),
        ("K8 natural, V 64 wide", "", "int8qk", (0,), (qi, ki, v, o), kv_len,
         lambda: st.attention_int8qk_reference(*one(qi, ki, v, sq, sk), kv_len), "max"),
        ("K7 natural, V_ext 65 (v3)", "consumers", "maxfree", (0,), (qs, k, v65, o), kv_len,
         lambda: st.attention_maxfree_reference(*one(qs, k, v65, rb), kv_len), "max"),
        ("K7 q^T, V^T_ext 80, o^T (vTm)", "consumers", "maxfree", (0,), (tok(qs), k, v80t, ot),
         n, lambda: st.attention_maxfree_reference(*one(qs, k, v80t, rb)), "max"),
        ("K7 q^T, V^T_ext 80, o^T, bf16 softmax (vTmc)", "consumers", "maxfree", (1,),
         (tok(qs), k, v80t, ot), n,
         lambda: st.attention_maxfree_reference(*one(qs, k, v80t, rb), soft_bf16=True), "max"),
        ("K9 qk_only, V 64 wide, chunk 640", "consumers", "probe", (0, 640), (qs, k, v, o), n,
         lambda: st.attention_probe_reference(*one(qs, k, v), "qk_only"), "max"),
        ("K9 qk_only, chunk 640", "consumers", "probe", (0, 640), (qs, k, v65, o), n,
         lambda: st.attention_probe_reference(*one(qs, k, v65), "qk_only"), "max"),
        ("K9 qk_only, K^T, chunk 640", "consumers", "probe", (0, 640), (qs, tok(k), v65, o), n,
         lambda: st.attention_probe_reference(*one(qs, k, v65), "qk_only"), "max"),
        ("K9 noexp, chunk 640", "consumers", "probe", (1, 640), (qs, k, v65, o), n,
         lambda: st.attention_probe_reference(*one(qs, k, v65), "noexp", dtype=torch.float64),
         "rms"),
    ]
    rms = lambda x: x.double().pow(2).mean().sqrt().item()
    for name, prefix, entry, flags, (qq, kk, vv, oo), kvl, plain, held in modes:
        strides = st._strides(qq, kk, vv, oo, extra=rb.stride() if entry == "maxfree" else ())
        ptrs = (qq.data_ptr(), kk.data_ptr(), vv.data_ptr(), oo.data_ptr())
        sizes = {"strided": (b, h, n, n, kvl, vv.shape[-1]),
                 "int8qk": (b, h, n, n, kvl, vv.shape[-1]),
                 "maxfree": (b, h, n, n, kvl, vv.shape[-1]),
                 "probe": (b, h, n, n, vv.shape[-1])}[entry]
        extra_ptrs = {"int8qk": (sq.data_ptr(), sk.data_ptr(), None),
                      "maxfree": (rb.data_ptr(),)}.get(entry, ())
        ref = plain()
        calls = {}
        for variant, entries in fns.items():
            if not variant.startswith(prefix):
                continue
            fn = entries[f"tpdm_attention_{entry}_d64"]
            call = (lambda fn=fn, args=(*ptrs, *extra_ptrs, strides, *sizes, *flags):
                    fn(*args, stream()))
            if call() != 0:
                raise SystemExit(f"sm90_variants: {name} {variant} launch failed")
            torch.cuda.synchronize()
            out = oo[sl].float()
            err = (rms(out - ref) / rms(ref) if held == "rms" else rel_err(out, ref))
            if not variant.startswith("probe") and not (err <= TOL and out.isfinite().all()):
                raise SystemExit(f"sm90_variants: {name} {variant} disagrees: {err}")
            calls[variant] = call
        del ref
        calls["scaled_dot_product_attention"] = (
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k[:, :, :kv_len], v[:, :, :kv_len]))
        calls["K1 flash_attention (q unscaled)"] = lambda: flash_attention(q, k, v, kv_len)
        flop = 4 * b * h * n * kvl * 64
        for variant, t in time_in_turns(calls, rounds=4).items():
            print(f"[K6-K9] {(b, h, n, 64)} {name}, {variant}: {spread(t)}, "
                  f"{flop / t[0] / 1e9:.1f} TFLOP/s of a whole attention", flush=True)


def _quant(x):
    """Per-row symmetric int8 of x (b, h, n, 64) and its scales (b, h, n),
    as attn_round3._quant_rows."""
    xi, s = _quant_rows(x)
    return xi, s[..., 0].contiguous()


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
    k3 = build(k3_variants((csrc / "attn_sm90.cu").read_text()), "k3",
               "tpdm_flash_attention_stats_d64")
    gemm = build(gemm_variants((csrc / "gemm_sm90.cu").read_text()), "gemm", "tpdm_bf16_gemm",
                 "tpdm_int8_gemm")
    studies = build(studies_variants((csrc / "attn_studies_sm90.cu").read_text()), "studies",
                    *STUDIES_ENTRIES)
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
        for name, t in time_in_turns(calls).items():
            print(f"[K1] {(b, h, n, 64)} kv_len {kv_len}, {name}: {spread(t)}, "
                  f"{flop / t[0] / 1e9:.1f} TFLOP/s", flush=True)
        del q, k, v, ref

    # K3 at the ring's shapes: the plain version on head 0 of each batch
    for n_q, n_kv in ((16717, 16384), (4429, 4096)):
        q = torch.randn(2, 24, n_q, 64, generator=g, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(2, 24, n_kv, 64, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        o_ref, m_ref, l_ref = attention_reference_stats(q[:, :1], k[:, :1], v[:, :1])
        lse_ref = torch.log2(l_ref) + m_ref
        calls = {}
        for name, fn in k3.items():
            o = torch.empty_like(q)
            m = torch.empty(2, 24, n_q, device=dev)
            l = torch.empty_like(m)
            call = (lambda fn=fn, o=o, m=m, l=l: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
                l.data_ptr(), 48, n_q, n_kv, n_kv, stream()))
            if call() != 0:
                raise SystemExit(f"sm90_variants: K3 {name} launch failed")
            torch.cuda.synchronize()
            err = rel_err(o[:, :1], o_ref)
            lse = torch.log2(l[:, :1]) + m[:, :1]
            if not (err <= TOL and torch.allclose(lse, lse_ref, atol=LSE_ATOL, rtol=LSE_RTOL)):
                raise SystemExit(f"sm90_variants: K3 {name} disagrees: o {err}, log2(l)+m "
                                 f"{(lse - lse_ref).abs().max().item()}")
            calls[name] = call
        calls["_scaled_dot_product_flash_attention"] = (
            lambda: torch.ops.aten._scaled_dot_product_flash_attention(q, k, v))
        flop = 4 * 48 * n_q * n_kv * 64
        for name, t in time_in_turns(calls, rounds=8).items():
            print(f"[K3] q (2, 24, {n_q}, 64) x kv (2, 24, {n_kv}, 64), {name}: {spread(t)}, "
                  f"{flop / t[0] / 1e9:.1f} TFLOP/s", flush=True)
        del q, k, v, o_ref, m_ref, l_ref, lse_ref, calls

    for m, kk, n in ((8192, 1536, 6144), (666, 1536, 6144)):
        a = torch.randn(m, kk, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(n, kk, generator=g, device=dev) * 0.02).to(torch.bfloat16)
        ref = bf16_gemm_reference(a, w)
        calls = {}
        for name, fns in gemm.items():
            c = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
            call = (lambda fn=fns["tpdm_bf16_gemm"], c=c: fn(a.data_ptr(), w.data_ptr(),
                                                              c.data_ptr(), m, n, kk, stream()))
            if call() != 0:
                raise SystemExit(f"sm90_variants: K5 {name} launch failed")
            torch.cuda.synchronize()
            if not name.startswith("probe") and not rel_err(c, ref) <= TOL:
                raise SystemExit(f"sm90_variants: K5 {name} disagrees: {rel_err(c, ref)}")
            calls[name] = call
        calls["torch.matmul"] = lambda: torch.matmul(a, w.t())
        for name, t in time_in_turns(calls).items():
            print(f"[K5] ({m}, {kk}) x ({n}, {kk}), {name}: {spread(t)}, "
                  f"{2 * m * n * kk / t[0] / 1e9:.1f} TFLOP/s", flush=True)
        # K4's dequant epilogue on int8 operands: its output is one bf16
        # step from the plain version's at most
        ai = torch.randint(-127, 128, (m, kk), generator=g, device=dev, dtype=torch.int8)
        wi = torch.randint(-127, 128, (n, kk), generator=g, device=dev, dtype=torch.int8)
        xs = torch.rand(m, generator=g, device=dev) * 1e-2 + 1e-3
        ws = torch.rand(n, generator=g, device=dev) * 1e-2 + 1e-3
        bias = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
        ref = int8_gemm_reference(ai, wi, xs, ws, bias).float()
        calls = {}
        for name, fns in gemm.items():
            c = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
            call = (lambda fn=fns["tpdm_int8_gemm"], c=c: fn(
                ai.data_ptr(), wi.data_ptr(), c.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                bias.data_ptr(), m, n, kk, stream()))
            if call() != 0:
                raise SystemExit(f"sm90_variants: K4 {name} launch failed")
            torch.cuda.synchronize()
            if not name.startswith("probe") and not (
                    (c.float() - ref).abs() <= ref.abs() * 2.0**-8).all():
                raise SystemExit(f"sm90_variants: K4 {name} disagrees")
            calls[name] = call
        calls["torch._int_mm (int32, no epilogue)"] = lambda: torch._int_mm(ai, wi.t())
        for name, t in time_in_turns(calls).items():
            print(f"[K4] ({m}, {kk}) x ({n}, {kk}), {name}: {spread(t)}, "
                  f"{2 * m * n * kk / t[0] / 1e9:.1f} TOP/s", flush=True)
    studies_section(g, dev, stream, studies)
    return 0


if __name__ == "__main__":
    sys.exit(main())
