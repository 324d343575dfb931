#!/usr/bin/env python3
"""How far the K9 noexp probe's plain version itself moves with the order
of its fp32 sums, at chip_smoke.py phase 10's inputs.

The probe divides by acc[:, 64] + 1, which comes near zero on some rows, so
phase 10 holds it by its RMS error against the plain version (within 2e-2
of the plain output's RMS). This script draws phase 10's operands as
chip_smoke.py does (the same seed, after the phases that draw from the same
generator) and a second set after six more draws of K2's shapes, three of
(2, 1, 16384, 512) and three of (1, 1, 65536, 512), from that generator,
which a version of phase 3 made. For each set it prints the RMS error of the
kernel against the plain version, as phase 10 computes it, and of the
kernel and the plain version (on the card and on the CPU, both in fp32)
against the same function evaluated in fp64 (P still rounded to bf16, as
the function defines it); then the rows' smallest |acc[:, 64] + 1| and the
share of the kernel's squared error that its 16 rows with the smallest
carry. Needs a CUDA card:

    python3 scripts/k9_noexp_conditioning.py [--seed 0]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def noexp64(q, k, v, chunk=640):
    """attention_probe_reference's noexp walk in fp64, (s - m) rounded to
    bf16 for the PV product; returns (o, acc[..., 64] + 1)."""
    s_all = torch.matmul(q.double(), k.double().transpose(-1, -2))
    acc = m = None
    for lo in range(0, k.shape[2], chunk):
        s = s_all[..., lo:lo + chunk]
        vv = v[:, :, lo:lo + s.shape[-1], :65].double()
        m_new = s.amax(-1, keepdim=True)
        m_new = m_new if m is None else torch.maximum(m, m_new)
        pv = torch.matmul((s - m_new).to(v.dtype).double(), vv)
        acc = pv if m is None else acc * (m - m_new) + pv
        m = m_new
    den = acc[..., 64] + 1.0
    return acc[..., :64] / den[..., None], den


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k9_noexp_conditioning: needs a CUDA card")
    from tpdm_tpu_torch.experiments import _common, attn_overlap
    from tpdm_tpu_torch.ops import _build
    from tpdm_tpu_torch.ops import attention_studies as st

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.median_ms = _common.median_ms
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    _build.load_library()

    # the generator as chip_smoke.py's phase 10 finds it: phases 3, 7 and 8
    # draw from it in this order
    g = torch.Generator(device=dev).manual_seed(args.seed)
    chip_smoke.kernel_phase(g, dev, args.seed)
    chip_smoke.gemm_phase(g, dev)
    chip_smoke.k3_phase(g, dev, 1)
    chip_smoke.merge_phase(g, dev)
    state = g.get_state()
    torch.cuda.empty_cache()

    b, h, n, d, kv_len = _common.B, _common.H, _common.N, _common.D, _common.N_REAL
    for label, extra in (("phase 10's inputs", ()),
                         ("after the six K2 draws", 3 * [(2, 1, 16384, 512)]
                          + 3 * [(1, 1, 65536, 512)])):
        g.set_state(state)
        for shape in extra:
            torch.randn(shape, generator=g, device=dev)
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        q3, k3, v3, *_ = attn_overlap._prep(*(t[:, :, :kv_len].contiguous() for t in (q, k, v)))
        ops = (q3[None], k3[None], v3[None])
        out = st.attention_probe(*ops, "noexp", 640).float()
        plain = st.attention_probe_reference(*ops, "noexp", 640).float()
        plain_cpu = st.attention_probe_reference(*(t.cpu() for t in ops), "noexp", 640).float()
        ref, den = noexp64(*ops)
        ref = ref.float()
        worst = den.abs().flatten().argsort()[:16]
        err2 = ((out - plain) ** 2).sum(-1).flatten()
        print(f"[noexp] {label}: RMS err, kernel vs plain {chip_smoke.rel_rms(out, plain):.6f} "
              f"(phase 10's check, bound {chip_smoke.KERNEL_REL_TOL}); against fp64: kernel "
              f"{chip_smoke.rel_rms(out, ref):.6f}, plain on the card "
              f"{chip_smoke.rel_rms(plain, ref):.6f}, plain on the CPU "
              f"{chip_smoke.rel_rms(plain_cpu, ref.cpu()):.6f}; plain on the card vs on the "
              f"CPU {chip_smoke.rel_rms(plain, plain_cpu.to(dev)):.6f}; smallest "
              f"|acc[:, 64] + 1| {den.abs().min().item():.3e} (median "
              f"{den.abs().median().item():.3e}); its 16 smallest rows carry "
              f"{100 * (err2[worst].sum() / err2.sum()).item():.1f} % of the kernel's squared "
              f"error against the plain version", flush=True)
        del q, k, v, q3, k3, v3, ops, out, plain, plain_cpu, ref, den
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
