"""The K-layout study of ``experiments/attn_layout.py`` on the card: K
given transposed, (bh, d, n_kv).

- kernel "kt": online softmax with the kv_len mask and the ones column (K6
  on a K^T view, whose fragments come through ldmatrix.trans);
- kernel "kt_qkonly": the tensor-core probe with K^T (K9).

The probe's ``chunk`` is part of its function and is carried over; the
TPU's ``block_q`` is not. Run ``python -m
tpdm_tpu_torch.experiments.attn_layout`` on a card to time them at the SD3
shape beside K1 and scaled_dot_product_attention.
"""

from __future__ import annotations

from tpdm_tpu_torch.experiments import _common, attn_overlap
from tpdm_tpu_torch.ops.attention import attention_reference
from tpdm_tpu_torch.ops.attention_studies import attention_probe, attention_strided

KERNELS = ("kt", "kt_qkonly")


def attn_kt(q, k, v, chunk: int = 640, kernel: str = "kt"):
    """As the study's ``attn_kt``: q prescaled, k and v padded to a multiple
    of 128 kv rows, V_ext with the ones column zeroed on the pad
    (``attn_overlap._prep``), and K materialised as kt (bh, d, n_kv_pad)."""
    if kernel not in KERNELS:
        raise ValueError(f"attn_kt: kernel {kernel!r}, expected one of {KERNELS}")
    b, h, n_q, d = q.shape
    q3, k3, v3, n_kv, _, _, _ = attn_overlap._prep(q, k, v)
    kt = k3.transpose(1, 2).contiguous()  # (bh, d, n_kv_pad)
    args = (q3[None], kt.transpose(1, 2)[None], v3[None])
    if kernel == "kt":
        o = attention_strided(*args, n_kv)
    else:
        o = attention_probe(*args, "qk_only", chunk)
    return o.reshape(b, h, n_q, d)


def main():
    _common.require_card()
    n = _common.N_REAL
    q, k, v = _common.natural_qkv(0, n=n)
    flops = 4 * _common.B * _common.H * n * n * _common.D
    _common.run_study("attn_layout", {**_common.yardsticks(q, k, v),
                                      "kt (K6)": lambda: attn_kt(q, k, v)},
                      flops, attention_reference(q, k, v))
    _common.run_study("attn_layout probe (output not attention; TF/s at attention's flop count)",
                      {"kt qk_only ch640 (K9)": lambda: attn_kt(q, k, v, kernel="kt_qkonly")},
                      flops)


if __name__ == "__main__":
    main()
