"""The attention variants of ``experiments/attn_variants.py`` on the card.

Each variant computes softmax(QK^T/sqrt(d))V with q prescaled by
log2(e)/sqrt(d) outside the kernel and V_ext carrying the ones column
(zeroed at or past kv_len) as the denominator:

- v1 resident row softmax and v2 chunked online softmax: one function, K6;
- v3 max-free against the per-row Cauchy-Schwarz bound rb: K7;
- v4 chunked with no column mask (pad excluded by zero k rows and the
  zeroed ones entries): K6 without kv_len.

The TPU tiling arguments (``block_q``, ``chunk``) are not carried over: the
Hopper kernels tile by themselves. Run ``python -m
tpdm_tpu_torch.experiments.attn_variants`` on a card to time them at the
SD3 shape beside K1 and scaled_dot_product_attention.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpdm_tpu_torch.experiments import _common
from tpdm_tpu_torch.ops.attention import attention_reference
from tpdm_tpu_torch.ops.attention_studies import attention_maxfree, attention_strided


def _prep(q, k, v, kv_len):
    """As the study's ``_prep``: k and v padded to a multiple of 128 kv rows,
    V_ext = [v, ones] with the ones zeroed at or past kv_len, all as
    (bh, n, .). q is not padded (the kernels mask their own ragged rows),
    so n_q_pad is n_q."""
    b, h, n_q, d = q.shape
    n_kv = k.shape[2]
    kv_len = n_kv if kv_len is None else kv_len
    n_kv_pad = _common.round_up(n_kv, 128)
    k = F.pad(k, (0, 0, 0, n_kv_pad - n_kv))
    v = F.pad(v, (0, 0, 0, n_kv_pad - n_kv))
    ones = (torch.arange(n_kv_pad, device=v.device) < kv_len).to(v.dtype)
    v_ext = torch.cat([v, ones.expand(b, h, n_kv_pad)[..., None]], dim=-1)
    bh = b * h
    return (q.reshape(bh, n_q, d), k.reshape(bh, n_kv_pad, d),
            v_ext.reshape(bh, n_kv_pad, d + 1), kv_len, n_q, n_kv_pad, bh)


def _run(q, k, v, kv_len, mask: bool):
    b, h, n_q, d = q.shape
    q3, k3, v3, kv_len, _, _, _ = _prep(_common.prescale(q), k, v, kv_len)
    o = attention_strided(q3[None], k3[None], v3[None], kv_len if mask else None)
    return o.reshape(b, h, n_q, d)


def attn_v1(q, k, v, kv_len=None):
    """v1: resident row softmax, exp2, prescaled q, ones column (K6)."""
    return _run(q, k, v, kv_len, mask=True)


def attn_v2(q, k, v, kv_len=None):
    """v2: v1's function by chunked online softmax (K6)."""
    return _run(q, k, v, kv_len, mask=True)


def attn_v3(q, k, v, kv_len=None):
    """v3: max-free, p = exp2(s - rb) with rb = |q_i| max_j |k_j| in the
    prescaled domain (K7)."""
    b, h, n_q, d = q.shape
    qs = _common.prescale(q)
    rb = torch.linalg.vector_norm(qs.float(), dim=-1) * torch.linalg.vector_norm(
        k.float(), dim=-1).amax(dim=-1)[..., None]
    q3, k3, v3, kv_len, _, _, bh = _prep(qs, k, v, kv_len)
    o = attention_maxfree(q3[None], k3[None], v3[None], rb.reshape(1, bh, n_q), kv_len)
    return o.reshape(b, h, n_q, d)


def attn_v4(q, k, v, kv_len=None):
    """v4: no column mask; the pad is excluded by zero k rows (s = 0) and
    the zeroed ones entries (K6 without kv_len)."""
    return _run(q, k, v, kv_len, mask=False)


def main():
    _common.require_card()
    q, k, v = _common.natural_qkv(0, n=_common.N_REAL)
    n = _common.N_REAL
    _common.run_study(
        "attn_variants", {**_common.yardsticks(q, k, v),
                          "v1 (K6)": lambda: attn_v1(q, k, v),
                          "v2 (K6)": lambda: attn_v2(q, k, v),
                          "v3 max-free (K7)": lambda: attn_v3(q, k, v),
                          "v4 no mask (K6)": lambda: attn_v4(q, k, v)},
        4 * _common.B * _common.H * n * n * _common.D, attention_reference(q, k, v))


if __name__ == "__main__":
    main()
