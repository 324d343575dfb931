"""The overlap study of ``experiments/attn_overlap.py`` on the card.

- "prefetch": the chunked online softmax with the next QK^T issued early;
  its function is v2's (K6).
- "qk_only": the tensor-core probe, sum over chunks of S[:, c0:c0+64] .
  V[c0:c0+64, :64] with every chunk's whole QK^T run (K9).
- "noexp": the exp probe, the online walk with exp2 replaced by s - m,
  divided by acc[:, 64] + 1 (K9).

The probes' ``chunk`` is part of their function and is carried over; the
TPU's ``block_q`` is not. Run ``python -m
tpdm_tpu_torch.experiments.attn_overlap`` on a card to time them at the
SD3 shape beside K1 and scaled_dot_product_attention.
"""

from __future__ import annotations

from tpdm_tpu_torch.experiments import _common, attn_variants
from tpdm_tpu_torch.ops.attention import attention_reference
from tpdm_tpu_torch.ops.attention_studies import attention_probe, attention_strided

KINDS = ("prefetch", "qk_only", "noexp")


def _prep(q, k, v):
    """As the study's ``_prep``: ``attn_variants._prep`` on q prescaled, the
    pad rows of V_ext's ones column zeroed."""
    return attn_variants._prep(_common.prescale(q), k, v, None)


def make_runner(kind: str, chunk: int = 640):
    """The study's runner for ``kind`` in KINDS: a function (q, k, v) ->
    (b, h, n_q, d) over natural (b, h, n, d) operands."""
    if kind not in KINDS:
        raise ValueError(f"make_runner: kind {kind!r}, expected one of {KINDS}")

    def run(q, k, v):
        b, h, n_q, d = q.shape
        q3, k3, v3, kv_len, _, _, _ = _prep(q, k, v)
        if kind == "prefetch":
            o = attention_strided(q3[None], k3[None], v3[None], kv_len)
        else:
            o = attention_probe(q3[None], k3[None], v3[None], kind, chunk)
        return o.reshape(b, h, n_q, d)

    return run


def main():
    _common.require_card()
    n = _common.N_REAL
    q, k, v = _common.natural_qkv(0, n=n)
    _common.run_study(
        "attn_overlap", {**_common.yardsticks(q, k, v),
                         "prefetch (K6)": lambda: make_runner("prefetch")(q, k, v)},
        4 * _common.B * _common.H * n * n * _common.D, attention_reference(q, k, v))
    _common.run_study(
        "attn_overlap probes (outputs not attention; TF/s at attention's flop count)",
        {f"{kind} ch640 (K9)": (lambda kind=kind: make_runner(kind)(q, k, v))
         for kind in ("qk_only", "noexp")},
        4 * _common.B * _common.H * n * n * _common.D)


if __name__ == "__main__":
    main()
