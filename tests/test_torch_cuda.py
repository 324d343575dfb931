"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA card: the
kernels have no CPU mode. On a machine with an sm_90a card run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` because the suite's conftest sets up JAX, which this file
does not use.) The first test builds the kernels with nvcc.

Tolerance for the bf16 kernels: atol 2e-2 / rtol 2e-2 on outputs of order
one. Both versions round P to bf16 before the PV product and the output to
bf16 (a relative step of 2^-8 = 0.4 %); they sum in different orders and the
kernel rescales its running sums tile by tile, so a few output ulps apart is
expected and anything wrong in the algorithm is far outside the bound.
K2's outputs are small (a weighted mean of many N(0, 1) rows), so it is
also held to 2e-2 of max |plain| in every 64-column block of its 512 (the
worst element of a block against the block's largest magnitude). At
65536 rows the plain version runs over blocks of 4096 query rows: its
whole fp32 score matrix would take 17 GB.

K3's statistics are compared in the frame log2(l) + m, which does not
depend on where each version puts m: atol 1e-3 / rtol 1e-4. The scores are
exact products of bf16 values summed in fp32 in another order (relative
~1e-6) and the sums l are fp32 in both, so on values of order 10 (or -170
for the strongly negative case) the two agree to a few 1e-4. Where q is
long (the ring of one at 2048 px), the plain version runs over blocks of
query rows, which are independent, so its fp32 scores fit the card.

The GEMMs: K4's int32 accumulator is exact, so it must equal its plain
version bit for bit; its dequant epilogue rounds each fp32 operation as the
plain version does and then once to bf16, so it is held to one bf16 step
(2^-8 of |ref|) at every element. K5 sums bf16 products in fp32 in another
order than cuBLAS's fp32 product and rounds once to bf16: within 2e-2 of
the output's largest magnitude, as chip_smoke.py holds it.

The studies' kernels K6-K9 (``ops/attention_studies.py``): every layout and
mode against its plain version on the same views, the output's max error
within 2e-2 of its largest magnitude (bf16 P and output, as K1). K8's int32
scores are exact. The four are one kernel template, which loads each
operand through TMA, a 65-wide V staged through TMA, or, where the view
allows neither, with the producer's plain loads: the routes are tested for
each operand, with the route asserted. The sm90.cuh helpers they add are
tested alone: the 64-byte-swizzled s8 product is exact, and the transposed-A bf16 product
is held to fp32 torch.matmul at 1e-4 (exact bf16 products summed in fp32
in another order, on sums of order 10). The noexp probe divides by
acc[:, 64] + 1, which can come near zero on some rows, so it is held by
RMS: within 2e-2 of the plain output's RMS.
"""

import pytest
import torch

from tpdm_tpu_torch.ops.gemm import (
    bf16_gemm,
    bf16_gemm_reference,
    int8_gemm,
    int8_gemm_reference,
)
from tpdm_tpu_torch.experiments.attn_round3 import _quant_rows
from tpdm_tpu_torch.ops.attention_studies import (
    attention_int8qk,
    attention_int8qk_reference,
    attention_maxfree,
    attention_maxfree_reference,
    attention_probe,
    attention_probe_reference,
    attention_strided,
    attention_strided_reference,
    int8_scores,
    studies_routes,
)
from tpdm_tpu_torch.ops.attention import (
    attention_reference,
    attention_reference_stats,
    flash_attention,
    flash_attention_streaming,
    flash_attention_with_stats,
    joint_attention,
    merge_attention_shards,
)

pytestmark = pytest.mark.cuda

ATOL = RTOL = 2e-2
LSE_ATOL, LSE_RTOL = 1e-3, 1e-4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(device, b, h, n_q, n_kv, d, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda n: torch.randn(b, h, n, d, generator=g, device=device).to(torch.bfloat16)
    return mk(n_q), mk(n_kv), mk(n_kv)


def _assert_close(out, ref):
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)


def _blocked_plain(q, k, v, kv_len=None, rows=4096):
    """attention_reference over blocks of ``rows`` query rows (rows are
    independent; the whole fp32 score matrix may not fit the card)."""
    return torch.cat([attention_reference(q[:, :, i:i + rows], k, v, kv_len)
                      for i in range(0, q.shape[2], rows)], dim=2)


@pytest.mark.parametrize(
    "shape,kv_len",
    [
        ((2, 24, 4480, 4480), 4429),  # SD3 1024 px joint attention
        ((1, 2, 333, 437), None),  # ragged on both axes
        ((2, 3, 64, 64), None),  # one tile
        ((1, 1, 200, 256), 1),  # a single valid kv column
        ((8, 24, 4480, 4480), 4429),  # 1024 px, the RLOO rollout's CFG batch
        ((4, 24, 4480, 4480), 4429),  # ... the recompute replay's
        ((1, 24, 4480, 4480), 4429),  # ... a conditional-only step outside a guidance window
        ((2, 24, 4096, 4096), None),  # SD3.5-medium's image-only attn2 at CFG batch 2
        ((4, 24, 4096, 4096), None),  # ... at CFG batch 4 (a batch-2 request)
        ((2, 38, 4480, 4480), 4429),  # SD3.5-large's joint attention, 38 heads
    ],
)
def test_k1_matches_plain(device, shape, kv_len):
    b, h, n_q, n_kv = shape
    q, k, v = _qkv(device, b, h, n_q, n_kv, 64, seed=n_q)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_close(out, _blocked_plain(q, k, v, kv_len, rows=1120))


def test_mmdit_cache_modes_match_cpu_fp32(device):
    """The Δ-cache forward of a 2-layer SD3-width MMDiT (4 heads of 64, one
    front block): "record", then "reuse" of its Δ at half the timestep, in
    bf16 through K1 against the same weights in fp32 on the CPU through
    the plain version. Velocity, temb, h1 and h2 of both within 5e-2 of
    their range (bf16 rounding of every activation, chip_smoke.py's module
    bound); Δ, a difference of two bf16 residual-stream values, is held
    through the reuse forward that takes it."""
    from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig

    cfg = MMDiTConfig.sd3_medium(num_layers=2, num_attention_heads=4, caption_projection_dim=256,
                                 sample_size=16, cache_front_blocks=1)
    g = torch.Generator().manual_seed(0)
    m_cpu = MMDiT(cfg).init_weights(g, 0.02).to(torch.bfloat16).float()
    m_card = MMDiT(cfg).to(device)
    m_card.load_state_dict(m_cpu.state_dict())
    m_card.to(torch.bfloat16)
    inputs = (torch.randn(2, 16, 16, 16, generator=g), torch.tensor([1000.0, 420.0]),
              torch.randn(2, 77, 4096, generator=g), torch.randn(2, 2048, generator=g))
    outs = {}
    before = flash_attention.launches
    with torch.no_grad():
        for name, model, xs in (("cpu", m_cpu, inputs),
                                ("card", m_card, [x.to(device, torch.bfloat16) for x in inputs])):
            rec = model(*xs, cache_mode="record")
            later = (xs[0], xs[1] * 0.5, *xs[2:])
            outs[name] = (*rec[:4], *model(*later, delta=rec[4], cache_mode="reuse")[:4])
    assert flash_attention.launches == before + 3  # 2 layers, then 1 front layer
    for card, cpu in zip(outs["card"], outs["cpu"]):
        err = (card.float().cpu() - cpu).abs().max() / cpu.abs().max()
        assert torch.isfinite(card.float()).all() and err < 5e-2


@pytest.mark.parametrize("n_kv", [64, 128, 129, 256, 4480])
@pytest.mark.parametrize("n_q", [1, 127, 128, 129, 192, 193])
def test_k1_tile_edges(device, n_q, n_kv):
    """Query tiles of 128 rows (two warp groups of 64) and kv tiles of 128
    rows through a 2-stage ring: one or two query tiles, a last tile with
    one row or one warp group, kv walks of one, two and 35 tiles."""
    q, k, v = _qkv(device, 1, 2, n_q, n_kv, 64, seed=n_q * 7 + n_kv)
    _assert_close(flash_attention(q, k, v), attention_reference(q, k, v))


@pytest.mark.parametrize("kv_len", [1, 127, 128, 129])
def test_k1_kv_len_at_tile_edges(device, kv_len):
    q, k, v = _qkv(device, 1, 2, 200, 256, 64, seed=kv_len)
    _assert_close(flash_attention(q, k, v, kv_len), attention_reference(q, k, v, kv_len))


def test_k1_2048px_unsharded(device):
    """The 2048 px joint sequence on one card: 16384 image + 333 text
    tokens padded to 16768, 131 kv tiles."""
    q, k, v = _qkv(device, 1, 2, 16768, 16768, 64, seed=16768)
    _assert_close(flash_attention(q, k, v, 16717), attention_reference(q, k, v, 16717))


def test_k1_mask_with_strongly_negative_scores(device):
    """Masked kv must score like -inf: every valid score ~ -120 here, so a
    zero-filled mask would pull the max to 0 and NaN the row."""
    q, k, v = _qkv(device, 1, 2, 128, 256, 64, seed=20)
    q[..., 0] += 12.0
    k[..., 0] = -80.0
    out = flash_attention(q, k, v, 200)
    ref = attention_reference(q[:, :, :, :], k[:, :, :200], v[:, :, :200])
    _assert_close(out, ref)


# K1 at the SD1.5 UNet's head dims at 512 px, at the CFG batches that its
# requests run: 2 (batch 1), 4 (batch 2) and 8 (the engine's batch of four);
# each level's self-attention and its cross-attention against the 77 text
# tokens
UNET_SHAPES = [
    shape for b in (2, 4, 8) for shape in (
        (b, 8, 4096, 4096, 40), (b, 8, 4096, 77, 40),  # level 0, 320 channels
        (b, 8, 1024, 1024, 80), (b, 8, 1024, 77, 80),  # level 1, 640
        (b, 8, 256, 256, 160), (b, 8, 256, 77, 160),  # level 2, 1280
        (b, 8, 64, 64, 160), (b, 8, 64, 77, 160),  # the mid block
    )
]


@pytest.mark.parametrize("shape", UNET_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k1_unet_head_dims_match_plain(device, shape):
    b, h, n_q, n_kv, d = shape
    q, k, v = _qkv(device, b, h, n_q, n_kv, d, seed=n_q + d)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_close(out, _blocked_plain(q, k, v, rows=1024))


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("n_q,n_kv,kv_len", [(1, 77, None), (65, 129, None), (193, 300, 257),
                                             (129, 256, 1), (64, 128, 100)])
def test_k1_unet_head_dims_tile_edges(device, d, n_q, n_kv, kv_len):
    """The padded instantiations at ragged query blocks (64 rows a consumer:
    192 a block at d 40, 128 at d 80, 64 at d 160) and kv walks that end
    mid-tile, masked or not."""
    q, k, v = _qkv(device, 1, 2, n_q, n_kv, d, seed=n_q * 3 + n_kv + d)
    _assert_close(flash_attention(q, k, v, kv_len), attention_reference(q, k, v, kv_len))


@pytest.mark.parametrize("d", [40, 80, 160])
def test_k1_unet_head_dims_strongly_negative_scores(device, d):
    q, k, v = _qkv(device, 1, 2, 128, 256, d, seed=30 + d)
    q[..., 0] += 12.0
    k[..., 0] = -80.0
    _assert_close(flash_attention(q, k, v, 200),
                  attention_reference(q, k[:, :, :200], v[:, :, :200]))


def test_k1_d40_scales_by_the_true_head_dim(device):
    """At d 40 the rows are padded to 64 columns: a softmax scaled by
    1/sqrt(64) instead of 1/sqrt(40) is far outside the bound here (scores
    of order 10), and the kernel must match the true scale."""
    q, k, v = _qkv(device, 1, 2, 256, 256, 40, seed=41)
    q = (q.float() * 2.0).to(torch.bfloat16)
    out = flash_attention(q, k, v)
    _assert_close(out, attention_reference(q, k, v))
    q_padded_scale = (q.float() * (40 / 64) ** 0.5).to(torch.bfloat16)
    wrong = attention_reference(q_padded_scale, k, v)
    assert (out.float() - wrong.float()).abs().max() > 10 * ATOL


# K1 at d 64 at SDXL's 1024 px shapes, at CFG batch 2 and 4: the base UNet's
# 10 heads over the level-1 grid's 4096 tokens and 20 heads over level 2's
# and the mid block's 1024; the refiner's 12 heads over 4096, 24 over 1024
# and, in its mid block, 24 over 256; each beside its cross-attention
# against the 77 text tokens; and the refiner's at CFG batch 8, where the
# ensemble's RLOO rollout of 2 prompts x rloo_k 2 runs it
SDXL_SHAPES = [
    shape for b in (2, 4) for h, n in ((10, 4096), (20, 1024), (12, 4096), (24, 1024), (24, 256))
    for shape in ((b, h, n, n), (b, h, n, 77))
] + [shape for h, n in ((12, 4096), (24, 1024), (24, 256))
     for shape in ((8, h, n, n), (8, h, n, 77))]


@pytest.mark.parametrize("shape", SDXL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k1_sdxl_shapes_match_plain(device, shape):
    b, h, n_q, n_kv = shape
    q, k, v = _qkv(device, b, h, n_q, n_kv, 64, seed=n_q + h)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_close(out, _blocked_plain(q, k, v, rows=1024))


# the toy UNets' head dims (toy_xl and toy_refiner at 4, the SD1.5 toy's 4,
# 6 and 8 heads of 2): K1's d-64 kernel on operands zero-padded to 64
# columns, at the toy world's self- and cross-attention shapes and ragged ones
@pytest.mark.parametrize("d", [4, 6, 8])
@pytest.mark.parametrize("b,h,n_q,n_kv,kv_len", [(4, 2, 256, 256, None), (4, 2, 256, 8, None),
                                                 (4, 4, 64, 64, None), (1, 3, 193, 300, 257),
                                                 (2, 2, 1, 77, None)])
def test_k1_padded_small_head_dims_match_plain(device, d, b, h, n_q, n_kv, kv_len):
    q, k, v = _qkv(device, b, h, n_q, n_kv, d, seed=n_q + n_kv + d)
    q = (q.float() * 3.0).to(torch.bfloat16)  # scores of order 10: the scale shows
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == (b, h, n_q, d)
    _assert_close(out, attention_reference(q, k, v, kv_len))


# K1 at FLUX's head dim 128: the joint [text, image] sequence of 512 T5
# tokens and the image tokens, 4096 at 1024 px (batch 1 and 2) and 1024 at
# 512 px (the continuous engine's 4 slots), no kv_len; at 1024 px at batch
# 4 (an RLOO rollout of 2 prompts x rloo_k 2, no CFG doubling); and ragged
# query and kv tiles of the d-128 entry (128 query rows a block)
FLUX_SHAPES = [(1, 24, 4608, 4608, None), (2, 24, 4608, 4608, None),
               (4, 24, 1536, 1536, None), (1, 3, 129, 300, 257), (2, 2, 1, 65, None),
               (1, 2, 193, 128, 1), (4, 24, 4608, 4608, None)]


@pytest.mark.parametrize("shape", FLUX_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k1_flux_shapes_match_plain(device, shape):
    b, h, n_q, n_kv, kv_len = shape
    q, k, v = _qkv(device, b, h, n_q, n_kv, 128, seed=n_q + n_kv + h)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == (b, h, n_q, 128)
    _assert_close(out, _blocked_plain(q, k, v, kv_len, rows=1024))


@pytest.mark.parametrize("d", [72, 96, 192, 256])
def test_k1_raises_on_other_head_dims(device, d):
    q, k, v = _qkv(device, 1, 1, 64, 64, d, seed=d)
    before = flash_attention.launches
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


def _reference_stats(q, k, v, kv_len, rows=1024):
    """attention_reference_stats over blocks of ``rows`` query rows."""
    parts = [attention_reference_stats(q[:, :, i:i + rows], k, v, kv_len)
             for i in range(0, q.shape[2], rows)]
    return tuple(torch.cat(x, dim=2) for x in zip(*parts))


def _assert_stats_close(got, ref):
    (o, m, l), (o_ref, m_ref, l_ref) = got, ref
    _assert_close(o, o_ref)
    assert m.dtype == l.dtype == torch.float32 and m.shape == l.shape == o.shape[:3]
    torch.testing.assert_close(torch.log2(l) + m, torch.log2(l_ref) + m_ref,
                               atol=LSE_ATOL, rtol=LSE_RTOL)


@pytest.mark.parametrize(
    "shape,kv_len",
    [
        ((2, 24, 4429, 4096), None),  # 2048 px, 4-way ring: rank 0 vs an image shard
        ((2, 24, 4429, 384), 333),  # ... vs the text tokens, padded and masked
        ((2, 24, 4096, 333), None),  # another rank vs the text tokens
        ((1, 2, 333, 437), 400),  # ragged on both axes
        ((1, 1, 200, 256), 1),  # a single valid kv column
        ((2, 24, 16717, 16384), None),  # 2048 px, a ring of one: the whole image kv
    ],
)
def test_k3_matches_plain(device, shape, kv_len):
    b, h, n_q, n_kv = shape
    q, k, v = _qkv(device, b, h, n_q, n_kv, 64, seed=n_kv)
    before = flash_attention_with_stats.launches
    got = flash_attention_with_stats(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert flash_attention_with_stats.launches == before + 1
    _assert_stats_close(got, _reference_stats(q, k, v, kv_len))


@pytest.mark.parametrize("n_kv", [64, 128, 129, 256, 4480])
@pytest.mark.parametrize("n_q", [1, 127, 128, 129, 192, 193])
def test_k3_tile_edges(device, n_q, n_kv):
    """K1's tile grid for the statistics: query tiles of one or two blocks,
    a last block with one row or one warp group (m and l of rows >= n_q
    are not written), kv walks of one, two and 35 tiles whose last tile
    reads past n_kv into TMA's zero fill, masked by the bias."""
    q, k, v = _qkv(device, 1, 2, n_q, n_kv, 64, seed=n_q * 7 + n_kv)
    _assert_stats_close(flash_attention_with_stats(q, k, v), attention_reference_stats(q, k, v))


@pytest.mark.parametrize("kv_len", [1, 127, 128, 129])
def test_k3_kv_len_at_tile_edges(device, kv_len):
    q, k, v = _qkv(device, 1, 2, 200, 256, 64, seed=kv_len)
    _assert_stats_close(flash_attention_with_stats(q, k, v, kv_len),
                        attention_reference_stats(q, k, v, kv_len))


def test_k3_mask_with_strongly_negative_scores(device):
    q, k, v = _qkv(device, 1, 2, 128, 256, 64, seed=21)
    q[..., 0] += 12.0
    k[..., 0] = -80.0
    got = flash_attention_with_stats(q, k, v, 200)
    _assert_stats_close(got, attention_reference_stats(q, k[:, :, :200], v[:, :, :200]))


def test_k3_shards_merge_to_k1(device):
    """K3 over four kv shards, the last one partly pad, merged by
    merge_attention_shards, equals K1 over the whole masked sequence."""
    q, k, v = _qkv(device, 1, 4, 300, 1000, 64, seed=22)
    parts = [flash_attention_with_stats(q, k[:, :, i:i + 250].contiguous(),
                                        v[:, :, i:i + 250].contiguous(), min(250, 900 - i))
             for i in range(0, 1000, 250)]
    merged = merge_attention_shards(*(torch.stack(x) for x in zip(*parts)))
    _assert_close(merged, flash_attention(q, k, v, 900))


def _assert_blocks_close(out, ref, tol=RTOL):
    """Max error within ``tol`` of max |ref| in every 64-column block of the
    head (K2's 512 columns come as eight TMA boxes: a wrong stride between
    them would spoil whole blocks), each block's error in the message."""
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().flatten(0, -2).amax(0).view(-1, 64).amax(1)
    scale = ref.float().abs().flatten(0, -2).amax(0).view(-1, 64).amax(1)
    assert (err <= tol * scale).all(), (err / scale).tolist()


@pytest.mark.parametrize(
    "shape,kv_len",
    [
        ((1, 1, 16384, 16384), None),  # SD3 VAE mid block at 1024 px
        ((1, 1, 300, 450), None),
        ((2, 1, 128, 512), 300),
        ((2, 1, 16384, 16384), None),  # ... batch 2
        ((4, 1, 16384, 16384), None),  # ... batch 4: the RLOO reward's decode
        ((1, 1, 65536, 65536), None),  # 2048 px, the plain version in query blocks
    ],
)
def test_k2_matches_plain(device, shape, kv_len):
    b, h, n_q, n_kv = shape
    q, k, v = _qkv(device, b, h, n_q, n_kv, 512, seed=n_q)
    before = flash_attention_streaming.launches
    out = flash_attention_streaming(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert flash_attention_streaming.launches == before + 1
    ref = _blocked_plain(q, k, v, kv_len)
    _assert_close(out, ref)
    _assert_blocks_close(out, ref)


@pytest.mark.parametrize("n_kv", [1, 31, 32, 33, 64, 65, 129])
@pytest.mark.parametrize("n_q", [1, 63, 64, 65, 200])
def test_k2_tile_edges(device, n_q, n_kv):
    """Query blocks and kv tiles of 64 rows, each tile's S split at column
    32 between the two consumers: one row, a block, tile or split edge and
    one past it, the last tile reading past n_kv into TMA's zero fill,
    masked by the bias."""
    q, k, v = _qkv(device, 1, 2, n_q, n_kv, 512, seed=n_q * 7 + n_kv)
    _assert_blocks_close(flash_attention_streaming(q, k, v), attention_reference(q, k, v))


@pytest.mark.parametrize("kv_len", [1, 31, 32, 33, 63, 64, 65])
def test_k2_kv_len_at_tile_edges(device, kv_len):
    q, k, v = _qkv(device, 1, 2, 100, 130, 512, seed=kv_len)
    _assert_blocks_close(flash_attention_streaming(q, k, v, kv_len),
                         attention_reference(q, k, v, kv_len))


def test_k2_mask_with_strongly_negative_scores(device):
    """Every valid score ~ -120 (34 * -80 / sqrt(512)), kv_len < n_kv: a
    zero-filled mask would pull the max to 0 and NaN the rows."""
    q, k, v = _qkv(device, 1, 1, 300, 512, 512, seed=23)
    q[..., 0] += 34.0
    k[..., 0] = -80.0
    out = flash_attention_streaming(q, k, v, 450)
    ref = attention_reference(q, k[:, :, :450], v[:, :, :450])
    _assert_close(out, ref)
    _assert_blocks_close(out, ref)


def test_joint_attention_routes_by_head_dim(device):
    q, k, v = _qkv(device, 1, 1, 64, 64, 64, seed=1)
    before = flash_attention.launches
    joint_attention(q, k, v)
    assert flash_attention.launches == before + 1
    q, k, v = _qkv(device, 1, 1, 64, 64, 512, seed=1)
    before = flash_attention_streaming.launches
    joint_attention(q, k, v)
    assert flash_attention_streaming.launches == before + 1
    q, k, v = _qkv(device, 1, 1, 64, 64, 96, seed=1)
    with pytest.raises(ValueError, match="head_dim 96"):
        joint_attention(q, k, v)


def test_wrappers_raise_on_what_the_kernel_does_not_take(device):
    q, k, v = _qkv(device, 1, 2, 64, 64, 64, seed=2)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_streaming(q, k, v)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, k, v, 0)
    # TMA takes 16-byte aligned tensors: the kernel's entry refuses the launch
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=device)[1:].view(q.shape)
    with pytest.raises(RuntimeError, match="misaligned"):
        flash_attention(shifted.copy_(q), k, v)
    q5, k5, v5 = _qkv(device, 1, 1, 64, 64, 512, seed=2)
    shifted = torch.empty(q5.numel() + 1, dtype=q5.dtype, device=device)[1:].view(q5.shape)
    with pytest.raises(RuntimeError, match="misaligned"):
        flash_attention_streaming(q5, k5, shifted.copy_(v5))
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_with_stats(q, k, v, 65)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_with_stats(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                   v[..., :32].contiguous())


def test_kernels_refuse_operands_that_require_grad(device):
    """No kernel has a backward: with grad mode on, an operand that requires
    grad makes every wrapper raise (its output would silently carry no
    gradient); under torch.no_grad() the same call launches."""
    q, k, v = _qkv(device, 1, 2, 64, 128, 64, seed=40)
    q5, k5, v5 = _qkv(device, 1, 1, 64, 128, 512, seed=41)
    g = torch.Generator(device=device).manual_seed(42)
    a, b_t = _int8(g, device, 64, 64), _int8(g, device, 32, 64)
    x_scale, w_scale = torch.ones(64, device=device), torch.ones(32, device=device)
    abf, bbf = a.to(torch.bfloat16), b_t.to(torch.bfloat16)
    qi, sq = _quant_rows(q.float())
    ki, sk = _quant_rows(k)
    sq, sk = sq[..., 0].contiguous(), sk[..., 0].contiguous()
    rb = torch.linalg.vector_norm(q.float(), dim=-1) * torch.linalg.vector_norm(
        k.float(), dim=-1).amax(-1)[..., None]
    calls = [
        (flash_attention, lambda x: flash_attention(x, k, v), q),
        (flash_attention_streaming, lambda x: flash_attention_streaming(q5, k5, x), v5),
        (flash_attention_with_stats, lambda x: flash_attention_with_stats(q, x, v), k),
        (int8_gemm, lambda x: int8_gemm(a, b_t, x, w_scale), x_scale),
        (bf16_gemm, lambda x: bf16_gemm(x, bbf), abf),
        (attention_strided, lambda x: attention_strided(x, k, v), q),
        (attention_maxfree, lambda x: attention_maxfree(q, k, v, x), rb),
        (attention_int8qk, lambda x: attention_int8qk(qi, ki, x, sq, sk), v),
        (attention_probe, lambda x: attention_probe(q, k, x, "qk_only"), v),
    ]
    for wrapper, call, operand in calls:
        leaf = operand.clone().requires_grad_()
        before = wrapper.launches
        with pytest.raises(RuntimeError, match="no backward.*ROADMAP queue 1, item 9"):
            call(leaf)
        assert wrapper.launches == before
        with torch.no_grad():
            call(leaf)
        call(operand)  # an operand without grad launches with grad mode on
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2, wrapper.__name__


# (M, K, N): the SD3 1024 px image rows (batch 1, CFG 2) against the qkv/out,
# FF proj_in and FF proj_out weights, the text rows, batch 2's rows (the
# twelve shapes chip_smoke.py times), tails, and SD3.5-large's shapes
GEMM_SHAPES = [
    (8192, 1536, 1536), (8192, 1536, 6144), (8192, 6144, 1536),
    (666, 1536, 1536), (666, 1536, 6144), (666, 6144, 1536),
    (16384, 1536, 1536), (16384, 1536, 6144), (16384, 6144, 1536),
    (1332, 1536, 1536), (1332, 1536, 6144), (1332, 6144, 1536),
    (1, 1536, 1536), (8193, 1536, 1536), (77, 96, 40),  # tails; N and K off the tile
    # K5's persistent grid: 133 output tiles of 128 x 256, one past a wave of
    # 132 SMs; N at and one past a tile
    (17024, 64, 256), (300, 128, 256), (300, 128, 257),
    # SD3.5-large at 1024 px, batch 1 (CFG 2): N 2432 ends in half a 256-column tile
    (8192, 2432, 2432), (8192, 2432, 9728), (8192, 9728, 2432),
    (666, 2432, 2432), (666, 2432, 9728), (666, 9728, 2432),
]


def _int8(g, device, *shape):
    return torch.randint(-127, 128, shape, generator=g, device=device, dtype=torch.int8)


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_k4_matches_plain(device, m, k, n):
    g = torch.Generator(device=device).manual_seed(m + n)
    a, b_t = _int8(g, device, m, k), _int8(g, device, n, k)
    before = int8_gemm.launches
    acc = int8_gemm(a, b_t)
    torch.cuda.synchronize()
    assert int8_gemm.launches == before + 1
    assert acc.dtype == torch.int32 and torch.equal(acc, int8_gemm_reference(a, b_t))
    x_scale = torch.rand(m, generator=g, device=device) * 0.01 + 1e-3
    w_scale = torch.rand(n, generator=g, device=device) * 0.01 + 1e-3
    bias = torch.randn(n, generator=g, device=device).to(torch.bfloat16)
    for b in (bias, None):
        out = int8_gemm(a, b_t, x_scale, w_scale, b)
        ref = int8_gemm_reference(a, b_t, x_scale, w_scale, b)
        assert out.dtype == torch.bfloat16
        bound = ref.float().abs() * 2.0**-8
        assert ((out.float() - ref.float()).abs() <= bound).all()


@pytest.mark.parametrize("n", [256, 257])
def test_k4_extreme_operands(device, n):
    """Every operand +-127 at K 6144: rows of a and b of one sign give the
    accumulator's largest magnitude, 127^2 * 6144 > 2^24, where its float
    conversion rounds; rows of random signs give the rest. N 256 stores the
    dequant through TMA, N 257 directly."""
    m, k = 300, 6144
    g = torch.Generator(device=device).manual_seed(n)
    sign = lambda *shape: torch.randint(0, 2, shape, generator=g, device=device) * 2 - 1
    a = (127 * sign(m, k)).to(torch.int8)
    b_t = (127 * sign(n, k)).to(torch.int8)
    a[:64] = (127 * sign(64, 1)).to(torch.int8)
    b_t[:64] = (127 * sign(64, 1)).to(torch.int8)
    acc = int8_gemm(a, b_t)
    ref = int8_gemm_reference(a, b_t)
    torch.cuda.synchronize()
    assert acc.dtype == torch.int32 and torch.equal(acc, ref)
    assert ref.abs().max().item() == 127 * 127 * k
    x_scale = torch.rand(m, generator=g, device=device) * 0.01 + 1e-3
    w_scale = torch.rand(n, generator=g, device=device) * 0.01 + 1e-3
    bias = torch.randn(n, generator=g, device=device).to(torch.bfloat16)
    for b in (bias, None):
        out = int8_gemm(a, b_t, x_scale, w_scale, b)
        deq = int8_gemm_reference(a, b_t, x_scale, w_scale, b)
        assert out.dtype == torch.bfloat16
        assert ((out.float() - deq.float()).abs() <= deq.float().abs() * 2.0**-8).all()


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_k5_matches_plain(device, m, k, n):
    g = torch.Generator(device=device).manual_seed(m + n + 1)
    a = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
    b_t = (torch.randn(n, k, generator=g, device=device) * 0.02).to(torch.bfloat16)
    before = bf16_gemm.launches
    out = bf16_gemm(a, b_t)
    torch.cuda.synchronize()
    assert bf16_gemm.launches == before + 1
    ref = bf16_gemm_reference(a, b_t).float()
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert (out.float() - ref).abs().max() <= RTOL * ref.abs().max()


def test_gemm_wrappers_raise_on_what_the_kernel_does_not_take(device):
    g = torch.Generator(device=device).manual_seed(3)
    a, b_t = _int8(g, device, 64, 64), _int8(g, device, 32, 64)
    with pytest.raises(TypeError, match="int8"):
        int8_gemm(a.float(), b_t.float())
    with pytest.raises(ValueError, match="multiple of 32"):
        int8_gemm(a[:, :48].contiguous(), b_t[:, :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        int8_gemm(a.t(), b_t[:, :64])
    with pytest.raises(ValueError, match="differ in K"):
        int8_gemm(a, b_t[:, :32].contiguous())
    with pytest.raises(ValueError, match="x_scale"):
        int8_gemm(a, b_t, torch.ones(63, device=device), torch.ones(32, device=device))
    with pytest.raises(TypeError, match="out_dtype"):
        int8_gemm(a, b_t, torch.ones(64, device=device), torch.ones(32, device=device),
                  out_dtype=torch.float32)
    with pytest.raises(ValueError, match="bias"):
        int8_gemm(a, b_t, torch.ones(64, device=device), torch.ones(32, device=device),
                  torch.ones(32, device=device))
    x, w = a.to(torch.bfloat16), b_t.to(torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        bf16_gemm(x.float(), w.float())
    with pytest.raises(ValueError, match="multiple of 16"):
        bf16_gemm(x[:, :40].contiguous(), w[:, :40].contiguous())
    with pytest.raises(ValueError, match="aligned"):
        bf16_gemm(x.view(-1)[4:4 + 63 * 64].view(63, 64), w)


# ------------------------------------------------------------ K6-K9

def _layout(t, kind):
    """The same values as the (b, h, n, d) tensor t, held in another layout:
    "nat" (b, h, n, d); "T" (b, h, d, n), token axis contiguous; "packed"
    (b, n, h, d), the projections' (b, n, h*d)."""
    if kind == "nat":
        return t.contiguous()
    if kind == "T":
        return t.transpose(-1, -2).contiguous().transpose(-1, -2)
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def _ones_column(v, kv_len, width=65):
    """v with the studies' ones column at 64 (zero at or past kv_len) and
    zeros to ``width``."""
    b, h, n, _ = v.shape
    ones = (torch.arange(n, device=v.device) < kv_len).to(v.dtype)
    extra = torch.zeros(b, h, n, width - 64, dtype=v.dtype, device=v.device)
    extra[..., 0] = ones
    return torch.cat([v, extra], dim=-1)


def _rel_close(out, ref, tol=RTOL):
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max()
    assert err <= tol * ref.float().abs().max(), (err, ref.float().abs().max())


def _prescaled(q):
    """q in the exp2 domain the study kernels take: q * log2(e)/sqrt(64)."""
    return (q.float() * (1.4426950408889634 / 8.0)).to(q.dtype)


# (q, k, v, out) layouts: the studies' natural, transposed (vT, round4),
# K^T, packed, natural-in/transposed-out; v "nat"/"T" with its ones column
K6_LAYOUTS = [
    ("nat", "nat", "nat", "nat"),
    ("T", "nat", "T", "T"),
    ("nat", "T", "nat", "nat"),
    ("packed", "packed", "packed", "packed"),
    ("nat", "nat", "nat", "T"),
    ("T", "T", "T", "nat"),
]


@pytest.mark.parametrize("layouts", K6_LAYOUTS)
@pytest.mark.parametrize("v_width", [64, 65, 80])
@pytest.mark.parametrize("shape,kv_len", [((1, 2, 333, 437), 400), ((2, 3, 64, 128), None)])
def test_k6_layouts_match_plain(device, layouts, v_width, shape, kv_len):
    b, h, n_q, n_kv = shape
    q, k, v = _qkv(device, b, h, n_q, n_kv, 64, seed=n_q + v_width)
    q = _prescaled(q)
    if v_width > 64:
        v = _ones_column(v, n_kv if kv_len is None else kv_len, v_width)
    lq, lk, lv, lo = layouts
    qv, kv_, vv = _layout(q, lq), _layout(k, lk), _layout(v, lv)
    out = _layout(torch.empty(b, h, n_q, 64, device=device, dtype=torch.bfloat16), lo)
    before = attention_strided.launches
    got = attention_strided(qv, kv_, vv, kv_len, out=out)
    torch.cuda.synchronize()
    assert got is out and attention_strided.launches == before + 1
    _rel_close(got, attention_strided_reference(q, k, v, kv_len))


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("score_bf16", [False, True])
def test_k6_modes_match_plain(device, streams, score_bf16):
    q, k, v = _qkv(device, 2, 3, 200, 389, 64, seed=7)
    q = _prescaled(q)
    kv_len = 333
    for kv_len_ in (kv_len, 1, None):
        got = attention_strided(q, k, v, kv_len_, score_bf16=score_bf16, streams=streams)
        ref = attention_strided_reference(q, k, v, kv_len_, score_bf16=score_bf16)
        _rel_close(got, ref)


def test_k6_study_shape_transposed_two_streams(device):
    """attn_round4's split_call: q^T, k, v^T with the ones row, o^T, at the
    SD3 1024 px study shape."""
    q, k, v = _qkv(device, 2, 24, 4480, 4480, 64, seed=8)
    q, v = _prescaled(q), _ones_column(v, 4480, 80)
    out = _layout(torch.empty_like(q), "T")
    got = attention_strided(_layout(q, "T"), k, _layout(v, "T"), streams=2, out=out)
    _rel_close(got, attention_strided_reference(q, k, v))


def test_k6_mask_with_strongly_negative_scores(device):
    q, k, v = _qkv(device, 1, 2, 128, 256, 64, seed=20)
    q[..., 0] += 12.0
    k[..., 0] = -80.0
    qs = _prescaled(q)
    for streams in (1, 2):
        got = attention_strided(_layout(qs, "T"), _layout(k, "T"), v, 200, streams=streams)
        # K1's plain softmax on the same (rounded) exp2-domain q, in fp32
        q_nat = qs.float() * (8.0 / 1.4426950408889634)
        _rel_close(got, attention_reference(q_nat, k[:, :, :200], v[:, :, :200]))


def _misaligned(t):
    """The same values as t, with t's strides (a permutation of a
    contiguous layout), in a view whose storage offset is 2 bytes (one
    bf16, or two int8) past a 16-byte boundary."""
    n = 1 if t.dtype == torch.bfloat16 else 2
    flat = torch.empty(t.numel() + n, dtype=t.dtype, device=t.device)
    view = flat.as_strided(t.shape, t.stride(), n)
    view.copy_(t)
    return view


# (case, the views' layouts and what is misaligned, the routes K6 takes)
K6_ROUTES = [
    ("transposed, n 333", ("T", "T", "T", "T"), (), "plain plain plain plain"),
    ("V_ext 65 natural", ("nat", "nat", "nat", "nat"), (), "tma tma staged tma"),
    ("V_ext 65 natural, n_kv 437", ("nat", "nat", "nat", "nat"), (), "tma tma plain tma"),
    ("q misaligned", ("nat", "nat", "nat", "nat"), ("q",), "plain tma tma tma"),
    ("k misaligned", ("nat", "nat", "nat", "nat"), ("k",), "tma plain tma tma"),
    ("v misaligned", ("nat", "nat", "nat", "nat"), ("v",), "tma tma plain tma"),
    ("o misaligned", ("nat", "nat", "nat", "nat"), ("o",), "tma tma tma plain"),
    ("q^T, K^T misaligned", ("T", "T", "nat", "nat"), ("q", "k"), "plain plain tma tma"),
    ("V^T, o^T misaligned", ("nat", "nat", "T", "T"), ("v", "o"), "tma tma plain plain"),
]


@pytest.mark.parametrize("case,layouts,misaligned,routes", K6_ROUTES,
                         ids=[c[0] for c in K6_ROUTES])
def test_k6_load_routes_match_plain(device, case, layouts, misaligned, routes):
    """Each operand through each load route: a 333-token transposed view
    (666-byte strides), V_ext 65 natural (130-byte rows) at n_kv 437 and
    views 2 bytes off 16-byte alignment take the plain loads; V_ext 65 at
    n_kv 448 (a multiple of 8) is staged through TMA; the rest TMA."""
    n_q, n_kv = (333, 437) if "333" in case or "437" in case else (320, 448)
    q, k, v = _qkv(device, 1, 2, n_q, n_kv, 64, seed=30)
    q = _prescaled(q)
    if "65" in case:
        v = _ones_column(v, 400)
    ops = dict(q=_layout(q, layouts[0]), k=_layout(k, layouts[1]), v=_layout(v, layouts[2]),
               o=_layout(torch.empty_like(q), layouts[3]))
    for name in misaligned:
        ops[name] = _misaligned(ops[name])
    assert studies_routes(ops["q"], ops["k"], ops["v"], ops["o"]) == dict(
        zip("qkvo", routes.split()))
    got = attention_strided(ops["q"], ops["k"], ops["v"], 400, out=ops["o"])
    _rel_close(got, attention_strided_reference(q, k, v, 400))


def test_k6_study_shape_views_take_tma(device):
    """The study's views at (2, 24, 4480, 64): natural, packed (b, n, h*d),
    K^T, q^T / V^T_ext 80 / o^T and V_ext 80 all load through TMA."""
    q, k, v = _qkv(device, 2, 24, 4480, 4480, 64, seed=31)
    q = _prescaled(q)
    v80 = _ones_column(v, 4429, 80)
    o = torch.empty_like(q)
    for views in ((q, k, v, o), (q, _layout(k, "T"), v80, o),
                  tuple(_layout(x, "packed") for x in (q, k, v, o)),
                  (_layout(q, "T"), k, _layout(v80, "T"), _layout(o, "T"))):
        assert set(studies_routes(*views).values()) == {"tma"}, [x.stride() for x in views]
    got = attention_strided(_layout(q, "T"), k, _layout(v80, "T"), 4429, out=_layout(o, "T"))
    _rel_close(got, attention_strided_reference(q, k, v80, 4429))


@pytest.mark.parametrize("out_layout", ["nat", "T"])
@pytest.mark.parametrize("score_bf16", [False, True])
@pytest.mark.parametrize("streams", [1, 2])
def test_k6_streams_soft_and_out_layout(device, streams, score_bf16, out_layout):
    q, k, v = _qkv(device, 2, 3, 333, 700, 64, seed=32)
    q, v = _prescaled(q), _ones_column(v, 650, 80)
    out = _layout(torch.empty_like(q), out_layout)
    for kv_len in (650, 100):  # six tiles (even and odd streams), one tile
        got = attention_strided(_layout(q, "T"), k, _layout(v, "T"), kv_len,
                                score_bf16=score_bf16, streams=streams, out=out)
        _rel_close(got, attention_strided_reference(q, k, v, kv_len, score_bf16=score_bf16))


@pytest.mark.parametrize("k_scale_first", [False, True])
@pytest.mark.parametrize("q_layout", ["nat", "T"])
def test_k8_study_shape_both_q_layouts(device, q_layout, k_scale_first):
    """K8 at the study shape (2, 24, 4480, 64), kv_len 4429, with q natural
    (TMA) or q^T (transposed into shared memory), either scale order."""
    q, k, v = _qkv(device, 2, 24, 4480, 4480, 64, seed=33)
    qi, sq = _quant_rows(_prescaled(q).float())
    ki, sk = _quant_rows(k)
    sq, sk = sq[..., 0].contiguous(), sk[..., 0].contiguous()
    v = _ones_column(v, 4429)
    qv = _layout(qi, q_layout)
    out = torch.empty(2, 24, 4480, 64, dtype=torch.bfloat16, device=device)
    assert studies_routes(qv, ki, v, out) == dict(
        q="tma" if q_layout == "nat" else "plain", k="tma", v="staged", o="tma")
    got = attention_int8qk(qv, ki, v, sq, sk, 4429, k_scale_first=k_scale_first, out=out)
    _rel_close(got, attention_int8qk_reference(qi, ki, v, sq, sk, 4429,
                                               k_scale_first=k_scale_first))


@pytest.mark.parametrize("misaligned", ["q", "k"])
def test_k8_plain_load_route_is_exact(device, misaligned):
    """int8 q or k 2 bytes off 16-byte alignment: the producer copies it
    into the 64-byte-swizzled tile with plain loads; S stays exact."""
    q, k, v = _qkv(device, 1, 2, 333, 437, 64, seed=34)
    qi, sq = _quant_rows(_prescaled(q).float())
    ki, sk = _quant_rows(k)
    sq, sk = sq[..., 0].contiguous(), sk[..., 0].contiguous()
    v = _ones_column(v, 400)
    ops = dict(q=qi, k=ki)
    ops[misaligned] = _misaligned(ops[misaligned])
    out = torch.empty(1, 2, 333, 64, dtype=torch.bfloat16, device=device)
    assert studies_routes(ops["q"], ops["k"], v, out)[misaligned] == "plain"
    scores = torch.empty(1, 2, 333, 437, dtype=torch.int32, device=device)
    got = attention_int8qk(ops["q"], ops["k"], v, sq, sk, 400, scores_out=scores, out=out)
    torch.cuda.synchronize()
    assert torch.equal(scores, int8_scores(qi, ki))
    _rel_close(got, attention_int8qk_reference(qi, ki, v, sq, sk, 400))


def test_sm90_helpers_alone(device):
    """sm90.cuh's new pieces on one 64-row product each: int8 tiles through
    64-byte-swizzled TMA boxes into wgmma m64n128k32 s8 (exact), and an
    MN-major (transposed) A into wgmma m64n128k16 bf16 against torch.matmul
    in fp32."""
    from tpdm_tpu_torch.ops import _build

    lib = _build.load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    g = torch.Generator(device=device).manual_seed(35)
    a8 = torch.randint(-128, 128, (64, 64), generator=g, device=device).to(torch.int8)
    b8 = torch.randint(-128, 128, (128, 64), generator=g, device=device).to(torch.int8)
    out8 = torch.empty(64, 128, dtype=torch.int32, device=device)
    assert lib.tpdm_sm90_helper_check(0, a8.data_ptr(), b8.data_ptr(), out8.data_ptr(),
                                      stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out8, a8.double().matmul(b8.double().t()).to(torch.int32))
    at = torch.randn(64, 64, generator=g, device=device).to(torch.bfloat16)  # A^T: (K, M)
    b = torch.randn(128, 64, generator=g, device=device).to(torch.bfloat16)
    out = torch.empty(64, 128, dtype=torch.float32, device=device)
    assert lib.tpdm_sm90_helper_check(1, at.data_ptr(), b.data_ptr(), out.data_ptr(),
                                      stream) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, at.float().t().matmul(b.float().t()), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("soft_bf16", [False, True])
@pytest.mark.parametrize("layouts", [("nat", "nat", "nat", "nat"), ("T", "nat", "T", "T"),
                                     ("nat", "nat", "T", "nat")])
def test_k7_matches_plain(device, soft_bf16, layouts):
    q, k, v = _qkv(device, 2, 3, 333, 437, 64, seed=9)
    q, v = _prescaled(q), _ones_column(v, 400)
    rb = torch.linalg.vector_norm(q.float(), dim=-1) * torch.linalg.vector_norm(
        k.float(), dim=-1).amax(-1)[..., None]
    lq, lk, lv, lo = layouts
    out = _layout(torch.empty_like(q), lo)
    before = attention_maxfree.launches
    got = attention_maxfree(_layout(q, lq), _layout(k, lk), _layout(v, lv), rb, 400,
                            soft_bf16=soft_bf16, out=out)
    torch.cuda.synchronize()
    assert attention_maxfree.launches == before + 1
    _rel_close(got, attention_maxfree_reference(q, k, v, rb, 400, soft_bf16=soft_bf16))


@pytest.mark.parametrize("soft_bf16", [False, True])
@pytest.mark.parametrize("layouts,kv_len,v_width,routes", [
    (("nat", "nat", "nat", "nat"), 4429, 65, "tma tma staged tma"),  # v3
    (("T", "nat", "T", "T"), None, 80, "tma tma tma tma"),  # vTm, vTmc on q^T
    (("nat", "nat", "T", "nat"), None, 80, "tma tma tma tma"),  # attn_round3b.attn_Tm's views
], ids=["natural", "transposed", "V^T"])
def test_k7_study_shape(device, soft_bf16, layouts, kv_len, v_width, routes):
    """K7 at the study shape (2, 24, 4480, 64) on the layouts the studies
    pass: v3's natural views with V_ext 65 (staged) and kv_len 4429; q^T /
    V^T_ext 80 / o^T; and attn_Tm's, whose q^T arrives as a view of a
    natural q, with V^T_ext 80; each with the fp32 and the bf16 softmax."""
    q, k, v = _qkv(device, 2, 24, 4480, 4480, 64, seed=36)
    q = _prescaled(q)
    v = _ones_column(v, kv_len or 4480, v_width)
    rb = torch.linalg.vector_norm(q.float(), dim=-1) * torch.linalg.vector_norm(
        k.float(), dim=-1).amax(-1)[..., None]
    lq, lk, lv, lo = layouts
    views = (_layout(q, lq), _layout(k, lk), _layout(v, lv),
             _layout(torch.empty_like(q), lo))
    assert studies_routes(*views) == dict(zip("qkvo", routes.split()))
    got = attention_maxfree(*views[:3], rb, kv_len, soft_bf16=soft_bf16, out=views[3])
    _rel_close(got, attention_maxfree_reference(q, k, v, rb, kv_len, soft_bf16=soft_bf16))


@pytest.mark.parametrize("q_layout", ["nat", "T"])
@pytest.mark.parametrize("shape,kv_len", [((1, 2, 333, 437), 400), ((2, 24, 4480, 4480), None)])
def test_k8_matches_plain_and_its_scores_are_exact(device, q_layout, shape, kv_len):
    b, h, n_q, n_kv = shape
    q, k, v = _qkv(device, b, h, n_q, n_kv, 64, seed=10)
    qi, sq = _quant_rows(q.float() * (1.4426950408889634 / 8.0))
    ki, sk = _quant_rows(k)
    sq, sk = sq[..., 0].contiguous(), sk[..., 0].contiguous()
    v = _ones_column(v, n_kv if kv_len is None else kv_len)
    scores = torch.empty(b, h, n_q, n_kv, dtype=torch.int32, device=device)
    before = attention_int8qk.launches
    got = attention_int8qk(_layout(qi, q_layout), ki, v, sq, sk, kv_len,
                           k_scale_first=q_layout == "T", scores_out=scores)
    torch.cuda.synchronize()
    assert attention_int8qk.launches == before + 1
    assert torch.equal(scores, int8_scores(qi, ki))
    _rel_close(got, attention_int8qk_reference(qi, ki, v, sq, sk, kv_len,
                                               k_scale_first=q_layout == "T"))


@pytest.mark.parametrize("k_layout", ["nat", "T"])
@pytest.mark.parametrize("mode", ["qk_only", "noexp"])
@pytest.mark.parametrize("n_kv,chunk", [(4480, 640), (448, 128), (300, 64)])
def test_k9_matches_plain(device, k_layout, mode, n_kv, chunk):
    q, k, v = _qkv(device, 1, 4, 333, n_kv, 64, seed=11)
    q, v = _prescaled(q), _ones_column(v, n_kv)
    before = attention_probe.launches
    got = attention_probe(q, _layout(k, k_layout), v, mode, chunk)
    torch.cuda.synchronize()
    assert attention_probe.launches == before + 1
    ref = attention_probe_reference(q, k, v, mode, chunk)
    if mode == "qk_only":
        _rel_close(got, ref)
    else:
        assert torch.isfinite(got.float()).all()
        rms = lambda x: x.float().pow(2).mean().sqrt()
        assert rms(got.float() - ref.float()) <= RTOL * rms(ref)


@pytest.mark.parametrize("mode", ["qk_only", "noexp"])
@pytest.mark.parametrize("n_kv,k_layout,v_route", [
    (4429, "nat", "plain"), (4480, "nat", "staged"), (4429, "T", "plain")])
def test_k9_chunks_start_mid_tile(device, mode, n_kv, k_layout, v_route):
    """chunk 192: every other chunk starts in the middle of a 128-token
    tile, so a tile's columns belong to two chunks (noexp loads such a
    tile in both chunks' passes); n_kv 4429 leaves the last tile ragged.
    V_ext 65 is staged at n_kv 4480 and takes the plain loads at 4429."""
    q, k, v = _qkv(device, 1, 4, 333, n_kv, 64, seed=37)
    q, v = _prescaled(q), _ones_column(v, n_kv)
    kv = _layout(k, k_layout)
    assert studies_routes(q, kv, v, torch.empty_like(q))["v"] == v_route
    got = attention_probe(q, kv, v, mode, 192)
    ref = attention_probe_reference(q, k, v, mode, 192, dtype=torch.float64)
    if mode == "qk_only":
        _rel_close(got, ref)
    else:
        assert torch.isfinite(got.float()).all()
        rms = lambda x: x.float().pow(2).mean().sqrt()
        assert rms(got.float() - ref.float()) <= RTOL * rms(ref)


def test_study_wrappers_raise_on_what_the_kernels_do_not_take(device):
    q, k, v = _qkv(device, 1, 2, 64, 64, 64, seed=12)
    with pytest.raises(TypeError, match="bfloat16"):
        attention_strided(q.float(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        attention_strided(q.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2), k, v)
    with pytest.raises(ValueError, match="kv_len"):
        attention_strided(q, k, v, 65)
    with pytest.raises(ValueError, match="streams"):
        attention_strided(q, k, v, streams=3)
    with pytest.raises(ValueError, match="last dim"):
        attention_strided(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="out"):
        attention_strided(q, k, v, out=torch.empty(1, 2, 63, 64, device=device,
                                                   dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="rb"):
        attention_maxfree(q, k, v, torch.zeros(1, 2, 63, device=device))
    rb = torch.zeros(1, 2, 64, device=device)
    with pytest.raises(ValueError, match=r"\(q, k\^T, v\) are not instantiated"):
        attention_maxfree(q, _layout(k, "T"), v, rb)
    with pytest.raises(ValueError, match=r"\(q\^T, k, v\) are not instantiated"):
        attention_maxfree(_layout(q, "T"), k, v, rb)
    qi, ki = q.to(torch.int8), k.to(torch.int8)
    sq = torch.ones(1, 2, 64, device=device)
    with pytest.raises(ValueError, match="dim axis"):
        attention_int8qk(qi, _layout(ki, "T"), v, sq, sq)
    with pytest.raises(ValueError, match="sk"):
        attention_int8qk(qi, ki, v, sq, sq[..., :63])
    with pytest.raises(ValueError, match="multiple of 64"):
        attention_probe(q, k, v, "qk_only", 96)
    with pytest.raises(ValueError, match="65 wide"):
        attention_probe(q, k, v, "noexp", 64)
    with pytest.raises(ValueError, match="mode"):
        attention_probe(q, k, v, "exp", 64)
    with pytest.raises(ValueError, match=r"\(q\^T, k, v\) are not instantiated"):
        attention_probe(_layout(q, "T"), k, v, "qk_only", 64)
    with pytest.raises(ValueError, match=r"\(q, k\^T, v\^T\) are not instantiated"):
        attention_probe(q, _layout(k, "T"), _layout(v, "T"), "noexp", 64)


@pytest.mark.parametrize("bits,act_quant", [(8, True), (4, True), (8, False)])
def test_fused_lora_beside_a_quantised_layer(device, bits, act_quant):
    """The fused LoRA path over a quantised backbone (``models/lora.py:
    lora_interceptor`` on a prequantised ``DenseMaybeQuant``): the layer's
    product runs on K4 (W8A8) or K5 (int4, and the weight-only int8 of the
    quantised T5 tower), one launch a call, the bank's row 0 leaves the
    layer's output as it is to the bit, and the output equals the plain
    versions of the same layer on the CPU plus the fp32 delta within 2e-2 of
    its largest magnitude (K5's bound)."""
    import copy

    from tpdm_tpu_torch.models.lora import lora_interceptor, stack_adapters
    from tpdm_tpu_torch.ops.quant import DenseMaybeQuant

    g = torch.Generator(device=device).manual_seed(bits + act_quant)
    holder = torch.nn.Module()
    holder.proj = DenseMaybeQuant(1536, 2048, bits=bits, act_quant=act_quant,
                                  bias=act_quant).to(device=device, dtype=torch.bfloat16)
    holder.proj.quantize_()
    lora = {"proj": {"a": torch.randn(1536, 16, generator=g, device=device) / 1536 ** 0.5,
                     "b": 0.05 * torch.randn(16, 2048, generator=g, device=device)}}
    bank, _ = stack_adapters({"x": (lora, 1.5)})
    ids = torch.tensor([0, 1, 1], device=device)
    x = torch.randn(3, 333, 1536, generator=g, device=device).to(torch.bfloat16)
    kernel = int8_gemm if bits == 8 and act_quant else bf16_gemm
    with torch.no_grad():
        base = holder.proj(x)
        before = kernel.launches
        with lora_interceptor(holder, bank, ids):
            out = holder.proj(x)
        assert kernel.launches == before + 1
        cpu = copy.deepcopy(holder).cpu()
        with lora_interceptor(cpu, {"proj": {k: v.cpu() for k, v in bank["proj"].items()}},
                              ids.cpu()):
            ref = cpu.proj(x.cpu())
    assert out.dtype == torch.bfloat16 and torch.equal(out[0], base[0])
    err = (out.float().cpu() - ref.float()).abs().max() / ref.float().abs().max()
    assert err <= 2e-2, err
    assert (out[1:].float() - base[1:].float()).abs().max() > 0.1 * base.float().abs().max()
