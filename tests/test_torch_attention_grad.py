"""The gradients the port's LoRA trainers take, against the JAX package's.

The plain versions of K1's and K2's backward (autograd through
``attention_reference``, the padded head-dim wrapper, and
``attention_backward_chunked``) against ``jax.vjp`` of JAX's
``attention_reference`` and its ``attention_backward_chunked``; the
streaming kernel's kv block; the differentiable resize against
``jax.image.resize(method="cubic")``; ``score_grad`` and the DRaFT
ImageReward ``reward_apply`` (values and input gradients) on a toy
ImageReward; the toy VAE's differentiable decode with a 512-wide mid block
(K2's route, the chunked backward); the differentiable LoRA merge and the
MMDiT's per-block remat under a merged-weights ``functional_call``.

fp32 throughout, rtol 1e-4 / atol 1e-5 (atol scaled by the reference's
largest magnitude where it exceeds 1, ``_torch_parity.close``): the two
programs sum in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, random_variables, t
from tpdm_tpu.models.vae import VAE as JVAE, VAEConfig as JVAEConfig
from tpdm_tpu.ops import attention as jattn
from tpdm_tpu.rewards.bert import BertMedConfig as JBertMedConfig
from tpdm_tpu.rewards.image_reward import ImageRewardModel as JImageRewardModel
from tpdm_tpu.rewards.image_reward import ImageRewardNet as JImageRewardNet
from tpdm_tpu.rewards.vit import ViTConfig as JViTConfig
from tpdm_tpu.train.draft import build_image_reward_grad_apply as jax_reward_grad_apply
from tpdm_tpu_torch.models.lora import apply_lora, call_merged, merge_lora
from tpdm_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
from tpdm_tpu_torch.models.vae import VAE, VAEConfig, make_fast_decode
from tpdm_tpu_torch.ops import _build
from tpdm_tpu_torch.ops.attention import (
    attention_backward_chunked,
    attention_reference,
    flash_attention,
    flash_attention_backward,
    flash_attention_streaming,
    streaming_block_kv,
)
from tpdm_tpu_torch.rewards import BertMedConfig, ImageRewardModel, ViTConfig
from tpdm_tpu_torch.rewards.image_reward import ImageRewardNet
from tpdm_tpu_torch.train.draft import build_image_reward_grad_apply, resize_cubic
from tpdm_tpu_torch.utils.convert import image_reward_from_jax, vae_from_jax


def _qkvo(shape, seed):
    rng = np.random.default_rng(seed)
    b, h, n_q, n_kv, d = shape
    mk = lambda n: rng.standard_normal((b, h, n, d)).astype(np.float32)
    return mk(n_q), mk(n_kv), mk(n_kv), mk(n_q)


def _jax_vjp(q, k, v, do, kv_len):
    _, vjp = jax.vjp(lambda q, k, v: jattn.attention_reference(q, k, v, kv_len), q, k, v)
    return vjp(do)


@pytest.mark.parametrize("kv_len", [None, 13])
def test_k1_plain_grads_match_jax(kv_len):
    """``flash_attention`` on CPU tensors under autograd (the plain version)
    against jax.vjp of JAX's attention_reference, JAX's ``_bwd``."""
    q, k, v, do = _qkvo((2, 3, 24, 20, 16), seed=kv_len or 0)
    want = _jax_vjp(q, k, v, do, kv_len)
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    flash_attention(*leaves, kv_len).backward(t(do))
    for got, ref in zip(leaves, want):
        close(got.grad, ref)
    if kv_len is not None:  # the masked rows of k and v take no gradient
        assert not leaves[1].grad[:, :, kv_len:].any() and not leaves[2].grad[:, :, kv_len:].any()


def test_k1_backward_plain_version_on_padded_operands():
    """``flash_attention_backward``'s CPU path (its plain version) on
    operands zero-padded to 64 columns, as the padded head dims reach it:
    the true head dim's gradients, zeros past it."""
    q, k, v, do = _qkvo((1, 2, 24, 24, 8), seed=3)
    want = _jax_vjp(q, k, v, do, 17)
    pad = lambda a: torch.nn.functional.pad(t(a), (0, 56))
    got = flash_attention_backward(pad(q), pad(k), pad(v), None, pad(do), None, 17, head_dim=8)
    for g, ref in zip(got, want):
        assert g.shape[-1] == 64 and not g[..., 8:].any()
        close(g[..., :8], ref)


@pytest.mark.parametrize("kv_len", [None, 29])
def test_k2_chunked_backward_matches_jax(kv_len):
    """The port of ``attention_backward_chunked`` against JAX's, over three
    16-column chunks (the last one ragged), and against jax.vjp of the
    dense reference."""
    q, k, v, do = _qkvo((1, 2, 40, 37, 24), seed=7)
    o = np.asarray(jattn.attention_reference(q, k, v, kv_len))
    want = jattn.attention_backward_chunked(q, k, v, o, do, kv_len, chunk=16)
    got = attention_backward_chunked(t(q), t(k), t(v), t(o), t(do), kv_len, chunk=16)
    for g, ref, dense in zip(got, want, _jax_vjp(q, k, v, do, kv_len)):
        close(g, ref)
        close(g, dense)


def test_k2_under_autograd_backpropagates_by_the_chunked_backward(monkeypatch):
    """``flash_attention_streaming`` under autograd on CPU tensors: the
    plain forward, and the chunked backward at the JAX forward's kv block
    (128 at the VAE's d 512, bf16 or fp32, as JAX's ``_streaming_blocks``)."""
    assert streaming_block_kv(512, 2) == jattn._streaming_blocks(512, 2)[1] == 128
    assert streaming_block_kv(512, 4) == jattn._streaming_blocks(512, 4)[1]
    assert streaming_block_kv(64, 2) == jattn._streaming_blocks(64, 2)[1]
    chunks = []
    real = attention_backward_chunked

    def spy(*a, **kw):
        chunks.append(a[-1])
        return real(*a, **kw)

    monkeypatch.setattr("tpdm_tpu_torch.ops.attention.attention_backward_chunked", spy)
    q, k, v, do = _qkvo((1, 1, 20, 20, 16), seed=8)
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention_streaming(*leaves, 15)
    close(out, jattn.attention_reference(q, k, v, 15))
    out.backward(t(do))
    assert chunks == [streaming_block_kv(16, 4)]
    for got, ref in zip(leaves, _jax_vjp(q, k, v, do, 15)):
        close(got.grad, ref)


def test_refuse_grad_names_the_queue_item():
    leaf = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match=r"no backward \(ROADMAP queue 1, item 14\(b\)"):
        _build.refuse_grad("k3", "ROADMAP queue 1, item 14(b): the ring's backward", leaf)
    with torch.no_grad():
        _build.refuse_grad("k3", "item", leaf)
    _build.refuse_grad("k3", "item", leaf.detach())


@pytest.mark.parametrize("src", [1024, 512])
def test_resize_matches_jax_cubic(src):
    """The DRaFT reward's resize to 224 against jax.image.resize's cubic
    (antialiased Keys a = -0.5) on [0, 1] images."""
    x = np.random.default_rng(src).random((1, 3, src, src), dtype=np.float32)
    ref = jax.image.resize(jnp.transpose(x, (0, 2, 3, 1)), (1, 224, 224, 3), method="cubic")
    close(resize_cubic(t(x), 224), np.transpose(np.asarray(ref), (0, 3, 1, 2)))


@pytest.fixture(scope="module")
def reward():
    """A toy JAX ImageReward drawn from a seed and the port's copy, toy ids
    (one row padded) and images in [-1, 1]."""
    vcfg, bcfg = JViTConfig.toy(), JBertMedConfig.toy()
    params = random_variables(JImageRewardNet(vcfg, bcfg).init, 11,
                              jnp.zeros((1, 3, vcfg.image_size, vcfg.image_size)),
                              jnp.zeros((1, 5), jnp.int32))
    jmodel = JImageRewardModel.create(params=params, vit_config=vcfg, bert_config=bcfg)
    net = ImageRewardNet(ViTConfig.toy(), BertMedConfig.toy())
    net.load_state_dict(image_reward_from_jax(jax.device_get(jmodel.params)))
    rng = np.random.default_rng(12)
    ids = rng.integers(1, 50, (2, 7)).astype(np.int32)
    mask = np.ones((2, 7), bool)
    mask[1, 4:] = False
    images = rng.uniform(-1.1, 1.1, (2, 3, 32, 32)).astype(np.float32)
    return jmodel, ImageRewardModel(net.requires_grad_(False)), ids, mask, images


def test_score_grad_matches_jax(reward):
    """``score_grad``: (r - mean) / std without the +3σ shift, and its
    gradient with respect to the pixels, against JAX's."""
    jmodel, model, ids, mask, _ = reward
    px = np.random.default_rng(13).standard_normal((2, 3, 16, 16)).astype(np.float32)
    w = np.array([1.0, -0.5], np.float32)
    fn = lambda p: jmodel.score_grad(jmodel.params, p, jnp.asarray(ids), jnp.asarray(mask))
    ref, ref_g = jax.jit(lambda p, w: (lambda r, f: (r, f(w)[0]))(*jax.vjp(fn, p)))(px, w)
    pixels = t(px).requires_grad_()
    got = model.score_grad(pixels, ids, mask)
    got.backward(t(w))
    close(got, ref)
    close(pixels.grad, ref_g)


def test_image_reward_grad_apply_matches_jax(reward):
    """The DRaFT ImageReward: decoded images in [-1, 1] -> clip -> the cubic
    resize -> CLIP normalisation -> score_grad, and the gradient with
    respect to the images, against JAX's ``build_image_reward_grad_apply``."""
    jmodel, model, ids, _, images = reward
    japply = jax_reward_grad_apply(jmodel)
    fn = lambda x: japply(x, {"reward_ids": jnp.asarray(ids)})
    ref, ref_g = jax.jit(lambda x: (lambda r, f: (r, f(jnp.ones(2))[0]))(*jax.vjp(fn, x)))(images)
    x = t(images).requires_grad_()
    got = build_image_reward_grad_apply(model)(x, {"reward_ids": ids})
    got.sum().backward()
    close(got, ref)
    close(x.grad, ref_g)


def test_vae_decode_gradient_matches_jax():
    """``make_fast_decode`` on an fp32 toy VAE whose mid block is 512 wide
    (K2's route: the streaming wrapper under autograd, the chunked
    backward) against jax.vjp of JAX's decode with the same un-scaling."""
    jcfg = JVAEConfig.toy(block_out_channels=(8, 512), norm_num_groups=4)
    jv = JVAE(jcfg)
    variables = random_variables(jv.init, 21, jnp.zeros((1, 4, 4, 4)), jnp.zeros((1, 3, 8, 8)))
    tv = VAE(VAEConfig.toy(block_out_channels=(8, 512), norm_num_groups=4))
    tv.load_state_dict(vae_from_jax(variables))
    z = np.random.default_rng(22).standard_normal((2, 4, 4, 4)).astype(np.float32)
    dy = np.random.default_rng(23).standard_normal((2, 3, 8, 8)).astype(np.float32)

    def jdecode(z):
        return jv.apply(variables, z / jcfg.scaling_factor + jcfg.shift_factor, method="decode")

    ref, vjp = jax.vjp(jax.jit(jdecode), z)
    (ref_g,) = vjp(dy)
    zt = t(z).requires_grad_()
    got = make_fast_decode(tv.eval())(zt)
    got.backward(t(dy))
    close(got, ref)
    close(zt.grad, ref_g)


def _toy_mmdit_and_lora(remat=False):
    torch.manual_seed(0)
    cfg = MMDiTConfig.toy()
    m = MMDiT(cfg, remat=remat).init_weights(torch.Generator().manual_seed(5)).eval()
    m.requires_grad_(False)
    g = torch.Generator().manual_seed(6)
    lora = {name: {"a": torch.randn(mod.in_features, 2, generator=g) * 0.1,
                   "b": torch.randn(2, mod.out_features, generator=g) * 0.1}
            for name, mod in m.named_modules() if isinstance(mod, torch.nn.Linear)}
    for f in lora.values():
        for v in f.values():
            v.requires_grad_(True)
    return cfg, m, lora


def test_merge_lora_is_apply_lora_under_autograd():
    """``merge_lora`` gives ``apply_lora``'s tensors to the bit and carries
    the gradient to the factors, never to the base weights."""
    _, m, lora = _toy_mmdit_and_lora()
    merged, served = merge_lora(m, lora, 0.5), apply_lora(m, lora, 0.5)
    assert merged.keys() == served.keys()
    for k in merged:
        assert torch.equal(merged[k], served[k]) and served[k].grad_fn is None
    sum(w.sum() for w in merged.values()).backward()
    assert all(f["a"].grad is not None and f["b"].grad is not None for f in lora.values())
    assert all(p.grad is None for p in m.parameters())


def test_mmdit_remat_gives_the_plain_gradients():
    """Per-block remat under a merged-weights ``functional_call``: the
    backward runs after ``call_merged`` has put the module's own weights
    back, and recomputes each block with the merged ones (the LoRA
    gradients equal those without remat)."""
    cfg = MMDiTConfig.toy()
    rng = np.random.default_rng(9)
    args = (t(rng.standard_normal((2, 16, 8, 8)).astype(np.float32)), t(np.array([500.0, 20.0])),
            t(rng.standard_normal((2, 5, cfg.joint_attention_dim)).astype(np.float32)),
            t(rng.standard_normal((2, cfg.pooled_projection_dim)).astype(np.float32)))
    grads = []
    for remat in (False, True):
        _, m, lora = _toy_mmdit_and_lora(remat)
        merged = merge_lora(m, lora)
        vel = call_merged(m, merged, m, *args)[0]
        (vel.square().mean()).backward()
        grads.append([lora[k][w].grad for k in sorted(lora) for w in ("a", "b")])
    for a, b in zip(*grads):
        close(b, a.numpy())
