"""Port vs JAX package: the flash-attention backward and ``flash_mha``.

The port's ``flash_mha`` on the CPU (stats-mode forward, then the plain
version of the backward kernel's steps) is held against ``jax.grad`` of the
JAX package's ``flash_mha`` with its Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` runs them: at a monolithic shape, at
S=1024 and at a strip shape (S=2048 engages ``_bwd_kernel_strips``), with
the saved softmax stats and without (``AFDM_FLASH_STATS=0`` on the JAX side,
``stats=False`` on the port's). Inputs come from a numpy seed.

Tolerances are those of the JAX package's own backward tests: f32 on both
sides, differing in summation order and in where 1/Σ is applied; atol 2e-4
up to S=1024 and 5e-4 for the strip shape, whose dK/dV sum over 2048 rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu.models.blocks import SelfAttention as JSelfAttention
from aliasfree_diffusion_models_pytorch_tpu.ops.flash_attention import flash_mha as j_flash_mha
from aliasfree_diffusion_models_pytorch_tpu_torch.models.blocks import SelfAttention
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import params_from_jax


def _qkv(b, h, s, d, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(n)]


def _port_grads(q, k, v, stats=True, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v))
    loss = (fa.flash_mha(tq, tk, tv, stats=stats).float() ** 2).sum()
    return [g.float().numpy() for g in torch.autograd.grad(loss, (tq, tk, tv))]


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "nostats"])
@pytest.mark.parametrize("b,h,s,d,atol", [
    (2, 4, 256, 8, 2e-4),    # monolithic _bwd_kernel, sa5-like
    (1, 2, 1024, 8, 2e-4),   # monolithic at its largest S, sa6-like
    (1, 2, 2048, 8, 5e-4),   # _bwd_kernel_strips
])
def test_grads_match_pallas_backward(monkeypatch, b, h, s, d, atol, stats):
    monkeypatch.setenv("AFDM_FLASH_STATS", "1" if stats else "0")
    q, k, v = _qkv(b, h, s, d, seed=s + d)

    def loss(q, k, v):
        return jnp.sum(j_flash_mha(q, k, v, None, True) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(q, k, v, stats=stats)
    for name, a, r in zip("qkv", got, ref):
        np.testing.assert_allclose(a, np.asarray(r), atol=atol, err_msg=f"d{name}")


@pytest.mark.parametrize("b,h,s,d,scale", [
    (2, 2, 64, 16, None),
    (1, 3, 100, 8, None),    # ragged against any tile size
    (2, 2, 128, 32, 0.25),   # custom scale
    (1, 1, 48, 64, None),
])
def test_plain_backward_matches_autograd_of_plain_forward(b, h, s, d, scale):
    """The explicit formulas against autograd through ``attention_reference``
    (f32: summation order only, atol 2e-5)."""
    q, k, v, g = map(torch.from_numpy, _qkv(b, h, s, d, seed=s, n=4))
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    out, m, ssum = fa.attention_reference(q, k, v, scale, with_stats=True)
    ref = torch.autograd.grad(out, (q, k, v), g)
    with torch.no_grad():
        got = fa.attention_backward_reference(q, k, v, out, m, ssum, g, scale)
        local = fa.attention_backward_reference(q, k, v, out, None, None, g, scale)
    for a, l_, r in zip(got, local, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=2e-5)
        torch.testing.assert_close(l_, a, rtol=0, atol=1e-6)  # same m, Σ recomputed


def test_bf16_backward_rounds_where_the_kernel_does():
    """bf16: P and dS are rounded to bf16 before their products and dQ, dK,
    dV once at the end, so each gradient is within a few bf16 ulps (2^-8
    relative; |grad| < 4 here, and S=256 products of rounded terms) of the f32
    gradient of the same bf16-representable inputs: atol 3e-2."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
               for a in _qkv(2, 4, 256, 16, seed=9))
    ref = _port_grads(q, k, v)
    got = _port_grads(q, k, v, dtype=torch.bfloat16)
    tq = torch.from_numpy(q).to(torch.bfloat16).requires_grad_()
    assert fa.flash_mha(tq, tq, tq).dtype == torch.bfloat16
    for a, r in zip(got, ref):
        assert np.abs(r).max() < 4.0
        np.testing.assert_allclose(a, r, atol=3e-2)
        assert np.abs(a - r).max() > 0  # bf16 did round somewhere


@pytest.mark.parametrize("stats,rel", [(True, 2.0**-10), (False, 2.0**-6)],
                         ids=["stats", "nostats"])
def test_bf16_grads_match_pallas_backward(monkeypatch, stats, rel):
    """bf16 on both sides, Pallas kernels in interpret mode; the limit is a
    share of each gradient's largest entry, of which one bf16 ulp is at most
    2^-7. With stats the two round at the same points from f32 values that
    differ in summation order: only small entries land one of their ulps
    apart, 2^-10 of the largest. Without, the JAX kernel rounds the normalised
    P and the port the unnormalised one (1/Σ applied after), so single weights
    round one ulp apart and so may the largest entries: 2^-6, two ulps there."""
    monkeypatch.setenv("AFDM_FLASH_STATS", "1" if stats else "0")
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
               for a in _qkv(2, 4, 256, 8, seed=31))

    def loss(q, k, v):
        return jnp.sum(j_flash_mha(q, k, v, None, True).astype(jnp.float32) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = _port_grads(q, k, v, stats=stats, dtype=torch.bfloat16)
    for name, a, r in zip("qkv", got, ref):
        assert r.dtype == jnp.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(a, r, atol=rel * np.abs(r).max(), err_msg=f"d{name}")


def _emulate_bf16_kernels(q, k, v, out, m, ssum, g, scale=None):
    """The bf16 tensor-core backward (``csrc/flash_bwd.cu``) in plain torch,
    rounding where it rounds: P = 2^(logits·scale·log2e − m·log2e) rounded to
    bf16; dV's operand g/Σ rounded to bf16 (the tensor cores take bf16 where
    the plain version multiplies by an f32 g/Σ); dS = P·(dP·(1/Σ) − δ/Σ)
    rounded to bf16; dQ summed in f32 one 64-key block at a time, as the
    kernel's blocks add their parts into the f32 scratch; dQ, dK, dV rounded
    once at the end. Products of bf16 values accumulate in f32."""
    b, h, s, _ = q.shape
    scale = fa._default_scale(q, scale)
    log2e = np.float32(np.log2(np.e))
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    m, inv = m.reshape(b, h, s, 1), 1.0 / ssum.reshape(b, h, s, 1)
    logits = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.exp2(logits * float(np.float32(scale) * log2e) - m * float(log2e))
    p = p.to(torch.bfloat16).float()
    dv = torch.matmul(p.transpose(-1, -2), (gf * inv).to(torch.bfloat16).float())
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp * inv - delta * inv)).to(torch.bfloat16).float()
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dq = torch.zeros_like(qf)
    for k0 in range(0, s, fa.BWD_KEY_BLOCK):
        keys = slice(k0, k0 + fa.BWD_KEY_BLOCK)
        dq += torch.matmul(ds[..., keys], kf[..., keys, :])
    return (dq * scale).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@pytest.mark.parametrize("b,h,s,d", [(1, 2, 1024, 8), (2, 2, 256, 16)])
def test_tensor_core_rounding_points_fit_the_bf16_share(monkeypatch, b, h, s, d):
    """Before any card: the bf16 kernel's rounding points (its one extra
    rounding, of g/Σ, included) against the plain version and against the
    Pallas backward in interpret mode, bf16 on every side, within the share
    the card checks hold the kernel to: 2^-6 of each gradient's largest
    entry, two bf16 ulps there."""
    monkeypatch.setenv("AFDM_FLASH_STATS", "1")
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(b, h, s, d, seed=s, n=4))
    out, m, ssum = fa.attention_reference(q, k, v, with_stats=True)
    got = _emulate_bf16_kernels(q, k, v, out, m, ssum, g)
    plain = fa.attention_backward_reference(q, k, v, out, m, ssum, g)
    _, vjp = jax.vjp(lambda q, k, v: j_flash_mha(q, k, v, None, True),
                     *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)))
    pallas = vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))
    for name, a, p, r in zip("qkv", got, plain, pallas):
        assert a.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        a, p, r = a.float().numpy(), p.float().numpy(), np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(a, p, rtol=0, atol=2.0**-6 * np.abs(p).max(),
                                   err_msg=f"d{name} vs the plain version")
        np.testing.assert_allclose(a, r, rtol=0, atol=2.0**-6 * np.abs(r).max(),
                                   err_msg=f"d{name} vs the Pallas backward")
    assert np.abs(got[2].float().numpy() - plain[2].float().numpy()).max() > 0  # dV rounds apart


def test_flash_mha_without_grad_is_the_fold_forward():
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 64, 8, seed=3))
    expect = fa.attention_reference(q, k, v)
    out = fa.flash_mha(q, k, v)  # no input needs a gradient
    assert out.grad_fn is None
    torch.testing.assert_close(out, expect, rtol=0, atol=0)
    q.requires_grad_()
    with torch.no_grad():
        assert fa.flash_mha(q, k, v).grad_fn is None
    with torch.inference_mode():
        assert not fa.flash_mha(q, k, v).requires_grad
    out = fa.flash_mha(q, k, v)
    assert out.grad_fn is not None and len(out.grad_fn.saved_tensors) == 6
    assert len(fa.flash_mha(q, k, v, stats=False).grad_fn.saved_tensors) == 4


def test_non_contiguous_cotangent_and_no_launch_on_cpu():
    q, k, v, g = map(torch.from_numpy, _qkv(1, 2, 32, 8, seed=4, n=4))
    q.requires_grad_()
    before = fa.flash_attention_bwd.launches, fa.flash_attention_fwd.launches
    out = fa.flash_mha(q, k, v)
    g_t = g.transpose(2, 3).contiguous().transpose(2, 3)
    assert not g_t.is_contiguous()
    (a,) = torch.autograd.grad(out, q, g_t, retain_graph=True)
    (b_,) = torch.autograd.grad(out, q, g)
    torch.testing.assert_close(a, b_, rtol=0, atol=0)
    assert (fa.flash_attention_bwd.launches, fa.flash_attention_fwd.launches) == before


@pytest.mark.parametrize("bad,err", [
    (lambda a: dict(g=a["g"][:, :1].contiguous()), ValueError),        # g shape
    (lambda a: dict(out=a["out"].double()), ValueError),               # out dtype
    (lambda a: dict(out=a["out"].transpose(2, 3).contiguous().transpose(2, 3)), ValueError),
    (lambda a: dict(m=a["m"].reshape(2, 8)), ValueError),              # stats layout
    (lambda a: dict(ssum=a["ssum"].double()), ValueError),             # stats dtype
    (lambda a: dict(q=a["q"].half(), k=a["k"].half(), v=a["v"].half(),
                    out=a["out"].half(), g=a["g"].half()), TypeError),  # fp16
])
def test_backward_argument_checks(bad, err):
    z = torch.zeros(1, 2, 8, 8)
    args = dict(q=z, k=z, v=z, out=z, m=torch.zeros(2, 1, 8), ssum=torch.ones(2, 1, 8), g=z)
    fa._check_bwd(**args)  # the good call passes
    args.update(bad(args))
    with pytest.raises(err):
        fa._check_bwd(**args)
    with pytest.raises(ValueError, match="both or neither"):
        fa.flash_attention_bwd(z, z, z, z, torch.zeros(2, 1, 8), None, z)


def test_self_attention_module_grads_match_jax_flash_module():
    """The whole block (LN, qkv projection, flash_mha, out-projection, FF)
    against the JAX module with ``attn_impl='flash'`` (Pallas forward and
    backward in interpret mode): output, input gradient and every parameter's
    gradient. atol 5e-4, as the JAX module test."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    jmod = JSelfAttention(channels=32, precision=jax.lax.Precision.HIGHEST, attn_impl="flash")
    params = jmod.init(jax.random.key(0), jnp.asarray(x))

    def jloss(p, x):
        return jnp.sum(jmod.apply(p, x) ** 2)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tmod = SelfAttention(32)
    tmod.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = tmod(tx)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jmod.apply(params, jnp.asarray(x))), atol=2e-5)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx), atol=5e-4)
    expect = params_from_jax(jax.tree.map(np.asarray, jgp))
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expect[name].numpy(), atol=5e-4,
                                   err_msg=name)


@pytest.mark.cuda
def test_cuda_kernel_grads_match_pallas_backward():
    """On a machine with both a card and JAX: the CUDA kernels' gradients
    against the Pallas kernels' (interpret mode), at the monolithic shape and
    its tolerance. The kernel-vs-plain checks that need no JAX are in
    ``tests/test_torch_cuda_kernels.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: flash_bwd.cu has no CPU mode")
    q, k, v = _qkv(2, 4, 256, 8, seed=21)

    def loss(q, k, v):
        return jnp.sum(j_flash_mha(q, k, v, None, True) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).cuda().requires_grad_() for a in (q, k, v))
    before = fa.flash_attention_bwd.launches
    got = torch.autograd.grad((fa.flash_mha(tq, tk, tv) ** 2).sum(), (tq, tk, tv))
    assert fa.flash_attention_bwd.launches == before + 1
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.cpu().numpy(), np.asarray(r), atol=2e-4)
