"""Port vs JAX package: the flash-attention forward.

The port's plain version (what its wrapper runs for CPU tensors) is held
against the JAX Pallas forward kernel itself, run in interpret mode on the
CPU as ``tests/test_flash_attention.py`` runs it, at that file's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu.ops.flash_attention import _flash_fwd, flash_mha
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5  # f32 on both sides; summation order of the two matmuls differs


def _qkv(b, h, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,h,s,d", [
    (2, 4, 256, 8),    # sa5-like
    (2, 4, 256, 16),   # sa1-like
    (1, 4, 1024, 8),   # sa6-like
    (2, 2, 128, 32),
])
def test_plain_version_matches_pallas_forward(b, h, s, d):
    q, k, v = _qkv(b, h, s, d, seed=s + d)
    ref = np.asarray(flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, True))
    out = fa.attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_stats_match_pallas_stats_mode():
    q, k, v = _qkv(2, 4, 256, 16, seed=7)
    scale = 0.25
    ref_out, ref_m, ref_s = (np.asarray(a) for a in _flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True, with_stats=True))
    out, m, ssum = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), scale,
                                          with_stats=True)
    assert m.shape == ssum.shape == (8, 1, 256) and m.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL)
    np.testing.assert_allclose(m.numpy(), ref_m, atol=1e-5)
    np.testing.assert_allclose(ssum.numpy(), ref_s, rtol=1e-5)


def test_bf16_plain_version_matches_pallas_forward():
    # Both cast p to bf16 before PV and round the output to bf16; the f32
    # logits differ only in summation order, which can move a p across a
    # bf16 rounding edge: one bf16 ulp of the output (|out| < 4 → 2^-6).
    q, k, v = (a.astype(np.float32) for a in _qkv(2, 4, 256, 16, seed=9))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv))
    ref = np.asarray(flash_mha(jq, jk, jv, None, True).astype(jnp.float32))
    out = fa.attention_reference(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2.0**-6)


def test_cpu_tensor_takes_plain_version_without_launch():
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 64, 8, seed=3))
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention_fwd(q, k, v)
    assert fa.flash_attention_fwd.launches == before
    torch.testing.assert_close(out, fa.attention_reference(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("bad,err", [
    (lambda q: (q[..., :4].contiguous(),) * 3, ValueError),          # head dim 4
    (lambda q: (q.half(),) * 3, TypeError),                          # fp16
    (lambda q: (q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3)), ValueError),
    (lambda q: (q, q[:, :1].contiguous(), q), ValueError),          # shape mismatch
])
def test_kernel_argument_checks(bad, err):
    q = torch.zeros(1, 2, 8, 8)
    with pytest.raises(err):
        fa._check(*bad(q))
