"""Port vs JAX package: attention backward at head depth 128.

The 128-px UNet at base width 128 has two attention blocks of 512 channels
and four heads (sa2, sa3): D = 128. The port's plain backward
(``attention_backward_reference``, the CPU's path and the yardstick of the
CUDA kernel) is held against the JAX package's Pallas backward
(``_flash_bwd``, interpret mode, as ``tests/test_flash_attention.py`` runs
it) at one (batch, head) and S ≤ 64, with the forward's stats from the JAX
stats-mode forward; then a whole SelfAttention block of 512 channels against
the JAX block with ``attn_impl='flash'``, through the weight carry-over.
Inputs come from a numpy seed. Tolerances, f32 on both sides: summation order
over S keys and D = 128 products, and where 1/Σ is applied — 2e-5 of the
largest entry for the kernel-level gradients; for the block, the JAX module
test's 5e-4 (absolute, on gradients of order 1 to 100 through a squared sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu.models.blocks import SelfAttention as JSelfAttention
from aliasfree_diffusion_models_pytorch_tpu.ops import flash_attention as jfa
from aliasfree_diffusion_models_pytorch_tpu_torch.models.blocks import SelfAttention
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import params_from_jax

REL = 2e-5


@pytest.mark.parametrize("s", [16, 64])
def test_plain_backward_matches_pallas_backward_at_d128(s):
    rng = np.random.default_rng(s)
    q, k, v, g = (rng.standard_normal((1, 1, s, 128)).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(128.0)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, m, ssum = jfa._flash_fwd(jq, jk, jv, scale, True, with_stats=True)
    ref = jfa._flash_bwd(jq, jk, jv, out, m, ssum, jg, scale, True)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, out, m, ssum, g)]
    got = fa.attention_backward_reference(*t, scale)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        r = np.asarray(r)
        err = np.abs(a.numpy() - r).max()
        assert err <= REL * np.abs(r).max(), f"{name}: {err} against max {np.abs(r).max()}"
    # the wrapper on the CPU is that plain version
    for a, b in zip(fa.flash_attention_bwd(*t, scale), got):
        assert torch.equal(a, b)


def test_self_attention_block_at_512_channels_matches_jax():
    """sa2's width at 128 px: 512 channels, 4 heads of depth 128, S = 64."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 8, 8, 512)).astype(np.float32)
    jmod = JSelfAttention(channels=512, precision=jax.lax.Precision.HIGHEST, attn_impl="flash")
    params = jmod.init(jax.random.key(0), jnp.asarray(x))

    def jloss(p, x):
        return jnp.sum(jmod.apply(p, x) ** 2)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tmod = SelfAttention(512)
    tmod.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    before = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    out = tmod(tx)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jmod.apply(params, jnp.asarray(x))), atol=2e-5)
    (out ** 2).sum().backward()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == before
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx), atol=5e-4)
    expect = params_from_jax(jax.tree.map(np.asarray, jgp))
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expect[name].numpy(), atol=5e-4,
                                   err_msg=name)
