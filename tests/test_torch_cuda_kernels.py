"""The port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``csrc/`` at first use and have no CPU mode), so each is marked ``cuda`` and
skips without a device. The file imports neither JAX nor the JAX package: on
a machine that has only PyTorch, run it with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances (f32 inputs of order 1): the kernels sum the same f32 products in
another order and use ``__expf`` where the plain versions use ``torch.exp``:
atol 1e-5 for the forward, 2e-5 for the gradients. In bf16 kernel and plain
version round p, dS and the result to bf16 from f32 values that differ in the
last bits, so entries land one bf16 ulp apart (at most 2^-7 of the entry):
each tensor within 2^-6 of its largest entry, two ulps there, at every S.
"""

import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels in csrc/ have no CPU mode")
    return torch.device("cuda")


def _tensors(card, b, h, s, d, n, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
            .to(card, dtype) for _ in range(n)]


def _assert_within_bf16_ulps(got, ref, name):
    err = (got.float() - ref.float()).abs().max().item()
    limit = 2.0**-6 * ref.float().abs().max().item()
    assert err <= limit, f"{name}: max error {err} > {limit} (2^-6 of the largest entry)"


@pytest.mark.parametrize("s,d", [(200, 16), (16, 32), (1024, 8), (300, 64)])
def test_forward_kernel_matches_plain_version(card, s, d):
    q, k, v = _tensors(card, 2, 4, s, d, 3, seed=s)
    before = fa.flash_attention_fwd.launches
    out, m, ssum = fa.flash_attention_fwd(q, k, v, with_stats=True)
    assert fa.flash_attention_fwd.launches == before + 1
    ref, ref_m, ref_s = fa.attention_reference(q, k, v, with_stats=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(m, ref_m, rtol=0, atol=1e-5)
    torch.testing.assert_close(ssum, ref_s, rtol=1e-4, atol=0)


@pytest.mark.parametrize("s,d", [(200, 16), (16, 32), (1024, 8), (300, 64)])
def test_backward_kernel_matches_plain_version(card, s, d):
    q, k, v, g = _tensors(card, 2, 4, s, d, 4, seed=s + 1)
    out, m, ssum = fa.flash_attention_fwd(q, k, v, with_stats=True)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, m, ssum, g)
    assert fa.flash_attention_bwd.launches == before + 1
    for a, r in zip(got, fa.attention_backward_reference(q, k, v, out, m, ssum, g)):
        torch.testing.assert_close(a, r, rtol=0, atol=2e-5)


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "nostats"])
@pytest.mark.parametrize("s,d", [(16, 32), (200, 16), (1024, 8), (300, 64), (4096, 16)])
def test_bf16_kernels_match_plain_versions(card, s, d, stats):
    q, k, v, g = _tensors(card, 2, 4, s, d, 4, seed=s + 2, dtype=torch.bfloat16)
    out, m, ssum = fa.flash_attention_fwd(q, k, v, with_stats=True)
    ref_out, ref_m, ref_s = fa.attention_reference(q, k, v, with_stats=True)
    _assert_within_bf16_ulps(out, ref_out, "out")
    _assert_within_bf16_ulps(fa.flash_attention_fwd(q, k, v), ref_out, "out (fold mode)")
    torch.testing.assert_close(m, ref_m, rtol=0, atol=1e-5)
    torch.testing.assert_close(ssum, ref_s, rtol=1e-4, atol=0)
    got = fa.flash_attention_bwd(q, k, v, out, *((m, ssum) if stats else (None, None)), g)
    ref = fa.attention_backward_reference(q, k, v, out, m, ssum, g)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16
        _assert_within_bf16_ulps(a, r, name)


def test_flash_mha_autograd_on_the_card_matches_the_cpu(card):
    cpu = _tensors(torch.device("cpu"), 2, 4, 256, 16, 4, seed=7)
    grads = {}
    for dev in ("cpu", "cuda"):
        q, k, v, g = (t.to(dev) for t in cpu)
        q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
        counts = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
        out = fa.flash_mha(q, k, v)
        grads[dev] = [t.cpu() for t in torch.autograd.grad(out, (q, k, v), g)]
        launched = (fa.flash_attention_fwd.launches - counts[0],
                    fa.flash_attention_bwd.launches - counts[1])
        assert launched == ((1, 1) if dev == "cuda" else (0, 0))
    for a, r in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, r, rtol=0, atol=2e-5)


def test_cuda_tensors_never_take_the_plain_version(card):
    q = torch.zeros(1, 2, 8, 4, device=card)  # head dim 4: no kernel instantiation
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, q, q)
    z = torch.zeros(1, 2, 8, 8, device=card)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(z, z, z, z, torch.zeros(2, 8, device=card),
                               torch.ones(2, 8, device=card), z)
