"""The port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``csrc/`` at first use and have no CPU mode), so each is marked ``cuda`` and
skips without a device. The file imports neither JAX nor the JAX package: on
a machine that has only PyTorch, run it with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances (f32 inputs of order 1): the f32 kernels sum the same f32
products in another order and use ``__expf`` where the plain versions use
``torch.exp``: atol 1e-5 for the forward, 2e-5 for the gradients. In bf16 the
tensor-core kernels and the plain versions round p, dS and the result to
bf16 from f32 values that differ in the last bits (exp2 against exp, the
tensor cores' adder, dQ summed by atomics), and the backward also rounds g/Σ,
its dV operand, so entries land one bf16 ulp apart (at most 2^-7 of the
entry): each tensor within 2^-6 of its largest entry, two ulps there, at
every S. The bf16 stats are held to the f32 limits of m (1e-5) and Σ (1e-4
relative).

The probe kernels: ``exp_chain`` within 2e-5 of its plain version's largest
|entry|. Every op(acc) is of order 1 before the chain subtracts 1, so each
application rounds by ulps of 1 whatever the size the chain ends at, and the
chains that end small get their own limit at 16 applications: ``exp`` and
``exp_fast`` 1e-4 (they end at 0.11; sixteen roundings and ``__expf``'s 2 ulp
add up to 2e-6), ``exp2`` 1e-3 (it ends at 2e-3). ``fastexp2`` gets 1e-4 for
one application and 1e-3 for a chain (its polynomial jumps by 5.5e-5 of its
value where x·log2e crosses a half-integer, and the kernel's FMAs put a few
inputs on the other side of such a jump; a chain ends at 0.11 to 0.3). ``rsqrt1p``'s chain ends at exactly 0, where kernel and plain version
must be equal, so its unrolled chain is also held without the subtract, where
it ends at 0.786. ``qk_rowsum`` within 2e-5 of the largest entry (f32 sums of
exact bf16 products in another order).
"""

import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import probes as kp

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


@pytest.mark.parametrize("b,h,s,d", [
    (16, 4, 16, 32),    # S=16, B·H=64: four heads a forward block
    (8, 4, 32, 32),     # S=32: two heads a block
    (1, 3, 200, 8),     # ragged against 64-row tiles
    (1, 5, 300, 64),    # ragged, D=64
    (2, 4, 256, 64),    # D=64
    (256, 4, 1024, 8),  # B·H=1024 at S=1024: sa6 of the 32-px train step
], ids=["s16_bh64", "s32", "s200", "s300_d64", "s256_d64", "s1024_bh1024"])
def test_bf16_tensor_core_kernels_at_main_path_shapes(card, b, h, s, d):
    q, k, v, g = _tensors(card, b, h, s, d, 4, seed=s + d, dtype=torch.bfloat16)
    out, m, ssum = fa.flash_attention_fwd(q, k, v, with_stats=True)
    ref_out, ref_m, ref_s = fa.attention_reference(q, k, v, with_stats=True)
    _assert_within_bf16_ulps(out, ref_out, "out")
    torch.testing.assert_close(m, ref_m, rtol=0, atol=1e-5)
    torch.testing.assert_close(ssum, ref_s, rtol=1e-4, atol=0)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, m, ssum, g)
    assert fa.flash_attention_bwd.launches == before + 1
    ref = fa.attention_backward_reference(q, k, v, out, m, ssum, g)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert bool(torch.isfinite(a).all()), name
        _assert_within_bf16_ulps(a, r, name)


def test_bf16_kernels_refuse_misaligned_rows(card):
    flat = torch.zeros(2 * 4 * 64 * 8 + 8, device=card, dtype=torch.bfloat16)
    z = flat[:-8].view(2, 4, 64, 8)
    off = flat[1:-7].view(2, 4, 64, 8)  # contiguous, 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(off, z, z)
    out, m, ssum = fa.flash_attention_fwd(z, z, z, with_stats=True)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_bwd(z, z, z, out, m, ssum, off)


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


def _chain_error(got, ref):
    finite = torch.isfinite(ref)
    assert torch.equal(got[~finite], ref[~finite])
    if not finite.any():
        return 0.0
    err, largest = (got[finite] - ref[finite]).abs().max().item(), ref[finite].abs().max().item()
    if largest == 0:  # rsqrt1p's chain: equal or fail
        return 0.0 if err == 0 else float("inf")
    return err / largest


def _chain_limit(op, chain):
    if op == "fastexp2":
        return 1e-4 if chain == 1 else 1e-3  # one jump against a value of order 1, or of 0.11
    return {"exp": 1e-4, "exp_fast": 1e-4, "exp2": 1e-3}.get(op, 2e-5) if chain == 16 else 2e-5


@pytest.mark.parametrize("chain", [1, 16, 5])
@pytest.mark.parametrize("op", kp.OPS)
def test_exp_chain_kernel_matches_plain_version(card, op, chain):
    rng = np.random.default_rng(chain)
    # 4·8191 + 3 elements: the float4 body and a scalar tail of three
    x = torch.from_numpy((-np.abs(rng.standard_normal(32767)) * 5).astype(np.float32)).to(card)
    before = kp.exp_chain.launches
    got = kp.exp_chain(x, op, chain)
    assert kp.exp_chain.launches == before + 1
    limit = _chain_limit(op, chain)
    assert _chain_error(got, kp.exp_chain_plain(x, op, chain)) <= limit
    if op == "rsqrt1p":
        free = kp.exp_chain(x, op, chain, subtract=False)
        assert _chain_error(free, kp.exp_chain_plain(x, op, chain, subtract=False)) <= 2e-5
    if chain == 1:  # without the subtract a longer chain of exponentials overflows
        single = kp.exp_chain(x, op, 1, subtract=False)
        assert _chain_error(single, kp.exp_chain_plain(x, op, 1, subtract=False)) <= limit


@pytest.mark.parametrize("n,s,d", [(4, 128, 8), (3, 256, 16), (2, 512, 32), (2, 128, 64),
                                   (4, 128, 128)])
def test_qk_rowsum_kernel_matches_plain_version(card, n, s, d):
    rng = np.random.default_rng(s + d)
    k = torch.from_numpy(rng.standard_normal((n, s, d)).astype(np.float32)).to(card).bfloat16()
    qt = torch.from_numpy(rng.standard_normal((n, d, s)).astype(np.float32)).to(card).bfloat16()
    before = kp.qk_rowsum.launches
    got = kp.qk_rowsum(k, qt)
    assert kp.qk_rowsum.launches == before + 1
    ref = kp.qk_rowsum_plain(k, qt)
    assert got.shape == (n, 1, s) and got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()


def test_qk_rowsum_block_diagonal_operands_on_the_card(card):
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.standard_normal((8, 128, 8)).astype(np.float32)).to(card).bfloat16()
    qt = torch.from_numpy(rng.standard_normal((8, 8, 128)).astype(np.float32)).to(card).bfloat16()
    packed = kp.qk_rowsum(*kp.block_diagonal_pack(k, qt, 4))
    per_head = kp.qk_rowsum(k, qt)
    assert (packed.reshape(8, 1, 128) - per_head).abs().max().item() <= 2e-5 * per_head.abs().max().item()


def test_probe_kernels_never_take_the_plain_version_on_the_card(card):
    x = torch.zeros(64, device=card)
    with pytest.raises(TypeError, match="float32"):
        kp.exp_chain(x.double(), "exp")
    with pytest.raises(ValueError, match="contiguous"):
        kp.exp_chain(torch.zeros(8, 8, device=card).t(), "exp")
    with pytest.raises(ValueError, match="aligned"):
        kp.exp_chain(x[1:], "exp")
    k = torch.zeros(2, 128, 8, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        kp.qk_rowsum(k.float(), k.float().transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="multiple of"):
        kp.qk_rowsum(k[:, :100].contiguous(), k[:, :100].transpose(1, 2).contiguous())
    k4 = torch.zeros(2, 128, 4, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="depth"):
        kp.qk_rowsum(k4, k4.transpose(1, 2).contiguous())
