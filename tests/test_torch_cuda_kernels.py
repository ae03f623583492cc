"""The port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``csrc/`` at first use and have no CPU mode), so each is marked ``cuda`` and
skips without a device. The file imports neither JAX nor the JAX package: on
a machine that has only PyTorch, run it with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances (f32 inputs of order 1): the f32 kernels sum the same f32
products in another order (the forward rescales its sums once per key tile,
the backward adds P/Σ and dS tile by tile) and use ``__expf`` where the plain
versions use ``torch.exp``: atol 1e-5 for the forward, 2e-5 for the
gradients, or 2e-5 of the tensor's largest entry where S reaches 4096 and
the entries shrink like 1/sqrt(S). Two f32 backward calls are bit-equal:
every sum runs in a fixed order, without atomics. In bf16 the
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


@pytest.mark.parametrize("s,d", [(200, 16), (16, 32), (1024, 8), (300, 64), (256, 128)])
def test_forward_kernel_matches_plain_version(card, s, d):
    q, k, v = _tensors(card, 2, 4, s, d, 3, seed=s)
    before = fa.flash_attention_fwd.launches
    out, m, ssum = fa.flash_attention_fwd(q, k, v, with_stats=True)
    assert fa.flash_attention_fwd.launches == before + 1
    ref, ref_m, ref_s = fa.attention_reference(q, k, v, with_stats=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(m, ref_m, rtol=0, atol=1e-5)
    torch.testing.assert_close(ssum, ref_s, rtol=1e-4, atol=0)


@pytest.mark.parametrize("s,d", [(200, 16), (16, 32), (1024, 8), (300, 64), (100, 128)])
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


@pytest.mark.parametrize("b,h,s", [(4, 4, 16), (2, 4, 32), (1, 4, 300), (1, 4, 1024)],
                         ids=["s16_four_heads", "s32_two_heads", "s300_ragged", "s1024"])
def test_bf16_forward_at_head_dim_128(card, b, h, s):
    """D = 128 (sa2 and sa3 of the 128-px UNet): the forward takes it, in
    dynamic shared memory above 48 KB, and so does the backward (K and V
    tiles in shared memory, dQ in two halves), with and without stats."""
    q, k, v, g = _tensors(card, b, h, s, 128, 4, seed=s, dtype=torch.bfloat16)
    out, m, ssum = fa.flash_attention_fwd(q, k, v, with_stats=True)
    ref_out, ref_m, ref_s = fa.attention_reference(q, k, v, with_stats=True)
    _assert_within_bf16_ulps(out, ref_out, "out")
    _assert_within_bf16_ulps(fa.flash_attention_fwd(q, k, v), ref_out, "out (fold mode)")
    torch.testing.assert_close(m, ref_m, rtol=0, atol=1e-5)
    torch.testing.assert_close(ssum, ref_s, rtol=1e-4, atol=0)
    ref = fa.attention_backward_reference(q, k, v, out, m, ssum, g)
    for stats in ((m, ssum), (None, None)):
        before = fa.flash_attention_bwd.launches
        got = fa.flash_attention_bwd(q, k, v, out, *stats, g)
        assert fa.flash_attention_bwd.launches == before + 1
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            assert bool(torch.isfinite(a).all()), name
            _assert_within_bf16_ulps(a, r, name)


# The filtered-GELU pair (csrc/filtered_gelu.cu) against its plain version
# (ops/resample.py: filtered_gelu_phases, and autograd of it). The forward
# repeats the plain version's rounded f32 operations in its order, so it is
# held to one bf16 ulp (2^-8 of the largest entry) and 1e-6 in f32 (erff
# against torch's erf), and in bf16 it must equal the plain version element
# for element; the backward sums in an order of its own and rounds dG and dP
# to bf16 from values a few f32 ulps apart: 2^-6 in bf16, 2e-5 in f32, of the
# largest entry. The shapes reach every instantiation (square planes of side
# 4 to 128 at k = 3, the generic one at other shapes and k) and its edges:
# batch 1, plane counts no multiple of a block, the smallest and largest
# planes.
FG_TOL = {torch.bfloat16: (2.0**-8, 2.0**-6), torch.float32: (1e-6, 2e-5)}


def _fg_taps(card, k, dtype):
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import filters

    return [torch.from_numpy(filters.circular_lowpass_kernel(w, k, 2.0)).to(card, dtype)
            for w in (np.pi / 2, np.pi / 3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,c,h,w,k", [
    (4, 32, 32, 32, 3), (8, 64, 16, 16, 3), (16, 128, 4, 4, 3), (2, 8, 64, 64, 3),
    (3, 5, 9, 40, 3), (2, 4, 12, 7, 5), (2, 3, 6, 6, 7), (3, 2, 1, 1, 7), (2, 2, 5, 5, 1),
    (1, 3, 4, 4, 3), (3, 5, 4, 4, 3), (3, 7, 8, 8, 3), (1, 5, 16, 16, 3), (1, 3, 64, 64, 3),
    (1, 2, 128, 128, 3), (2, 3, 32, 32, 5),
])
def test_filtered_gelu_kernels_match_plain_version(card, n, c, h, w, k, dtype):
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import resample as tr

    rng = np.random.default_rng(h * w + k)
    x = torch.from_numpy(2 * rng.standard_normal((n, c, h, w)).astype(np.float32)).to(card, dtype)
    g = torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32)).to(card, dtype)
    up, down = _fg_taps(card, k, dtype)
    before = tr.filtered_gelu_fwd.launches, tr.filtered_gelu_bwd.launches
    y = tr.filtered_gelu_fwd(x, up, down)
    dx = tr.filtered_gelu_bwd(x, up, down, g)
    assert (tr.filtered_gelu_fwd.launches, tr.filtered_gelu_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    plan = tr.fg_plan(n * c, h, w, k)
    assert tr.filtered_gelu_fwd.last_plan == plan and tr.filtered_gelu_bwd.last_plan == plan
    xg = x.clone().requires_grad_()
    ref = tr.filtered_gelu_phases(xg, up, down)
    (ref_dx,) = torch.autograd.grad(ref, xg, g)
    fwd_tol, bwd_tol = FG_TOL[dtype]
    for name, a, r, tol in (("out", y, ref, fwd_tol), ("dx", dx, ref_dx, bwd_tol)):
        assert a.dtype == dtype and a.shape == r.shape
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item(), (name, err)
    if dtype == torch.bfloat16:
        assert torch.equal(y, ref.detach()), int((y != ref).sum())


@pytest.mark.parametrize("mode", ["exact", "poly13"])
@pytest.mark.parametrize("n,c,h,w,k", [(4, 32, 32, 32, 3), (3, 5, 9, 40, 3), (2, 4, 12, 7, 5),
                                       (16, 128, 4, 4, 3)])
def test_filtered_gelu_kernels_follow_the_gelu_mode(card, monkeypatch, mode, n, c, h, w, k):
    """Under AFDM_GELU the pair takes the same GELU form as its plain version
    (ops/resample.py:gelu_form): the bf16 forward equal element for element,
    the backward within two bf16 ulps of the largest entry; f32 keeps erf."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import resample as tr

    monkeypatch.setenv("AFDM_GELU", mode)
    rng = np.random.default_rng(h * w + k + 1)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(2 * rng.standard_normal((n, c, h, w)).astype(np.float32)).to(
            card, dtype)
        g = torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32)).to(card, dtype)
        up, down = _fg_taps(card, k, dtype)
        y, dx = tr.filtered_gelu_fwd(x, up, down), tr.filtered_gelu_bwd(x, up, down, g)
        xg = x.clone().requires_grad_()
        ref = tr.filtered_gelu_phases(xg, up, down)
        (ref_dx,) = torch.autograd.grad(ref, xg, g)
        fwd_tol, bwd_tol = FG_TOL[dtype]
        for name, a, r, tol in (("out", y, ref, fwd_tol), ("dx", dx, ref_dx, bwd_tol)):
            err = (a.float() - r.float()).abs().max().item()
            assert err <= tol * r.float().abs().max().item(), (dtype, name, err)
        if dtype == torch.bfloat16:
            assert torch.equal(y, ref.detach()), int((y != ref).sum())
            monkeypatch.delenv("AFDM_GELU")
            default = tr.filtered_gelu_fwd(x, up, down)  # the degree-15 form differs
            monkeypatch.setenv("AFDM_GELU", mode)
            assert not torch.equal(default, y)


def test_filtered_gelu_misaligned_input_takes_the_generic_kernel(card):
    """A tensor 2 bytes past a 16-byte boundary cannot take the square-plane
    instantiation's word loads: the plan names the generic one, which still
    equals the plain version."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import resample as tr

    flat = torch.randn(2 * 3 * 8 * 8 + 1, device=card).bfloat16()
    x = flat[1:].view(2, 3, 8, 8)
    g = torch.randn(2, 3, 8, 8, device=card).bfloat16()
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert tr.fg_plan(6, 8, 8, 3, aligned=False).instantiation == "k3_generic"
    up, down = _fg_taps(card, 3, torch.bfloat16)
    assert torch.equal(tr.filtered_gelu_fwd(x, up, down), tr.filtered_gelu_phases(x, up, down))
    assert tr.filtered_gelu_fwd.last_plan.instantiation == "k3_generic"
    xg = x.clone().requires_grad_()
    (ref_dx,) = torch.autograd.grad(tr.filtered_gelu_phases(xg, up, down), xg, g)
    dx = tr.filtered_gelu_bwd(x, up, down, g)
    assert (dx.float() - ref_dx.float()).abs().max() <= FG_TOL[torch.bfloat16][1] * ref_dx.float().abs().max()


def test_filtered_gelu_autograd_on_the_card_is_the_kernel_pair(card, monkeypatch):
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import resample as tr

    monkeypatch.delenv("AFDM_FG_IMPL", raising=False)
    x = torch.randn(2, 8, 16, 16, device=card).bfloat16().requires_grad_()
    up, down = _fg_taps(card, 3, torch.bfloat16)
    before = tr.filtered_gelu_fwd.launches, tr.filtered_gelu_bwd.launches
    tr.filtered_gelu(x, up, down).float().sum().backward()
    assert (tr.filtered_gelu_fwd.launches, tr.filtered_gelu_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="taps"):
        tr.filtered_gelu_fwd(x.detach(), *_fg_taps(card, 9, torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        tr.filtered_gelu_fwd(x.detach().transpose(2, 3), up, down)


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


def _assert_within_f32_share(got, ref, name):
    err = (got - ref).abs().max().item()
    limit = 2e-5 * ref.abs().max().item()
    assert err <= limit, f"{name}: max error {err} > {limit} (2e-5 of the largest entry)"


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("b,h,s", [(5, 4, 16), (3, 4, 32), (2, 3, 200), (1, 4, 1024),
                                   (1, 2, 4096)],
                         ids=["s16_bh20", "s32_bh12", "s200", "s1024", "s4096"])
def test_f32_kernels_at_every_depth(card, b, h, s, d):
    """The f32 forward (several heads a block at S <= 32, a partial group of
    heads at B·H = 20 and 12) and the deterministic backward: each within 2e-5
    of its tensor's largest entry, and two backward calls bit-equal."""
    q, k, v, g = _tensors(card, b, h, s, d, 4, seed=s + 3 * d)
    out, m, ssum = fa.flash_attention_fwd(q, k, v, with_stats=True)
    ref_out, ref_m, ref_s = fa.attention_reference(q, k, v, with_stats=True)
    _assert_within_f32_share(out, ref_out, "out")
    _assert_within_f32_share(fa.flash_attention_fwd(q, k, v), ref_out, "out (fold mode)")
    torch.testing.assert_close(m, ref_m, rtol=0, atol=1e-5)
    torch.testing.assert_close(ssum, ref_s, rtol=1e-4, atol=0)
    before = fa.flash_attention_bwd.launches
    first = fa.flash_attention_bwd(q, k, v, out, m, ssum, g)
    again = fa.flash_attention_bwd(q, k, v, out, m, ssum, g)
    assert fa.flash_attention_bwd.launches == before + 2
    ref = fa.attention_backward_reference(q, k, v, out, m, ssum, g)
    for name, a, a2, r in zip(("dq", "dk", "dv"), first, again, ref):
        assert torch.equal(a, a2), f"{name}: two f32 backward calls differ"
        _assert_within_f32_share(a, r, name)


def test_f32_cuda_tensors_never_reach_the_plain_versions(card, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("an f32 CUDA tensor reached a plain version")

    q, k, v, g = _tensors(card, 2, 4, 200, 32, 4, seed=5)
    monkeypatch.setattr(fa, "attention_reference", refuse)
    monkeypatch.setattr(fa, "attention_backward_reference", refuse)
    counts = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    out, m, ssum = fa.flash_attention_fwd(q, k, v, with_stats=True)
    fa.flash_attention_bwd(q, k, v, out, m, ssum, g)
    fa.flash_attention_bwd(q, k, v, out, None, None, g)  # stats recomputed by the forward kernel
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    torch.autograd.grad(fa.flash_mha(qg, kg, vg), (qg, kg, vg), g)
    with torch.no_grad():
        fa.flash_mha(q, k, v)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches - counts[0],
            fa.flash_attention_bwd.launches - counts[1]) == (4, 3)


def test_f32_kernels_refuse_misaligned_rows(card):
    flat = torch.zeros(2 * 4 * 64 * 8 + 4, device=card)
    z = flat[:-4].view(2, 4, 64, 8)
    off = flat[1:-3].view(2, 4, 64, 8)  # contiguous, 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(off, z, z)
    out, m, ssum = fa.flash_attention_fwd(z, z, z, with_stats=True)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_bwd(z, z, z, out, m, ssum, off)


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
                                   (4, 128, 128),
                                   # 32 key tiles through a ring of 8 stages
                                   (2, 4096, 32),
                                   # one group, and three; s = 384 leaves the last block's
                                   # second warpgroup idle
                                   *[(1, 384, d) for d in kp.QK_HEAD_DIMS],
                                   *[(3, 256, d) for d in kp.QK_HEAD_DIMS],
                                   # more (group, 256-query) items than an H100's blocks:
                                   # each block walks several, the ring runs on between them
                                   (300, 384, 8), (200, 384, 64), (140, 1024, 128)])
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
    # a contiguous view that starts 2 bytes into its storage: TMA needs a 16-byte base
    odd = torch.zeros(2 * 128 * 8 + 1, device=card, dtype=torch.bfloat16)[1:].view(2, 128, 8)
    assert odd.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        kp.qk_rowsum(odd, k.transpose(1, 2).contiguous())
