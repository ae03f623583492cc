"""The plain bf16 GELU: ``gelu_exact``'s dispatch, its plain version and the
kernel pair ``csrc/plain_gelu.cu``.

``gelu_exact`` on a bf16 CUDA tensor under a polynomial form (``gelu_form``:
``poly15`` by default, ``poly13`` under ``AFDM_GELU=poly13``) is the kernel
pair, tied by a ``torch.autograd.Function``; f32, ``AFDM_GELU=exact`` and a
CPU tensor keep what they ran before (``F.gelu``; the composed polynomial
``gelu_poly`` with autograd's backward). The CPU tests hold the dispatch, the
Function's plain path, the layouts it takes, the registration of the source
and of the shared header ``csrc/gelu.cuh``, the kernel names the benchmark's
trace readers must not confuse with other kernels, and the calls a step makes
(a spy on the UNet on the meta device). The tests marked ``cuda`` need an
NVIDIA GPU and ``nvcc`` and skip without a device; the file imports neither
JAX nor the JAX package, so on a machine with only PyTorch run

    python -m pytest --noconftest tests/test_torch_plain_gelu.py -q

Tolerances: none. The forward kernel repeats the plain version's f32
products and sums in its order and rounds once to bf16; the backward kernel
repeats autograd's products and sums through the plain version
(``gelu_poly_vjp`` in ``csrc/gelu.cuh``) and rounds once. So both are held
bit-equal to them, NaN for NaN, over all 65,536 bf16 patterns; the backward
is also held to the looser bound a backward summed in another order would
need, one bf16 ulp or 2^-20·|g| where that is larger (where the derivative
cancels toward 0: near x = -0.75, beyond the clamp, and near |x| = 4 inside
it, where the polynomial's terms reach ~25 against a derivative of ~1e-3).
"""

import re

import pytest
import torch
import torch.nn.functional as F

from aliasfree_diffusion_models_pytorch_tpu_torch.ops import resample as rs
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

MODES = [None, "poly13", "exact"]


def _set_mode(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("AFDM_GELU", raising=False)
    else:
        monkeypatch.setenv("AFDM_GELU", mode)


def _launches():
    return rs.plain_gelu_fwd.launches, rs.plain_gelu_bwd.launches


def _inputs(shape, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(shape, generator=gen)).bfloat16().to(device)
    g = torch.randn(shape, generator=gen).bfloat16().to(device)
    return x, g


def _value_and_grad(fn, x, g):
    xg = x.detach().clone().requires_grad_()
    y = fn(xg)
    (dx,) = torch.autograd.grad(y, xg, g)
    return y.detach(), dx


def _same(a, b):
    """Equal bit for bit, or both NaN."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan]))


# ---- dispatch: what the CPU and the erf form run ----

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", MODES)
def test_gelu_exact_off_the_card_runs_what_it_ran_before(monkeypatch, mode, dtype):
    """A CPU tensor takes F.gelu in the erf form (f32, AFDM_GELU=exact) and
    the composed polynomial with autograd's backward otherwise: the same
    values and gradients, and no launch of the plain GELU's kernels."""
    _set_mode(monkeypatch, mode)
    x, g = _inputs((2, 5, 6, 6), seed=1)
    x, g = x.to(dtype), g.to(dtype)
    form = rs.gelu_form(dtype)
    assert form == ("erf" if dtype == torch.float32 or mode == "exact" else mode or "poly15")
    before = _launches()
    got = _value_and_grad(rs.gelu_exact, x, g)
    ref = _value_and_grad(F.gelu if form == "erf" else rs.gelu_poly, x, g)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert _launches() == before


@pytest.mark.parametrize("mode", [None, "poly13"])
def test_gelu_poly_is_the_composed_horner_form(monkeypatch, mode):
    """gelu_poly evaluates x·(0.5 + x_c·R(x_c²)) in f32 with the form's
    coefficients, products and sums rounded in Horner's order, and rounds
    once to bf16; it refuses the erf form."""
    _set_mode(monkeypatch, mode)
    x, _ = _inputs((4097,), seed=2)
    coefs = rs._GELU_POLY_13 if mode == "poly13" else rs._GELU_POLY_15
    xf = x.float()
    xc = xf.clamp(-rs._GELU_CLAMP, rs._GELU_CLAMP)
    t = xc * xc
    p = torch.full_like(t, coefs[-1])
    for coef in reversed(coefs[:-1]):
        p = p * t + coef
    assert torch.equal(rs.gelu_poly(x), (xf * (0.5 + xc * p)).bfloat16())
    with pytest.raises(ValueError, match="polynomial forms"):
        rs.gelu_poly(x.float())


LAYOUTS = {
    "nchw": lambda t: t,
    "channels_last": lambda t: t.contiguous(memory_format=torch.channels_last),
    "tokens": lambda t: t.flatten(2).transpose(1, 2).contiguous(),  # (n, S, C)
    "transposed": lambda t: t.transpose(2, 3),  # dense in another order: taken as it lies
    "every_other_row": lambda t: t[:, :, ::2],  # not dense: made contiguous first
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode", [None, "poly13"])
def test_function_plain_path_equals_the_composed_form(monkeypatch, mode, layout):
    """The autograd Function's own plain path (a CPU tensor) is the composed
    form: the same forward and the same gradient as autograd through
    gelu_poly, in every layout the kernels take."""
    _set_mode(monkeypatch, mode)
    x, g = _inputs((2, 6, 5, 7), seed=3)
    x, g = LAYOUTS[layout](x), LAYOUTS[layout](g)
    got = _value_and_grad(rs._PlainGelu.apply, x, g)
    ref = _value_and_grad(rs.gelu_poly, x, g)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert rs.plain_gelu_fwd(x).equal(ref[0]) and rs.plain_gelu_bwd(x, g).equal(ref[1])


def test_dense_layouts():
    t = torch.zeros(2, 3, 4, 5)
    dense = [t, t.contiguous(memory_format=torch.channels_last), t.transpose(1, 3),
             t.flatten(2).transpose(1, 2), t[:1], torch.zeros(0, 3), torch.zeros(()),
             torch.zeros(7)[1:]]
    gapped = [t[:, :, ::2], t[..., :4], t[:, :1], torch.zeros(3, 1, 4).expand(3, 5, 4),
              torch.zeros(4, 4).t()[::2]]
    assert [rs._dense(a) for a in dense] == [True] * len(dense)
    assert [rs._dense(a) for a in gapped] == [False] * len(gapped)


def test_plain_gelu_wrappers_refuse_other_devices():
    x = torch.zeros(4, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        rs.plain_gelu_fwd(x)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        rs.plain_gelu_bwd(x, x)


# ---- the source, its registration and its names ----

def test_source_and_shared_header_are_registered():
    assert kernels.SOURCES["plain_gelu"] == "plain_gelu.cu"
    pair = (kernels.CSRC / kernels.SOURCES["filtered_gelu"]).read_text()
    plain = (kernels.CSRC / kernels.SOURCES["plain_gelu"]).read_text()
    header = (kernels.CSRC / "gelu.cuh").read_text()
    for src in (pair, plain):
        assert '#include "gelu.cuh"' in src
    # one definition of the polynomial and its coefficients, in the header
    for name in ("gelu_poly(", "gelu_poly_grad(", "gelu_poly_vjp(", "kPoly[8]", "kPoly13[7]"):
        assert name in header and name not in pair and name not in plain, name
    # the C interface's form indices are the Python side's
    assert "kGeluPoly15 = 0, kGeluPoly13 = 1, kGeluErf = 2" in header
    assert rs.FG_GELU_FORMS == ("poly15", "poly13", "erf")


def test_library_name_hashes_the_shared_gelu_header(tmp_path):
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    before = {name: kernels.library_path(name, csrc) for name in kernels.SOURCES}
    header = csrc / "gelu.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: kernels.library_path(name, csrc) for name in kernels.SOURCES}
    assert after["plain_gelu"] != before["plain_gelu"]
    assert after["filtered_gelu"] != before["filtered_gelu"]


def test_kernel_names_are_the_plain_gelus_own():
    """The benchmark's trace readers find the filtered-GELU pair and the
    attention kernels by substring (``filtered_gelu``, ``flash_``): every
    kernel of the plain GELU is named ``plain_gelu…`` and holds neither."""
    src = (kernels.CSRC / kernels.SOURCES["plain_gelu"]).read_text()
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(", src)
    assert names == ["plain_gelu_fwd_kernel", "plain_gelu_bwd_kernel"]
    assert all("filtered_gelu" not in n and "flash_" not in n for n in names)
    assert re.findall(r"<<<([^>]*)>>>", src) == ["blocks, kThreads, 0, stream"] * 2


# ---- the calls a step makes ----

def _gelu_calls(variant, batch=2):
    """(calls, elements) of gelu_exact in one forward of the bf16 32-px
    UNet of this variant (a spy on the blocks' gelu_exact over the model on
    the meta device; attention and the filtered GELU stubbed)."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
    from aliasfree_diffusion_models_pytorch_tpu_torch.models import blocks, unet

    config = TrainConfig(image_size=32, image_channels=3, variant=variant, batch_size=batch,
                         compute_dtype="bfloat16",
                         filters=FilterSettings() if variant == 3 else None)
    with torch.device("meta"):
        model = unet.build_model(config, device="meta")
    calls = []

    def spy(x):
        assert x.dtype == torch.bfloat16
        calls.append(x.numel())
        return x

    real = blocks.gelu_exact, blocks.filtered_gelu, blocks.flash_mha
    blocks.gelu_exact, blocks.filtered_gelu = spy, lambda x, *a, **k: x
    blocks.flash_mha = lambda q, k, v, scale: torch.empty_like(q)
    try:
        with torch.no_grad():
            model(torch.zeros((batch, 32, 32, 3), device="meta"),
                  torch.ones((batch,), dtype=torch.long, device="meta"))
    finally:
        blocks.gelu_exact, blocks.filtered_gelu, blocks.flash_mha = real
    return len(calls), sum(calls) // batch


@pytest.mark.parametrize("variant,calls,per_image", [(0, 28, 456_704), (3, 6, 71_680)],
                         ids=["config_A", "config_D"])
def test_plain_gelu_calls_of_a_forward(variant, calls, per_image):
    """Config A runs the plain GELU in each of its 22 DoubleConv GELUs and the
    six attention feed-forwards; Config D only in the feed-forwards."""
    assert _gelu_calls(variant) == (calls, per_image)


# ---- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels in csrc/ have no CPU mode")
    return torch.device("cuda")


def _all_bf16(device):
    return torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [None, "poly13"])
def test_forward_kernel_is_bit_equal_over_every_bf16(card, monkeypatch, mode):
    _set_mode(monkeypatch, mode)
    x = _all_bf16(card)
    before = _launches()
    y = rs.plain_gelu_fwd(x)
    assert _launches() == (before[0] + 1, before[1])
    assert _same(y, rs.gelu_poly(x))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [None, "poly13"])
def test_backward_kernel_equals_autograd_over_every_bf16(card, monkeypatch, mode):
    _set_mode(monkeypatch, mode)
    x = _all_bf16(card)
    g = torch.randn(65536, generator=torch.Generator().manual_seed(4)).bfloat16().to(card)
    before = _launches()
    dx = rs.plain_gelu_bwd(x, g)
    assert _launches() == (before[0], before[1] + 1)
    _, ref = _value_and_grad(rs.gelu_poly, x, g)
    assert _same(dx, ref)
    finite = torch.isfinite(x)
    r, d = ref.float()[finite], dx.float()[finite]
    ulp = torch.where(r != 0, torch.exp2(torch.floor(torch.log2(r.abs())) - 7), 0.0)
    assert ((d - r).abs() <= torch.maximum(ulp, 2.0**-20 * g.float()[finite].abs())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_gelu_exact_on_the_card_in_every_layout(card, layout):
    """Through gelu_exact's autograd: one launch each way, the result laid
    out as the (dense) input, the values and gradient bit-equal to the
    composed form's."""
    x, g = _inputs((4, 64, 9, 9), seed=5, device=card)
    x, g = LAYOUTS[layout](x), LAYOUTS[layout](g)
    before = _launches()
    y, dx = _value_and_grad(rs.gelu_exact, x, g)
    assert _launches() == (before[0] + 1, before[1] + 1)
    ref_y, ref_dx = _value_and_grad(rs.gelu_poly, x, g)
    assert _same(y, ref_y) and _same(dx, ref_dx)
    assert y.stride() == (x.stride() if rs._dense(x) else x.contiguous().stride())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 7, 8, 4097, 1 << 20])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 3), (1, 4)], ids=str)
def test_kernels_at_ragged_sizes_and_offsets(card, n, offsets):
    """Sizes that leave a tail and storage that starts off a 16-byte boundary
    (x and g at the same offset: a head done one element at a time; at
    different ones: every element one at a time); an empty tensor launches
    nothing."""
    gen = torch.Generator().manual_seed(n)
    xs = (3 * torch.randn(n + 8, generator=gen)).bfloat16().to(card)
    gs = torch.randn(n + 8, generator=gen).bfloat16().to(card)
    x, g = xs[offsets[0]:offsets[0] + n], gs[offsets[1]:offsets[1] + n]
    before = _launches()
    y, dx = rs.plain_gelu_fwd(x), rs.plain_gelu_bwd(x, g)
    assert _launches() == (before[0] + (n > 0), before[1] + (n > 0))
    ref_y, ref_dx = _value_and_grad(rs.gelu_poly, x, g)
    assert y.shape == dx.shape == (n,)
    assert _same(y, ref_y) and _same(dx, ref_dx)


@pytest.mark.cuda
def test_kernels_under_cuda_graph_capture(card):
    x, g = _inputs((8, 32, 16, 16), seed=6, device=card)
    eager = rs.plain_gelu_fwd(x), rs.plain_gelu_bwd(x, g)  # loads the library
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            captured = rs.plain_gelu_fwd(x), rs.plain_gelu_bwd(x, g)
    torch.cuda.current_stream().wait_stream(stream)
    for seed in (7, 8):
        fresh = _inputs(x.shape, seed=seed, device=card)
        x.copy_(fresh[0])
        g.copy_(fresh[1])
        graph.replay()
        torch.cuda.synchronize()
        eager = rs.plain_gelu_fwd(x), rs.plain_gelu_bwd(x, g)
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,mode", [(torch.float32, None), (torch.bfloat16, "exact")],
                         ids=["f32", "bf16_exact"])
def test_erf_form_on_the_card_launches_nothing(card, monkeypatch, dtype, mode):
    _set_mode(monkeypatch, mode)
    x, g = _inputs((4, 8, 8, 8), seed=9, device=card)
    x, g = x.to(dtype), g.to(dtype)
    before = _launches()
    got = _value_and_grad(rs.gelu_exact, x, g)
    ref = _value_and_grad(F.gelu, x, g)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert _launches() == before
    with pytest.raises((TypeError, ValueError)):
        rs.plain_gelu_fwd(x)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x, g = _inputs((4, 8, 8, 8), seed=10, device=card)
    with pytest.raises(TypeError, match="bfloat16"):
        rs.plain_gelu_fwd(x.float())
    with pytest.raises(ValueError, match="dense"):
        rs.plain_gelu_fwd(x[:, :, ::2])
    with pytest.raises(ValueError, match="laid out as x"):
        rs.plain_gelu_bwd(x, g.contiguous(memory_format=torch.channels_last))


@pytest.mark.cuda
@pytest.mark.parametrize("variant,calls", [(0, 28), (3, 6)], ids=["config_A", "config_D"])
def test_launches_of_one_eager_train_step(card, variant, calls):
    from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion

    config = TrainConfig(image_size=32, image_channels=3, variant=variant, batch_size=4,
                         compute_dtype="bfloat16", noise_steps=50,
                         filters=FilterSettings() if variant == 3 else None)
    model, state = train_mod.create_train_state(config, device=card)
    step = train_mod.make_train_step(model, config, Diffusion(noise_steps=50, img_size=32,
                                                              device=card), graphs=False)
    batch = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(11)) * 2 - 1
    before = _launches()
    state, loss = step(state, batch.to(card), train_mod.step_generator(
        torch.Generator(device=card), 0, 0))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert _launches() == (before[0] + calls, before[1] + calls)



@pytest.mark.cuda
@pytest.mark.parametrize("variant,calls", [(0, 28), (3, 6)], ids=["config_A", "config_D"])
def test_launches_of_a_graphed_sampler_call(card, variant, calls):
    """A DDPM call replays one graph for each noised step, and the counters
    add the launches it captured at each replay: the forward kernel once a
    call of gelu_exact in each of the STEPS - 1 forwards, the backward
    never."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import init_params

    steps = 12
    config = TrainConfig(image_size=16, base_width=32, image_channels=3, variant=variant,
                         compute_dtype="bfloat16", noise_steps=steps, batch_size=2,
                         filters=FilterSettings() if variant == 3 else None)
    model = build_model(config, device=card, state_dict=init_params(config, 0))
    sampler = Diffusion(noise_steps=steps, img_size=16, device=card)
    gen = torch.Generator(device=card).manual_seed(12)
    sampler.sample(model, 2, 3, generator=gen)  # warm-up and capture
    before = _launches()
    sampler.sample(model, 2, 3, generator=gen)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + calls * (steps - 1), before[1])
