"""The port's probe ops against the JAX probes' formulas and Pallas bodies.

Same seeded numpy inputs through both sides, on the CPU:

* each plain version of ``ops.probes.exp_chain`` against the op formulas of
  ``benchmarks/exp_micro.py`` (:57-89, :132-135), copied below because that
  script defines them inside ``main``, and against the probe's Pallas body
  (``kern``, :96-100, launched as ``build`` does, :102-114) in interpret mode;
* ``qk_rowsum_plain`` against ``benchmarks/attn_headpack.py``'s
  ``qk_rowsum_kernel`` (:84-92, launched as ``make_qk_probe`` does, :94-113) in
  interpret mode, at small versions of the probe's three shapes;
* the two probes run at ``small`` size give the JAX probes' result keys.

Tolerances. One application: both sides evaluate the same f32 formula with
their own libm, so a few ulps: rtol 2e-6 plus atol 2e-7 (an ulp of the values
near 1). A chain of 16: as a share of the result's own largest |entry|, 2e-5.
Every op(acc) is of order 1 before the subtract, so each application rounds
by ulps of 1 whatever the size the chain ends at, and the chains that end
small get their own limit: ``exp`` and ``exp_fast`` 1e-4 (they end at 0.11,
near the fixed point 0 of e^x − 1 where sixteen roundings add up without
shrinking), ``exp2`` 1e-3 (2^x − 1 contracts by ln 2 per application and ends
at 2e-3), ``fastexp2`` 1e-3 (its polynomial jumps by 5.5e-5 of its value where
x·log2e crosses a half-integer, inputs an ulp apart land on both sides of such
a jump, and its chain ends at 0.11). ``rsqrt1p``'s chain ends at exactly 0,
where both sides must be equal: it is also held without the subtract, where it
ends at 0.786. ``poly4``'s ends at −inf on both sides.
``qk_rowsum``: f32 sums of exact bf16 products in another order, 2e-5 of the
largest entry.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from aliasfree_diffusion_models_pytorch_tpu_torch import cli, probes
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import probes as kp

LOG2E = float(np.log2(np.e))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several worker processes at once. A worker whose
    convolutions take every core makes the others' OpenMP threads spin at
    their barriers, and all of them crawl; two threads are enough here."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


# benchmarks/exp_micro.py:57-89
def op_copy(v):
    return v


def op_mul2(v):
    return v * 2.0


def op_poly4(v):
    acc = v
    for c in (0.5, 0.25, 0.125, 0.0625):
        acc = acc * v + c
    return acc


def op_fastexp2(v):
    y = v * LOG2E
    n = jnp.round(y)
    f = y - n
    p = 0.05550410866 * f + 0.2402265069
    p = p * f + 0.6931471806
    p = p * f + 1.0
    biased = (n.astype(jnp.int32) + 127) << 23
    scale = jax.lax.bitcast_convert_type(biased, jnp.float32)
    return p * scale


# benchmarks/exp_micro.py:125-136 (exp_fast is the port's extra row: the same
# exponential, taken by __expf in the kernel)
JAX_OPS = {
    "copy": op_copy, "mul2": op_mul2, "poly4": op_poly4, "exp": jnp.exp, "exp2": jnp.exp2,
    "fastexp2": op_fastexp2, "tanh": jnp.tanh, "erf": jax.lax.erf,
    "rsqrt1p": lambda v: jax.lax.rsqrt(1.0 + v * v), "logistic": jax.nn.sigmoid,
    "exp_fast": jnp.exp,
}
CHAIN = 16
CHAIN_TOL = {op: 2e-5 for op in kp.OPS} | {"exp": 1e-4, "exp_fast": 1e-4, "exp2": 1e-3,
                                            "fastexp2": 1e-3}


# benchmarks/exp_micro.py:96-100
def kern(op, x_ref, o_ref):
    acc = x_ref[...]
    for _ in range(CHAIN):
        acc = op(acc) - 1.0
    o_ref[...] = acc


# benchmarks/exp_micro.py:102-114, at a small shape and in interpret mode
def pallas_chain(op, x):
    b, rows, cols = x.shape
    blk = rows // 2
    spec = pl.BlockSpec((1, blk, cols), lambda i, j: (i, j, 0))
    return pl.pallas_call(
        functools.partial(kern, op),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        grid=(b, rows // blk),
        in_specs=[spec],
        out_specs=spec,
        interpret=True,
    )(x)


def _domain(shape, seed=0):
    # softmax-like domain: logits − max <= 0 (exp_micro.py:53)
    rng = np.random.default_rng(seed)
    return (-np.abs(rng.standard_normal(shape)) * 5).astype(np.float32)


def _assert_chain_close(got: np.ndarray, ref: np.ndarray, tol: float):
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(got[~finite], ref[~finite])
    if finite.any():
        err = np.abs(got[finite] - ref[finite]).max()
        scale = np.abs(ref[finite]).max()  # 0 for rsqrt1p: equal or fail
        assert err <= tol * scale, f"max error {err} > {tol} of {scale}"


def test_ops_are_the_probes_ten_and_exp_fast():
    assert kp.OPS[:10] == ("copy", "mul2", "poly4", "exp", "exp2", "fastexp2", "tanh", "erf",
                           "rsqrt1p", "logistic")
    assert kp.OPS[10:] == ("exp_fast",)
    assert set(JAX_OPS) == set(kp.OPS)


@pytest.mark.parametrize("op", kp.OPS)
def test_one_application_matches_the_jax_formula(op):
    x = _domain((4, 64, 64))
    got = kp.exp_chain_plain(torch.from_numpy(x), op, chain=1, subtract=False).numpy()
    ref = np.asarray(JAX_OPS[op](jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)


@pytest.mark.parametrize("op", kp.OPS)
def test_chain_matches_the_jax_formula(op):
    x = _domain((4, 64, 64), seed=1)
    got = kp.exp_chain(torch.from_numpy(x), op).numpy()  # a CPU tensor: the plain version
    acc = jnp.asarray(x)
    for _ in range(CHAIN):
        acc = JAX_OPS[op](acc) - 1.0
    _assert_chain_close(got, np.asarray(acc), CHAIN_TOL[op])


def test_rsqrt1p_chain_without_the_subtract_matches_the_jax_formula():
    x = _domain((4, 64, 64), seed=4)
    got = kp.exp_chain(torch.from_numpy(x), "rsqrt1p", subtract=False).numpy()
    acc = jnp.asarray(x)
    for _ in range(CHAIN):
        acc = JAX_OPS["rsqrt1p"](acc)
    ref = np.asarray(acc)
    assert 0.78 < np.abs(ref).min() and np.abs(ref).max() < 0.79  # the fixed point 0.786
    _assert_chain_close(got, ref, CHAIN_TOL["rsqrt1p"])


@pytest.mark.parametrize("op", kp.OPS)
def test_chain_matches_the_pallas_body_in_interpret_mode(op):
    x = _domain((2, 16, 128), seed=2)
    got = kp.exp_chain_plain(torch.from_numpy(x), op, CHAIN).numpy()
    ref = np.asarray(pallas_chain(JAX_OPS[op], jnp.asarray(x)))
    _assert_chain_close(got, ref, CHAIN_TOL[op])


def test_poly4_chain_overflows_to_minus_infinity_on_both_sides():
    # v^5 + ... - 1 < v for every v <= 0: sixteen applications reach -inf.
    x = _domain((1, 8, 128), seed=3)
    got = kp.exp_chain_plain(torch.from_numpy(x), "poly4").numpy()
    assert np.all(got == -np.inf)
    assert np.all(np.asarray(pallas_chain(op_poly4, jnp.asarray(x))) == -np.inf)


def test_fastexp2_wraps_the_exponent_below_minus_87_like_the_jax_form():
    x = np.array([-86.0, -88.0, -90.5, -100.0, -127.3, -150.0], np.float32)
    got = kp.exp_chain_plain(torch.from_numpy(x), "fastexp2", 1, subtract=False).numpy()
    ref = np.asarray(op_fastexp2(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.uint32) >> 23, ref.view(np.uint32) >> 23)
    np.testing.assert_allclose(got, ref, rtol=2e-6)
    assert got[0] > 0 and got[1] == 0  # biased exponents 3 and 0
    assert (got[2:] < 0).all()  # a negative biased exponent, shifted, sets the sign bit


def test_fastexp2_accuracy_line():
    # exp_micro.py:137-142: max relative error against float64 exp on [-80, 0]
    rel = probes.fastexp2_max_rel_err("cpu")
    xs = jnp.asarray(np.linspace(-80, 0, 100001), jnp.float32)
    ref = np.exp(np.asarray(xs, np.float64))
    jax_rel = np.max(np.abs(np.asarray(op_fastexp2(xs), np.float64) - ref) / ref)
    assert 5e-4 < rel < 1e-3
    assert abs(rel - jax_rel) < 1e-6


def test_exp_chain_options_and_errors():
    x = torch.from_numpy(_domain((2, 8, 8)))
    assert torch.equal(kp.exp_chain(x, "copy", chain=3), x - 1.0 - 1.0 - 1.0)
    assert torch.equal(kp.exp_chain(x, "copy", chain=0), x)
    assert kp.exp_chain(x, "copy", chain=0) is not x
    assert torch.equal(kp.exp_chain(x, "exp", chain=1, subtract=False), torch.exp(x))
    with pytest.raises(ValueError, match="unknown op"):
        kp.exp_chain(x, "sinh")
    with pytest.raises(ValueError, match="chain"):
        kp.exp_chain(x, "exp", chain=-1)
    before = kp.exp_chain.launches
    kp.exp_chain(x, "exp")
    assert kp.exp_chain.launches == before  # only a kernel launch counts


# benchmarks/attn_headpack.py:84-92
def qk_rowsum_kernel(k_ref, qt_ref, o_ref):
    logits_t = jax.lax.dot_general(
        k_ref[...], qt_ref[...],
        (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )
    o_ref[...] = jnp.sum(logits_t, axis=1, keepdims=True)


# benchmarks/attn_headpack.py:94-113, in interpret mode
def pallas_qk_rowsum(k, qt, qblk):
    n, s, d = k.shape
    kspec = pl.BlockSpec((1, s, d), lambda i, r: (i, 0, 0))
    qtspec = pl.BlockSpec((1, d, qblk), lambda i, r: (i, 0, r))
    ospec = pl.BlockSpec((1, 1, qblk), lambda i, r: (i, 0, r))
    return pl.pallas_call(
        qk_rowsum_kernel,
        out_shape=jax.ShapeDtypeStruct((n, 1, s), jnp.float32),
        grid=(n, s // qblk),
        in_specs=[kspec, qtspec],
        out_specs=ospec,
        interpret=True,
    )(k, qt)


def _bf16_pair(n, s, d, seed):
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.standard_normal((n, s, d)).astype(np.float32)).bfloat16()
    qt = torch.from_numpy(rng.standard_normal((n, d, s)).astype(np.float32)).bfloat16()
    return k, qt


def _to_jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)  # exact: the values are bf16 already


@pytest.mark.parametrize("n,s,d,packed", [(4, 128, 8, False), (2, 256, 32, True),
                                          (4, 128, 128, False)],
                         ids=["perhead_d8", "blockdiag_hd32", "perhead_d128"])
def test_qk_rowsum_matches_the_pallas_kernel_in_interpret_mode(n, s, d, packed):
    if packed:  # (b): four heads of (s/4, d/4) per group on the diagonal blocks
        k, qt = kp.block_diagonal_pack(*_bf16_pair(n * 4, s // 4, d // 4, seed=s), heads=4)
    else:
        k, qt = _bf16_pair(n, s, d, seed=s + d)
    assert k.shape == (n, s, d) and qt.shape == (n, d, s)
    got = kp.qk_rowsum(k, qt)  # CPU tensors: the plain version
    assert got.shape == (n, 1, s) and got.dtype == torch.float32
    ref = np.asarray(pallas_qk_rowsum(_to_jax(k), _to_jax(qt), qblk=s // 2))
    err = np.abs(got.numpy() - ref).max()
    assert err <= 2e-5 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_block_diagonal_pack_matches_the_probes_loops():
    b, h, s, d = 2, 4, 16, 8
    k, qt = _bf16_pair(b * h, s, d, seed=9)
    kpk, qtpk = kp.block_diagonal_pack(k, qt, h)
    # benchmarks/attn_headpack.py:134-142
    kp_ref = np.zeros((b, h * s, h * d), np.float32)
    qtp_ref = np.zeros((b, h * d, h * s), np.float32)
    k8n = k.float().numpy().reshape(b, h, s, d)
    qt8n = qt.float().numpy().reshape(b, h, d, s)
    for i in range(h):
        kp_ref[:, i * s:(i + 1) * s, i * d:(i + 1) * d] = k8n[:, i]
        qtp_ref[:, i * d:(i + 1) * d, i * s:(i + 1) * s] = qt8n[:, i]
    np.testing.assert_array_equal(kpk.float().numpy(), kp_ref)
    np.testing.assert_array_equal(qtpk.float().numpy(), qtp_ref)
    assert kpk.dtype == torch.bfloat16
    # the diagonal blocks hold the heads' own logits: the same row sums
    torch.testing.assert_close(kp.qk_rowsum_plain(kpk, qtpk).reshape(b * h, 1, s),
                               kp.qk_rowsum_plain(k, qt), rtol=0, atol=1e-4)


def test_qk_rowsum_refuses_what_it_cannot_take():
    k, qt = _bf16_pair(2, 16, 8, seed=1)
    with pytest.raises(ValueError, match="qt must be"):
        kp.qk_rowsum(k, qt.transpose(1, 2))
    with pytest.raises(ValueError, match="divide"):
        kp.block_diagonal_pack(k[:1], qt[:1], 4)


def test_exp_probe_at_small_size_on_the_cpu(capsys):
    res = probes.run_exp_micro(iters=1, device="cpu", small=True)
    out = capsys.readouterr().out
    assert set(res["ms"]) == set(kp.OPS) == set(res["per_application_ns_per_element"])
    assert res["device"] == "cpu" and "host clock" in res["timer"]
    assert res["chain"] == 16 and 5e-4 < res["fastexp2_max_rel_err"] < 1e-3
    # the JAX probe's lines: exp_micro.py:142, :152
    assert "fastexp2 max_rel_err vs exp on [-80, 0]:" in out
    for op in kp.OPS:
        assert any(line.startswith(f"{op:10s} ") and line.endswith("ms  (chain=16)")
                   for line in out.splitlines()), op


def test_headpack_probe_at_small_size_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "headpack.json"
    res = probes.run_attn_headpack(iters=1, device="cpu", out=str(path), small=True)
    # the JAX probe's keys: attn_headpack.py:115-180
    for key in ("shape", "iters", "perhead_d8_ms", "blockdiag_hd32_ms", "perhead_d128_ms",
                "flash_fwd_ms", "flash_fwdbwd_ms", "packed_over_perhead", "d128_over_d8",
                "verdict"):
        assert key in res, key
    assert res["shape"] == {"B": 2, "H": 4, "S": 128, "D": 8}
    assert res["verdict"] in ("REJECT head-packing", "ACCEPT head-packing")
    assert res["device"] == "cpu" and "host clock" in res["timer"]
    assert json.loads(path.read_text()) == res
    assert "per-head D=8" in capsys.readouterr().out


@pytest.mark.parametrize("which", ["exp", "headpack"])
def test_probe_subcommand_runs_small_on_the_cpu(which, tmp_path, capsys):
    out = tmp_path / f"{which}.json"
    assert cli.main(["probe", which, "--small", "--device", "cpu", "--iters", "1",
                     "--out", str(out)]) == 0
    assert json.loads(out.read_text())["device"] == "cpu"
    assert f"wrote {out}" in capsys.readouterr().out
