"""``bench_torch.py``, the port's bench, held to ``bench.py`` and to the JAX
package on the CPU.

bench.py is read, never imported or run: its output keys, its ``TrainConfig``
call and its phase names come from its AST. The bench runs here as a user
runs it (``python bench_torch.py --device cpu``, and without a card and
without that flag, where it must fail), and its mesh branch on two gloo
ranks (``tests/_torch_parallel_worker.py``). Its FLOP count is held to the
route-independent model count: the same under every ``AFDM_FG_IMPL`` and
``AFDM_GELU``, linear in the batch, and its batched matmuls, the attention
cores, equal to PyTorch's SDPA formula over the six attention blocks. Its
step is held to the JAX package's first step at image 8 and base width 8
(``tests/test_torch_train.py``'s size and loss tolerance, rtol 2e-5: one f32
forward on each side).
"""

import ast
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random
from torch.utils.flop_counter import sdpa_backward_flop_count, sdpa_flop_count

import _torch_parallel_worker as worker
from aliasfree_diffusion_models_pytorch_tpu.config import FilterSettings as JFilters
from aliasfree_diffusion_models_pytorch_tpu.config import TrainConfig as JTrainConfig
from aliasfree_diffusion_models_pytorch_tpu.diffusion import Diffusion as JDiffusion
from aliasfree_diffusion_models_pytorch_tpu.train import create_train_state as j_create_train_state
from aliasfree_diffusion_models_pytorch_tpu.train import make_train_step as j_make_train_step
from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import params_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
BENCH = REPO / "bench_torch.py"
LOSS_RTOL = 2e-5
RUN_TIMEOUT_S = 300
# Model FLOPs of one forward and backward of Config D at 32 px (base width 32)
# and at 64 px (base width 64), per image: the conv form's convolutions, the
# linears, and PyTorch's SDPA formula for the six attention cores.
FLOPS_32PX, FLOPS_64PX = 3_179_667_456, 59_369_127_936
# (channels, side) of the six attention blocks sa1..sa6 at image 32, base width 32
ATTENTION_32PX = [(64, 16), (128, 8), (128, 4), (64, 8), (32, 16), (32, 32)]
HEADS = 4


def _load_bench():
    spec = importlib.util.spec_from_file_location("bench_torch", BENCH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


bench = _load_bench()


def _bench_py_main() -> ast.FunctionDef:
    tree = ast.parse((REPO / "bench.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _assigned(name: str) -> ast.expr:
    """The value of bench.py's ``main`` assignment to ``name``."""
    return next(n.value for n in ast.walk(_bench_py_main()) if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name) and n.targets[0].id == name)


def _bench_py_keys() -> tuple[list[str], list[str]]:
    """bench.py's output keys: the ``out`` dict's own, and the 64-px ones it
    spreads in (``**t64``)."""
    out = _assigned("out")
    t64 = next(n.value for n in ast.walk(_bench_py_main()) if isinstance(n, ast.Assign)
               and isinstance(n.targets[0], ast.Name) and n.targets[0].id == "t64"
               and isinstance(n.value, ast.Dict) and n.value.keys)
    return [k.value for k in out.keys if k is not None], [k.value for k in t64.keys]


def _bench_py_phases() -> list[str]:
    return [n.args[0].value for n in ast.walk(_bench_py_main()) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name) and n.func.id == "_phase"]


def _branch(node: ast.expr, on_card: bool):
    """A constant, or one branch of ``a if on_tpu else b``."""
    if isinstance(node, ast.IfExp):
        assert isinstance(node.test, ast.Name) and node.test.id == "on_tpu"
        return ast.literal_eval(node.body if on_card else node.orelse)
    return ast.literal_eval(node)


def _bench_py_config_kwargs(on_card: bool) -> dict:
    """The keyword arguments of bench.py's ``TrainConfig(...)`` call on one
    branch, on one device: ``filters`` as the JAX ``FilterSettings()``."""
    call = next(n for n in ast.walk(_bench_py_main()) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Name) and n.func.id == "TrainConfig")
    kwargs = {}
    for kw in call.keywords:
        if kw.arg == "filters":
            assert isinstance(kw.value, ast.Call) and kw.value.func.id == "FilterSettings"
            assert not kw.value.args and not kw.value.keywords
            kwargs[kw.arg] = JFilters()
        elif kw.arg == "batch_size":
            # batch = (256 if on_tpu else 16) * max(1, <devices>): one device here
            assert isinstance(kw.value, ast.Name) and kw.value.id == "batch"
            batch = _assigned("batch")
            assert isinstance(batch, ast.BinOp) and isinstance(batch.op, ast.Mult)
            kwargs[kw.arg] = _branch(batch.left, on_card)
        else:
            kwargs[kw.arg] = _branch(kw.value, on_card)
    return kwargs


def _run_bench(*args, env=None):
    env = {**os.environ, "OMP_NUM_THREADS": "2", **(env or {})}
    return subprocess.run([sys.executable, str(BENCH), *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=RUN_TIMEOUT_S)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def test_cpu_branch_prints_bench_py_keys():
    proc = _run_bench("--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0])
    keys, _ = _bench_py_keys()
    assert list(out) == keys  # bench.py's CPU branch: no train64_* keys
    assert list(out["phase_s"]) == _bench_py_phases()
    assert out["metric"] == "train_imgs_per_sec_chip"
    assert (out["backend"], out["device_kind"], out["compute_dtype"]) == ("cpu", "cpu", "float32")
    assert (out["batch_size"], out["n_devices"], out["mesh"]) == (16, 1, None)
    assert out["flops_per_step"] == 16 * FLOPS_32PX
    assert out["mfu"] is None  # no peak for a CPU
    assert out["sample_1000step_n16_wall_s"] is None and out["ddim_50step_n16_wall_s"] is None
    for key in ("value", "vs_baseline", "step_ms", "final_loss"):
        assert math.isfinite(out[key]) and out[key] > 0, key
    assert out["vs_baseline"] == pytest.approx(out["value"] / bench.A100_TORCH_IMGS_PER_SEC_EST,
                                               abs=1e-3)
    # stderr: the launches of the three timed steps (none on the CPU) and the impl report
    launches = json.loads(re.search(r"launches (\{[^}]*\})", proc.stderr).group(1))
    assert launches == {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                        "filtered_gelu_fwd": 0, "filtered_gelu_bwd": 0,
                        "plain_gelu_fwd": 0, "plain_gelu_bwd": 0,
                        "layer_norm_fwd": 0, "layer_norm_bwd": 0}
    assert "impl.fg_impl_perf: phases | impl.fg_impl_parity: conv" in proc.stderr


def test_without_a_card_the_bench_fails():
    proc = _run_bench(env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "--device cpu" in proc.stderr


@pytest.mark.parametrize("on_card", [True, False], ids=["cuda", "cpu"])
def test_config_is_bench_py_config(on_card):
    kwargs = _bench_py_config_kwargs(on_card)
    assert kwargs["compute_dtype"] == ("bfloat16" if on_card else "float32")
    assert kwargs["batch_size"] == (256 if on_card else 16)
    config = bench.bench_config("cuda" if on_card else "cpu")
    assert config == TrainConfig(**{**kwargs, "filters": FilterSettings()})
    assert dataclasses.asdict(FilterSettings()) == dataclasses.asdict(JFilters())
    # and the JAX package reads the same settings into its own config
    jconfig = JTrainConfig(**kwargs)
    shared = ({f.name for f in dataclasses.fields(JTrainConfig)}
              & {f.name for f in dataclasses.fields(TrainConfig)}) - {"filters"}
    assert {n: getattr(config, n) for n in shared} == {n: getattr(jconfig, n) for n in shared}
    # bench.py's images
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        bench.bench_images(np.random.default_rng(0), 4, 32),
        rng.standard_normal((4, 32, 32, 3)).astype(np.float32))


@pytest.mark.parametrize("env", [{}, {"AFDM_FG_IMPL": "conv"}, {"AFDM_FG_IMPL": "phases"},
                                 {"AFDM_GELU": "poly13"}],
                         ids=["default", "fg_conv", "fg_phases", "gelu_poly13"])
def test_flop_count_does_not_depend_on_the_route(env, monkeypatch):
    for name in ("AFDM_FG_IMPL", "AFDM_GELU"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for dtype in ("bfloat16", "float32"):
        config = dataclasses.replace(bench.bench_config("cuda"), compute_dtype=dtype)
        assert bench.step_flops(config)["total"] == FLOPS_32PX, dtype
    assert os.environ.get("AFDM_FG_IMPL") == env.get("AFDM_FG_IMPL")  # put back


@pytest.mark.parametrize("n, shape", [(1, (1, 1)), (2, (2, 1)), (3, (3, 1)), (4, (2, 2)),
                                      (6, (3, 2)), (8, (4, 2))])
def test_mesh_shape_is_bench_py_shape(n, shape):
    assert bench.bench_mesh_shape(n) == shape


def test_flop_count_is_linear_in_the_batch_and_counts_sdpa_for_attention():
    config = bench.bench_config("cuda")
    one, two = bench.step_flops(config, 1), bench.step_flops(config, 2)
    assert two["total"] == 2 * one["total"]
    assert two["by_op"] == {op: 2 * n for op, n in one["by_op"].items()}
    sdpa = 0
    for channels, side in ATTENTION_32PX:
        shape = (1, HEADS, side * side, channels // HEADS)
        fwd, bwd = sdpa_flop_count(shape, shape, shape), sdpa_backward_flop_count(
            shape, shape, shape, shape)
        # two products forward; five backward, the scores recomputed among them
        b, h, s, d = shape
        assert (fwd, bwd) == (4 * b * h * s * s * d, 10 * b * h * s * s * d)
        sdpa += fwd + bwd
    assert one["by_op"]["aten.bmm"] == sdpa  # the batched matmuls are the attention cores
    assert set(one["by_op"]) == {"aten.convolution", "aten.convolution_backward", "aten.addmm",
                                 "aten.mm", "aten.bmm"}
    config64 = dataclasses.replace(config, image_size=64, batch_size=32)
    assert bench.step_flops(config64)["total"] == FLOPS_64PX


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)  # copies: the jitted step donates its state


def test_bench_step_matches_jax_first_step():
    """The step the bench times, at image 8 and base width 8, against the
    JAX package's ``make_train_step`` from the same weights on bench.py's
    images, with t and noise from bench.py's first warm-up key."""
    kwargs = {**_bench_py_config_kwargs(on_card=False), "image_size": 8, "base_width": 8}
    jconfig = JTrainConfig(**kwargs)
    jmodel, jstate = j_create_train_state(jconfig, random.key(0))
    weights = params_from_jax(_numpy_tree(jstate.params))
    jdiff = JDiffusion(noise_steps=jconfig.noise_steps, img_size=8)
    jstep = j_make_train_step(jmodel, jconfig, jdiff, mesh=None)
    batch = jconfig.batch_size
    images = bench.bench_images(np.random.default_rng(0), batch, 8)
    key = random.key(0)
    tkey, nkey, _ = random.split(key, 3)  # as the JAX loss_fn splits its step key
    t = np.array(jdiff.sample_timesteps(tkey, batch)).astype(np.int64)
    noise = np.array(random.normal(nkey, images.shape, jnp.float32))
    _, jloss = jstep(jstate, jnp.asarray(images), key)

    config = dataclasses.replace(bench.bench_config("cpu"), image_size=8, base_width=8)
    _, state, step = bench.build_step(config, torch.device("cpu"), state_dict=weights)
    state, loss = step(state, torch.from_numpy(images), None, t=torch.from_numpy(t),
                       noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert state.step == 1


def test_mesh_branch_on_two_ranks(tmp_path):
    """The bench under torch.distributed with two gloo ranks takes bench.py's
    mesh branch: a (2, 1) mesh, the global batch twice the CPU's, no FLOP
    count, and one line, from rank 0."""
    cases = {"bench": {"bench": str(BENCH), "argv": ["--device", "cpu"]}}
    ranks = worker.launch(cases, str(tmp_path), timeout=RUN_TIMEOUT_S)
    assert [r["bench"]["exit"] for r in ranks] == [0, 0]
    assert ranks[1]["bench"]["stdout"] == ""
    lines = ranks[0]["bench"]["stdout"].strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert list(out) == _bench_py_keys()[0]
    assert out["n_devices"] == 2 and out["mesh"] == {"data": 2, "fsdp": 1}
    assert out["batch_size"] == 32 and out["flops_per_step"] is None and out["mfu"] is None
    assert math.isfinite(out["final_loss"]) and out["value"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / bench.A100_TORCH_IMGS_PER_SEC_EST,
                                               abs=1e-3)
