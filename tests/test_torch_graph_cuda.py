"""The port's CUDA-graph runner on a card: graphed against eager.

The samplers and the train step run on the card as CUDA graphs
(``utils/graphs.py``); ``graphs=False`` runs the same step eagerly. The same
kernels on the same inputs give the same bits, so the graphed sampler must
equal the eager one exactly, from the same generator, and the f32 train step
too over several steps (under deterministic algorithms, which the eager step
needs to repeat itself: cuDNN's weight gradients may add with atomics). The
bf16 step sums dQ with atomics in an order that changes from run to run, so
it is held to the spread of two eager runs instead. The tests need an NVIDIA
GPU and ``nvcc``, are marked ``cuda`` and skip without a device. The file
imports neither JAX nor the JAX package: on a machine with only PyTorch run

    python -m pytest --noconftest tests/test_torch_graph_cuda.py -q
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch import diffusion as diffusion_mod
from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod
from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import resample as rs
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import graphs, kernels
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import init_params

pytestmark = pytest.mark.cuda

# Image 16, base width 32, Config D: attention at head depths 8 to 32, and
# the filtered GELU's kernel pair in bf16.
SIZE, WIDTH, N, STEPS = 16, 32, 4, 12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels in csrc/ have no CPU mode")
    return torch.device("cuda")


def _config(dtype="bfloat16", **kw):
    return TrainConfig(image_size=SIZE, base_width=WIDTH, variant=3, filters=FilterSettings(),
                       compute_dtype=dtype, noise_steps=STEPS, batch_size=N, seed=0, **kw)


@contextlib.contextmanager
def _deterministic():
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        torch.utils.deterministic.fill_uninitialized_memory = True


def _sample(card, use_graphs, call, num_classes=None):
    cfg = _config(num_classes=num_classes)
    model = build_model(cfg, device=card, state_dict=init_params(cfg, 0))
    d = Diffusion(noise_steps=STEPS, img_size=SIZE, snapshot_every=4, device=card,
                  graphs=use_graphs)
    gen = torch.Generator(device=card).manual_seed(7)
    outs = [call(d, model, gen) for _ in range(2)]  # the second call reuses the graphs
    return outs, gen.get_state()


SAMPLERS = {
    "ddpm_snapshots": lambda d, m, g: d.sample(m, N, 3, generator=g),
    "revert": lambda d, m, g: d.revert(m, N, 3, generator=g),
    "shift": lambda d, m, g: d.sample_shift(m, N, 3, generator=g, shift=3),
    "ddim_eta0_theta": lambda d, m, g: d.sample_ddim(m, N, 3, generator=g, steps=5, theta=30.0),
    "ddim_eta1": lambda d, m, g: d.sample_ddim(m, N, 3, generator=g, steps=5, eta=1.0),
}


def _tensors(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_graphed_sampler_equals_eager(card, name):
    graphed, state_g = _sample(card, True, SAMPLERS[name])
    eager, state_e = _sample(card, False, SAMPLERS[name])
    for a, b in zip(graphed, eager):
        for x, y in zip(_tensors(a), _tensors(b)):
            assert torch.equal(x, y), name
    assert torch.equal(state_g, state_e)  # the caller's generator moved alike
    # the second call drew on from where the first left the generator
    assert not torch.equal(_tensors(graphed[0])[0], _tensors(graphed[1])[0])


def test_graphed_cfg_sampler_equals_eager(card):
    def call(d, m, g):
        return d.sample_ddim(m, N, 3, generator=g, steps=5, eta=1.0, labels=[0, 1, 2, 3],
                             cfg_scale=3.0)

    graphed, _ = _sample(card, True, call, num_classes=4)
    eager, _ = _sample(card, False, call, num_classes=4)
    assert all(torch.equal(a, b) for a, b in zip(graphed, eager))


def test_launch_counters_count_replays(card):
    cfg = _config()
    model = build_model(cfg, device=card, state_dict=init_params(cfg, 0))
    d = Diffusion(noise_steps=STEPS, img_size=SIZE, device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    d.sample(model, N, 3, generator=gen)  # first call: warm-up and capture
    fa.flash_attention_fwd.launches = rs.filtered_gelu_fwd.launches = 0
    d.sample(model, N, 3, generator=gen)
    torch.cuda.synchronize()
    # STEPS - 1 reverse steps, six attention blocks each; every step but the
    # noiseless last one is a replay of one graph, the last one runs eagerly.
    assert fa.flash_attention_fwd.launches == 6 * (STEPS - 1)
    per_forward = rs.filtered_gelu_fwd.launches // (STEPS - 1)
    assert per_forward > 0 and rs.filtered_gelu_fwd.launches == per_forward * (STEPS - 1)
    (sampler,) = diffusion_mod._SAMPLERS[model].values()
    assert sampler.captured == (True,)  # the last, noiseless step comes once: eager


def _train(card, use_graphs, dtype, steps=4, start=None, mesh=None, **kw):
    cfg = _config(dtype, **kw)
    model, state = train_mod.create_train_state(cfg, device=card, mesh=mesh)
    if start is not None:
        start.update({k: v.clone() for k, v in state.params.items()})
    step = train_mod.make_train_step(model, cfg, Diffusion(noise_steps=STEPS, img_size=SIZE,
                                                           device=card), graphs=use_graphs,
                                     mesh=mesh)
    batch = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (N, SIZE, SIZE, 3)).astype(np.float32))
    gen = torch.Generator(device=card)
    losses = []
    for i in range(steps):
        state, loss = step(state, batch.pin_memory(), train_mod.step_generator(gen, 0, i))
        losses.append(loss)
    torch.cuda.synchronize()
    return state, torch.stack(losses)


@pytest.mark.parametrize("knobs", [{}, dict(use_ema=True, grad_accum=2, grad_clip=0.5,
                                            lr_schedule="warmup_cosine", warmup_steps=1,
                                            lr_total_steps=4)], ids=["plain", "knobs"])
def test_graphed_f32_train_step_equals_eager(card, knobs, monkeypatch):
    # With the knobs the updates land on micro-batches 1, 3, 5 and 7: the EMA
    # copies on the first two and blends on the others, so every branch (the
    # accumulating one, and the update with either EMA) is warmed up, then
    # captured and replayed.
    monkeypatch.setattr(train_mod, "STEP_START_EMA", 4)
    with _deterministic():
        graphed, loss_g = _train(card, True, "float32", steps=8, **knobs)
        eager, loss_e = _train(card, False, "float32", steps=8, **knobs)
    assert torch.equal(loss_g, loss_e)
    for field in ("params", "ema_params"):
        for name, value in getattr(graphed, field).items():
            assert torch.equal(value, getattr(eager, field)[name]), (field, name)
    assert (graphed.step, graphed.updates) == (eager.step, eager.updates)
    # the capturable AdamW counts its updates on the device, in step with the
    # host's count that the checkpoint writes (utils/checkpoint.opt_state_arrays)
    for state in (graphed, eager):
        (count,) = {int(s["step"]) for s in state.optimizer.state.values()}
        assert count == state.updates


def _mean_difference(a, b):
    """Mean |a − b| over every parameter entry but the key part of each qkv
    bias (zero true gradient: AdamW moves it on rounding noise alone)."""
    total, count = 0.0, 0
    for name, value in a.items():
        d = (value - b[name]).abs().flatten()
        if name.endswith(".qkv.bias"):
            third = d.numel() // 3
            d = torch.cat([d[:third], d[2 * third:]])
        total, count = total + d.sum().item(), count + d.numel()
    return total / count


def test_graphed_bf16_train_step_within_eager_spread(card):
    start = {}
    graphed, loss_g = _train(card, True, "bfloat16")
    eager, loss_e = _train(card, False, "bfloat16", start=start)
    again, _ = _train(card, False, "bfloat16")
    spread = _mean_difference(eager.params, again.params)
    diff = _mean_difference(graphed.params, eager.params)
    movement = _mean_difference(eager.params, start)
    # Two eager runs differ by dQ's atomic order alone, from whichever step
    # its first differing rounding falls in, so their mean difference varies
    # by orders of magnitude between pairs; the graphed run differs from an
    # eager one alike. Both within 1% of the parameters' mean movement: a
    # step that replayed the wrong noise, batch or lr moves them elsewhere by
    # a share of the movement itself (chip_smoke's BF16_STEP_SHARE).
    assert max(diff, spread) <= 1e-2 * movement, (diff, spread, movement)
    torch.testing.assert_close(loss_g, loss_e, rtol=1e-2, atol=0)


def test_capturable_adamw_against_plain_adamw(card):
    """The card's optimizer keeps its step and lr on the device; its update
    agrees with the plain AdamW's to f32 rounding."""
    rng = np.random.default_rng(2)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(card)
              for s in ((64, 32), (32,))]
    cfg = _config("float32")
    copies = [[p.clone() for p in params] for _ in range(2)]
    opts = [train_mod.make_optimizer(cfg, copies[0]),
            train_mod.make_optimizer(cfg, copies[1], capturable=False)]
    assert opts[0].defaults["capturable"] and not opts[1].defaults["capturable"]
    for i in range(5):
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)).to(card)
                 for p in params]
        for opt, ps in zip(opts, copies):
            train_mod._set_lr(opt, 3e-4 * (i + 1) / 5)
            for p, g in zip(ps, grads):
                p.grad = g.clone()
            opt.step()
    for a, b in zip(*copies):
        # 5 updates of at most lr each: a few f32 ulps of the parameters
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


class _Syncing(graphs.GraphedStep):
    def __init__(self, device):
        super().__init__(device)
        self.x = torch.zeros(4, device=device)

    def step(self, variant):
        self.x.add_(1.0)
        if self.x.sum().item() < 0:  # a host sync: not allowed under capture
            self.x.zero_()


def test_capture_error_raises(card):
    runner = _Syncing(card)
    runner(None)  # the eager warm-up runs
    counts = [w.launches for w in kernels.COUNTED]
    with pytest.raises(RuntimeError):
        runner(None)  # the capture fails and raises: no eager fallback
    assert runner.captured == ()
    assert [w.launches for w in kernels.COUNTED] == counts


def test_graphed_step_binds_its_state(card):
    cfg = _config("float32")
    model, state = train_mod.create_train_state(cfg, device=card)
    step = train_mod.make_train_step(model, cfg, Diffusion(noise_steps=STEPS, img_size=SIZE,
                                                           device=card))
    batch = torch.zeros((N, SIZE, SIZE, 3), device=card)
    gen = torch.Generator(device=card)
    for i in range(2):
        state, _ = step(state, batch, gen)
    _, other = train_mod.create_train_state(dataclasses.replace(cfg), device=card)
    with pytest.raises(ValueError, match="bound to the TrainState"):
        step(other, batch, gen)


@pytest.fixture
def nccl_world_of_one(card):
    """torch.distributed over NCCL with this process as its only rank."""
    import socket

    import torch.distributed as dist

    from aliasfree_diffusion_models_pytorch_tpu_torch.parallel.multihost import init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert init_distributed(f"tcp://localhost:{port}", 1, 0)
    assert dist.get_backend() == "nccl"
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("shape,axes", [((1,), ("data",)), ((1, 1), ("data", "fsdp"))])
def test_graphed_mesh_step_on_one_nccl_rank_equals_the_single_step(card, nccl_world_of_one,
                                                                   shape, axes):
    """The step on a one-rank mesh runs its collectives through NCCL (inside
    the CUDA graphs) and computes the single-device step's bits, f32 under
    deterministic algorithms, over six steps."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.parallel import make_mesh

    mesh = make_mesh(shape, axes)
    with _deterministic():
        single, loss_s = _train(card, True, "float32", steps=6)
        meshed, loss_m = _train(card, True, "float32", steps=6, mesh=mesh)
    assert torch.equal(loss_s, loss_m)
    for name, value in single.params.items():
        assert torch.equal(value, meshed.params[name]), name
