"""The plain reference against the port at tiny sizes on the CPU, and the
frozen FLOP and bound arithmetic against the figures it was frozen from."""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from portbench.lib import bounds, cost, spec
from portbench.lib import weights as wlib
from portbench.reference import data as ref_data
from portbench.reference import diffusion as ref_diffusion
from portbench.reference import filters as ref_filters
from portbench.reference import train as ref_train
from portbench.reference import unet as ref_unet

TINY = dict(image_size=16, base_width=8, time_dim=32, noise_steps=50)


def _tiny(variant: int) -> tuple[dict, ref_unet.Model, object]:
    """A tiny configuration file's dict, its reference model and the port's
    float32 TrainConfig of the same model."""
    from portbench.lib import program

    cfg = spec.config("cifar10-D-2N" if variant else "cifar10-A")
    cfg.update(TINY, variant=variant, compute_dtype="float32")
    if variant in (1, 2) and cfg["filters"] is None:
        cfg["filters"] = spec.config("cifar10-D-2N")["filters"]
    return cfg, ref_unet.Model.from_config(cfg), program.train_config(cfg, "t", batch_size=4)


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_forward_matches_the_port(variant):
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model

    _, model, config = _tiny(variant)
    w = wlib.make(model, 11, "cpu")
    port = build_model(config, device="cpu", state_dict=w)
    x = torch.randn(3, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([1, 17, 49])
    with torch.no_grad():
        got, ref = port(x, t), ref_unet.forward(w, model, x, t)
    # float32 on both sides, the same operations in other orders (cuDNN-free
    # CPU convolutions, einsum against conv for the FIRs): a few ulps of the
    # largest entry
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert ref.std() > 0.3  # the seeded weights give the model something to say


@pytest.mark.parametrize("resumed", [False, True])
@pytest.mark.parametrize("variant", [0, 3])
def test_train_step_matches_the_port(variant, resumed):
    """One step from the same weights, t and noise: the loss, the gradient
    as AdamW got it, the update and the EMA, which copies at first and, in a
    run resumed at the configuration's ``ema_start_steps``, blends."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    cfg, model, config = _tiny(variant)
    w = wlib.make(model, 12, "cpu")
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(4, 16, 16, 3, generator=gen) * 2 - 1
    t = torch.randint(1, cfg["noise_steps"], (4,), generator=gen)
    eps = torch.randn(4, 16, 16, 3, generator=gen)
    _, state = create_train_state(config, device="cpu", state_dict=w)
    start = cfg["ema_start_steps"] if resumed else 0
    state.step = start
    step = make_train_step(*create_train_state(config, device="cpu", state_dict=w)[:1], config,
                           Diffusion(noise_steps=cfg["noise_steps"], img_size=16, device="cpu"),
                           graphs=False)
    state, loss = step(state, x, None, t=t, noise=eps)
    ref = ref_train.run(w, model, cfg, [x], [(t, eps)], start_step=start)
    assert float(loss) == pytest.approx(ref["losses"][0], rel=1e-5)
    for name, p in state.params.items():
        g_prog = state.optimizer.state[p]["exp_avg"] / 0.1
        g_ref = ref["grads"][0][name]
        assert (g_prog - g_ref).abs().max() <= 1e-4 * g_ref.abs().max() + 1e-12, name
        # AdamW's first step is ±lr where the gradient is not nought to rounding
        big = g_ref.abs() > 1e-3 * g_ref.abs().max()
        d_prog, d_ref = (p - w[name])[big], (ref["params"][name] - w[name])[big]
        assert (d_prog - d_ref).abs().max() <= 1e-3 * cfg["lr"], name
        if resumed:  # the EMA blends: it moves by (1 − β) of the parameters' change
            # (a hundredth of that move: float32 rounds the blend of weights
            # near 1 to a few 1e-9; a copy, or another β, is off by far more)
            d_ema, d_ref_ema = state.ema_params[name] - w[name], ref["ema"][name] - w[name]
            assert (d_ema - d_ref_ema)[big].abs().max() <= 1e-2 * cfg["lr"] * (
                1.0 - cfg["ema_beta"]), name
            assert not torch.equal(state.ema_params[name], p)
        else:
            assert torch.equal(state.ema_params[name], p)  # the EMA copies at first
    if not resumed:
        assert all(torch.equal(ref["ema"][n], ref["params"][n]) for n in ref["params"])


def test_flop_count_is_bench_torch_s():
    """The reference counts 3,179,667,456 FLOPs an image for D-2N's forward
    and backward at 32 px: exactly bench_torch.py's count (PERF.md §5),
    since it counts the same operations (the FIR layers as depthwise
    convolutions, zero-stuffed samples included; the attention cores by SDPA's
    five-product backward) over the same shapes."""
    model = ref_unet.Model.from_config(spec.config("cifar10-D-2N"))
    assert cost.flops_per_image(model, backward=True) == 3_179_667_456
    # the forward alone is a little under a third of it: the backward of the
    # input layer's data gradient is not taken
    fwd = cost.flops_per_image(model, backward=False)
    assert 0.32 < fwd / 3_179_667_456 < 0.34


def test_bounds_are_perf_md_s():
    """The frozen arithmetic gives PERF.md §6's bounds: the bf16 attention
    forward of one n=16 sampling forward 0.0186 ms, the six backward calls of
    a batch-256 step 0.311 ms, the filtered-GELU pair of that step (22 + 22
    calls) 0.462 ms."""
    model = ref_unet.Model.from_config(spec.config("cifar10-D-2N"))
    fwd = bounds.bound([bounds.attention_fwd(bh, s, d)
                        for _, bh, s, d in ref_unet.attention_shapes(model, 16)])
    bwd = bounds.bound([bounds.attention_bwd(bh, s, d)
                        for _, bh, s, d in ref_unet.attention_shapes(model, 256)])
    shapes = ref_unet.filtered_gelu_shapes(model, 256)
    assert sum(shapes.values()) == 22
    fg = bounds.bound([bounds.fg(math.prod(sh), 3, b) for sh, n in shapes.items()
                       for b in (False, True) for _ in range(n)])
    assert round(1e3 * fwd, 4) == 0.0186
    assert round(1e3 * bwd, 3) == 0.311
    assert round(1e3 * fg, 3) == 0.462
    assert ref_unet.filtered_gelu_shapes(
        ref_unet.Model.from_config(spec.config("cifar10-A")), 256) == {}


def test_taps_table_schedule_and_order_are_the_port_s():
    from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings
    from aliasfree_diffusion_models_pytorch_tpu_torch.data import splitmix64_permutation
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.blocks import design_taps
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import _time_embedding_table

    filters = spec.config("cifar10-D-2N")["filters"]
    for ours, theirs in zip(ref_filters.design(filters), design_taps(FilterSettings(**filters))):
        assert np.array_equal(ours, theirs)
    assert np.array_equal(ref_unet._time_table_np(1024, 256), _time_embedding_table(1024, 256))
    cfg = spec.config("cifar10-D-2N")
    ours, theirs = ref_diffusion.Schedule(cfg), Diffusion(noise_steps=1000, device="cpu")
    assert torch.equal(ours.alpha_hat, theirs.alpha_hat)
    x = torch.linspace(-1.3, 1.3, 1001)
    assert torch.equal(ref_diffusion.to_uint8(x), Diffusion.to_uint8(x))
    for seed, epoch in ((0, 0), (2**31 - 5, 3)):
        assert np.array_equal(ref_data.permutation(997, seed, epoch),
                              splitmix64_permutation(997, seed, epoch))


def test_config_files_name_the_port_s_parameters():
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model

    from portbench.lib import program

    for name in ("cifar10-D-2N", "cifar10-A"):
        cfg = spec.config(name)
        model = ref_unet.Model.from_config(cfg)
        port = build_model(program.train_config(cfg, "t"), device="meta")
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
            ref_unet.param_shapes(model)
        assert list(port.state_dict()) == list(ref_unet.param_shapes(model))
        assert json.loads(json.dumps(cfg)) == cfg
    assert dataclasses.is_dataclass(ref_unet.Model)
