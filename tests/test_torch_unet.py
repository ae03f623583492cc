"""Port vs JAX package: the UNet forward, weight conversion and checkpoints.

Weights come from the JAX ``init_params`` and reach the port through
``params_from_jax`` (every load ``strict=True``); inputs are numpy arrays
from a seed. Both sides run f32 on the CPU, the JAX side at
Precision.HIGHEST, so ``tests/test_reference_parity.py``'s tolerance holds:
atol 5e-4, rtol 1e-3.
"""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu.config import FilterSettings as JFilters
from aliasfree_diffusion_models_pytorch_tpu.models.unet import UNet as JUNet
from aliasfree_diffusion_models_pytorch_tpu.models.unet import param_count as j_param_count
from aliasfree_diffusion_models_pytorch_tpu.utils.checkpoint import save_checkpoint
from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import (
    UNet,
    build_model,
    model_summary,
    param_count,
)
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import weights

SIZE = 16
FILTERS = dict(kernel_size=3, kaiser_beta=2.0, omega_c_down=math.pi / 2, omega_c_up=math.pi / 2)
ATOL, RTOL = 5e-4, 1e-3


def _pair(variant, num_classes=None, c=3, dtype=None, precision=jax.lax.Precision.HIGHEST):
    jmodel = JUNet(c_in=c, c_out=c, image_size=SIZE, variant=variant, num_classes=num_classes,
                   filters=None if variant == 0 else JFilters(**FILTERS),
                   dtype=dtype, precision=precision)
    params = jmodel.init_params(jax.random.key(variant), batch=1)
    tmodel = UNet(c_in=c, c_out=c, image_size=SIZE, variant=variant, num_classes=num_classes,
                  filters=None if variant == 0 else FilterSettings(**FILTERS))
    tmodel.load_state_dict(weights.params_from_jax(params), strict=True)
    return jmodel, params, tmodel.eval()


def _inputs(seed, n=2, c=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, SIZE, SIZE, c)).astype(np.float32)
    t = np.array([500, 3, 999, 1][:n], dtype=np.int32)
    return x, t


def _port(tmodel, x, t, *extra):
    with torch.no_grad():
        return tmodel(torch.from_numpy(x), torch.from_numpy(t).long(), *extra).numpy()


@pytest.mark.parametrize("variant", [0, 1, 2, 3, 4])
def test_forward_parity(variant):
    jmodel, params, tmodel = _pair(variant)
    x, t = _inputs(variant)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    out = _port(tmodel, x, t)
    assert out.dtype == np.float32 and out.shape == x.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    assert param_count(tmodel) == j_param_count(params)


def test_conditional_forward_with_y_mask():
    jmodel, params, tmodel = _pair(3, num_classes=5)
    x, t = _inputs(11, n=3)
    y = np.array([1, 4, 0], dtype=np.int32)
    mask = np.array([1.0, 0.0, 1.0], dtype=np.float32)
    ref = np.asarray(jax.jit(jmodel.apply)(params, *map(jnp.asarray, (x, t, y, mask))))
    out = _port(tmodel, x, t, torch.from_numpy(y).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    # mask 0 is the unconditional model (a batch of 1 takes another CPU
    # convolution path than a batch of 3: summation order only)
    uncond = _port(tmodel, x[1:2], t[1:2])
    np.testing.assert_allclose(out[1:2], uncond, atol=1e-5)


def test_attention_held_against_pallas_kernel(monkeypatch):
    """AFDM_FLASH_ATTN=1 sends every JAX attention block through the Pallas
    forward (interpret mode on the CPU), so the port's attention is held
    against the TPU kernel's own function in place."""
    monkeypatch.setenv("AFDM_FLASH_ATTN", "1")
    jmodel, params, tmodel = _pair(3, c=1)
    x, t = _inputs(5, c=1)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(_port(tmodel, x, t), ref, atol=ATOL, rtol=RTOL)


def test_bf16_forward():
    """bf16 is held against the f32 function, beside the JAX bf16 model:
    both round activations to 8 mantissa bits through ~40 layers, in
    different places (the JAX bf16 path fuses its filtered GELU into a
    polyphase form), so the port's error may not exceed twice the JAX
    model's own bf16 error."""
    jmodel, params, tmodel = _pair(3)
    jbf16 = dataclasses.replace(jmodel, dtype=jnp.bfloat16, precision=None)
    x, t = _inputs(8)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    jax_bf16 = np.asarray(jax.jit(jbf16.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    out = _port(tmodel.to(torch.bfloat16), x, t)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    err_port = np.abs(out - ref).max()
    err_jax = np.abs(jax_bf16 - ref).max()
    assert err_port <= 2 * err_jax + 1e-3, (err_port, err_jax)


def test_npz_checkpoint_loads(tmp_path):
    jmodel, params, _ = _pair(3, num_classes=4)
    ema = jax.tree.map(lambda a: a * 0.5, params)
    state = types.SimpleNamespace(params=params, ema_params=ema, step=np.int32(7))
    path = save_checkpoint(str(tmp_path / "ckpt_MNIST_3"), state, backend="npz")
    config = TrainConfig(image_size=SIZE, variant=3, num_classes=4,
                         filters=FilterSettings(**FILTERS))
    for use_ema, tree in ((False, params), (True, ema)):
        sd = weights.load_jax_npz(str(tmp_path / "ckpt_MNIST_3"), ema=use_ema)
        model = build_model(config, device="cpu", state_dict=sd)
        expect = weights.params_from_jax(tree)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, expect[k], rtol=0, atol=0)
    assert path.endswith(".npz")
    with pytest.raises(ValueError, match="Orbax"):
        weights.load_jax_npz(str(tmp_path))


def test_init_params_seeded_torch_defaults():
    config = TrainConfig(image_size=SIZE, variant=3, num_classes=3,
                         filters=FilterSettings(**FILTERS))
    a, b = weights.init_params(config, 1), weights.init_params(config, 1)
    c = weights.init_params(config, 2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["sa1.qkv.weight"], c["sa1.qkv.weight"])
    assert not a["sa1.qkv.bias"].any() and not a["sa1.out.bias"].any()
    w = a["inc.conv1.conv.weight"]
    assert w.abs().max() <= 1.0 / math.sqrt(w[0].numel()) + 1e-7  # kaiming(a=√5) bound
    model = build_model(config, device="cpu", state_dict=a)
    assert "UNet variant 3" in model_summary(model)
