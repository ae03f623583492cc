"""The reference's ``.pt`` checkpoints in the port (``utils/torch_compat.py``)
against the JAX package's maps.

* ``torch_to_flax`` and ``flax_to_torch`` give the JAX package's keys and
  arrays, bit for bit (numpy transposes only), for variants 0-4 (variant 4
  with its dead ``norm1`` parameters) and the conditional model;
* a ``.pt`` saved from the JAX package's ``flax_to_torch`` loads through
  ``load_reference_state_dict`` into the same port model as
  ``params_from_jax`` gives (bit-equal weights, ``strict=True``), and its
  forward matches the JAX ``UNet.apply`` at ``test_torch_unet.py``'s
  tolerance (f32 on the CPU, JAX at Precision.HIGHEST: atol 5e-4, rtol 1e-3).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu.config import FilterSettings as JFilters
from aliasfree_diffusion_models_pytorch_tpu.models.unet import UNet as JUNet
from aliasfree_diffusion_models_pytorch_tpu.utils import torch_compat as jcompat
from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import torch_compat, weights

SIZE = 16
FILTERS = dict(kernel_size=3, kaiser_beta=2.0, omega_c_down=math.pi / 2, omega_c_up=math.pi / 2)
ATOL, RTOL = 5e-4, 1e-3
CASES = [(0, None), (1, None), (2, None), (3, None), (4, None), (3, 5)]
IDS = ["v0", "v1", "v2", "v3", "v4", "v3_conditional"]


def _jax(variant, num_classes):
    jmodel = JUNet(c_in=3, c_out=3, image_size=SIZE, variant=variant, num_classes=num_classes,
                   filters=None if variant == 0 else JFilters(**FILTERS),
                   precision=jax.lax.Precision.HIGHEST)
    params = jmodel.init_params(jax.random.key(variant + 10), batch=1)
    return jmodel, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("variant,num_classes", CASES, ids=IDS)
def test_maps_equal_the_jax_packages(variant, num_classes):
    _, params = _jax(variant, num_classes)
    ours, theirs = torch_compat.flax_to_torch(params, variant), jcompat.flax_to_torch(params,
                                                                                     variant)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key], value, err_msg=key)
    if variant == 4:
        assert "down1.norm1.weight" in ours and "up3.norm1.bias" in ours  # dead in the reference
    # and back, from numpy arrays and from torch tensors
    back = torch_compat.torch_to_flax({k: torch.tensor(v) for k, v in ours.items()})
    jback = jcompat.torch_to_flax(theirs)
    flat, jflat = weights._flatten(back), weights._flatten(jback)
    assert set(flat) == set(jflat) == set(weights._flatten(params))
    for key, value in jflat.items():
        np.testing.assert_array_equal(flat[key], value, err_msg=key)


@pytest.mark.parametrize("variant,num_classes", [(4, None), (3, 5)], ids=["v4", "v3_conditional"])
def test_reference_pt_runs_in_the_port(tmp_path, variant, num_classes):
    jmodel, params = _jax(variant, num_classes)
    path = tmp_path / "ckpt_CIFAR10.pt"
    torch.save({k: torch.tensor(v)
                for k, v in jcompat.flax_to_torch(params, variant).items()}, path)
    config = TrainConfig(image_size=SIZE, image_channels=3, variant=variant,
                         num_classes=num_classes,
                         filters=None if variant == 0 else FilterSettings(**FILTERS))
    model = torch_compat.load_reference_state_dict(str(path), config, device="cpu")
    expect = weights.params_from_jax(params)
    got = model.state_dict()
    assert set(got) == set(expect)
    for key, value in expect.items():
        assert torch.equal(got[key], value), key

    rng = np.random.default_rng(variant)
    x = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    t = np.array([500, 3], dtype=np.int32)
    extra_j, extra_t = (), ()
    if num_classes:
        y = np.array([1, 4], dtype=np.int32)
        extra_j, extra_t = (jnp.asarray(y),), (torch.from_numpy(y).long(),)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t), *extra_j))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t).long(), *extra_t).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
