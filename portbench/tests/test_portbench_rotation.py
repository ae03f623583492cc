"""Config E's plain rotation (``reference/rotation.py``) and its cell's driver
(``drivers/rotate.py``) on the CPU.

* The reference against ``scipy.ndimage.rotate(reshape=False,
  mode='grid-wrap', order=3)`` at 8, 16 and 32 px, at angles from 0.0225° to
  90° and their negatives, within 1e-6 of the image's largest entry; and
  against the port's dense ``rotation_operator`` applied by
  ``apply_pixel_operator`` (float32) within 1e-5.
* The reference loads nothing of the port, of JAX or of ``scipy.ndimage``.
* A tiny cell through the driver (8 px, 10 noise steps, seeded random
  weights, a new θ every call) comes out ``correct``; with a fault planted in
  the program's rotation (skipped, applied twice, at −θ, at 1.5 times the
  angle, in bfloat16) it does not.
* The controls of ``update_gap`` (the reference's rotation in TF32 and in
  bfloat16, ``calibrate_rotation.py``) read above the tiny cell's limit, and
  the sound run below it.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import calibrate_rotation
from portbench import run as bench_run
from portbench.reference import rotation as ref_rotation
from portbench.tests.helpers import tiny_bench
from portbench.tests.test_portbench_imports import JAX_SIDE, PORT, _imported, _loaded_after

ANGLES = (0.0225, 0.09, 1.0, 12.5, 45.0, 67.3, 90.0)
SEED = 2**31 + 4099
TINY_LIMITS = {"start_gap": 0.0, "eps_gap": 0.1, "update_gap": 1e-5, "uint8_levels": 1.0,
               "outputs_bad": 0.0}


def _scipy_rotate(img: np.ndarray, degrees: float) -> np.ndarray:
    from scipy import ndimage

    return np.stack([np.stack([ndimage.rotate(img[b, :, :, c], degrees, reshape=False,
                                              mode="grid-wrap", order=3)
                               for c in range(img.shape[3])], -1) for b in range(len(img))])


@pytest.mark.parametrize("size", [8, 16, 32])
@pytest.mark.parametrize("degrees", [a * s for a in ANGLES for s in (1, -1)])
def test_reference_is_scipys_rotation(size, degrees):
    img = np.random.default_rng(size).standard_normal((2, size, size, 3))
    got = ref_rotation.rotate(torch.from_numpy(img), degrees).numpy()
    want = _scipy_rotate(img, degrees)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(img).max()


@pytest.mark.parametrize("size", [8, 16, 32])
@pytest.mark.parametrize("degrees", [0.0225, -0.09, 33.3, -90.0])
def test_reference_is_the_ports_operator(size, degrees):
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops.rotation import (
        apply_pixel_operator,
        rotation_operator,
    )

    img = np.random.default_rng(size + 1).standard_normal((3, size, size, 3))
    port = apply_pixel_operator(torch.from_numpy(img).float(),
                                torch.from_numpy(rotation_operator(size, degrees, 3)))
    got = ref_rotation.rotate(torch.from_numpy(img), degrees)
    assert float((port.double() - got).abs().max()) <= 1e-5 * np.abs(img).max()
    basis = torch.eye(size * size, dtype=torch.float64).reshape(size * size, size, size, 1)
    dense = ref_rotation.rotate(basis, degrees).reshape(size * size, size * size).T.numpy()
    assert np.abs(dense - rotation_operator(size, degrees, 3)).max() <= 1e-6


def test_reference_loads_nothing_of_the_port_jax_or_scipy_ndimage():
    assert not (_imported(Path(ref_rotation.__file__)) & (JAX_SIDE | {PORT, "scipy"}))
    loaded = _loaded_after("import portbench.reference.rotation")
    assert PORT not in loaded and not (loaded & JAX_SIDE)
    assert "scipy" not in loaded  # scipy.ndimage would load scipy


@pytest.fixture()
def tiny(tmp_path):
    """The tiny benchmark with a Config-E cell: D-2N's 8-px model at 10 noise
    steps, n 4, every row and 4 steps of every call checked."""
    bench = tiny_bench(tmp_path)
    cfg = json.loads((tmp_path / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny-e", noise_steps=10,
               rotation={"order": 3, "per_step": "theta / noise_steps"})
    (tmp_path / "configs" / "tiny-e.json").write_text(json.dumps(cfg))
    mix = {"driver": "rotate", "n": 4, "theta_range": [-90.0, 90.0], "settle_s": 0.01,
           "check": {"rows": 4, "steps": 4, "first_calls": 3, "block": 8}}
    (tmp_path / "mixes" / "rot.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": "tiny-rotate", "config": "tiny-e", "traffic": "rot",
                               "chips": 1, "why": "test"})
    limits = {"numbers": {k: {"limit": v} for k, v in TINY_LIMITS.items()}}
    (tmp_path / "limits" / "tiny-rotate.json").write_text(json.dumps(limits))

    def run(records=None) -> dict:
        return bench_run.run_cell("tiny-rotate", SEED, 0.3, False, "cpu", bench=bench,
                                  base=tmp_path, t_start=time.perf_counter(), records=records)
    return run


def test_sound_rotation_run_is_correct(tiny):
    records: dict = {}
    result = tiny(records)
    assert result["correct"], result["checks"]
    assert result["checks"]["update_gap"]["value"] > 0.0  # float32 against float64
    thetas = records["thetas"]
    assert len(set(thetas.values())) == len(thetas) and all(-90 <= t <= 90 for t in thetas.values())
    assert set(records["kept"]) <= set(thetas)


def _rotation_fault(fault: str, monkeypatch):
    from aliasfree_diffusion_models_pytorch_tpu_torch import diffusion

    real_apply, real_build = diffusion.apply_pixel_operator, diffusion.build_rotation
    if fault in ("minus_theta", "wrong_angle"):
        scale = -1.0 if fault == "minus_theta" else 1.5

        def build(size, degrees, *a, **k):
            return real_build(size, scale * degrees, *a, **k)
        monkeypatch.setattr(diffusion, "build_rotation", build)
        return

    def apply(x, m):
        if fault == "skipped":
            return x
        if fault == "twice":
            return real_apply(real_apply(x, m), m)
        return real_apply(x.bfloat16(), m.bfloat16()).float()  # "bf16"
    monkeypatch.setattr(diffusion, "apply_pixel_operator", apply)


@pytest.mark.parametrize("fault", ["skipped", "twice", "minus_theta", "wrong_angle", "bf16"])
def test_broken_rotation_is_not_correct(tiny, fault, monkeypatch):
    _rotation_fault(fault, monkeypatch)
    result = tiny()
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("kind", sorted(calibrate_rotation.PRECISIONS))
def test_rotation_controls_read_above_the_limit(tiny, kind):
    records: dict = {}
    assert tiny(records)["correct"]
    numbers = calibrate_rotation.rotation_readings(records, kind)
    assert numbers["update_gap"] > 10 * TINY_LIMITS["update_gap"], numbers


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11 + 2.0**-12, -(1.0 + 2.0**-12), 3.0])
    assert calibrate_rotation.tf32(x).tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, -1.0, 3.0]
