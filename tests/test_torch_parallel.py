"""The port's data-parallel and FSDP training against the single-process step
and the JAX package's mesh step.

Two gloo ranks on the CPU (``tests/_torch_parallel_worker.py``, started once
for the module by ``torch.multiprocessing`` with a free port) run Config D
(variant 3, f32, image 8, base width 8) from the JAX initialisation
(``params_from_jax``): three steps on a ``(2, 1)`` ``data`` mesh, the same on
a ``(1, 2)`` ``fsdp`` mesh, a padded batch (three real rows and one
duplicate) on the data mesh, ``train()`` for an epoch on the fsdp mesh (three
steps under an accumulation window of two, with ``profile_dir``), and a second
epoch resumed from its checkpoint on the fsdp mesh; a single-device run
resumes that checkpoint too. Each rank steps its rows
of the global batch with the global batch's timesteps and noise, which the
test draws with the JAX package's per-step key split (as
``tests/test_torch_train.py``) and hands to both packages; the JAX side is
``make_train_step(..., mesh=make_mesh((2, 1), ("data", "fsdp"),
devices=jax.devices()[:2]))`` on the virtual CPU devices.

Tolerances. Against the JAX step, ``tests/test_torch_train.py``'s: loss rtol
2e-5, parameters atol 2e-6 with at most 0.1% of a tensor's entries (two in a
small tensor) allowed up to the bound both sides obey, 2·lr per update, and
the key bias (zero true gradient) held to that bound only. Against the port's
single-process step the arithmetic is the same but for the order of one sum:
each gradient is the sum of the two ranks' partial sums (the loss of their
two rows each) where the single step sums all four rows at once. That moves
a gradient by f32 rounding of its size (~1e-7 relative), and AdamW passes it
through as it passes the frameworks' difference, so the same tolerances
hold, not loosened; the loss, the sum of two halves against one mean, to
rtol 1e-6. The checkpoints' AdamW moments and accumulated gradients, sums of
such gradients, are held to 1e-5 of each tensor's largest entry: the largest
difference measured here is 2.6e-6 of it (the accumulated gradient of a group
norm's scale), the update count and the window's place exactly.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import _torch_parallel_worker as worker
from aliasfree_diffusion_models_pytorch_tpu.config import FilterSettings as JFilters
from aliasfree_diffusion_models_pytorch_tpu.config import TrainConfig as JTrainConfig
from aliasfree_diffusion_models_pytorch_tpu.diffusion import Diffusion as JDiffusion
from aliasfree_diffusion_models_pytorch_tpu.parallel.mesh import batch_sharding as j_batch_sharding
from aliasfree_diffusion_models_pytorch_tpu.parallel.mesh import make_mesh as j_make_mesh
from aliasfree_diffusion_models_pytorch_tpu.parallel.mesh import param_sharding as j_param_sharding
from aliasfree_diffusion_models_pytorch_tpu.train import create_train_state as j_create_train_state
from aliasfree_diffusion_models_pytorch_tpu.train import make_train_step as j_make_train_step
from aliasfree_diffusion_models_pytorch_tpu_torch import train as ttrain
from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.data import Dataloader, synthetic_dataset
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model
from aliasfree_diffusion_models_pytorch_tpu_torch.parallel import (
    Sharding,
    batch_sharding,
    make_mesh,
    param_sharding,
    replicated,
)
from aliasfree_diffusion_models_pytorch_tpu_torch.parallel.multihost import (
    init_distributed,
    local_slice,
    put_global_batch,
)
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import checkpoint as ckpt
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import params_from_jax

LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-6
SPLIT_LOSS_RTOL = 1e-6
MOMENT_RTOL = 1e-5
N, SIZE, C, STEPS, TRAIN_STEPS = 4, 8, 3, 50, 3
TRAIN_ROWS = 12  # three steps an epoch: the accumulation window of two is open at its end
FILTERS = dict(kernel_size=3, kaiser_beta=2.0, omega_c_down=math.pi / 2, omega_c_up=math.pi / 2)
WORKER_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several worker processes at once; two threads each keep
    their OpenMP barriers from spinning against each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _configs(**kw):
    base = dict(run_name="p", epochs=1, batch_size=N, image_size=SIZE, base_width=8,
                image_channels=C, noise_steps=STEPS, variant=3, seed=0, time_dim=32)
    base.update(kw)
    return (JTrainConfig(filters=JFilters(**FILTERS), **base),
            TrainConfig(filters=FilterSettings(**FILTERS), **base))


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _draws(jdiff, i, rows):
    """The JAX step's timesteps and noise for micro-batch ``i``."""
    key = random.fold_in(random.key(1), i)
    tkey, nkey, _ = random.split(key, 3)
    t = np.array(jdiff.sample_timesteps(tkey, rows)).astype(np.int64)
    noise = np.array(random.normal(nkey, (rows, SIZE, SIZE, C), jnp.float32))
    return key, t, noise


def _assert_params(got: dict, expect: dict, lr: float, updates: int):
    """``tests/test_torch_train.py``'s rule (see the module docstring)."""
    bound = 2.0 * lr * updates
    assert set(got) == set(expect)
    for name, value in got.items():
        a, e = value.numpy(), expect[name].numpy()
        if name.endswith(".qkv.bias"):
            third = len(a) // 3
            key_bias = slice(third, 2 * third)
            assert np.abs(a[key_bias] - e[key_bias]).max() <= bound, name
            a, e = np.delete(a, key_bias), np.delete(e, key_bias)
        err = np.abs(a - e)
        assert err.max() <= bound, (name, err.max())
        assert int((err > PARAM_ATOL).sum()) <= max(2, 1e-3 * err.size), (name, err.max())


class _Reference:
    """The JAX package's mesh step and the port's single-process step over
    the cases' global batches, from the same weights."""

    def __init__(self):
        self.jcfg, self.tcfg = _configs()
        jmodel, jstate = j_create_train_state(self.jcfg, random.key(0))
        self.jmodel, self.jstate0 = jmodel, _numpy_tree(jstate)
        self.weights = params_from_jax(_numpy_tree(jstate.params))
        self.jdiff = JDiffusion(noise_steps=STEPS, img_size=SIZE)
        self.jmesh = j_make_mesh((2, 1), ("data", "fsdp"), devices=jax.devices()[:2])
        self.jstep = j_make_train_step(jmodel, self.jcfg, self.jdiff, mesh=self.jmesh)

    def steps(self, batches, n_real=None):
        """[(loss, params)] of the JAX mesh step and of the port's single step."""
        jstate = jax.tree.map(jnp.asarray, self.jstate0)
        model, tstate = ttrain.create_train_state(self.tcfg, device="cpu",
                                                  state_dict=self.weights)
        tstep = ttrain.make_train_step(model, self.tcfg,
                                       Diffusion(noise_steps=STEPS, img_size=SIZE, device="cpu"))
        jax_out, port_out = [], []
        for i, batch in enumerate(batches):
            key, t, noise = _draws(self.jdiff, i, batch.shape[0])
            jbatch = jax.device_put(jnp.asarray(batch), j_batch_sharding(self.jmesh))
            jstate, jloss = self.jstep(jstate, jbatch, key, None,
                                       None if n_real is None else jnp.asarray(n_real, jnp.int32))
            jax_out.append((float(jloss), params_from_jax(_numpy_tree(jstate.params))))
            tstate, tloss = tstep(tstate, torch.from_numpy(batch), None, None, n_real,
                                  t=torch.from_numpy(t), noise=torch.from_numpy(noise))
            port_out.append((float(tloss), {k: v.clone() for k, v in tstate.params.items()}))
        return jax_out, port_out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results of every case, and the references."""
    ref = _Reference()
    batches = [worker.batch_of(N, SIZE, C, seed=3 + i) for i in range(TRAIN_STEPS)]

    def steps_case(mesh_shape, batches, n_real=None):
        steps = []
        for i, b in enumerate(batches):
            _, t, noise = _draws(ref.jdiff, i, b.shape[0])
            steps.append((b, t, noise, n_real))
        return dict(mesh_shape=mesh_shape, config=ref.tcfg, weights=ref.weights, steps=steps)

    real = worker.batch_of(3, SIZE, C, seed=11)
    padded = np.concatenate([real, real[:1]], axis=0)
    root = tmp_path_factory.mktemp("fsdp_train")
    resume_root = str(tmp_path_factory.mktemp("fsdp_resume") / "root")
    profile_dir = tmp_path_factory.mktemp("profile")
    _, train_cfg = _configs(epochs=1, image_gen_n=1, noise_steps=10, checkpoint_opt_state=True,
                            grad_accum=2, run_name="fsdp_run")
    train_case = dict(mesh_shape=(1, 2), config=train_cfg, train=True, rows=TRAIN_ROWS,
                      data_seed=5)
    cases = {
        "data": steps_case((2, 1), batches),
        "fsdp": steps_case((1, 2), batches),
        "padded": steps_case((2, 1), [padded], n_real=3),
        "train": dict(train_case, root=str(root), profile_dir=str(profile_dir)),
        "resume": dict(train_case, root=resume_root, resume_from=str(root)),
    }
    out = tmp_path_factory.mktemp("ranks")
    ranks = worker.launch(cases, str(out), timeout=WORKER_TIMEOUT_S)
    return dict(ranks=ranks, ref=ref, batches=batches, padded=padded, root=str(root),
                resume_root=resume_root, profile_dir=str(profile_dir), train_cfg=train_cfg)


def test_make_mesh_shapes_and_its_error():
    assert make_mesh().shape == {"data": 1}  # one process, no torch.distributed
    assert make_mesh(ranks=range(8)).shape == {"data": 8}
    mesh = make_mesh((4, 2), ("data", "fsdp"), ranks=range(8))
    assert mesh.shape == {"data": 4, "fsdp": 2} and mesh.size == 8
    assert mesh.coords(5) == {"data": 2, "fsdp": 1}
    assert batch_sharding(mesh, axis=mesh.axis_names).index(5) == 5  # rows in grid order
    assert make_mesh((8, 1), ("data", "fsdp"), ranks=range(8)).shape == {"data": 8, "fsdp": 1}
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((3, 2), ("data", "fsdp"), ranks=range(8))
    assert batch_sharding(mesh).spec == ("data", None, None, None)
    assert replicated(mesh).spec == () and replicated(mesh).dim is None


def test_param_sharding_of_config_d():
    """Every leaf of at least min_size entries is split along its largest
    dimension that fsdp divides, the shards tile it, smaller and odd leaves
    are replicated; the same leaves split as in the JAX package, along a
    dimension of the same size (its index may differ: OIHW against HWIO)."""
    jcfg, tcfg = _configs()
    mesh = make_mesh((4, 2), ("data", "fsdp"), ranks=range(8))
    params = dict(build_model(tcfg, device="cpu").named_parameters())
    params["odd"] = torch.zeros(33333)  # not divisible by 2: replicated
    layout = param_sharding(mesh, params)
    assert isinstance(layout["odd"], Sharding) and layout["odd"].dim is None
    split = {n for n, s in layout.items() if s.dim is not None}
    assert len(split) == 8
    for name, value in params.items():
        s = layout[name]
        if value.numel() < 2**14:
            assert s.dim is None, name
            continue
        if s.dim is None:
            assert all(d % 2 for d in value.shape), name
            continue
        assert value.shape[s.dim] == max(d for d in value.shape if d % 2 == 0), name
        pieces = [s.shard(value.detach(), rank=r) for r in (0, 1)]  # ranks 0 and 1: fsdp 0, 1
        assert all(p.shape[s.dim] == value.shape[s.dim] // 2 for p in pieces)
        assert torch.equal(torch.cat(pieces, dim=s.dim), value.detach())
    # the JAX package's choice, leaf by leaf
    jmodel, jstate = j_create_train_state(jcfg, random.key(0))
    jlayout = j_param_sharding(j_make_mesh((4, 2), ("data", "fsdp")), jstate.params)

    def split_size(leaf, sharding):
        dims = [d for d, a in enumerate(sharding.spec) if a is not None]
        return np.full(leaf.shape, leaf.shape[dims[0]] if dims else 0, np.float32)

    expect = params_from_jax(jax.tree.map(split_size, _numpy_tree(jstate.params), jlayout))
    for name, value in expect.items():
        s = layout[name]
        ours = 0 if s.dim is None else params[name].shape[s.dim]
        assert ours == int(value.flatten()[0]), name


def test_local_slice_and_put_global_batch_give_the_global_batch():
    """Every rank's rows, in the order of its place on the mesh, are the
    global batch (what ``tests/test_multihost.py`` proves for JAX)."""
    ds = synthetic_dataset(n=8, image_size=SIZE, channels=1, seed=0)
    images, _ = next(iter(Dataloader(ds, batch_size=8, seed=0)))
    assert torch.equal(put_global_batch(make_mesh(), images), torch.from_numpy(images))
    assert torch.equal(put_global_batch(None, images), torch.from_numpy(images))
    mesh = make_mesh((2, 2), ("data", "fsdp"), ranks=range(4))
    rows = batch_sharding(mesh, images.ndim, axis=mesh.axis_names)
    assert rows.parts() == 4
    parts = [local_slice(images, rows.index(r), rows.parts()) for r in range(4)]
    assert [p.shape[0] for p in parts] == [2] * 4
    np.testing.assert_array_equal(np.concatenate(parts), images)
    with pytest.raises(ValueError, match="not divisible by 3 processes"):
        local_slice(images, 0, 3)


def test_step_on_a_mesh_needs_torch_distributed():
    _, tcfg = _configs()
    model, _ = ttrain.create_train_state(tcfg, device="cpu")
    mesh = make_mesh((2, 1), ("data", "fsdp"), ranks=range(2))
    with pytest.raises(ValueError, match="needs torch.distributed"):
        ttrain.make_train_step(model, tcfg, Diffusion(noise_steps=STEPS, img_size=SIZE,
                                                      device="cpu"), mesh=mesh)
    assert ttrain.train_mesh(tcfg) is None  # one process: no mesh
    assert init_distributed() is False  # no launcher's environment: nothing to start


@pytest.mark.parametrize("case", ["data", "fsdp"])
def test_mesh_step_matches_single_process_and_jax(runs, case):
    jax_out, port_out = runs["ref"].steps(runs["batches"])
    lr = runs["ref"].tcfg.lr
    for rank in runs["ranks"]:
        got = rank[case]
        assert len(got["losses"]) == TRAIN_STEPS
        for i, ((jloss, jparams), (tloss, tparams)) in enumerate(zip(jax_out, port_out)):
            np.testing.assert_allclose(got["losses"][i], tloss, rtol=SPLIT_LOSS_RTOL)
            np.testing.assert_allclose(got["losses"][i], jloss, rtol=LOSS_RTOL)
            _assert_params(got["params"][i], tparams, lr, i + 1)
            _assert_params(got["params"][i], jparams, lr, i + 1)
    # both ranks hold the same whole parameters
    for a, b in zip(runs["ranks"][0][case]["params"], runs["ranks"][1][case]["params"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_fsdp_ranks_hold_only_their_shards(runs):
    """Under fsdp each rank keeps half of every split leaf (masters and
    AdamW's moments); on the data mesh every tensor is whole."""
    whole = {k: tuple(v.shape) for k, v in runs["ref"].weights.items()}
    for rank in runs["ranks"]:
        fsdp, data = rank["fsdp"], rank["data"]
        assert len(fsdp["sharded"]) == 8 and data["sharded"] == []
        assert data["shards"] == whole
        for name, shape in fsdp["shards"].items():
            assert fsdp["moments"][name] == shape
            if name in fsdp["sharded"]:
                assert math.prod(shape) * 2 == math.prod(whole[name]), name
            else:
                assert shape == whole[name], name
    assert [r["fsdp"]["position"] for r in runs["ranks"]] == [0, 1]


def test_padded_batch_across_ranks_matches_jax(runs):
    """Three real rows and a duplicate over two ranks: the duplicate, on rank
    1, is masked by its global row, as in the JAX package's padded step."""
    jax_out, port_out = runs["ref"].steps([runs["padded"]], n_real=3)
    lr = runs["ref"].tcfg.lr
    for rank in runs["ranks"]:
        got = rank["padded"]
        np.testing.assert_allclose(got["losses"][0], port_out[0][0], rtol=SPLIT_LOSS_RTOL)
        np.testing.assert_allclose(got["losses"][0], jax_out[0][0], rtol=LOSS_RTOL)
        _assert_params(got["params"][0], port_out[0][1], lr, 1)
        _assert_params(got["params"][0], jax_out[0][1], lr, 1)


def _assert_opt_state(got: dict, expect: dict):
    """Flat optimizer arrays of two checkpoints: the counters equal, each
    moment and accumulator within MOMENT_RTOL of its tensor's largest entry
    (see the module docstring)."""
    assert set(got) == set(expect)
    for key, value in expect.items():
        assert got[key].shape == value.shape, key
        if value.ndim == 0:
            assert got[key] == value, key
            continue
        err, scale = np.abs(got[key] - value).max(), np.abs(value).max()
        assert err <= MOMENT_RTOL * scale, (key, err, scale)


def test_fsdp_checkpoint_resumes_on_a_single_device(runs, tmp_path):
    """``train()`` on the fsdp mesh writes one whole checkpoint (rank 0) that
    holds what a single-device run of the same epoch holds, optimizer state
    included (AdamW's moments, the update count, and the open accumulation
    window); that checkpoint resumed on the fsdp mesh and on a single device
    continues as a single-device run of two epochs does."""
    cfg = runs["train_cfg"]
    fsdp_root = runs["root"]

    def loader():
        return Dataloader(synthetic_dataset(n=TRAIN_ROWS, image_size=SIZE, channels=C, seed=5),
                          batch_size=N, seed=cfg.seed)

    def restore(root):
        return ckpt.restore_checkpoint(cfg.checkpoint_path(root))

    single_losses = ttrain.train(cfg, loader(), root=str(tmp_path / "single"), device="cpu")
    two_losses = ttrain.train(dataclasses.replace(cfg, epochs=2), loader(),
                              root=str(tmp_path / "two"), device="cpu")
    np.testing.assert_allclose(runs["ranks"][0]["train"]["losses"], single_losses,
                               rtol=SPLIT_LOSS_RTOL)
    assert runs["ranks"][1]["train"]["losses"] == runs["ranks"][0]["train"]["losses"]
    fsdp_ckpt, single_ckpt = restore(fsdp_root), restore(str(tmp_path / "single"))
    assert fsdp_ckpt["step"] == single_ckpt["step"] == 3
    _assert_params(fsdp_ckpt["params"], single_ckpt["params"], cfg.lr, 1)
    _assert_opt_state(fsdp_ckpt["opt_state"], single_ckpt["opt_state"])
    assert fsdp_ckpt["opt_state"][".mini_step"] == 1  # the window is open
    assert os.path.exists(os.path.join(cfg.results_dir(fsdp_root), "0.jpg"))
    two_ckpt = restore(str(tmp_path / "two"))
    # resumed on the fsdp mesh (both ranks restore their shards)
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["resume"]["losses"], two_losses[1:], rtol=SPLIT_LOSS_RTOL)
    resumed = restore(runs["resume_root"])
    assert resumed["step"] == two_ckpt["step"] == 6
    _assert_params(resumed["params"], two_ckpt["params"], cfg.lr, 3)
    _assert_opt_state(resumed["opt_state"], two_ckpt["opt_state"])
    # resumed on a single device
    losses = ttrain.train(cfg, loader(), root=fsdp_root, device="cpu", resume=True)
    np.testing.assert_allclose(losses, two_losses[1:], rtol=SPLIT_LOSS_RTOL)
    resumed = restore(fsdp_root)
    assert resumed["step"] == 6
    _assert_params(resumed["params"], two_ckpt["params"], cfg.lr, 3)
    _assert_opt_state(resumed["opt_state"], two_ckpt["opt_state"])


def test_only_rank0_writes_the_profile_trace(runs):
    """``train(profile_dir=)`` on a mesh of two ranks: one Chrome trace,
    written by rank 0 alone (no rank-1 process in it)."""
    files = os.listdir(runs["profile_dir"])
    assert files == [f"trace_{runs['train_cfg'].run_name}.json"]
    with open(os.path.join(runs["profile_dir"], files[0])) as f:
        events = json.load(f)["traceEvents"]
    pids = {e.get("pid") for e in events}
    assert runs["ranks"][0]["train"]["pid"] in pids
    assert runs["ranks"][1]["train"]["pid"] not in pids
