"""One rank of the port's data-parallel and FSDP tests (``test_torch_parallel.py``)
and of the bench's mesh branch (``test_torch_bench.py``).

:func:`launch` starts the ranks with ``torch.multiprocessing`` (spawn), gloo
on the CPU; imports no JAX. :func:`main` starts torch.distributed at
``tcp://localhost:<port>``, runs each case the test hands it, in order, and
writes what this rank saw to ``<out>/rank<r>.pt``.
"""

import contextlib
import importlib.util
import io
import os
import shutil
import socket

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch import train as ttrain
from aliasfree_diffusion_models_pytorch_tpu_torch.data import Dataloader, synthetic_dataset
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.parallel import batch_sharding, make_mesh, world
from aliasfree_diffusion_models_pytorch_tpu_torch.parallel.multihost import (
    init_distributed,
    put_global_batch,
)


def _steps(case, config, mesh):
    """The step on ``mesh`` over the case's global batches and draws: the
    losses, and the whole parameters after every step."""
    model, state = ttrain.create_train_state(config, device="cpu", state_dict=case["weights"],
                                             mesh=mesh)
    step = ttrain.make_train_step(
        model, config, Diffusion(noise_steps=config.noise_steps, img_size=config.image_size,
                                 device="cpu"), mesh=mesh)
    losses, params = [], []
    for batch, t, noise, n_real in case["steps"]:
        state, loss = step(state, put_global_batch(mesh, batch), None, None, n_real,
                           t=torch.from_numpy(t), noise=torch.from_numpy(noise))
        losses.append(float(loss))
        params.append({k: v.clone() for k, v in state.gather(state.params).items()})
    shards = {n: tuple(v.shape) for n, v in state.params.items()}
    moments = {n: tuple(s["exp_avg"].shape) for n, s in
               ((n, state.optimizer.state[p]) for n, p in state.params.items())}
    return {"losses": losses, "params": params, "shards": shards, "moments": moments,
            "sharded": sorted(n for n, s in (state.shardings or {}).items()
                              if s.dim is not None)}


def _train(case, config, mesh):
    """``train()`` on the mesh for the case's epochs; rank 0 writes the run.
    ``resume_from``: a copy of that run's root resumes its checkpoint;
    ``profile_dir``: the run traces its first step there."""
    resume = "resume_from" in case
    if resume:
        if world()[0] == 0:
            shutil.copytree(case["resume_from"], case["root"])
        torch.distributed.barrier()
    ttrain.PROFILE_STEPS = (0, 1)  # a window inside the few steps of the run
    ds = synthetic_dataset(n=case["rows"], image_size=config.image_size,
                           channels=config.image_channels, seed=case["data_seed"])
    loader = Dataloader(ds, batch_size=config.batch_size, seed=config.seed)
    losses = ttrain.train(config, loader, root=case["root"], device="cpu", mesh=mesh,
                          resume=resume, profile_dir=case.get("profile_dir"))
    return {"losses": losses}


def _bench(case):
    """``bench_torch.main(case["argv"])`` (the file ``case["bench"]``) on this
    rank: its return value and what it printed on stdout."""
    spec = importlib.util.spec_from_file_location("bench_torch", case["bench"])
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        code = bench.main(case["argv"])
    return {"exit": code, "stdout": stdout.getvalue()}


def main(rank: int, size: int, port: int, cases: dict, out: str) -> None:
    torch.set_num_threads(1)
    init_distributed(f"tcp://localhost:{port}", size, rank, backend="gloo")
    results = {}
    for name, case in cases.items():
        if "bench" in case:
            results[name] = _bench(case)
            continue
        mesh = make_mesh(case["mesh_shape"], ("data", "fsdp"))
        run = _train if case.get("train") else _steps
        results[name] = run(case, case["config"], mesh)
        results[name]["position"] = batch_sharding(mesh, axis=mesh.axis_names).index()
        results[name]["pid"] = os.getpid()
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def batch_of(rows: int, size: int, channels: int, seed: int) -> np.ndarray:
    return synthetic_dataset(n=rows, image_size=size, channels=channels, seed=seed).images


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cases: dict, out: str, size: int = 2, timeout: float = 240.0) -> list[dict]:
    """Run :func:`main` on ``size`` spawned gloo ranks over ``cases``; every
    rank's results. Raises when a rank fails or outlives ``timeout`` seconds
    (then every rank is stopped)."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=main, args=(r, size, port, cases, out)) for r in range(size)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(timeout=10)
    if alive:
        raise RuntimeError(f"ranks did not finish in {timeout} s")
    codes = [p.exitcode for p in procs]
    if codes != [0] * size:
        raise RuntimeError(f"rank exit codes {codes}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(size)]
