"""One rank of the port's data-parallel and FSDP tests (``test_torch_parallel.py``),
of its entry points on a mesh (``test_torch_parallel_entry.py``) and of the
bench's mesh branch (``test_torch_bench.py``).

:func:`launch` starts the ranks with ``torch.multiprocessing`` (spawn), gloo
on the CPU; imports no JAX. :func:`main` first runs the cases that start
torch.distributed themselves, from torchrun's environment (``torchrun``:
the CLI), then starts it at ``tcp://localhost:<port>`` for every other case
the test hands it, in order, and writes what this rank saw to
``<out>/rank<r>.pt``.
"""

import builtins
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
    ds = synthetic_dataset(n=case["rows"], image_size=config.image_size,
                           channels=config.image_channels, seed=case["data_seed"])
    loader = Dataloader(ds, batch_size=config.batch_size, seed=config.seed)
    # the profiler's window lies inside the few steps of the run
    losses = ttrain.train(config, loader, root=case["root"], device="cpu", mesh=mesh,
                          resume=resume, profile_dir=case.get("profile_dir"),
                          profile_steps=(0, 1))
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


class _WriteSpy:
    """Lists the files opened for writing or moved into place and the
    directories made under ``root`` while it is entered (``open``,
    ``io.open``, ``os.replace``, ``os.makedirs``)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.files: list[str] = []
        self.dirs: list[str] = []

    def _under(self, path) -> bool:
        return isinstance(path, (str, os.PathLike)) and os.path.abspath(path).startswith(self.root)

    def __enter__(self):
        self._open, self._makedirs, self._replace = builtins.open, os.makedirs, os.replace

        def spy_open(file, mode="r", *args, **kwargs):
            if self._under(file) and any(c in mode for c in "wax+"):
                self.files.append(os.path.relpath(file, self.root))
            return self._open(file, mode, *args, **kwargs)

        def spy_makedirs(name, *args, **kwargs):
            if self._under(name) and not os.path.isdir(name):
                self.dirs.append(os.path.relpath(name, self.root))
            return self._makedirs(name, *args, **kwargs)

        def spy_replace(src, dst, *args, **kwargs):
            if self._under(dst):
                self.files.append(os.path.relpath(dst, self.root))
            return self._replace(src, dst, *args, **kwargs)

        builtins.open = io.open = spy_open
        os.makedirs, os.replace = spy_makedirs, spy_replace
        return self

    def __exit__(self, *exc):
        builtins.open = io.open = self._open
        os.makedirs, os.replace = self._makedirs, self._replace


def _ddpm_run(case, config, mesh):
    """``tasks.ddpm_run`` on the mesh: its result's keys, its losses, and the
    files and directories this rank wrote under the run's root."""
    from aliasfree_diffusion_models_pytorch_tpu_torch import tasks

    with _WriteSpy(case["root"]) as spy:
        result = tasks.ddpm_run(config, root=case["root"], device="cpu", mesh=mesh)
    return {"losses": result["loss_all"], "keys": sorted(result), "files": spy.files,
            "dirs": spy.dirs}


def _cli(case, rank: int, size: int):
    """``cli.main(case["cli"])`` with torchrun's environment for this rank:
    its exit code, whether torch.distributed still runs after it, and the
    files this rank wrote under ``case["root"]``."""
    from aliasfree_diffusion_models_pytorch_tpu_torch import cli

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(size),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(case["port"]))
    try:
        with _WriteSpy(case["root"]) as spy:
            code = cli.main(case["cli"])
    finally:
        for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(key)
    return {"exit": code, "initialized_after": torch.distributed.is_initialized(),
            "files": spy.files}


def main(rank: int, size: int, port: int, cases: dict, out: str) -> None:
    torch.set_num_threads(1)
    results = {name: _cli(case, rank, size) for name, case in cases.items() if "cli" in case}
    init_distributed(f"tcp://localhost:{port}", size, rank, backend="gloo")
    for name, case in cases.items():
        if "cli" in case:
            continue
        if "bench" in case:
            results[name] = _bench(case)
            continue
        mesh = make_mesh(case["mesh_shape"], ("data", "fsdp"))
        run = _ddpm_run if case.get("ddpm_run") else _train if case.get("train") else _steps
        results[name] = run(case, case["config"], mesh)
        results[name]["position"] = batch_sharding(mesh, axis=mesh.axis_names).index()
        results[name]["pid"] = os.getpid()
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def batch_of(rows: int, size: int, channels: int, seed: int) -> np.ndarray:
    return synthetic_dataset(n=rows, image_size=size, channels=channels, seed=seed).images


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cases: dict, out: str, size: int = 2, timeout: float = 240.0) -> list[dict]:
    """Run :func:`main` on ``size`` spawned gloo ranks over ``cases``; every
    rank's results. Raises when a rank fails or outlives ``timeout`` seconds
    (then every rank is stopped)."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
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
