"""Multi-process training: start torch.distributed, and give each rank its rows.

Counterpart of ``aliasfree_diffusion_models_pytorch_tpu/parallel/multihost.py``.
One process a GPU, as ``torchrun`` starts them:

    torchrun --nproc-per-node 4 -m aliasfree_diffusion_models_pytorch_tpu_torch train ...

* every process calls :func:`init_distributed` once (NCCL on the card, gloo on
  the CPU), which binds it to ``cuda:LOCAL_RANK``;
* the data: the loader's order is a function of (seed, epoch) alone
  (``data.Dataloader``), so every rank walks the same global batches without
  talking to the others and hands its own contiguous rows to the step
  (:func:`put_global_batch`), the rows that rank's place on the mesh names.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.parallel.mesh import Mesh, batch_sharding, world

__all__ = ["init_distributed", "local_slice", "put_global_batch"]


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None) -> bool:
    """Start torch.distributed (idempotent: a no-op when it is running).

    Without arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and does nothing where
    there is none (a single process); explicit arguments
    (``init_method="tcp://localhost:<port>"``, ``world_size``, ``rank``) serve
    a process that no launcher started. The backend is NCCL where CUDA is
    available and gloo otherwise, unless given. On the card each rank is
    bound to ``cuda:LOCAL_RANK`` (``LOCAL_RANK``, else the rank). Returns
    whether torch.distributed is running."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    if rank is not None:
        kwargs["rank"] = int(rank)
    if init_method is not None:
        kwargs["init_method"] = init_method
    if backend == "nccl":
        torch.cuda.set_device(_device_of_rank(rank))
    dist.init_process_group(backend, **kwargs)
    return True


def _device_of_rank(rank: int | None = None) -> torch.device:
    """The card of this process: ``cuda:LOCAL_RANK``, else ``cuda:<rank>``
    (one host), else ``cuda:0``."""
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if rank is None:
        rank = int(os.environ.get("RANK", world()[0]))
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def local_slice(global_batch, index: int, parts: int):
    """Part ``index`` of ``parts`` contiguous row slices of a global batch.
    Raises when the rows do not divide."""
    n = global_batch.shape[0]
    if n % parts != 0:
        raise ValueError(f"global batch {n} not divisible by {parts} processes")
    per = n // parts
    return global_batch[index * per:(index + 1) * per]


def put_global_batch(mesh: Mesh | None, batch: np.ndarray, device="cpu") -> torch.Tensor:
    """This rank's rows of a global numpy batch, as a tensor on ``device``
    (pinned host memory for a card, which the step copies without waiting):
    the rows split over every axis of the mesh (``batch_sharding``). Without
    a mesh (one process) it is the whole batch."""
    if mesh is not None:
        rows = batch_sharding(mesh, batch.ndim, axis=mesh.axis_names)
        batch = local_slice(batch, rows.index(), rows.parts())
    tensor = torch.from_numpy(np.ascontiguousarray(batch))
    return tensor.pin_memory() if torch.device(device).type == "cuda" else tensor
