"""The rank mesh and the sharding layouts of data-parallel and FSDP training.

Counterpart of ``aliasfree_diffusion_models_pytorch_tpu/parallel/mesh.py``.
The JAX package lays a ``jax.sharding.Mesh`` over devices and lets XLA insert
the collectives. Here the processes of ``torch.distributed`` (one a GPU,
started by ``torchrun``) form the grid, and the train step calls the
collectives itself (``train.py``):

* the ``data`` axis: data parallelism. Every rank holds the parameters and
  its rows of the batch; the gradients are summed over the ranks.
* the ``fsdp`` axis (optional): the f32 master parameters, AdamW's moments,
  the EMA and the gradient accumulator are split along each large leaf's
  largest dimension that the axis size divides (:func:`param_sharding`, the
  JAX rule), every rank keeping its shard; the step all-gathers the masters
  before the forward and reduce-scatters the gradients onto the shards.

A :class:`Mesh` is the grid of ranks, ``ranks.reshape(shape)``, and, when
``torch.distributed`` is initialised, this rank's process group along each
axis (every rank builds every group, in the same order, as
``torch.distributed.new_group`` asks). A :class:`Sharding` names, for each
dimension of a tensor, the axis it is split over, as a ``PartitionSpec``
does; the empty spec replicates.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["Mesh", "Sharding", "make_mesh", "batch_sharding", "replicated", "param_sharding",
           "world"]


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without torch.distributed."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Ranks on a grid of named axes (see the module docstring)."""

    def __init__(self, ranks: np.ndarray, axes: tuple[str, ...]):
        if ranks.ndim != len(axes):
            raise ValueError(f"mesh of {ranks.ndim} dimensions and axes {axes}")
        self.ranks = ranks
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.size = int(ranks.size)
        self._groups: dict = {}

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape})"

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """The grid position of ``rank`` (default: this process's)."""
        rank = world()[0] if rank is None else rank
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on the mesh {self.ranks.tolist()}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def group(self, axis: str | None = None):
        """This rank's process group along ``axis`` (None: every rank of the
        mesh); None without torch.distributed."""
        return self._groups.get(axis)

    def build_groups(self) -> None:
        """Make the process groups: along each axis, and of the whole mesh.
        Every rank of the world must call this, with the same mesh."""
        import torch.distributed as dist

        rank, size = world()
        if size == 1 and not (dist.is_available() and dist.is_initialized()):
            return
        if sorted(self.ranks.ravel().tolist()) != list(range(size)):
            raise ValueError(f"the mesh {self.ranks.tolist()} must hold each of the "
                             f"{size} ranks once")

        def make(ranks: list[int]):
            return dist.group.WORLD if len(ranks) == size else dist.new_group(ranks)

        self._groups[None] = make(self.ranks.ravel().tolist())
        for d, axis in enumerate(self.axis_names):
            lines = np.moveaxis(self.ranks, d, -1).reshape(-1, self.ranks.shape[d])
            for line in lines:
                group = make(line.tolist())
                if rank in line:
                    self._groups[axis] = group


def make_mesh(shape: tuple[int, ...] | None = None, axes: tuple[str, ...] = ("data",),
              ranks=None) -> Mesh:
    """A mesh over ``ranks`` (default: every rank of torch.distributed, or the
    one process without it), with the JAX package's shape rules:
    ``shape=None`` puts every rank on the first axis, a trailing axis of
    size 1 is fine (``(8, 1)`` over ``("data", "fsdp")``), and a shape whose
    product is not the number of ranks raises ``ValueError``. With the
    default ranks under torch.distributed the mesh's process groups are
    made here, so every rank must call this, in the same order."""
    default = ranks is None
    ranks = np.arange(world()[1]) if default else np.asarray(list(ranks), dtype=np.int64)
    if shape is None:
        shape = (ranks.size,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != ranks.size:
        raise ValueError(f"mesh shape {shape} != #devices {ranks.size}")
    mesh = Mesh(ranks.reshape(shape), tuple(axes))
    if default:
        mesh.build_groups()
    return mesh


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: ``spec[d]`` is the axis (or tuple of
    axes) dimension d is split over, None where it is whole; the empty spec
    replicates."""

    mesh: Mesh
    spec: tuple = ()

    @property
    def dim(self) -> int | None:
        """The split dimension, or None for a replicated tensor."""
        split = [d for d, a in enumerate(self.spec) if a is not None]
        return split[0] if split else None

    def parts(self) -> int:
        """Into how many pieces the split dimension is cut."""
        if self.dim is None:
            return 1
        axes = self.spec[self.dim]
        axes = axes if isinstance(axes, tuple) else (axes,)
        return math.prod(self.mesh.shape[a] for a in axes)

    def index(self, rank: int | None = None) -> int:
        """Which piece ``rank`` (default: this process) holds."""
        if self.dim is None:
            return 0
        axes = self.spec[self.dim]
        axes = axes if isinstance(axes, tuple) else (axes,)
        coords = self.mesh.coords(rank)
        index = 0
        for a in axes:
            index = index * self.mesh.shape[a] + coords[a]
        return index

    def shard(self, tensor: torch.Tensor, rank: int | None = None) -> torch.Tensor:
        """``rank``'s piece of the whole ``tensor`` (a view)."""
        if self.dim is None:
            return tensor
        size = tensor.shape[self.dim] // self.parts()
        return tensor.narrow(self.dim, self.index(rank) * size, size)


def batch_sharding(mesh: Mesh, ndim: int = 4, axis: str | tuple = "data") -> Sharding:
    """Split the leading (batch) dimension over ``axis``; the rest whole. The
    train step splits it over every axis of its mesh
    (``axis=mesh.axis_names``): rank by rank in the grid's row-major order."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def param_sharding(mesh: Mesh, params: dict, axis: str = "fsdp",
                   min_size: int = 2**14) -> dict[str, Sharding]:
    """The FSDP layout of a ``{name: tensor}`` dict, by the JAX package's
    rule: each leaf of at least ``min_size`` entries is split along its
    largest dimension that the axis size divides (the first of equal ones),
    the others are replicated. The port's leaves are NCHW/OIHW, so where two
    dimensions are equal the split one may differ from the JAX package's
    HWIO choice (a 64 → 64 3×3 convolution splits O here and I there); the
    numbers do not depend on it."""
    axis_size = mesh.shape[axis]

    def spec_for(leaf: torch.Tensor) -> Sharding:
        if axis_size == 1 or leaf.numel() < min_size:
            return replicated(mesh)
        dims = list(leaf.shape)
        for d in sorted(range(len(dims)), key=lambda d: -dims[d]):
            if dims[d] % axis_size == 0:
                spec = [None] * len(dims)
                spec[d] = axis
                return Sharding(mesh, tuple(spec))
        return replicated(mesh)

    return {name: spec_for(leaf) for name, leaf in params.items()}
