"""Data-parallel and FSDP training over torch.distributed: the rank mesh and
its sharding layouts (``mesh``), and starting the processes and handing each
its rows (``multihost``)."""

from aliasfree_diffusion_models_pytorch_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Sharding,
    batch_sharding,
    make_mesh,
    param_sharding,
    replicated,
    world,
)
