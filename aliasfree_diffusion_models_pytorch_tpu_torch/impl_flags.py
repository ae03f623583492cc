"""The implementation choices of a run, for its artifacts.

Counterpart of ``aliasfree_diffusion_models_pytorch_tpu/impl_flags.py``. Two
runs of one configuration can compute different numbers, or at different
speeds, because of choices that the configuration does not name: environment
knobs and the port's own routes. Every run artifact records them as they
stood at run start: ``impl_report()`` is the ``impl`` entry of the
``metrics.jsonl`` run header (``train.py``), and ``impl_report_text()`` the
``impl.*`` lines at the end of the settings dump
(``TrainConfig.settings_text``).

The JAX package latches its knobs when it traces a step; the port latches
them when it captures a CUDA graph, and keys each graph on them
(``ops/resample.py:fg_impl_override``, ``gelu_mode``), so a changed knob
captures a new graph.

Keys shared with the JAX package, with its values:

========================  ====================================================
``gelu``                  ``AFDM_GELU`` as set (exact | poly13), else
                          ``auto(bf16:poly15,f32:exact)``
``resample_impl``         ``conv``: the port has no ``shifts`` forms
``fg_impl_perf``          the filtered GELU's form for bf16 (``phases``, the
                          CUDA kernel pair on the card; ``AFDM_FG_IMPL``)
``fg_impl_parity``        ... and for f32 (``conv``; ``AFDM_FG_IMPL``)
``native_loader``         the C++ CSV loader: loaded, or not built yet
========================  ====================================================

The port's own:

========================  ====================================================
``attention``             the kernels by dtype: bf16 on the tensor cores
                          (``mma.sync``), f32 on the FMA pipes
``attention_plans``       the bf16 forward's heads per block, from
                          ``fwd_plan`` at S = 16, 32, 64 (and D = 128), and
                          the f32 kernels' register tiles (``F32_TILES``);
                          ``f32_plan`` and ``fg_plan`` choose by shape
``kernel_lib``            each kernel library's hash (``utils/kernels.py``:
                          its source, the shared headers and nvcc's flags)
``deterministic``         ``torch.are_deterministic_algorithms_enabled()``
``tf32``                  cuDNN's and cuBLAS's TF32 switches as set, and
                          cuDNN's while ``eval`` computes its features
                          (``eval.EVAL_CUDNN_TF32``)
``cuda_graphs``           whether the run's steps replay CUDA graphs
``distributed``           torch.distributed's world size and backend, and the
                          run's mesh
========================  ====================================================

Not reported: the JAX package's flash-gate knobs (``AFDM_FLASH_ATTN``,
``_MIN_SEQ``, ``_MAX_SEQ``, ``_STRIP_MIN``, ``_DQT``, ``_STATS``). They tune the
TPU kernels' gate and tiling, and the port reads none of them: every
attention block takes the CUDA kernels on the card.

Rendering the report builds nothing: no kernel, no C++ library.
"""

from __future__ import annotations

import os

import torch


def impl_report(mesh=None, graphs: bool | None = None) -> dict:
    """The implementation choices in effect now. ``mesh`` is the run's
    (default: the shape ``parallel.make_mesh()`` gives in this process),
    ``graphs`` whether its steps run as CUDA graphs (default: they do on the
    card)."""
    import torch.distributed as dist

    from aliasfree_diffusion_models_pytorch_tpu_torch.eval import EVAL_CUDNN_TF32
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops.flash_attention import F32_TILES, fwd_plan
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops.resample import fg_impl_override
    from aliasfree_diffusion_models_pytorch_tpu_torch.parallel import make_mesh, world
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.native import native_status

    if mesh is None:  # the default mesh's shape; its process groups are not needed
        mesh = make_mesh(ranks=range(world()[1]))
    initialised = dist.is_available() and dist.is_initialized()
    return {
        "gelu": os.environ.get("AFDM_GELU") or "auto(bf16:poly15,f32:exact)",
        "resample_impl": "conv",
        "fg_impl_perf": fg_impl_override() or "phases",
        "fg_impl_parity": fg_impl_override() or "conv",
        # Probe only: rendering a settings dump must not start a g++ build.
        "native_loader": native_status(),
        "attention": "auto(bf16:tensor-cores,f32:fma-pipes)",
        "attention_plans": {
            "bf16_fwd_heads_per_block": {f"s{s}_d{d}": fwd_plan(1, s, d).heads_per_block
                                         for s, d in ((16, 64), (32, 64), (64, 64), (16, 128))},
            "f32_tiles": {k: {str(d): list(tile) for d, tile in v.items()}
                          for k, v in F32_TILES.items()},
        },
        "kernel_lib": {name: kernels.library_path(name).stem.rsplit("-", 1)[1]
                       for name in kernels.SOURCES},
        "deterministic": torch.are_deterministic_algorithms_enabled(),
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                 "matmul": torch.backends.cuda.matmul.allow_tf32, "eval": EVAL_CUDNN_TF32},
        "cuda_graphs": "auto(cuda:on,cpu:off)" if graphs is None else graphs,
        "distributed": {
            "world_size": dist.get_world_size() if initialised else 1,
            "backend": dist.get_backend() if initialised else None,
            "mesh": mesh.shape,
        },
    }


def impl_report_text(mesh=None, graphs: bool | None = None) -> str:
    """``impl.key: value`` lines for the ``settings_{dataset}_{variant}.txt``
    snapshot."""
    return "\n".join(f"impl.{k}: {v}" for k, v in impl_report(mesh, graphs).items())
