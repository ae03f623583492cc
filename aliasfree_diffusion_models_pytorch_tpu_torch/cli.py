"""Command-line interface of the port.

    python -m aliasfree_diffusion_models_pytorch_tpu_torch run --epochs 100 --batch-size 256
    python -m aliasfree_diffusion_models_pytorch_tpu_torch train --epochs 100 --batch-size 256
    python -m aliasfree_diffusion_models_pytorch_tpu_torch sample --n 16 --out samples.png
    python -m aliasfree_diffusion_models_pytorch_tpu_torch sample --ddim-steps 50 --theta 90
    python -m aliasfree_diffusion_models_pytorch_tpu_torch rotate --thetas=-90:90:9 --out rotation
    python -m aliasfree_diffusion_models_pytorch_tpu_torch shift --shifts=-8,0,8
    python -m aliasfree_diffusion_models_pytorch_tpu_torch eval images/generated/X images/original/X
    python -m aliasfree_diffusion_models_pytorch_tpu_torch sweep --variants 1,2,3
    python -m aliasfree_diffusion_models_pytorch_tpu_torch summary --variant 3
    python -m aliasfree_diffusion_models_pytorch_tpu_torch info
    python -m aliasfree_diffusion_models_pytorch_tpu_torch probe exp
    python -m aliasfree_diffusion_models_pytorch_tpu_torch probe headpack --out headpack.json
    python -m aliasfree_diffusion_models_pytorch_tpu_torch reproduce-grid --configs A,D-2N

The flags and their defaults are the JAX CLI's (``cli.py:_add_common``): Config
A (variant 0) at 32 px, one channel, f32, so the same command line trains and
samples the same model in both packages. Every subcommand that takes them in
the JAX CLI takes the training flags (``sample``, ``rotate``, ``shift`` and
``summary`` read none of them). ``--device`` and ``--lr-total-steps`` are the
port's own. Data-parallel training runs one process a GPU under ``torchrun``
(``parallel/``): ``train``, ``run`` and ``sweep`` start torch.distributed from
its environment and end it before they return; ``info`` prints the mesh
``parallel.make_mesh()`` gives. ``train`` writes the
run's ``.npz`` checkpoint (``models/<run_name>/ckpt_<dataset>_<variant>.npz``
under ``--root``), in the JAX package's layout; with no ``--dataset-path`` it
trains on the synthetic dataset. ``run`` is the whole experiment pipeline
(``tasks.ddpm_run``: diagnostics, training, demos, the generated image set);
``sweep`` runs it for several variants. ``sample``, ``rotate`` and ``shift``
read the run's checkpoint (or one written by the JAX package); ``sample
--random-weights`` draws a seeded torch-default initialisation instead.
``eval`` computes IS/FID/KID between two folders of PNGs. ``probe`` runs one
of the two kernel micro-probes (``probes.py``). ``reproduce-grid`` trains,
samples and scores the published quality grid (``reproduce.py``), printing
its markdown table and writing its JSON artifact. ``--device`` picks the card
(default ``cuda``) or ``cpu``.
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import math
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--variant", type=int, default=0, help="UNet variant 0-4 (Configs A-D + v4)")
    p.add_argument("--dataset", default="MNIST", help="names the run directory")
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--base-width", type=int, default=None,
                   help="base channel width override (default: image-size); multiple of 4")
    p.add_argument("--image-channels", type=int, default=1)
    p.add_argument("--noise-steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--f-kernel", type=int, default=None, help="filter kernel size (enables filters)")
    p.add_argument("--f-beta", type=float, default=None, help="Kaiser beta")
    p.add_argument("--f-down", type=float, default=None, help="omega_c_down (default pi/2)")
    p.add_argument("--f-up", type=float, default=None, help="omega_c_up (default pi/2)")
    p.add_argument("--no-normalize-filters", action="store_true",
                   help="expose the README's non-normalized kernel configs")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--use-ema", action="store_true", help="sample with the EMA weights")
    p.add_argument("--root", default=".", help="artifact root directory")
    p.add_argument("--num-classes", type=int, default=None, help="class-conditional model")
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")


def _add_train(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset-path", default=None,
                   help="MNIST CSV file, or an image tree with one directory per class "
                        "for other datasets; absent -> the synthetic dataset")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--resume", action="store_true",
                   help="resume from the run checkpoint if present")
    p.add_argument("--checkpoint-opt-state", action="store_true",
                   help="checkpoint the optimizer state too (exact resume)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of train steps 10-19 here, with the "
                        "spans train.batch, train.step, train.log, train.epoch_end, "
                        "graph.warmup and graph.capture")
    p.add_argument("--image-gen-per-epoch", type=int, default=4)
    p.add_argument("--gen-per-batch", type=int, default=200)
    p.add_argument("--gen-total", type=int, default=2000)
    p.add_argument("--label-dropout", type=float, default=0.0,
                   help="CFG training: per-sample label-drop probability (~0.1)")
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "warmup_cosine"],
                   help="constant (reference) | linear warmup + cosine decay")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear-warmup optimizer updates (warmup_cosine only)")
    p.add_argument("--lr-min-ratio", type=float, default=0.0,
                   help="cosine floor as a fraction of peak lr")
    p.add_argument("--lr-total-steps", type=int, default=None,
                   help="cosine horizon in optimizer updates (default: epochs x batches "
                        "per epoch / grad-accum; a resumed run keeps its checkpoint's)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches averaged per optimizer update "
                        "(effective batch = k * batch-size)")
    p.add_argument("--grad-clip", type=float, default=None,
                   help="global-norm gradient clipping threshold")


# TrainConfig field -> argparse attribute of the training flags
_TRAIN_FIELDS = {
    "epochs": "epochs", "batch_size": "batch_size", "dataset_path": "dataset_path",
    "lr": "lr", "image_gen_n": "image_gen_per_epoch", "gen_per_batch": "gen_per_batch",
    "gen_total": "gen_total", "label_dropout": "label_dropout",
    "lr_schedule": "lr_schedule", "warmup_steps": "warmup_steps",
    "lr_min_ratio": "lr_min_ratio", "lr_total_steps": "lr_total_steps",
    "grad_accum": "grad_accum", "grad_clip": "grad_clip",
    "checkpoint_opt_state": "checkpoint_opt_state",
}


def config_from_args(args) -> TrainConfig:
    filters = None
    if args.f_kernel is not None or args.variant != 0:
        filters = FilterSettings(
            kernel_size=args.f_kernel if args.f_kernel is not None else 3,
            kaiser_beta=args.f_beta,
            omega_c_down=args.f_down if args.f_down is not None else math.pi / 2,
            omega_c_up=args.f_up if args.f_up is not None else math.pi / 2,
            normalize=not args.no_normalize_filters,
        )
    return TrainConfig(
        run_name=f"DDPM_Uncondtional_{args.dataset}_{args.variant}",
        image_size=args.image_size,
        base_width=args.base_width,
        image_channels=args.image_channels,
        noise_steps=args.noise_steps,
        variant=args.variant,
        dataset=args.dataset,
        seed=args.seed,
        filters=filters,
        compute_dtype=args.compute_dtype,
        use_ema=args.use_ema,
        num_classes=args.num_classes,
        **{field: getattr(args, flag) for field, flag in _TRAIN_FIELDS.items()},
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="aliasfree-diffusion-torch",
        description="Alias-free diffusion training and sampling on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="full experiment pipeline (ddpm_run)")
    train = sub.add_parser("train", help="training only")
    sample = sub.add_parser("sample", help="generate images")
    rotate = sub.add_parser("rotate", help="Config-E rotation sweep -> video/GIF")
    shift = sub.add_parser("shift", help="translation sweep")
    evaluate = sub.add_parser("eval", help="IS/FID/KID between two image folders")
    sub.add_parser("info", help="torch, CUDA and device report")
    summary = sub.add_parser("summary", help="model inspection: param count + per-layer shapes")
    sweep = sub.add_parser("sweep", help="run the full pipeline for several variants")
    probe = sub.add_parser("probe", help="kernel micro-probes: exp cost, QK^T head packing")
    grid = sub.add_parser("reproduce-grid",
                          help="train + eval the published quality grid (reference README)")
    # The JAX CLI gives every subcommand but eval, info and reproduce-grid its
    # training flags too; sample, rotate, shift and summary read none of them.
    for p in (run, train, sample, rotate, shift, summary, sweep):
        _add_common(p)
        _add_train(p)
    rotate.add_argument("--thetas", default="-90:90:9", help="start:stop:count degrees")
    rotate.add_argument("--out", default="rotation")
    rotate.add_argument("--fps", type=int, default=15)
    rotate.add_argument("--save-sweep", default=None, metavar="PATH",
                        help="also persist the sweep's finals + trajectories as a .npz")
    shift.add_argument("--shifts", default="-8,0,8")
    shift.add_argument("--out", default="shift_sweep.png")
    sweep.add_argument("--variants", default="1,2,3",
                       help="comma-separated UNet variants to run (reference sweep: 1,2,3)")
    evaluate.add_argument("generated_dir")
    evaluate.add_argument("reference_dir")
    evaluate.add_argument("--limit", type=int, default=None)
    evaluate.add_argument("--save", default=None)
    probe.add_argument("which", choices=["exp", "headpack"])
    probe.add_argument("--iters", type=int, default=None,
                       help="timed launches per op or shape (default: exp 50, headpack 20)")
    probe.add_argument("--out", default=None, help="write the result dict as JSON here")
    probe.add_argument("--small", action="store_true",
                       help="a size the CPU runs through the plain versions in seconds")
    grid.add_argument("--dataset", default="MNIST", help="MNIST | CIFAR10 | MNISTM")
    grid.add_argument("--dataset-path", default=None,
                      help="real training data (CSV for MNIST, image tree otherwise); "
                           "absent -> synthetic fallback, clearly labeled")
    grid.add_argument("--inception-weights", default=None,
                      help="local pt_inception/.npz weights; absent -> RandomFeatures "
                           "(NOT comparable to published numbers)")
    grid.add_argument("--configs", default=None,
                      help="comma-separated subset (default: all 13, e.g. A,D-1N,D-2N)")
    grid.add_argument("--epochs", type=int, default=100)
    grid.add_argument("--batch-size", type=int, default=16)
    grid.add_argument("--seed", type=int, default=42)
    grid.add_argument("--gen-total", type=int, default=2000)
    grid.add_argument("--gen-per-batch", type=int, default=200)
    grid.add_argument("--image-size", type=int, default=32)
    grid.add_argument("--image-channels", type=int, default=None)
    grid.add_argument("--noise-steps", type=int, default=1000)
    grid.add_argument("--root", default=".")
    grid.add_argument("--out", default="sample_results/reproduced_grid.json")
    grid.add_argument("--resume", action="store_true",
                      help="reload finished rows from --out and skip those configs "
                           "(recipe must match the prior artifact)")
    grid.add_argument("--reuse-checkpoints", action="store_true",
                      help="skip training for configs whose checkpoint exists under --root "
                           "(regenerate + re-evaluate only)")
    grid.add_argument("--reuse-generated", action="store_true",
                      help="reuse persisted gen_{dataset}_{config}.npz image sets instead of "
                           "re-sampling (metric recompute)")
    for p in (evaluate, probe, grid):
        p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    sample.add_argument("--n", type=int, default=16)
    sample.add_argument("--out", default="samples.png")
    sample.add_argument("--ddim-steps", type=int, default=None,
                        help="use the DDIM sampler with this many steps (default: DDPM)")
    sample.add_argument("--ddim-eta", type=float, default=0.0)
    sample.add_argument("--theta", type=float, default=None,
                        help="Config-E rotation: total angle in degrees, spread over the steps")
    sample.add_argument("--label", type=int, default=None,
                        help="conditional sampling: generate this class (needs --num-classes)")
    sample.add_argument("--cfg-scale", type=float, default=None,
                        help="classifier-free guidance scale (needs --label)")
    sample.add_argument("--random-weights", action="store_true",
                        help="torch-default weights drawn from --seed instead of a checkpoint")
    return parser


def run_sample(args) -> np.ndarray:
    """The ``sample`` subcommand: returns the final uint8 (n, H, W, C) batch
    and writes its grid to ``args.out``."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model
    from aliasfree_diffusion_models_pytorch_tpu_torch.tasks import _load_model_params
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.io import save_image_grid
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import init_params

    config = config_from_args(args)
    device = torch.device(args.device)
    if args.random_weights:
        model = build_model(config, device=device, state_dict=init_params(config, config.seed))
    else:
        model = _load_model_params(config, args.root, device)
    d = Diffusion(noise_steps=config.noise_steps, img_size=config.image_size, device=device)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    cond = dict(labels=args.label, cfg_scale=args.cfg_scale, theta=args.theta)
    if args.ddim_steps:
        final = d.sample_ddim(model, n=args.n, image_channels=config.image_channels,
                              generator=generator, steps=args.ddim_steps, eta=args.ddim_eta,
                              **cond)
    else:
        final, _ = d.sample(model, n=args.n, image_channels=config.image_channels,
                            generator=generator, **cond)
    final = final.cpu().numpy()
    save_image_grid(final, args.out)
    return final


class _ProcessGroup:
    """torch.distributed for one subcommand: started from torchrun's
    environment (nothing without one; a group the caller started is left to
    the caller), and torn down on the way out when this subcommand started it.

    :meth:`close` first drops what is left of a train step (its CUDA graphs
    hold collectives captured on the group's communicators: destroying the
    group under them hangs the ranks), then meets every rank at a barrier,
    then destroys the group. On an exception the group goes without the
    barrier, which could wait forever on a rank that died.
    """

    def __init__(self):
        from aliasfree_diffusion_models_pytorch_tpu_torch.parallel.multihost import (
            init_distributed,
        )

        self.started = not dist.is_initialized() and init_distributed()

    def close(self) -> None:
        if not self.started:
            return
        self.started = False
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        nccl = dist.get_backend() == "nccl"
        dist.barrier(device_ids=[torch.cuda.current_device()] if nccl else None)
        dist.destroy_process_group()

    def __enter__(self) -> "_ProcessGroup":
        return self

    def __exit__(self, kind, value, tb) -> None:
        if kind is None:
            self.close()
        elif self.started:
            self.started = False
            traceback.clear_frames(tb)  # the failed frames may hold a train step
            gc.collect()
            dist.destroy_process_group()


def run_train(args) -> list[float]:
    """The ``train`` subcommand: returns the per-epoch mean losses. Under
    ``torchrun`` (one process a GPU) it starts torch.distributed and trains
    data-parallel (``train.train_mesh``); rank 0 writes the run."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.data import get_data
    from aliasfree_diffusion_models_pytorch_tpu_torch.train import train

    with _ProcessGroup():
        config = config_from_args(args)
        dl, _ = get_data(
            config.dataset, config.dataset_path, config.image_size, config.batch_size,
            image_channels=config.image_channels, seed=config.seed, synthetic_fallback=True,
        )
        return train(config, dl, root=args.root, device=args.device, resume=args.resume,
                     profile_dir=args.profile_dir)


def run_ddpm(args) -> dict:
    """The ``run`` subcommand: ``tasks.ddpm_run``'s result dict. Under
    ``torchrun`` every rank trains; the process group ends with training,
    since nothing after it is collective, and rank 0 samples and writes."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.tasks import ddpm_finish, ddpm_train

    with _ProcessGroup() as group:
        trained = ddpm_train(config_from_args(args), root=args.root, device=args.device,
                             profile_dir=args.profile_dir)
        group.close()
        return ddpm_finish(trained)


def run_sweep(args) -> list[dict]:
    """The ``sweep`` subcommand: one full ``ddpm_run`` per variant, each in
    its own run-name tree. Every variant trains first (on every rank under
    ``torchrun``), then the process group ends, then rank 0 samples and
    writes each variant's artifacts."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.tasks import ddpm_finish, ddpm_train

    with _ProcessGroup() as group:
        trained = []
        for v in (int(s) for s in args.variants.split(",")):
            cfg_v = config_from_args(argparse.Namespace(**{**vars(args), "variant": v}))
            print(f"=== sweep: variant {v} -> {cfg_v.run_name} ===")
            trained.append(ddpm_train(cfg_v, root=args.root, device=args.device,
                                      profile_dir=args.profile_dir))
        group.close()
        return [ddpm_finish(t) for t in trained]


def run_reproduce_grid(args) -> dict:
    """The ``reproduce-grid`` subcommand: the grid's result dict; its table
    is printed and its JSON written to ``args.out``."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.reproduce import reproduce_grid

    return reproduce_grid(
        args.dataset, args.dataset_path,
        configs=args.configs.split(",") if args.configs else None,
        inception_weights=args.inception_weights,
        epochs=args.epochs, batch_size=args.batch_size, seed=args.seed,
        gen_total=args.gen_total, gen_per_batch=args.gen_per_batch,
        image_size=args.image_size, image_channels=args.image_channels,
        noise_steps=args.noise_steps, root=args.root, out_path=args.out,
        resume=args.resume, reuse_checkpoints=args.reuse_checkpoints,
        reuse_generated=args.reuse_generated, device=args.device,
    )


def run_rotate(args) -> str:
    """The ``rotate`` subcommand: returns the path of the video or GIF."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.tasks import rotation_video

    start, stop, count = (float(v) for v in args.thetas.split(":"))
    return rotation_video(
        config_from_args(args), np.linspace(start, stop, int(count)), args.out,
        root=args.root, fps=args.fps, save_sweep=args.save_sweep, device=args.device,
    )


def run_shift(args) -> list[np.ndarray]:
    """The ``shift`` subcommand: the per-shift uint8 batches; their grid goes
    to ``args.out``."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.tasks import shift_results
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.io import save_image_grid

    shifts = [int(s) for s in args.shifts.split(",")]
    outs = shift_results(config_from_args(args), shifts, root=args.root, device=args.device)
    save_image_grid(np.concatenate(outs, axis=0), args.out)
    return outs


def run_eval(args) -> dict:
    """The ``eval`` subcommand: the metric dict of two folders of PNGs."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.eval import evaluate_folders

    return evaluate_folders(args.generated_dir, args.reference_dir, limit=args.limit,
                            save_path=args.save, device=args.device)


def run_probe(args) -> dict:
    """The ``probe`` subcommand: the probe's result dict."""
    from aliasfree_diffusion_models_pytorch_tpu_torch import probes

    if args.which == "exp":
        result = probes.run_exp_micro(args.iters or 50, args.device, small=args.small)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=2)
            print(f"wrote {args.out}")
        return result
    return probes.run_attn_headpack(args.iters or 20, args.device, args.out, small=args.small)


def info_text() -> str:
    """The ``info`` subcommand's report: torch and CUDA versions, every
    visible device with its memory, and the default mesh of this process
    (``parallel.make_mesh()``: every rank on the ``data`` axis)."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.parallel import make_mesh, world
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

    lines = [f"torch: {torch.__version__}  cuda: {torch.version.cuda}  "
             f"available: {torch.cuda.is_available()}  devices: {torch.cuda.device_count()}"]
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        lines.append(f"  cuda:{i} {props.name}  {props.total_memory / 2**30:.1f} GiB  "
                     f"sm_{props.major}{props.minor}  {kernels.sm_count(i)} SMs")
    lines.append(f"default mesh: shape={make_mesh(ranks=range(world()[1])).shape}")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # train narrates its progress through logging.info; the root stays at WARNING.
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s",
                        datefmt="%H:%M:%S")
    logging.getLogger().setLevel(logging.WARNING)
    logging.getLogger(__package__).setLevel(logging.INFO)
    if args.cmd == "summary":
        from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import (
            build_model,
            model_summary,
        )

        # On the meta device: shapes and counts only, no weights are allocated.
        print(model_summary(build_model(config_from_args(args), device="meta")))
        return 0
    if args.cmd == "train":
        losses = run_train(args)
        print(json.dumps({"final_loss": losses[-1] if losses else None}))
        return 0
    if args.cmd == "sample":
        run_sample(args)
        print(f"wrote {args.out}")
        return 0
    if args.cmd == "info":
        print(info_text())
        return 0
    if args.cmd == "eval":
        print(json.dumps(run_eval(args), indent=2))
        return 0
    if args.cmd == "run":
        run_ddpm(args)
        return 0
    if args.cmd == "sweep":
        run_sweep(args)
        return 0
    if args.cmd == "rotate":
        path = run_rotate(args)
        if args.save_sweep:
            print(f"wrote sweep {args.save_sweep}")
        print(f"wrote {path}")
        return 0
    if args.cmd == "shift":
        run_shift(args)
        print(f"wrote {args.out}")
        return 0
    if args.cmd == "probe":
        run_probe(args)
        return 0
    if args.cmd == "reproduce-grid":
        from aliasfree_diffusion_models_pytorch_tpu_torch.reproduce import format_grid_markdown

        print(format_grid_markdown(run_reproduce_grid(args)))
        print(f"wrote {args.out}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
