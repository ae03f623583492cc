"""End-to-end experiment pipeline.

Counterpart of ``aliasfree_diffusion_models_pytorch_tpu/tasks.py``:
:func:`ddpm_run` is the "train everything" routine, stage for stage — settings
dump, filter / noising / resampling diagnostics, UNet smoke test, training,
loss CSV, checkpoint reload, sampling and denoising demos, batch generation
for the metrics, collages — with saved artifacts under the reference's file
names (typos included). It runs as two stages, :func:`ddpm_train` (every
rank trains on the mesh) and :func:`ddpm_finish` (rank 0 alone writes and
samples), so a caller that started torch.distributed can end it in between.

:func:`rotation_results` / :func:`shift_results` are the Config-E evaluation
routines: per θ (or shift) the generator is re-seeded with the SAME seed, so
every member of a sweep starts from identical initial noise — the property
that makes the rotation videos frame-consistent.

Randomness follows the trainer's rule for (seed, index) streams
(``train.step_generator``): the demos draw from ``config.seed`` itself, and
generation chunk ``start_no`` from index ``GEN_INDEX_BASE + start_no``, a
range above every per-step and per-epoch index, so a chunk's images depend
on ``(config.seed, start_no)`` alone.

Figures need matplotlib. Where it is not installed the pipeline still runs
every stage (the samplers of the demos included) and skips only the drawing,
with one warning.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os
import time
from typing import Sequence

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.data import ArrayDataset, get_data
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import (
    UNet,
    build_model,
    param_count,
)
from aliasfree_diffusion_models_pytorch_tpu_torch.ops.filters import (
    circular_lowpass_kernel,
    jinc_filter_2d,
)
from aliasfree_diffusion_models_pytorch_tpu_torch.ops.resample import (
    depthwise_fir,
    maxpool2x,
    upsample_bilinear_align_corners,
)
from aliasfree_diffusion_models_pytorch_tpu_torch.parallel import world
from aliasfree_diffusion_models_pytorch_tpu_torch.train import (
    recover_stored_config,
    step_generator,
    train,
)
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import plotting
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.io import (
    make_collage,
    make_video,
    save_dataset_images,
    save_gen_images,
)
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import init_params, load_jax_npz

logger = logging.getLogger(__name__)

# First (seed, index) stream index of the generation chunks: the train steps
# count up from 0 and the per-epoch sample grids from 2**31.
GEN_INDEX_BASE = 3 * 2**30


def _load_model_params(config: TrainConfig, root: str, device="cuda") -> UNet:
    """Rebuild the UNet on ``device`` with the run checkpoint's weights (the
    EMA ones under ``config.use_ema``).

    ``base_width`` is recovered from the ``config.json`` that ``train()``
    writes beside the checkpoint: the weights fix the width, so the stored
    value wins over the one passed in.
    """
    config = recover_stored_config(config, root)
    state = load_jax_npz(config.checkpoint_path(root), ema=config.use_ema)
    return build_model(config, device=device, state_dict=state)


def _diffusion(config: TrainConfig, device) -> Diffusion:
    return Diffusion(
        noise_steps=config.noise_steps, beta_start=config.beta_start,
        beta_end=config.beta_end, img_size=config.image_size, device=device,
    )


def resample_ab_demo(
    image: np.ndarray, filters: FilterSettings, device="cuda"
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Filtered vs plain down/up-sampling A/B on one real image.

    * filtered chain: original → depthwise jinc FIR (ω_c_down) → MaxPool(2) →
      bilinear 2x up (align_corners=True) → depthwise FIR (ω_c_up);
    * plain chain: original → MaxPool(2) → bilinear 2x up.

    ``image`` is one NHWC (or HWC) float image in [-1, 1]. Returns the
    (filtered_stages, plain_stages) dicts of named HWC arrays, ordered as the
    reference's plot titles.
    """
    x = torch.as_tensor(np.asarray(image, np.float32), device=device)
    if x.dim() == 3:
        x = x[None]
    x = x.permute(0, 3, 1, 2)  # the port's ops take NCHW
    jinc = circular_lowpass_kernel(filters.omega_c_down, filters.kernel_size, filters.kaiser_beta)
    sinc = circular_lowpass_kernel(filters.omega_c_up, filters.kernel_size, filters.kaiser_beta)

    def hwc(t: torch.Tensor) -> np.ndarray:
        return t[0].permute(1, 2, 0).cpu().numpy()

    filtered: dict[str, np.ndarray] = {"original": hwc(x)}
    y = depthwise_fir(x, jinc)
    filtered["downfilter"] = hwc(y)
    y = maxpool2x(y)
    filtered["downsample"] = hwc(y)
    y = upsample_bilinear_align_corners(y)
    filtered["upsample"] = hwc(y)
    y = depthwise_fir(y, sinc)
    filtered["upfilter"] = hwc(y)

    plain: dict[str, np.ndarray] = {"original": hwc(x)}
    z = maxpool2x(x)
    plain["downsample"] = hwc(z)
    z = upsample_bilinear_align_corners(z)
    plain["upsample"] = hwc(z)
    return filtered, plain


@dataclasses.dataclass
class TrainedRun:
    """What :func:`ddpm_train` leaves for :func:`ddpm_finish`. ``writer``:
    this process was rank 0 when it trained (the process group may be gone
    by the time the run finishes)."""

    writer: bool
    config: TrainConfig
    root: str
    device: torch.device
    loss_all: list[float]
    settings_path: str | None
    dataset: ArrayDataset
    diffusion: Diffusion
    generator: torch.Generator
    plots: bool
    t_run: float


def ddpm_run(
    config: TrainConfig,
    *,
    root: str = ".",
    device="cuda",
    mesh=None,
    diagnostics: bool = True,
    generate: bool = True,
    profile_dir: str | None = None,
) -> dict:
    """Full experiment on ``device``: :func:`ddpm_train`, then
    :func:`ddpm_finish` (``mesh`` and ``profile_dir``: see ``train.train``).

    Returns a result dict with the per-epoch losses and artifact paths. All
    artifact names and locations follow the reference layout, including its
    typos ("Uncondtional" run dirs, the hardcoded ``trining_loss_MNIST_*.csv``
    file name). Under torch.distributed every rank trains on the mesh and
    rank 0 alone writes and samples; the other ranks return
    ``{"loss_all": ...}`` once training is over.
    """
    return ddpm_finish(ddpm_train(config, root=root, device=device, mesh=mesh,
                                  diagnostics=diagnostics, profile_dir=profile_dir),
                       generate=generate)


def ddpm_train(
    config: TrainConfig,
    *,
    root: str = ".",
    device="cuda",
    mesh=None,
    diagnostics: bool = True,
    profile_dir: str | None = None,
) -> TrainedRun:
    """The stages of :func:`ddpm_run` up to training: the settings file, the
    diagnostics and the UNet smoke test (rank 0), then training (every rank).
    Nothing after it is collective."""
    t_run = time.time()
    device = torch.device(device)
    writer = world()[0] == 0
    runs_dir = config.runs_dir(root)
    plots = writer and plotting.available()
    if writer and not plots:
        logger.warning("matplotlib is not installed: the run's figures are skipped")
    generator = torch.Generator(device=device)
    settings_path = None
    if writer:
        os.makedirs(runs_dir, exist_ok=True)
        # 1. Settings snapshot.
        settings_path = os.path.join(runs_dir,
                                     f"settings_{config.dataset}_{config.variant}.txt")
        with open(settings_path, "w") as f:
            f.write(config.settings_text())
        logger.info("device: %s", torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device)

    # 2. Filter diagnostics.
    if plots and diagnostics and config.filters is not None:
        fs = config.filters
        for name, kern in [
            ("jinc2d", jinc_filter_2d(fs.kernel_size, fs.kaiser_beta or 14.0)),
            ("circular", circular_lowpass_kernel(fs.omega_c_down, fs.kernel_size)),
            ("circular_kaiser",
             circular_lowpass_kernel(fs.omega_c_down, fs.kernel_size, fs.kaiser_beta)),
        ]:
            plotting.plot_filter_and_response(kern, os.path.join(runs_dir, f"filter_{name}.png"))

    # 3. UNet smoke test: parameter count and an executed forward on random input.
    if writer:
        model = build_model(config, device=device, state_dict=init_params(config, 0))
        logger.info("UNet parameters: %s", f"{param_count(model):,}")
        shape = (2, config.image_size, config.image_size, config.image_channels)
        x = torch.randn(shape, generator=generator.manual_seed(1), device=device)
        t = torch.full((2,), min(500, config.noise_steps - 1), dtype=torch.long, device=device)
        with torch.inference_mode():
            out = model(x, t)
        if out.shape != x.shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"UNet smoke forward: {tuple(x.shape)} -> {tuple(out.shape)}, "
                               f"finite: {bool(torch.isfinite(out).all())}")
        logger.info("UNet forward: %s -> %s", tuple(x.shape), tuple(out.shape))
        del model, out

    # 4. Data and the noising visualisation.
    dataloader, dataset = get_data(
        config.dataset, config.dataset_path, config.image_size, config.batch_size,
        image_channels=config.image_channels, seed=config.seed,
        synthetic_fallback=True,
    )
    diffusion = _diffusion(config, device)
    if writer and diagnostics:
        img = torch.from_numpy(dataset.images[:1].repeat(9, axis=0)).to(device)
        tvis = torch.from_numpy(
            np.round(np.linspace(0, config.noise_steps - 1, 9)).astype(np.int64)).to(device)
        noised, _ = diffusion.noise_images(img, tvis, generator.manual_seed(config.seed))
        if plots:
            plotting.plot_images(Diffusion.to_uint8(noised).cpu().numpy(),
                                 os.path.join(runs_dir, "noising_chain.png"))

    # 4b. Filtered vs plain resampling A/B on a real training image.
    if writer and diagnostics and config.filters is not None:
        filtered, plain = resample_ab_demo(dataset.images[0], config.filters, device)
        if plots:
            plotting.plot_image_panels(list(filtered.values()), list(filtered.keys()),
                                       os.path.join(runs_dir, "resample_filtered.png"))
            plotting.plot_image_panels(list(plain.values()), list(plain.keys()),
                                       os.path.join(runs_dir, "resample_plain.png"))

    # 5. Train.
    loss_all = train(config, dataloader, root=root, device=device, mesh=mesh,
                     profile_dir=profile_dir)
    return TrainedRun(writer, config, root, device, loss_all, settings_path, dataset, diffusion,
                      generator, plots, t_run)


def ddpm_finish(run: TrainedRun, *, generate: bool = True) -> dict:
    """The stages of :func:`ddpm_run` after training, on rank 0 (another rank
    returns ``{"loss_all": ...}``): the loss artifacts, the sampling and
    denoising demos from the reloaded checkpoint, the generated image set for
    the metrics and its collages."""
    config, root, device = run.config, run.root, run.device
    loss_all, diffusion, generator = run.loss_all, run.diffusion, run.generator
    if not run.writer:
        return {"loss_all": loss_all}
    runs_dir = config.runs_dir(root)
    if run.plots:
        plotting.plot_loss(loss_all, os.path.join(runs_dir, "loss.png"))
    loss_csv = os.path.join(runs_dir, f"trining_loss_MNIST_{config.variant}.csv")  # [sic]
    with open(loss_csv, "w", newline="") as f:
        csv.writer(f).writerow(loss_all)

    # 6. Reload the checkpoint; sampling and denoising demos, both from
    # config.seed (the same initial noise).
    model = _load_model_params(config, root, device)
    finals, _ = diffusion.sample(model, n=6, image_channels=config.image_channels,
                                 generator=generator.manual_seed(config.seed))
    traj = diffusion.revert(model, n=1, image_channels=config.image_channels,
                            generator=generator.manual_seed(config.seed))
    if run.plots:
        plotting.plot_images(finals.cpu().numpy(), os.path.join(runs_dir, "samples.png"))
        plotting.plot_images(traj.cpu().numpy(), os.path.join(runs_dir, "denoising.png"))

    # 7. Optional training-set export (the metrics' reference set).
    gen_dir = os.path.join(root, f"images/generated/{config.dataset}_{config.variant}")
    if config.save_training:
        save_dataset_images(os.path.join(root, f"images/original/{config.dataset}"),
                            run.dataset.images)

    # 8. Batch generation for the metric set, then the collages.
    if generate and config.gen_total > 0:
        for start_no in range(0, config.gen_total, config.gen_per_batch):
            # Every chunk samples gen_per_batch images; the trailing chunk only
            # *saves* those that were asked for, so exactly gen_total files exist.
            n_save = min(config.gen_per_batch, config.gen_total - start_no)
            fileno = np.arange(start_no, start_no + n_save)
            x, _ = diffusion.sample(
                model, n=config.gen_per_batch, image_channels=config.image_channels,
                generator=step_generator(generator, config.seed, GEN_INDEX_BASE + start_no),
            )
            save_gen_images(gen_dir, x.cpu().numpy()[:n_save], fileno)
        # The collage request is clamped to what was generated: a collage_n
        # above gen_total would reference image files that do not exist.
        collage_total = min(config.collage_n, config.gen_total)
        per_collage = min(config.collage_n_per_image, collage_total)
        if per_collage >= 1:
            make_collage(gen_dir, gen_dir, per_collage, collage_total, config.image_size)

    logger.info("ddpm_run finished in %.1fs", time.time() - run.t_run)
    return {
        "loss_all": loss_all,
        "settings_path": run.settings_path,
        "loss_csv": loss_csv,
        "checkpoint": config.checkpoint_path(root),
        "gen_dir": gen_dir,
    }


def rotation_results(
    config: TrainConfig,
    thetas: Sequence[float],
    *,
    root: str = ".",
    n: int = 4,
    rotation_order: int = 3,
    device="cuda",
):
    """Config-E sweep: the same seed per θ → identical initial noise, directly
    comparable rotations. Returns (finals, trajectories) lists of uint8 arrays."""
    model = _load_model_params(config, root, device)
    diffusion = _diffusion(config, device)
    generator = torch.Generator(device=torch.device(device))
    x_all, results_all = [], []
    for theta in thetas:
        x, results = diffusion.sample(
            model, n=n, image_channels=config.image_channels,
            generator=generator.manual_seed(config.seed),
            theta=float(theta), rotation_order=rotation_order,
        )
        x_all.append(x.cpu().numpy())
        results_all.append(results.cpu().numpy())
    return x_all, results_all


def shift_results(
    config: TrainConfig,
    shifts: Sequence[int],
    *,
    root: str = ".",
    n: int = 4,
    device="cuda",
):
    """Translation sweep: the same seed per shift. Returns a list of uint8 arrays."""
    model = _load_model_params(config, root, device)
    diffusion = _diffusion(config, device)
    generator = torch.Generator(device=torch.device(device))
    return [
        diffusion.sample_shift(
            model, n=n, image_channels=config.image_channels,
            generator=generator.manual_seed(config.seed), shift=int(s),
        ).cpu().numpy()
        for s in shifts
    ]


def rotation_video(
    config: TrainConfig,
    thetas: Sequence[float],
    vname: str,
    *,
    root: str = ".",
    fps: int = 15,
    save_sweep: str | None = None,
    device="cuda",
) -> str:
    """θ-sweep → per-θ final frames → video or GIF; returns the path written.

    ``save_sweep`` also persists the sweep's finals and trajectories
    (:func:`save_rotation_sweep`).
    """
    x_all, traj_all = rotation_results(config, thetas, root=root, n=1, device=device)
    if save_sweep:
        save_rotation_sweep(save_sweep, thetas, x_all, traj_all)
    frames = np.concatenate(x_all, axis=0)
    return make_video(frames, vname, fps=fps)


def save_rotation_sweep(
    path: str,
    thetas: Sequence[float],
    finals: Sequence[np.ndarray],
    trajectories: Sequence[np.ndarray],
) -> str:
    """Persist a Config-E θ-sweep as a compressed ``.npz``: ``thetas`` (K,),
    ``finals`` (K, n, H, W, C) uint8, ``trajectories`` (K, T, n, H, W, C)
    uint8 — the JAX package's layout. Load with :func:`load_rotation_sweep`."""
    if not path.endswith(".npz"):
        path += ".npz"
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    np.savez_compressed(
        path,
        thetas=np.asarray(thetas, np.float64),
        finals=np.stack([np.asarray(f) for f in finals]),
        trajectories=np.stack([np.asarray(t) for t in trajectories]),
    )
    return path


def load_rotation_sweep(path: str) -> dict[str, np.ndarray]:
    """Load a sweep saved by :func:`save_rotation_sweep`."""
    with np.load(path) as z:
        return {k: z[k] for k in ("thetas", "finals", "trajectories")}
