"""One-command reproduction of the reference's published quality grid.

Port of ``aliasfree_diffusion_models_pytorch_tpu/reproduce.py``. The
reference's headline result is a 13-configuration x 3-dataset table of
IS/FID/KID numbers (recipe: 100 epochs, batch 16, AdamW lr 3e-4, 1000 noise
steps, 32x32, seed 42, metrics on 2000 generated images against the training
set). :func:`reproduce_grid` runs that recipe per configuration on
``device`` (training and sampling go through the hand-written attention
kernels on the card) and emits the table, with deltas against the published
values where the numbers are comparable.

Without a dataset and an Inception weight file the grid trains on the
synthetic dataset (or on whatever image tree ``dataset_path`` names) and
measures in the deterministic :class:`~aliasfree_diffusion_models_pytorch_tpu_torch.eval.RandomFeatures`
space, labelled ``comparable_to_published: false``. With a real dataset and a
``pt_inception`` weight file the same command fills the real grid.

Configuration names: letter = architecture (A baseline, B alias-free
resampling, C filtered nonlinearities, D = B+C), digit = Kaiser beta,
trailing N = normalised kernel. Filters for B/C/D: kernel_size=3,
omega_c = pi/2.

The JAX package sets up a persistent compile cache before the grid; PyTorch
runs eagerly and the port's kernels are built once per checkout
(``utils/kernels.py``), so there is nothing to set up here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time

import numpy as np

logger = logging.getLogger(__name__)

# name -> (variant, kaiser_beta, normalize); beta None == no filters.
GRID_CONFIGS: dict[str, tuple[int, float | None, bool]] = {
    "A": (0, None, True),
    "B-0": (1, 0.0, False), "C-0": (2, 0.0, False), "D-0": (3, 0.0, False),
    "B-1": (1, 1.0, False), "C-1": (2, 1.0, False), "D-1": (3, 1.0, False),
    "B-1N": (1, 1.0, True), "C-1N": (2, 1.0, True), "D-1N": (3, 1.0, True),
    "B-2N": (1, 2.0, True), "C-2N": (2, 2.0, True), "D-2N": (3, 2.0, True),
}

# Published numbers (IS, FID, KIDx100) per dataset, from the reference's
# README (transcribed in BASELINE.md).
PUBLISHED: dict[str, dict[str, tuple[float, float, float]]] = {
    "CIFAR10": {
        "A": (4.54, 98.77, 5.97), "B-0": (4.71, 94.23, 5.44),
        "C-0": (3.75, 129.42, 7.92), "D-0": (4.33, 97.44, 6.67),
        "B-1": (4.63, 121.45, 6.90), "C-1": (3.56, 138.88, 10.47),
        "D-1": (4.32, 108.06, 7.42), "B-1N": (4.63, 125.71, 6.64),
        "C-1N": (3.99, 107.37, 6.96), "D-1N": (4.51, 90.21, 5.54),
        "B-2N": (4.34, 109.96, 7.65), "C-2N": (4.34, 95.11, 6.70),
        "D-2N": (4.50, 102.28, 6.81),
    },
    "MNISTM": {
        "A": (3.76, 85.00, 6.23), "B-0": (3.39, 93.81, 7.37),
        "C-0": (3.11, 124.10, 9.43), "D-0": (3.33, 98.16, 7.56),
        "B-1": (3.40, 94.11, 7.40), "C-1": (3.48, 124.78, 7.86),
        "D-1": (3.44, 114.27, 8.35), "B-1N": (3.71, 100.91, 7.53),
        "C-1N": (3.69, 144.41, 9.69), "D-1N": (3.68, 108.14, 7.65),
        "B-2N": (4.14, 88.05, 5.47), "C-2N": (4.01, 101.59, 6.78),
        "D-2N": (3.99, 82.46, 5.35),
    },
    "MNIST": {
        "A": (1.98, 9.61, 0.47), "B-0": (1.99, 10.23, 0.58),
        "C-0": (1.94, 14.07, 0.96), "D-0": (1.94, 14.37, 1.01),
        "B-1": (1.97, 11.00, 0.64), "C-1": (1.97, 14.76, 1.05),
        "D-1": (1.98, 16.08, 1.12), "B-1N": (1.97, 11.62, 0.72),
        "C-1N": (1.96, 15.95, 1.23), "D-1N": (1.96, 14.25, 0.97),
        "B-2N": (2.00, 12.78, 0.87), "C-2N": (1.97, 16.73, 1.29),
        "D-2N": (1.99, 11.19, 0.71),
    },
}

# sha256 prefixes of the two publicly distributed Inception weight files the
# port can read. torch-fidelity's FID Inception (the one behind every
# published FID number) carries its prefix in its file name.
KNOWN_INCEPTION_SHA256_PREFIXES = {
    "6726825d": "pt_inception-2015-12-05 (torch-fidelity FID Inception)",
    "0cc3c7bd": "inception_v3_google (torchvision)",
}

# Generation chunk i of the grid draws from stream index GRID_GEN_INDEX + i of
# (seed, index) (``train.step_generator``): the JAX package's fold_in of
# 7000 + i, placed in the generation range above every train-step and
# per-epoch index (``tasks.GEN_INDEX_BASE``).
GRID_GEN_OFFSET = 7000


def validate_inception_weights(path: str) -> dict:
    """Hash-check a local Inception weight file before trusting its FIDs.

    Returns ``{"path", "sha256", "known": name-or-None}``. An unknown hash
    does not raise (a converted ``.npz`` is legal) but is recorded in the grid
    output, so that one can tell which weights produced the numbers.
    """
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    digest = h.hexdigest()
    known = KNOWN_INCEPTION_SHA256_PREFIXES.get(digest[:8])
    if known is None:
        logger.warning(
            "inception weights %s have unrecognized sha256 %s…; FIDs will be "
            "self-consistent but may not match published numbers", path,
            digest[:16],
        )
    return {"path": path, "sha256": digest, "known": known}


def _build_config(name: str, dataset: str, *, epochs: int, batch_size: int,
                  image_size: int, image_channels: int, seed: int,
                  gen_total: int, gen_per_batch: int, dataset_path=None):
    from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig

    variant, beta, normalize = GRID_CONFIGS[name]
    filters = None
    if variant != 0:
        filters = FilterSettings(kernel_size=3, kaiser_beta=beta, normalize=normalize)
    return TrainConfig(
        run_name=f"grid_{dataset}_{name}",
        epochs=epochs, batch_size=batch_size, image_size=image_size,
        image_channels=image_channels, dataset=dataset,
        dataset_path=dataset_path, lr=3e-4, noise_steps=1000,
        image_gen_n=0, variant=variant, filters=filters, seed=seed,
        gen_total=gen_total, gen_per_batch=gen_per_batch,
        compute_dtype="bfloat16",
    )


def reproduce_grid(
    dataset: str = "MNIST",
    dataset_path: str | None = None,
    *,
    configs: list[str] | None = None,
    inception_weights: str | None = None,
    epochs: int = 100,
    batch_size: int = 16,
    seed: int = 42,
    gen_total: int = 2000,
    gen_per_batch: int = 200,
    image_size: int = 32,
    image_channels: int | None = None,
    noise_steps: int = 1000,
    root: str = ".",
    out_path: str | None = None,
    resume: bool = False,
    reuse_checkpoints: bool = False,
    reuse_generated: bool = False,
    device="cuda",
) -> dict:
    """Run the published-grid recipe for ``configs`` on ``device`` and emit
    the table (the JAX package's artifact, key for key).

    With real assets (``dataset_path`` + ``inception_weights``) the numbers
    are comparable to the published ones and the rows carry deltas. Without
    them the synthetic fallback and the RandomFeatures space run the same
    pipeline, labelled ``comparable_to_published: False``.

    ``resume=True`` reloads a prior (possibly ``complete: False``) artifact
    from ``out_path`` and skips every config that already has a row; its
    recipe must match exactly, or it raises rather than mix rows. Prior rows
    of configs outside this call's ``configs`` are carried into the output
    untouched, so a narrower re-run drops no finished row.

    Each config's generated images are kept as ``gen_{dataset}_{config}.npz``
    beside ``out_path``. ``reuse_checkpoints=True`` skips training where a
    checkpoint exists under ``root``; ``reuse_generated=True`` reuses a kept
    image set instead of sampling, and then needs no model and skips
    training, so the metrics are recomputed from the ``gen_*.npz`` files
    alone. Both inherit the training facts (``final_loss``, ``train_s``) from
    a prior artifact at ``out_path`` whose training recipe matches.
    """
    import torch

    from aliasfree_diffusion_models_pytorch_tpu_torch.data import Dataloader, get_data
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.eval import (
        InceptionV3Features,
        RandomFeatures,
        calculate_metrics,
    )
    from aliasfree_diffusion_models_pytorch_tpu_torch.tasks import (
        GEN_INDEX_BASE,
        _load_model_params,
    )
    from aliasfree_diffusion_models_pytorch_tpu_torch.train import step_generator, train

    device = torch.device(device)
    configs = configs or list(GRID_CONFIGS)
    unknown = [c for c in configs if c not in GRID_CONFIGS]
    if unknown:
        raise ValueError(f"unknown grid configs {unknown}; valid: {list(GRID_CONFIGS)}")

    if image_channels is None:
        image_channels = 1 if dataset.upper() == "MNIST" else 3

    weights_info = None
    if inception_weights is not None:
        weights_info = validate_inception_weights(inception_weights)
        extractor = InceptionV3Features(inception_weights, device=str(device))
    else:
        logger.warning(
            "no --inception-weights: falling back to the RandomFeatures "
            "space — numbers are NOT comparable to the published grid")
        extractor = RandomFeatures(seed=0, device=str(device))

    # One dataset decides real-vs-synthetic up front so every config trains
    # on the same data.
    _, ds = get_data(
        dataset, dataset_path, image_size, batch_size,
        image_channels=image_channels, seed=seed, synthetic_fallback=True,
    )
    real_data = dataset_path is not None and os.path.exists(dataset_path)
    if dataset_path is not None and not real_data:
        logger.warning("dataset path %s missing — synthetic fallback in use", dataset_path)
    train_u8 = np.clip((ds.images + 1) / 2 * 255, 0, 255).astype(np.uint8)
    comparable = bool(real_data and inception_weights)

    d = Diffusion(noise_steps=noise_steps, img_size=image_size, device=device)
    published = PUBLISHED.get(dataset.upper(), {})
    recipe = {
        "epochs": epochs, "batch_size": batch_size, "seed": seed,
        "gen_total": gen_total, "noise_steps": noise_steps, "image_size": image_size,
    }

    prior_rows: dict[str, dict] = {}
    if resume and out_path and os.path.exists(out_path):
        with open(out_path) as f:
            prior = json.load(f)
        # The weight file's identity matters too: two runs both in the
        # 'inception' space but with different weights give incomparable rows.
        prior_w = (prior.get("inception_weights") or {}).get("sha256")
        cur_w = (weights_info or {}).get("sha256")
        current = {"dataset": dataset, "real_data": real_data, "feature_space": extractor.name}
        mismatched = {k for k, v in current.items() if prior.get(k) != v}
        if prior_w != cur_w:
            mismatched.add("inception_weights")
        if prior.get("recipe") != recipe or mismatched:
            raise ValueError(
                f"--resume artifact {out_path} was produced under a different "
                f"recipe/setup (recipe {prior.get('recipe')} vs "
                f"{recipe}, mismatched keys {sorted(mismatched)}); "
                "refusing to mix rows")
        prior_rows = {r["config"]: r for r in prior.get("rows", [])}
        logger.info("resume: %d finished rows reloaded from %s", len(prior_rows), out_path)

    # When training is skipped, the training facts (final_loss, train_s) still
    # describe the checkpoint or image set reused: inherit them from a prior
    # artifact whose *training* recipe matches (the feature space may differ:
    # that is the recompute-after-a-metric-fix case).
    train_meta: dict[str, dict] = {}
    if (reuse_checkpoints or reuse_generated) and out_path and os.path.exists(out_path):
        with open(out_path) as f:
            prior_any = json.load(f)
        prior_recipe = prior_any.get("recipe") or {}
        if prior_any.get("dataset") == dataset and all(
                prior_recipe.get(k) == recipe[k]
                for k in ("epochs", "batch_size", "seed", "noise_steps", "image_size")):
            train_meta = {r["config"]: r for r in prior_any.get("rows", [])}

    # Final artifact = rows computed now + prior rows of configs outside this
    # call's list, in the canonical grid order.
    target = [n for n in GRID_CONFIGS if n in configs or n in prior_rows]
    done: dict[str, dict] = {}

    def _result(complete: bool) -> dict:
        merged = [done.get(n) or prior_rows[n] for n in target if n in done or n in prior_rows]
        return {
            "dataset": dataset,
            "real_data": real_data,
            "feature_space": extractor.name,
            "comparable_to_published": comparable,
            "inception_weights": weights_info,
            "recipe": dict(recipe),
            "complete": complete,
            "configs_done": len(merged),
            "configs_total": len(target),
            "rows": merged,
        }

    def _dump(result: dict) -> None:
        if not out_path:
            return
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)

    def _gen_path(name: str) -> str | None:
        if not out_path:
            return None
        return os.path.join(os.path.dirname(os.path.abspath(out_path)),
                            f"gen_{dataset}_{name}.npz")

    generator = torch.Generator(device=device)
    for name in configs:
        if resume and name in prior_rows:
            done[name] = prior_rows[name]
            logger.info("grid config %s: resumed from prior artifact", name)
            continue
        config = _build_config(
            name, dataset, epochs=epochs, batch_size=batch_size,
            image_size=image_size, image_channels=image_channels, seed=seed,
            gen_total=gen_total, gen_per_batch=gen_per_batch,
            dataset_path=dataset_path,
        )
        config = dataclasses.replace(config, noise_steps=noise_steps)

        losses: list = []
        train_s = None
        final_loss = None
        gen_path = _gen_path(name)
        gen_u8 = None
        if reuse_generated and gen_path and os.path.exists(gen_path):
            # A reused image set needs neither model nor checkpoint.
            with np.load(gen_path) as z:
                gen_u8 = z["images"]
            meta = train_meta.get(name) or {}
            final_loss, train_s = meta.get("final_loss"), meta.get("train_s")
            logger.info("grid config %s: reusing %d generated images from %s",
                        name, len(gen_u8), gen_path)
        elif reuse_checkpoints and os.path.exists(config.checkpoint_path(root) + ".npz"):
            logger.info("grid config %s: reusing checkpoint %s", name,
                        config.checkpoint_path(root))
            meta = train_meta.get(name) or {}
            final_loss, train_s = meta.get("final_loss"), meta.get("train_s")
        else:
            logger.info("grid config %s: training %d epochs", name, epochs)
            t0 = time.time()
            dl = Dataloader(ds, batch_size=batch_size, seed=seed)
            losses = train(config, dl, root=root, device=device, sample_each_epoch=False)
            train_s = time.time() - t0

        if gen_u8 is None:
            model = _load_model_params(config, root, device)
            gen = []
            remaining = gen_total
            chunk_i = 0
            while remaining > 0:
                x, _ = d.sample(
                    model, n=gen_per_batch, image_channels=image_channels,
                    generator=step_generator(
                        generator, seed, GEN_INDEX_BASE + GRID_GEN_OFFSET + chunk_i),
                )
                gen.append(x.cpu().numpy()[:remaining])
                remaining -= gen_per_batch
                chunk_i += 1
            gen_u8 = np.concatenate(gen)
            del model
            if gen_path:
                # Kept beside the grid JSON so the metrics can be recomputed
                # without training or sampling again. (The JSON's directory
                # may not exist yet: it is first written after this row.)
                os.makedirs(os.path.dirname(gen_path), exist_ok=True)
                np.savez_compressed(gen_path, images=gen_u8)

        m = calculate_metrics(gen_u8, train_u8[:gen_total], extractor)
        row = {
            "config": name,
            "is": round(m["inception_score_mean"], 2),
            "fid": round(m["frechet_inception_distance"], 2),
            "kid_x100": round(100 * m["kernel_inception_distance_mean"], 2),
            # Full-precision copies for ordering analysis: the 2-decimal
            # display collapses close KIDs into ties.
            "is_raw": float(m["inception_score_mean"]),
            "fid_raw": float(m["frechet_inception_distance"]),
            "kid_x100_raw": float(100 * m["kernel_inception_distance_mean"]),
            "final_loss": round(losses[-1], 4) if losses else final_loss,
            "train_s": round(train_s, 1) if train_s is not None else None,
        }
        if gen_path:
            row["gen_images"] = os.path.basename(gen_path)
        pub = published.get(name)
        if pub and comparable:
            row["published_is"], row["published_fid"], row["published_kid_x100"] = pub
            row["delta_fid"] = round(row["fid"] - pub[1], 2)
            row["delta_kid_x100"] = round(row["kid_x100"] - pub[2], 2)
        done[name] = row
        logger.info("grid config %s: %s", name, json.dumps(row))
        # Incremental dump: a long run that dies keeps its finished rows
        # (complete=False marks it).
        _dump(_result(complete=False))

    result = _result(complete=True)
    _dump(result)
    return result


def format_grid_markdown(result: dict) -> str:
    """BASELINE.md-format table; deltas only when comparable to published."""
    comparable = result["comparable_to_published"]
    space = result["feature_space"]
    header = (f"## Reproduced grid — {result['dataset']} "
              f"({space}{'' if comparable else ' — NOT comparable to published'})")
    lines = [header, ""]
    if comparable:
        lines += ["| Configuration | IS↑ | FID↓ | KID×100↓ | pub FID | ΔFID | pub KID | ΔKID |",
                  "|---|---|---|---|---|---|---|---|"]
        for r in result["rows"]:
            lines.append(
                f"| {r['config']} | {r['is']} | {r['fid']} | {r['kid_x100']} "
                f"| {r.get('published_fid', '—')} | {r.get('delta_fid', '—')} "
                f"| {r.get('published_kid_x100', '—')} | {r.get('delta_kid_x100', '—')} |"
            )
    else:
        lines += ["| Configuration | IS↑ | FID↓ | KID×100↓ |", "|---|---|---|---|"]
        for r in result["rows"]:
            lines.append(f"| {r['config']} | {r['is']} | {r['fid']} | {r['kid_x100']} |")
    return "\n".join(lines)
