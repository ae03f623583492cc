"""The port's study path on the CPU: tasks, IO, plotting and the new subcommands.

* ``depthwise_fir`` and ``resample_ab_demo`` against the JAX package on the
  same seeded image: 1e-6 absolute (f32 3x3 filters and a separable bilinear
  upsample in another summation order, values in [-1, 1]);
* the IO helpers against the JAX package's: the same files, pixel for pixel;
* ``ddpm_run`` at image 8, 20 noise steps, 1 epoch writes every artifact of
  the reference layout, and a generation chunk depends on ``(seed, start_no)``
  alone;
* ``rotation_results`` / ``shift_results`` start every member of a sweep from
  the same noise;
* the sweep ``.npz`` round trip, also through the JAX package's loader;
* every new subcommand parses with the JAX CLI's flags and defaults, and
  ``rotate``, ``shift``, ``eval``, ``info`` run with ``--device cpu``.
"""

import csv
import dataclasses
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aliasfree_diffusion_models_pytorch_tpu import config as jconfig
from aliasfree_diffusion_models_pytorch_tpu import tasks as jtasks
from aliasfree_diffusion_models_pytorch_tpu.ops import resample as jresample
from aliasfree_diffusion_models_pytorch_tpu.utils import io as jio
from aliasfree_diffusion_models_pytorch_tpu_torch import cli, tasks
from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.data import synthetic_dataset
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import resample
from aliasfree_diffusion_models_pytorch_tpu_torch.ops.filters import circular_lowpass_kernel
from aliasfree_diffusion_models_pytorch_tpu_torch.train import step_generator
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import io, plotting

TINY = ["--variant", "3", "--image-size", "8", "--image-channels", "3", "--noise-steps", "20",
        "--compute-dtype", "float32", "--device", "cpu", "--dataset", "CIFAR10"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several worker processes at once. A worker whose
    convolutions take every core makes the others' OpenMP threads spin at
    their barriers, and all of them crawl; two threads are enough here."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# ops and diagnostics against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [3, 4])
def test_depthwise_fir_matches_jax(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    taps = circular_lowpass_kernel(math.pi / 2, size, 2.0)
    got = resample.depthwise_fir(torch.from_numpy(x).permute(0, 3, 1, 2), taps)
    ref = np.asarray(jresample.depthwise_fir(jnp.asarray(x), taps))
    assert got.shape == (2, 3, 9, 10)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("beta,kernel", [(2.0, 3), (None, 5)])
def test_resample_ab_demo_matches_jax(beta, kernel):
    image = synthetic_dataset(2, 16, 3, seed=1).images[1]
    kw = dict(kernel_size=kernel, kaiser_beta=beta, omega_c_down=math.pi / 2, omega_c_up=math.pi / 3)
    filtered, plain = tasks.resample_ab_demo(image, FilterSettings(**kw), device="cpu")
    jfiltered, jplain = jtasks.resample_ab_demo(image, jconfig.FilterSettings(**kw))
    assert list(filtered) == list(jfiltered) == ["original", "downfilter", "downsample",
                                                 "upsample", "upfilter"]
    assert list(plain) == list(jplain) == ["original", "downsample", "upsample"]
    for ours, theirs in ((filtered, jfiltered), (plain, jplain)):
        for name, value in theirs.items():
            assert ours[name].shape == value.shape, name
            np.testing.assert_allclose(ours[name], value, rtol=0, atol=1e-6, err_msg=name)
    assert filtered["downsample"].shape == (8, 8, 3) and filtered["upfilter"].shape == (16, 16, 3)


def test_settings_text_is_the_jax_packages_without_its_switches():
    kw = dict(variant=3, dataset="CIFAR10", image_size=16, noise_steps=50)
    ours = TrainConfig(filters=FilterSettings(), **kw).settings_text().splitlines()
    theirs = jconfig.TrainConfig(filters=jconfig.FilterSettings(), **kw).settings_text().splitlines()
    # the same settings lines; each package ends with its own impl.* report
    # (tests/test_torch_impl_config.py holds the keys the two share)
    assert [line for line in ours if not line.startswith("impl.")] == [
        line for line in theirs if not line.startswith("impl.")]
    assert any(line.startswith("impl.") for line in ours)
    assert "kernel_size: 3" in ours and "noise_steps: 50" in ours
    assert "kernel_size: None" in TrainConfig().settings_text().splitlines()


# ---------------------------------------------------------------------------
# IO and plotting
# ---------------------------------------------------------------------------


def _same_image_files(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(a, name))),
                                      np.asarray(Image.open(os.path.join(b, name))))


@pytest.mark.parametrize("channels", [1, 3])
def test_image_dumps_and_collages_match_the_jax_package(tmp_path, channels):
    rng = np.random.default_rng(channels)
    data = rng.integers(0, 256, (8, 6, 6, channels), dtype=np.uint8)
    for mod, name in ((io, "ours"), (jio, "theirs")):
        mod.save_gen_images(str(tmp_path / name / "gen"), data, np.arange(3, 11))
        mod.save_dataset_images(str(tmp_path / name / "orig"), data.astype(np.float32) / 127.5 - 1)
        written = mod.make_collage(str(tmp_path / name / "orig"), str(tmp_path / name / "col"), 4,
                                   8, 6)
        assert [os.path.basename(w) for w in written] == ["col_collage_0.png", "col_collage_4.png"]
    for sub in ("gen", "orig"):
        _same_image_files(tmp_path / "ours" / sub, tmp_path / "theirs" / sub)
    assert sorted(os.listdir(tmp_path / "ours" / "gen"))[0] == "image_10.png"
    for name in ("col_collage_0.png", "col_collage_4.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ours" / name)),
                                      np.asarray(Image.open(tmp_path / "theirs" / name)))


def test_video_falls_back_to_the_same_gif(tmp_path):
    frames = np.random.default_rng(0).integers(0, 256, (5, 8, 8, 1), dtype=np.uint8)
    ours = io.make_video(frames, str(tmp_path / "ours"), fps=5)
    theirs = jio.make_video(frames, str(tmp_path / "theirs"), fps=5)
    assert os.path.basename(ours) == "ours" + os.path.splitext(theirs)[1]
    a, b = Image.open(ours), Image.open(theirs)
    assert a.n_frames == b.n_frames == 5
    for i in range(5):
        a.seek(i), b.seek(i)
        np.testing.assert_array_equal(np.asarray(a.convert("RGB")), np.asarray(b.convert("RGB")))
    assert io.save_gif(str(tmp_path / "ours"), 5, 16) == ours  # already a GIF
    with pytest.raises(FileNotFoundError):
        io.save_gif(str(tmp_path / "nothing"), 5, 16)
    scaled = io.save_gif_frames(io._normalize_frames(frames), str(tmp_path / "big"), 5, scale=16)
    assert Image.open(scaled).size == (16, 16)


def test_plots_are_written(tmp_path):
    assert plotting.available()
    rng = np.random.default_rng(0)
    plotting.plot_images(rng.integers(0, 256, (3, 8, 8, 1), dtype=np.uint8), str(tmp_path / "a.png"))
    plotting.plot_images(rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8), str(tmp_path / "b.png"))
    plotting.plot_image_panels([rng.uniform(-1, 1, (8, 8, 3)), rng.uniform(-1, 1, (4, 4, 1))],
                               ["big", "small"], str(tmp_path / "c.png"))
    plotting.plot_loss([1.0, 0.5, 0.4], str(tmp_path / "d.png"))
    plotting.plot_filter_and_response(circular_lowpass_kernel(math.pi / 2, 3, 2.0),
                                      str(tmp_path / "e.png"))
    for name in "abcde":
        assert Image.open(tmp_path / f"{name}.png").size[0] > 50


# ---------------------------------------------------------------------------
# ddpm_run and the sweeps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One ``run`` through the CLI's entry point: image 8, 20 steps, 1 epoch."""
    root = str(tmp_path_factory.mktemp("study"))
    args = cli.build_parser().parse_args(
        ["run", *TINY, "--root", root, "--batch-size", "128", "--epochs", "1",
         "--image-gen-per-epoch", "2", "--gen-total", "6", "--gen-per-batch", "4"])
    return root, cli.config_from_args(args), cli.run_ddpm(args)


def test_ddpm_run_writes_every_artifact(run):
    root, config, result = run
    assert list(result) == ["loss_all", "settings_path", "loss_csv", "checkpoint", "gen_dir"]
    assert len(result["loss_all"]) == 1 and math.isfinite(result["loss_all"][0])
    runs = config.runs_dir(root)
    assert result["settings_path"] == os.path.join(runs, "settings_CIFAR10_3.txt")
    assert result["loss_csv"] == os.path.join(runs, "trining_loss_MNIST_3.csv")  # [sic]
    assert "variant: 3" in open(result["settings_path"]).read()
    with open(result["loss_csv"]) as f:
        assert [float(v) for v in next(csv.reader(f))] == result["loss_all"]
    for name in ("filter_jinc2d.png", "filter_circular.png", "filter_circular_kaiser.png",
                 "noising_chain.png", "resample_filtered.png", "resample_plain.png", "loss.png",
                 "samples.png", "denoising.png", "metrics.jsonl"):
        assert os.path.exists(os.path.join(runs, name)), name
    assert os.path.exists(result["checkpoint"] + ".npz")
    assert os.path.exists(os.path.join(config.model_dir(root), "config.json"))
    assert os.path.exists(os.path.join(config.results_dir(root), "0.jpg"))
    assert result["gen_dir"] == os.path.join(root, "images/generated/CIFAR10_3")
    # exactly gen_total images, though the second chunk sampled four
    assert sorted(os.listdir(result["gen_dir"])) == [f"image_{i}.png" for i in range(6)]
    assert Image.open(os.path.join(result["gen_dir"], "image_5.png")).size == (8, 8)
    # collage clamped to what was generated: 6 images, a 2x2 tile
    assert Image.open(result["gen_dir"] + "_collage_0.png").size == (16, 16)
    assert not os.path.exists(os.path.join(root, "images/original"))  # save_training is off


def test_generation_chunk_depends_on_seed_and_start_alone(run):
    root, config, result = run
    model = tasks._load_model_params(config, root, "cpu")
    d = Diffusion(noise_steps=20, img_size=8, device="cpu")
    gen = step_generator(torch.Generator(), config.seed, tasks.GEN_INDEX_BASE + 4)
    x, _ = d.sample(model, n=4, image_channels=3, generator=gen)
    for i in (4, 5):
        saved = np.asarray(Image.open(os.path.join(result["gen_dir"], f"image_{i}.png")))
        np.testing.assert_array_equal(saved, x[i - 4].numpy())


def test_ddpm_run_without_matplotlib_skips_only_the_figures(tmp_path, monkeypatch):
    monkeypatch.setattr(plotting, "available", lambda: False)
    config = TrainConfig(run_name="noplots", variant=0, image_size=8, noise_steps=6, epochs=1,
                         batch_size=256, image_gen_n=0, gen_total=2, gen_per_batch=2,
                         save_training=True, dataset="CIFAR10")
    result = tasks.ddpm_run(config, root=str(tmp_path), device="cpu")
    runs = config.runs_dir(str(tmp_path))
    assert not [f for f in os.listdir(runs) if f.endswith(".png")]
    assert os.path.exists(result["loss_csv"]) and os.path.exists(result["checkpoint"] + ".npz")
    assert len(os.listdir(result["gen_dir"])) == 2
    # save_training exports the whole dataset as the metrics' reference set
    assert len(os.listdir(tmp_path / "images" / "original" / "CIFAR10")) == 512


class _NoiseSpy:
    """Records the initial latent of every sampler call."""

    def __init__(self, monkeypatch):
        self.firsts = []
        plain = Diffusion._noise

        def spy(d, shape, step, generator, noise_fn):
            out = plain(d, shape, step, generator, noise_fn)
            if step == 0:
                self.firsts.append(out.clone())
            return out

        monkeypatch.setattr(Diffusion, "_noise", spy)


def test_rotation_results_reuse_the_noise_across_theta(run, monkeypatch):
    root, config, _ = run
    spy = _NoiseSpy(monkeypatch)
    finals, trajs = tasks.rotation_results(config, [-90.0, 0.0, 90.0], root=root, n=2,
                                           device="cpu")
    assert len(spy.firsts) == 3
    assert torch.equal(spy.firsts[0], spy.firsts[1]) and torch.equal(spy.firsts[0], spy.firsts[2])
    assert [f.shape for f in finals] == [(2, 8, 8, 3)] * 3 and finals[0].dtype == np.uint8
    assert trajs[0].shape == (2, 8, 8, 3)  # 20 steps: no mid snapshot, the final state only
    assert not np.array_equal(finals[0], finals[2])
    # the same call again gives the same sweep
    again, _ = tasks.rotation_results(config, [-90.0, 0.0, 90.0], root=root, n=2, device="cpu")
    for a, b in zip(finals, again):
        np.testing.assert_array_equal(a, b)


def test_shift_results_reuse_the_noise_and_shift_zero_is_the_plain_sample(run, monkeypatch):
    root, config, _ = run
    spy = _NoiseSpy(monkeypatch)
    outs = tasks.shift_results(config, [-2, 0, 2], root=root, n=3, device="cpu")
    assert len(spy.firsts) == 3 and all(torch.equal(spy.firsts[0], f) for f in spy.firsts[1:])
    model = tasks._load_model_params(config, root, "cpu")
    d = Diffusion(noise_steps=20, img_size=8, device="cpu")
    plain, _ = d.sample(model, n=3, image_channels=3,
                        generator=torch.Generator().manual_seed(config.seed))
    np.testing.assert_array_equal(outs[1], plain.numpy())
    assert not np.array_equal(outs[0], outs[2])


def test_rotation_sweep_npz_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    thetas = np.linspace(-45, 45, 3)
    finals = [rng.integers(0, 256, (2, 8, 8, 1), dtype=np.uint8) for _ in thetas]
    trajs = [rng.integers(0, 256, (4, 8, 8, 1), dtype=np.uint8) for _ in thetas]
    path = tasks.save_rotation_sweep(str(tmp_path / "deep" / "sweep"), thetas, finals, trajs)
    assert path.endswith("sweep.npz")
    for loader in (tasks.load_rotation_sweep, jtasks.load_rotation_sweep):
        sweep = loader(path)
        np.testing.assert_array_equal(sweep["thetas"], thetas)
        np.testing.assert_array_equal(sweep["finals"], np.stack(finals))
        np.testing.assert_array_equal(sweep["trajectories"], np.stack(trajs))
    jpath = jtasks.save_rotation_sweep(str(tmp_path / "theirs.npz"), thetas, finals, trajs)
    np.testing.assert_array_equal(tasks.load_rotation_sweep(jpath)["finals"], np.stack(finals))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_new_subcommands_parse_with_the_jax_clis_defaults():
    parse = cli.build_parser().parse_args
    rot = parse(["rotate"])
    assert (rot.thetas, rot.out, rot.fps, rot.save_sweep) == ("-90:90:9", "rotation", 15, None)
    assert (rot.device, rot.variant, rot.noise_steps) == ("cuda", 0, 1000)
    assert (rot.image_channels, rot.compute_dtype) == (1, "float32")
    assert parse(["shift"]).shifts == "-8,0,8"
    assert parse(["sweep"]).variants == "1,2,3"
    ev = parse(["eval", "a", "b", "--limit", "7", "--save", "m.txt"])
    assert (ev.generated_dir, ev.reference_dir, ev.limit, ev.save, ev.device) == (
        "a", "b", 7, "m.txt", "cuda")
    run_args = parse(["run", "--epochs", "3", "--gen-total", "10", "--gen-per-batch", "5"])
    config = cli.config_from_args(run_args)
    assert (config.epochs, config.gen_total, config.gen_per_batch) == (3, 10, 5)
    assert config.run_name == "DDPM_Uncondtional_MNIST_0"
    probe = parse(["probe", "headpack"])
    assert (probe.which, probe.iters, probe.out, probe.small, probe.device) == (
        "headpack", None, None, False, "cuda")
    assert parse(["info"]).cmd == "info"
    with pytest.raises(SystemExit):
        parse(["probe", "sinh"])
    # rotate and shift carry the JAX CLI's train flags with its defaults, and
    # read none of them
    assert rot.epochs == 100 and cli.config_from_args(rot).epochs == 100


def test_rotate_and_shift_subcommands_from_the_runs_checkpoint(run, tmp_path, capsys):
    root, _, _ = run
    sweep = tmp_path / "sweep.npz"
    assert cli.main(["rotate", *TINY, "--root", root, "--thetas=-90:90:3", "--fps", "4",
                     "--out", str(tmp_path / "rot"), "--save-sweep", str(sweep)]) == 0
    out = capsys.readouterr().out
    assert f"wrote sweep {sweep}" in out
    video = out.strip().splitlines()[-1].removeprefix("wrote ")
    assert os.path.exists(video) and os.path.splitext(video)[1] in (".mp4", ".gif")
    loaded = tasks.load_rotation_sweep(str(sweep))
    np.testing.assert_array_equal(loaded["thetas"], [-90.0, 0.0, 90.0])
    assert loaded["finals"].shape == (3, 1, 8, 8, 3)
    grid = tmp_path / "shift.png"
    assert cli.main(["shift", *TINY, "--root", root, "--shifts=-2,0,2", "--out", str(grid)]) == 0
    assert Image.open(grid).size == (2 + 8 * 10, 2 + 2 * 10)  # 12 images, 8 a row


def test_eval_and_info_subcommands(run, tmp_path, capsys):
    root, _, result = run
    io.save_dataset_images(str(tmp_path / "orig"), synthetic_dataset(6, 8, 3, seed=42).images)
    save = tmp_path / "eval.txt"
    assert cli.main(["eval", result["gen_dir"], str(tmp_path / "orig"), "--device", "cpu",
                     "--limit", "5", "--save", str(save)]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed["feature_space"] == "random-conv-v2"
    assert set(printed) == {"feature_space", "inception_score_mean", "inception_score_std",
                            "frechet_inception_distance", "kernel_inception_distance_mean",
                            "kernel_inception_distance_std"}
    assert json.loads(save.with_suffix(".json").read_text()) == printed
    assert cli.main(["info"]) == 0
    info = capsys.readouterr().out
    assert f"torch: {torch.__version__}" in info and "devices:" in info


def test_sweep_subcommand_runs_the_pipeline_per_variant(tmp_path, capsys):
    assert cli.main(["sweep", "--variants", "0,1", "--image-size", "8", "--noise-steps", "4",
                     "--compute-dtype", "float32", "--image-channels", "3", "--device", "cpu",
                     "--root", str(tmp_path), "--batch-size", "256", "--epochs", "1", "--image-gen-per-epoch", "0",
                     "--gen-total", "1", "--gen-per-batch", "1", "--f-kernel", "3"]) == 0
    out = capsys.readouterr().out
    for v in (0, 1):
        assert f"=== sweep: variant {v} -> DDPM_Uncondtional_MNIST_{v} ===" in out
        assert os.path.exists(tmp_path / "models" / f"DDPM_Uncondtional_MNIST_{v}"
                              / f"ckpt_MNIST_{v}.npz")
        assert os.path.exists(tmp_path / "images" / "generated" / f"MNIST_{v}" / "image_0.png")


def test_run_config_matches_the_jax_clis(run):
    _, config, _ = run
    jax_fields = {f.name for f in dataclasses.fields(jconfig.TrainConfig)}
    assert {f.name for f in dataclasses.fields(config)} <= jax_fields
