"""The port's entry points on two ranks: ``tasks.ddpm_run(mesh=)`` and the CLI
under torchrun's environment.

Two gloo ranks on the CPU (``tests/_torch_parallel_worker.py``, one spawn for
the module) run:

* the CLI's ``train``, ``run`` and ``sweep`` with torchrun's environment variables set
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; the worker
  starts no process group of its own for them): each returns 0 with the
  process group it started destroyed, and rank 0 alone writes the run;
* ``ddpm_run`` on a ``(2, 1)`` data mesh at a tiny size (Config A, image 8,
  base width 8, 10 noise steps, 512 synthetic images at batch 64): both
  ranks' epoch losses are equal, and a spy on ``open`` and ``os.makedirs``
  finds that rank 0 alone wrote the run's files (settings, figures, loss
  CSV, checkpoint, samples, generated images, collage), while rank 1 wrote
  nothing and returned only its losses.

In this process, a world of one gloo rank with stand-ins for the work: the
CLI destroys the group it started when the work raises, ``run`` ends it
before rank 0's finishing stages, and a group the caller started outlives
the CLI.
"""

import os

import pytest
import torch

import _torch_parallel_worker as worker
from aliasfree_diffusion_models_pytorch_tpu_torch.config import TrainConfig

TINY = ["--device", "cpu", "--image-size", "8", "--base-width", "8", "--batch-size", "64",
        "--epochs", "1", "--noise-steps", "10"]
WORKER_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    roots = {name: str(tmp_path_factory.mktemp(name))
             for name in ("train", "run", "sweep", "ddpm")}
    config = TrainConfig(run_name="mesh_run", epochs=1, batch_size=64, image_size=8,
                         base_width=8, image_channels=1, noise_steps=10, variant=0, seed=0,
                         time_dim=32, gen_total=2, gen_per_batch=2, collage_n=2,
                         collage_n_per_image=2)
    cases = {
        "cli_train": dict(cli=["train", *TINY, "--root", roots["train"]], root=roots["train"],
                          port=worker.free_port()),
        "cli_run": dict(cli=["run", *TINY, "--gen-total", "2", "--gen-per-batch", "2",
                              "--image-gen-per-epoch", "0", "--root", roots["run"]],
                        root=roots["run"], port=worker.free_port()),
        "cli_sweep": dict(cli=["sweep", *TINY, "--variants", "0,3", "--gen-total", "0",
                                "--image-gen-per-epoch", "0", "--root", roots["sweep"]],
                          root=roots["sweep"], port=worker.free_port()),
        "ddpm_run": dict(ddpm_run=True, mesh_shape=(2, 1), config=config, root=roots["ddpm"]),
    }
    out = tmp_path_factory.mktemp("ranks")
    return worker.launch(cases, str(out), timeout=WORKER_TIMEOUT_S), roots, config


@pytest.mark.parametrize("case", ["cli_train", "cli_run", "cli_sweep"])
def test_cli_under_torchrun_destroys_its_process_group(ranks, case):
    results, roots, _ = ranks
    for rank in results:
        assert rank[case]["exit"] == 0
        assert rank[case]["initialized_after"] is False
    assert results[0][case]["files"]  # rank 0 writes the run
    assert results[1][case]["files"] == []


def test_cli_run_under_torchrun_writes_the_run_on_rank0(ranks):
    results, _, _ = ranks
    files = set(results[0]["cli_run"]["files"])
    gen = os.path.join("images", "generated", "MNIST_0")
    assert {os.path.join(gen, "image_0.png"), os.path.join(gen, "image_1.png")} <= files
    assert any(f.endswith(".npz") for f in files)  # the checkpoint
    assert any(os.path.basename(f) == "settings_MNIST_0.txt" for f in files)


def test_cli_sweep_under_torchrun_trains_every_variant_then_writes_on_rank0(ranks):
    results, _, _ = ranks
    files = set(results[0]["cli_sweep"]["files"])
    for variant in (0, 3):
        run = os.path.join("runs", f"DDPM_Uncondtional_MNIST_{variant}")
        assert os.path.join(run, f"trining_loss_MNIST_{variant}.csv") in files
        assert os.path.join("models", f"DDPM_Uncondtional_MNIST_{variant}",
                            f"ckpt_MNIST_{variant}.npz") in files


def test_ddpm_run_on_a_mesh_trains_in_step_on_both_ranks(ranks):
    results, _, _ = ranks
    r0, r1 = results[0]["ddpm_run"], results[1]["ddpm_run"]
    assert len(r0["losses"]) == 1 and torch.isfinite(torch.tensor(r0["losses"])).all()
    assert r1["losses"] == r0["losses"]
    assert r1["keys"] == ["loss_all"]
    assert r0["keys"] == ["checkpoint", "gen_dir", "loss_all", "loss_csv", "settings_path"]


def test_ddpm_run_on_a_mesh_writes_on_rank0_alone(ranks):
    results, roots, config = ranks
    r0, r1 = results[0]["ddpm_run"], results[1]["ddpm_run"]
    assert r1["files"] == [] and r1["dirs"] == []
    written = set(r0["files"])
    runs = os.path.relpath(config.runs_dir(roots["ddpm"]), roots["ddpm"])
    gen = os.path.join("images", "generated", f"{config.dataset}_{config.variant}")
    expect = {os.path.join(runs, f"settings_{config.dataset}_{config.variant}.txt"),
              os.path.join(runs, f"trining_loss_MNIST_{config.variant}.csv"),
              os.path.join(runs, "metrics.jsonl"),
              os.path.relpath(config.checkpoint_path(roots["ddpm"]), roots["ddpm"]) + ".npz",
              os.path.join(gen, "image_0.png"), os.path.join(gen, "image_1.png")}
    assert expect <= written, expect - written
    for path in expect:
        assert os.path.exists(os.path.join(roots["ddpm"], path)), path


# The process group's lifetime in one process (a world of one gloo rank),
# with the work behind the subcommands replaced by stand-ins.
@pytest.fixture
def torchrun_env(monkeypatch):
    for key, value in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(worker.free_port())).items():
        monkeypatch.setenv(key, value)


def test_cli_destroys_its_group_on_an_exception(torchrun_env, monkeypatch):
    from aliasfree_diffusion_models_pytorch_tpu_torch import cli
    from aliasfree_diffusion_models_pytorch_tpu_torch import train as ttrain

    def fail(*args, **kwargs):
        assert torch.distributed.is_initialized()
        raise RuntimeError("step failed")

    monkeypatch.setattr(ttrain, "train", fail)
    with pytest.raises(RuntimeError, match="step failed"):
        cli.main(["train", "--device", "cpu", "--image-size", "8"])
    assert not torch.distributed.is_initialized()


def test_cli_run_ends_its_group_before_rank0_samples(torchrun_env, monkeypatch):
    from aliasfree_diffusion_models_pytorch_tpu_torch import cli, tasks

    seen = {}
    monkeypatch.setattr(tasks, "ddpm_train", lambda config, **kw: seen.setdefault(
        "training", torch.distributed.is_initialized()))
    monkeypatch.setattr(tasks, "ddpm_finish", lambda run: seen.setdefault(
        "finishing", torch.distributed.is_initialized()) and {})
    assert cli.main(["run", "--device", "cpu", "--image-size", "8"]) == 0
    assert seen == {"training": True, "finishing": False}


def test_cli_leaves_a_group_it_did_not_start(monkeypatch):
    from aliasfree_diffusion_models_pytorch_tpu_torch import cli
    from aliasfree_diffusion_models_pytorch_tpu_torch import train as ttrain
    from aliasfree_diffusion_models_pytorch_tpu_torch.parallel.multihost import init_distributed

    monkeypatch.setattr(ttrain, "train", lambda *args, **kwargs: [1.0])
    init_distributed(f"tcp://localhost:{worker.free_port()}", 1, 0, backend="gloo")
    try:
        assert cli.main(["train", "--device", "cpu", "--image-size", "8"]) == 0
        assert torch.distributed.is_initialized()
    finally:
        torch.distributed.destroy_process_group()
