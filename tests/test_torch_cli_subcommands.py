"""The port's CLI takes every command line the JAX CLI takes.

For each subcommand of the JAX CLI, the port's subparser has every flag and
positional of the JAX one, with the JAX default. The port's own additions are
named here and nowhere else: ``--device`` and ``--lr-total-steps`` where they
apply, ``sample``'s ``--theta`` and ``--random-weights``, ``shift``'s
``--out``, and the ``probe`` subcommand. The JAX CLI builds its parser inside
``main``; the test takes it from there by stopping ``main`` at its
``parse_args``, before anything runs.
"""

import argparse

import pytest

from aliasfree_diffusion_models_pytorch_tpu import cli as jcli
from aliasfree_diffusion_models_pytorch_tpu_torch import cli

PORT_ONLY_EVERYWHERE = {"--device", "--lr-total-steps"}
PORT_ONLY = {"sample": {"--theta", "--random-weights"}, "shift": {"--out"}}
PORT_ONLY_SUBCOMMANDS = {"probe"}


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    def stop(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as caught:
        jcli.main([])
    return caught.value.args[0]


def _subparsers(parser: argparse.ArgumentParser) -> dict:
    (action,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return dict(action.choices)


def _arguments(parser: argparse.ArgumentParser) -> dict:
    """{option string or positional dest: default} of every argument."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        for name in action.option_strings or [action.dest]:
            out[name] = action.default
    return out


@pytest.fixture(scope="module")
def jax_subparsers():
    mp = pytest.MonkeyPatch()
    try:
        return _subparsers(_jax_parser(mp))
    finally:
        mp.undo()


def test_every_jax_subcommand_exists_in_the_port(jax_subparsers):
    port = _subparsers(cli.build_parser())
    assert set(port) - set(jax_subparsers) == PORT_ONLY_SUBCOMMANDS
    assert set(jax_subparsers) <= set(port)


@pytest.mark.parametrize("name", ["run", "train", "sample", "rotate", "shift", "eval", "info",
                                  "summary", "sweep", "reproduce-grid"])
def test_subcommand_has_every_jax_flag_with_its_default(jax_subparsers, name):
    jax_args = _arguments(jax_subparsers[name])
    port_args = _arguments(_subparsers(cli.build_parser())[name])
    missing = set(jax_args) - set(port_args)
    assert not missing, f"{name}: the port refuses {sorted(missing)}"
    differ = {k: (port_args[k], v) for k, v in jax_args.items() if port_args[k] != v}
    assert differ == {}, f"{name}: defaults (port, jax) differ: {differ}"
    extra = set(port_args) - set(jax_args)
    assert extra <= PORT_ONLY_EVERYWHERE | PORT_ONLY.get(name, set()), (name, extra)


@pytest.mark.parametrize("argv", [
    ["sample", "--batch-size", "16", "--n", "2"],
    ["rotate", "--epochs", "3", "--lr", "1e-3", "--thetas=-90:90:3"],
    ["shift", "--gen-total", "8", "--dataset-path", "x.csv"],
    ["summary", "--batch-size", "16", "--grad-accum", "2", "--variant", "3"],
])
def test_jax_command_lines_parse_in_the_port(argv):
    args = cli.build_parser().parse_args(argv)
    # the JAX package parses the same command line
    assert args.cmd == argv[0]
    config = cli.config_from_args(args)
    # the training flags reach the config as in the JAX CLI, which these
    # subcommands do not read otherwise
    if "--batch-size" in argv:
        assert config.batch_size == 16


def test_info_reports_the_default_mesh(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert "default mesh: shape={'data': 1}" in out
