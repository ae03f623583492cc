"""The port's CLI takes the JAX CLI's defaults: the same command line trains
and samples the same model in both packages."""

import argparse

from aliasfree_diffusion_models_pytorch_tpu import cli as jcli
from aliasfree_diffusion_models_pytorch_tpu_torch import cli

# The port's own flags, which the JAX CLI does not have.
PORT_ONLY = {"device", "lr_total_steps"}


def _defaults(*adders):
    parser = argparse.ArgumentParser()
    for add in adders:
        add(parser)
    return vars(parser.parse_args([]))


def test_every_shared_flag_has_the_jax_default():
    jax = _defaults(jcli._add_common)
    port = _defaults(cli._add_common, cli._add_train)
    assert set(port) - set(jax) == PORT_ONLY
    differ = {k: (port[k], jax[k]) for k in set(port) & set(jax) if port[k] != jax[k]}
    assert differ == {}
    assert (port["variant"], port["image_channels"], port["compute_dtype"]) == (0, 1, "float32")


def test_subcommands_build_the_jax_default_model():
    config = cli.config_from_args(cli.build_parser().parse_args(["train"]))
    assert (config.variant, config.image_channels, config.compute_dtype) == (0, 1, "float32")
    assert config.filters is None and config.run_name == "DDPM_Uncondtional_MNIST_0"
