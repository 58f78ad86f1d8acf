"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

The port keeps its own configuration classes (facialmmt_tpu_torch/config.py)
and imports nothing of the JAX package, so a parity test states ONE config,
the JAX one, and builds the port's from it here.
"""

import dataclasses
import typing

import torch

from facialmmt_tpu_torch import config as port_config_module

# One intra-op thread for the port's tests: every pytest-xdist worker imports
# this module when it collects the test_torch_* files, and the workers share
# the machine's cores, where torch's default of one thread per core in each
# worker oversubscribes them several times over.
torch.set_num_threads(1)


def _build(cls, values: dict):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        if dataclasses.is_dataclass(hints[f.name]):
            v = _build(hints[f.name], v)
        kwargs[f.name] = v
    return cls(**kwargs)


def port_config(jax_cfg):
    """The port's config object of the same class name, from
    dataclasses.asdict() of a JAX-package config.  Every field the port has
    is carried across, SwinConfig's attention_impl / mlp_impl / merge_impl
    included; the few it lacks (the PRNG implementation, the
    `fused_attention` switches of the encoder, crossmodal and text stacks,
    RuntimeConfig.debug_nans, which neither command line sets: both act on
    the flag) are dropped."""
    cls = getattr(port_config_module, type(jax_cfg).__name__)
    return _build(cls, dataclasses.asdict(jax_cfg))
