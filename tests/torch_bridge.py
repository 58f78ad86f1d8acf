"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

The port keeps its own configuration classes (facialmmt_tpu_torch/config.py)
and imports nothing of the JAX package, so a parity test states ONE config,
the JAX one, and builds the port's from it here.
"""

import dataclasses
import typing

from facialmmt_tpu_torch import config as port_config_module


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
    dataclasses.asdict() of a JAX-package config (fields the port does not
    have, the TPU kernel selectors, are dropped)."""
    cls = getattr(port_config_module, type(jax_cfg).__name__)
    return _build(cls, dataclasses.asdict(jax_cfg))
