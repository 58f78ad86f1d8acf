"""Configurations and workloads, found by name.

A configuration is `configs/<name>.json`: `model` names the reference
module, `config` holds the program's configuration tree (field names of the
program's FacialMMTConfig, nested groups as objects), beside the source and
what was assumed.  A cell's traffic mix is `workloads/<traffic>.json`, by
the `traffic` name of its entry; its `runner` names the module of
`runners/` that drives it."""

from __future__ import annotations

import dataclasses
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ROOT)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(repo: str = REPO) -> dict:
    return load_json(os.path.join(repo, "BENCHMARK.json"))


def workload_entry(name: str, repo: str = REPO) -> dict:
    for w in benchmark(repo)["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(name: str, repo: str = REPO) -> dict:
    for c in benchmark(repo)["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def config_file(name: str, repo: str = REPO) -> dict:
    return load_json(os.path.join(repo, config_entry(name, repo)["file"]))


def traffic_file(name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "workloads", name + ".json"))


def program_config(tree: dict):
    """The program's FacialMMTConfig from a configuration's `config` tree:
    every field the tree names is set, the rest keep their defaults."""
    from facialmmt_tpu_torch.config import FacialMMTConfig

    return _fill(FacialMMTConfig, tree)


def _fill(cls, tree):
    kw = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in tree.items():
        if key not in fields:
            raise KeyError(f"{cls.__name__} has no field {key!r}")
        default = fields[key].default_factory \
            if fields[key].default_factory is not dataclasses.MISSING else None
        sub = default() if default is not None else None
        if isinstance(value, dict) and dataclasses.is_dataclass(sub):
            kw[key] = _fill(type(sub), value)
        elif isinstance(value, list):
            kw[key] = tuple(value)
        else:
            kw[key] = value
    return cls(**kw)
