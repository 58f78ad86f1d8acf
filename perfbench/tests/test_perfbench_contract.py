"""BENCHMARK.json keeps to the benchmark's contract, and every cell, metric
and kernel count is found by its name, so that a later change adds one as
new files only."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench.lib import config as cfgmod
from perfbench.lib import harness

REPO = cfgmod.REPO
BENCH = cfgmod.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry["name"]
    for w in BENCH["workloads"]:
        yield "config", w["config"]
        yield "traffic", w["traffic"]
    for c in BENCH["configs"]:
        for key in c["reduced"]:
            yield "reduced", key


@pytest.mark.parametrize("group,name", list(_names()))
def test_names_use_only_the_allowed_characters(group, name):
    assert NAME.match(name), (group, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source"}
    if "bound" in metric:
        keys |= {"bound"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        keys |= {"layer", "moves", "workloads"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["workloads"], "a per-layer metric lists its cells"
        assert "\n" not in metric["layer"] and "\t" not in metric["layer"]
    assert set(metric) | {"workloads"} == keys | {"workloads"}
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    cells = {w["name"] for w in BENCH["workloads"]}
    assert len(cells) == len(BENCH["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(cells)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files_by_name(cell):
    entry = cfgmod.workload_entry(cell)
    tree = cfgmod.config_file(entry["config"])
    assert tree["config"] and tree["model"] in ("facialmmt", "swin_fer")
    assert cfgmod.config_entry(entry["config"])["file"].startswith(
        "perfbench/configs/")
    spec = cfgmod.traffic_file(entry["traffic"])
    assert os.path.isfile(os.path.join(cfgmod.ROOT, "runners",
                                       spec["runner"] + ".py"))
    reports = {m["name"] for m in BENCH["end_to_end"]
               if cell in m.get("workloads", [cell])}
    assert "setup_s" in reports and len(reports) >= 2
    layer = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
    assert layer
    for m in layer:
        assert m["moves"] in reports
        path = os.path.join(cfgmod.ROOT, "metrics", m["name"] + ".py")
        assert callable(harness.load_file(path, "m_" + m["name"]
                                          .replace(".", "_")).read)


def test_kernel_counts_are_found_by_name():
    models = harness.kernel_models(cfgmod.ROOT)
    assert {"fused_attention", "fused_attention_block",
            "fused_ln_mlp_residual"} <= set(models)
    for mod in models.values():
        assert mod.DEVICE_KERNELS and mod.COUNTERS


def test_a_new_cell_metric_and_kernel_are_new_files_only(tmp_path):
    """In a copy of the benchmark: a new traffic file, a new metric reader
    and a new kernel count, with entries added to BENCHMARK.json, are
    found without editing any file that was there."""
    repo = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "perfbench"), repo / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = {p: open(p, "rb").read() for p in
              map(str, (repo / "perfbench").rglob("*.py"))}
    bench = json.loads(json.dumps(BENCH))
    spec = cfgmod.traffic_file("serve_tav_poisson")
    spec["rate_utt_per_s"] = 50.0
    (repo / "perfbench/workloads/serve_tav_light.json").write_text(
        json.dumps(spec))
    (repo / "perfbench/metrics/queue_fill.serve_light.py").write_text(
        "def read(r):\n    return 1.0\n")
    (repo / "perfbench/kernels/shift_permute.py").write_text(
        "DEVICE_KERNELS = ('shift_permute_kernel',)\n"
        "COUNTERS = ('shift_permute',)\nMARKER = None\n\n\n"
        "def launches(c, step):\n    return []\n")
    bench["workloads"].append({"name": "serve_tav_light",
                               "config": "facialmmt_tav_roberta_large",
                               "traffic": "serve_tav_light", "chips": 1,
                               "why": "light load"})
    bench["end_to_end"][0]["workloads"].append("serve_tav_light")
    bench["per_layer"].append({"name": "queue_fill.serve_light",
                               "unit": "requests", "better": "higher",
                               "source": "program_counter",
                               "layer": "front end",
                               "moves": "serve_p95_ms",
                               "workloads": ["serve_tav_light"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, argparse; sys.path.insert(0, sys.argv[1]);"
        "from perfbench.lib import harness;"
        "a = argparse.Namespace(workload='serve_tav_light', seed=1,"
        " seconds=1, trace=1);"
        "c = harness.Context(a, 0.0, None, sys.argv[1]);"
        "print(c.traffic['rate_utt_per_s'], [m['name'] for m in"
        " c.per_layer()], sorted(harness.kernel_models(c.root)))")
    out = subprocess.run([sys.executable, "-c", code, str(repo)],
                         capture_output=True, text=True, check=True).stdout
    assert out.startswith("50.0") and "queue_fill.serve_light" in out
    assert "shift_permute" in out
    assert all(open(p, "rb").read() == b for p, b in before.items())
