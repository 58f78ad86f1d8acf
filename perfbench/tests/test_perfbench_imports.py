"""Nothing a cell runs may load JAX or the JAX package: no source under
perfbench/ imports one, and importing every runner and the reference loads
none (top-level module names compared whole)."""

import ast
import os
import subprocess
import sys

from perfbench.lib import config as cfgmod
from perfbench.lib.harness import FORBIDDEN


def _sources():
    for root, _, files in os.walk(cfgmod.ROOT):
        if "_cache" in root:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad


def test_a_cells_modules_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import perfbench.run, perfbench.runners.serve,"
            " perfbench.runners.train_aux, perfbench.runners.train_target,"
            " perfbench.reference.target, perfbench.lib.check,"
            " perfbench.lib.check_train, perfbench.reference.facialmmt,"
            " perfbench.reference.augment;"
            "import facialmmt_tpu_torch.serving,"
            " facialmmt_tpu_torch.train.steps;"
            "from perfbench.lib.harness import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, cfgmod.REPO],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_the_run_time_check_compares_whole_top_level_names(monkeypatch):
    from perfbench.lib import harness

    monkeypatch.setitem(sys.modules, "facialmmt_tpu_torch_probe", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "facialmmt_tpu.probe", sys)
    assert harness.forbidden_modules() == ["facialmmt_tpu"]
