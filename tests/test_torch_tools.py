"""The port's offline tools (facialmmt_tpu_torch/tools.py, utils/flops.py,
ops/swin.py::swin_flops) against the JAX package's on the CPU.

The FLOPs counts are integers and must equal JAX's; `print-flops` prints
JAX's lines.  `doctor` runs as a subprocess.  The checkpoint tools run on
tiny() trees drawn from a numpy seed (the tools' config is monkeypatched to
tiny(), the JAX converter handed the same config): a reference-layout `.pt`
written by JAX's torch_export goes through JAX's torch_convert and through
the port's convert-checkpoint, and the port's file equals
checkpoint/from_jax.py of the JAX result tensor for tensor (for `unimodal`,
for which from_jax has no function, JAX's export of it: the port's names
are the reference's); the port's export-checkpoint of a port checkpoint
holding the same tree equals JAX's torch_export, key for key and bit for
bit.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import facialmmt_tpu.checkpoint.torch_convert as jax_convert
import facialmmt_tpu.checkpoint.torch_export as jax_export
import facialmmt_tpu.ops.swin as jax_swin
import facialmmt_tpu.tools as jax_tools
import facialmmt_tpu.utils.flops as jax_flops
import facialmmt_tpu_torch.ops.swin as port_swin
import facialmmt_tpu_torch.tools as port_tools
import facialmmt_tpu_torch.utils.flops as port_flops
from facialmmt_tpu.config import FacialMMTConfig as JaxConfig
from facialmmt_tpu.models.pipeline import FacialMMTPipeline as JaxPipeline
from facialmmt_tpu.models.unimodal import MeldUttTransformer as JaxUnimodal
from facialmmt_tpu_torch.checkpoint import from_jax
from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
from tests.test_models import make_multimodal_batch
from tests.test_torch_ops import random_params
from tests.torch_bridge import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------- FLOPs --

def _cfg(name):
    return JaxConfig() if name == "default" else JaxConfig.tiny()


@pytest.mark.parametrize("cfg_name, batch_utts, unique_dias, faces", [
    ("default", 128, 16, 512),      # tests/test_metrics.py's cases
    ("default", 128, 16, 513),
    ("default", 128, 32, 512),
    ("default", 129, 16, 512),
    ("default", 8, 1, 64),          # a serving pack of the (8, 64) bucket
    ("tiny", 3, 2, 12),
])
def test_flops_equal_jax(cfg_name, batch_utts, unique_dias, faces):
    jcfg = _cfg(cfg_name)
    pcfg = port_config(jcfg)
    assert port_swin.swin_flops(pcfg.swin) == jax_swin.swin_flops(jcfg.swin)
    got = port_flops.eval_step_macs(pcfg, batch_utts, unique_dias, faces)
    want = jax_flops.eval_step_macs(jcfg, batch_utts, unique_dias, faces)
    assert type(got) is int and got == want
    d, t = jcfg.hidden_size, jcfg.text
    for args in ((t.num_layers, jcfg.data.max_seq_length, t.hidden_size,
                  t.intermediate_size), (2, faces, d, 4 * d)):
        assert (port_flops.transformer_encoder_macs(*args)
                == jax_flops.transformer_encoder_macs(*args))
    for args in ((2, 38, 157, d), (2, 195, 32, d), (1, batch_utts, 7, 5)):
        assert (port_flops.crossmodal_macs(*args)
                == jax_flops.crossmodal_macs(*args))


@pytest.mark.parametrize("argv", [[], ["--batch", "32", "--faces_per_utt",
                                       "12"]])
def test_print_flops_prints_jax_lines(argv, capsys):
    jax_tools.main(["print-flops", *argv])
    want = capsys.readouterr().out
    port_tools.main(["print-flops", *argv])
    assert capsys.readouterr().out == want
    assert want.count("\n") == 2


# ------------------------------------------------------------------ doctor --

def _doctor(*argv):
    return subprocess.run([sys.executable, "-m", "facialmmt_tpu_torch.tools",
                           "doctor", *argv], cwd=REPO, capture_output=True,
                          text=True, timeout=120)


def test_doctor_on_the_cpu():
    proc = _doctor("--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = {line.split(":")[0].strip(): line
             for line in proc.stdout.splitlines()[1:]}
    assert "cpu" in lines["device"]
    assert "OK" in lines["matmul readback"]
    assert "not built" in lines["kernels"]
    assert {"native face loader", "transformers", "cv2", "yaml",
            "sklearn"} <= set(lines)
    assert "jax" not in proc.stdout


def test_doctor_without_a_card_exits_3():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    proc = _doctor()
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "no CUDA device" in proc.stdout


# ------------------------------------------------------------- checkpoints --

@pytest.fixture(scope="module")
def trees():
    """tiny() JAX trees from one numpy draw: the pipeline's variables and
    the V-only model's."""
    cfg = JaxConfig.tiny()
    rng = np.random.default_rng(4)
    batch = make_multimodal_batch(rng, cfg, b=2)
    pipe = jax.tree.map(np.asarray,
                        random_params(JaxPipeline(cfg), rng, batch))
    d = cfg.data
    feats = np.zeros((2, d.vision_utt_max_len, d.vision_feat_dim), np.float32)
    mask = np.ones((2, d.vision_utt_max_len), np.int32)
    uni = jax.tree.map(np.asarray, random_params(JaxUnimodal(cfg), rng,
                                                 feats, mask))
    swin = {"params": pipe["params"]["swin_model"],
            "batch_stats": pipe["batch_stats"]["swin_model"]}
    return {"cfg": cfg, "unimodal": {"params": uni["params"]},
            "multimodal": {"params": pipe["params"]["multimodal"]},
            "swin": swin, "pipeline": pipe}


@pytest.fixture
def tiny_tools(monkeypatch, trees):
    """The port's tools check against tiny(), as the JAX converter is told."""
    pcfg = port_config(trees["cfg"])
    monkeypatch.setattr(port_tools, "config_for",
                        lambda plm_name: pcfg.replace(plm_name=plm_name))


def _reference_file(kind, trees):
    """The reference-layout state_dict of `kind`, as JAX's torch_export
    writes it (for swin_backbone: the Ms-Celeb-1M file's `backbone.*` keys
    beside a classifier head that the converters skip)."""
    if kind == "unimodal":
        return jax_export.export_unimodal(trees["unimodal"])
    if kind == "multimodal":
        return jax_export.export_multimodal(trees["multimodal"])
    sd = jax_export.export_swin_fer(trees["swin"])
    if kind == "swin":
        return sd
    out = {"backbone." + k[len("swin."):]: v for k, v in sd.items()
           if k.startswith("swin.")}
    out.update({"head.weight": np.ones((3, 4), np.float32),
                "head.bias": np.zeros(3, np.float32)})
    return out


def _port_of_jax(kind, result, trees):
    """from_jax.py's state_dict of a JAX converter result."""
    if kind == "unimodal":
        return jax_export.export_unimodal(result)
    if kind == "multimodal":
        return from_jax.multimodal_state_dict(result)
    if kind == "swin":
        return from_jax.swin_fer_state_dict(result)
    # swin_backbone: the backbone under swin_fer_state_dict's 'swin.' names
    params = dict(trees["swin"]["params"], swin=result["params"]["swin"])
    sd = from_jax.swin_fer_state_dict(
        {"params": params, "batch_stats": result["batch_stats"]})
    return {k[len("swin."):]: v for k, v in sd.items()
            if k.startswith("swin.")}


def _hold(got, want):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        value = np.asarray(value)
        g = got[name].numpy()
        assert g.shape == value.shape, name
        np.testing.assert_array_equal(g, value, err_msg=name)


@pytest.mark.parametrize("kind", ["unimodal", "multimodal", "swin",
                                  "swin_backbone"])
def test_convert_checkpoint_equals_jax(kind, trees, tiny_tools, tmp_path,
                                       capsys):
    cfg = trees["cfg"]
    pt = str(tmp_path / f"{kind}.pt")
    jax_export.save_state_dict_pt(_reference_file(kind, trees), pt)
    sd = jax_convert.load_torch_state_dict(pt)
    result = {"unimodal": lambda: jax_convert.convert_unimodal(sd, cfg),
              "multimodal": lambda: jax_convert.convert_multimodal(
                  sd, cfg, cfg.text),
              "swin": lambda: jax_convert.convert_swin_fer(sd, cfg),
              "swin_backbone": lambda:
                  jax_convert.convert_pretrained_swin_backbone(sd, cfg),
              }[kind]()
    port_tools.main(["convert-checkpoint", "--kind", kind, "--input", pt,
                     "--output", str(tmp_path / "ckpt" / kind)])
    assert f"({kind}," in capsys.readouterr().out
    got = CheckpointManager(str(tmp_path / "ckpt")).restore(kind)
    _hold(got, _port_of_jax(kind, jax.tree.map(np.asarray, result), trees))


def test_convert_checkpoint_strict_load_raises(trees, tiny_tools, tmp_path):
    """A tensor missing from the file fails the strict load, naming it."""
    ref = jax_export.export_swin_fer(trees["swin"])
    ref.pop("classifier.bias")
    pt = str(tmp_path / "swin.pt")
    jax_export.save_state_dict_pt(ref, pt)
    with pytest.raises(RuntimeError, match="classifier.bias"):
        port_tools.main(["convert-checkpoint", "--kind", "swin", "--input",
                         pt, "--output", str(tmp_path / "ckpt" / "swin")])


@pytest.mark.parametrize("kind", ["unimodal", "multimodal", "swin",
                                  "pipeline"])
def test_export_checkpoint_equals_jax(kind, trees, tiny_tools, tmp_path):
    tree = trees[kind]
    port_sd = {"unimodal": lambda: jax_export.export_unimodal(tree),
               "multimodal": lambda: from_jax.multimodal_state_dict(tree),
               "swin": lambda: from_jax.swin_fer_state_dict(tree),
               "pipeline": lambda: from_jax.pipeline_state_dict(tree)}[kind]()
    CheckpointManager(str(tmp_path / "saved")).save(
        "best_1", {k: torch.from_numpy(np.asarray(v))
                   for k, v in port_sd.items()})
    out = str(tmp_path / "export.pt")
    port_tools.main(["export-checkpoint", "--kind", kind, "--input",
                     str(tmp_path / "saved" / "best_1"), "--output", out])
    if kind == "pipeline":
        pairs = [(out[:-3] + "_multimodal.pt", jax_export.export_multimodal(
                     {"params": tree["params"]["multimodal"]})),
                 (out[:-3] + "_swin.pt", jax_export.export_swin_fer(
                     {"params": tree["params"]["swin_model"],
                      "batch_stats": tree["batch_stats"]["swin_model"]}))]
    else:
        want = {"unimodal": jax_export.export_unimodal,
                "multimodal": jax_export.export_multimodal,
                "swin": jax_export.export_swin_fer}[kind](tree)
        pairs = [(out, want)]
    for path, want in pairs:
        _hold(torch.load(path, weights_only=True), want)
