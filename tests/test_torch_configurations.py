"""Configurations of the JAX command line that the other CPU suites run on
another setting: M3ED's own text tower, chinese-roberta-large (a BERT
architecture: type vocabulary 2, pad id 0, LayerNorm eps 1e-12, no position
offset), through the port's command line at --text_preset tiny, on
tests/fixtures.py's files.

The --doEval command evaluates weights that the JAX package's module made
(drawn from a numpy seed, carried over by checkpoint/from_jax.py into the
port's best file); its logits are held against the JAX module's forward on
the JAX package's dataset of the same files (fp32 on both sides, atol 1e-4,
as tests/test_torch_appendix_cli.py), its macro-F1 equals the port's API
call exactly and a second run gives the same bits.
"""

import os
import shutil

import jax
import numpy as np
import torch

import facialmmt_tpu_torch.main as port_main
from facialmmt_tpu_torch.checkpoint import from_jax
from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
from facialmmt_tpu_torch.config import resolve_text_config
from tests.test_torch_appendix_cli import (LOGIT_TOL, _argv, _jax_setup,
                                           _record, root)  # noqa: F401
from tests.test_torch_ops import random_params

PLM = "chinese-roberta-large"


def test_cli_chinese_roberta_large_t_doeval_equals_jax(root, tmp_path,  # noqa: F811
                                                       monkeypatch, rng):
    from facialmmt_tpu_torch.data.m3ed import M3edTextDataset
    from facialmmt_tpu_torch.train.trainer import TextTrainer

    data = root / "data" / "T"
    for split in ("train", "val", "test"):   # the BERT-style M3ED caches
        shutil.copy(data / f"text_{split}_roberta-large_m3ed.npz",
                    data / f"text_{split}_{PLM}_m3ed.npz")
    save = tmp_path / "saved"
    os.makedirs(save)
    argv = _argv(root, save, "--doEval", "1", "--choice_modality", "T",
                 "--plm_name", PLM)
    jcfg, jmodel, jds = _jax_setup(root, argv, dia=False)
    cfg = port_main.config_from_args(port_main.build_argparser()
                                     .parse_args(argv))
    tower = resolve_text_config(cfg)
    full = resolve_text_config(port_main.config_from_args(
        port_main.build_argparser().parse_args(["--plm_name", PLM])))
    assert (jcfg.plm_name, cfg.plm_name) == (PLM, PLM)
    assert (tower.model_type, tower.type_vocab_size,
            tower.pad_token_id) == ("bert", 2, 0)
    assert (full.model_type, full.vocab_size, full.num_layers,
            full.layer_norm_eps) == ("bert", 21128, 24, 1e-12)
    batch = jds.get_batch(list(range(len(jds))))
    args = [batch[k] for k in ("dia_input_ids", "dia_input_mask",
                               "dia_sep_mask")]
    kw = {k: batch[k] for k in ("utt_in_dia_idx", "dia_idx") if k in batch}
    variables = random_params(jmodel, rng, *args, **kw)
    sd = from_jax.multimodal_state_dict(variables, PLM)
    types = [np.asarray(v) for k, v in sd.items()
             if k.endswith("token_type_embeddings.weight")]
    assert len(types) == 1 and types[0].shape[0] == 2    # BERT's two types
    CheckpointManager(str(save)).save_best(
        {k: torch.tensor(np.asarray(a)) for k, a in sd.items()}, 1)
    want = np.asarray(jax.jit(jmodel.apply)(variables, *args, **kw))
    got = []
    _record(monkeypatch, TextTrainer, got)
    f1 = port_main.run(argv)
    f1_again = port_main.run(argv)
    assert len(got) == 2 and got[0].shape == want.shape == (9, 7)
    np.testing.assert_allclose(got[0], want, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(got[1], got[0])
    api = TextTrainer(cfg, device="cpu").eval_text_only(
        M3edTextDataset(*port_main.m3ed_text_arrays(cfg, "", "test")),
        ckpt_dir=str(save))
    assert api == f1 == f1_again and 0.0 <= f1 <= 1.0


def test_chip_smoke_phase16_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 16 end to end on the CPU at tiny() widths, the
    card's checks stubbed (launch counts, the fp32 pack's bound, the device
    synchronisations) and the kernel rows left out (they need the card):
    every path of (a), (c) and the float32 model runs, with finite losses
    and reruns bit for bit where the phase holds them."""
    import dataclasses

    from facialmmt_tpu_torch.config import FacialMMTConfig
    from tests.test_torch_cli import SMALL, _small_swin

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    tiny = FacialMMTConfig.tiny()
    real = port_main.config_from_args
    monkeypatch.setattr(port_main, "config_from_args",
                        lambda args: _small_swin(real(args), tiny))
    noop = lambda *a, **k: None
    for name in ("require_counts", "require_launched", "expect_text_kernel",
                 "hold_fp32_pack", "hold_fp32_route"):
        monkeypatch.setattr(chip_smoke, name, noop)
    monkeypatch.setattr(chip_smoke, "AUX_IMAGES", 8)
    monkeypatch.setattr(torch.cuda, "synchronize", noop)
    monkeypatch.setattr(torch.cuda, "empty_cache", noop)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    cfg = tiny.replace(runtime=dataclasses.replace(tiny.runtime, seed=0))
    paths, rows = chip_smoke.phase_configurations(
        torch, torch.device("cpu"), "cpu", str(tmp_path), cfg=cfg,
        extra=(*SMALL, "--device", "cpu"), kernel_rows=False)
    assert rows == {}
    assert sorted(paths) == sorted(
        f"configurations_{k}" for k in (
            "drop_eval", "drop_aux", "fp32_pack", "fp32_pack_pallas",
            "fp32_pack_pair", "fp32_aux", "fp32_aux_pallas", "fp32_target",
            "bert_meld_eval", "bert_meld_train", "m3ed_t_train",
            "m3ed_t_eval", "m3ed_dia_train", "m3ed_dia_eval"))
    assert not any(any(p.values()) for p in paths.values())   # CPU: plain
