"""The dialogue cell's files at tiny widths for the CPU tests: its
configuration with a 2-layer BERT tower at 64 (TextEncoderConfig.tiny
("bert")), encoders and stacks at 32, and its traffic at 2 dialogues of 5
slots from a pool of 6, run on the CPU through the same runner."""

from __future__ import annotations

import copy
import dataclasses

from perfbench.lib import config as cfgmod

CELL = "train_m3ed_dia"


def tiny_tree():
    from facialmmt_tpu_torch.config import TextEncoderConfig

    tree = copy.deepcopy(cfgmod.config_file(
        cfgmod.workload_entry(CELL)["config"])["config"])
    tree.update(hidden_size=32, audio_utt_transformer_num=2,
                vision_utt_transformer_num=1)
    tree["encoder"].update(hidden_size=32, num_attention_heads=4,
                           intermediate_size=64)
    for key in ("crossmodal_ta", "crossmodal_ta_v"):
        tree[key].update(embed_dim=32, num_heads=4)
    tree["text"] = dataclasses.asdict(TextEncoderConfig.tiny("bert"))
    tree["data"].update(max_seq_length=48, text_utt_max_len=10,
                        audio_utt_max_len=6, vision_utt_max_len=4,
                        audio_feat_dim=12, vision_feat_dim=8)
    return tree


def tiny_traffic():
    spec = copy.deepcopy(cfgmod.traffic_file(CELL))
    spec.update(dialogues=2, slots=5, pool_dialogues=6, epoch_dialogues=40,
                trace={"first_step": 3, "steps": 2})
    s = spec["sizes"]
    s["utts_per_dialogue"].update(scale=3.0, max=5)
    s["tokens_per_utt"].update(scale=3.0, max=8)
    s["audio_frames"].update(scale=2.0, max=6)
    s["vision_rows"].update(scale=2.0, max=4)
    return spec


def patch(monkeypatch, traffic=None):
    """Point the harness at the tiny files of the dialogue cell."""
    tree, spec = tiny_tree(), traffic or tiny_traffic()
    real = cfgmod.config_file
    monkeypatch.setattr(cfgmod, "config_file",
                        lambda name, repo=cfgmod.REPO: dict(
                            real(name, repo), config=tree))
    monkeypatch.setattr(cfgmod, "traffic_file",
                        lambda name, root=cfgmod.ROOT: spec)
    return tree, spec
