"""Tiny configurations and traffic for the CPU tests: the cells' files with
the program's FacialMMTConfig.tiny() widths, short pools and small
samples, run on the CPU through the same runners."""

from __future__ import annotations

import copy
import dataclasses

from perfbench.lib import config as cfgmod


def _lists(o):
    if isinstance(o, dict):
        return {k: _lists(v) for k, v in o.items()}
    if isinstance(o, tuple):
        return list(o)
    return o


def tiny_tree():
    from facialmmt_tpu_torch.config import FacialMMTConfig

    c = _lists(dataclasses.asdict(FacialMMTConfig.tiny()))
    for k in ("load_unimodal_path", "load_multimodal_path", "load_swin_path",
              "pretrained_backbone_path", "pretrained_text_model_path",
              "parallel", "do_eval"):
        c.pop(k)
    for k in ("load_anno_csv_path", "meld_text_path", "data_load_path",
              "data_folder", "anno_folder", "data_list_train"):
        c["data"].pop(k)
    c["runtime"] = {"compute_dtype": "bfloat16", "param_dtype": "float32",
                    "deterministic_gumbel": False}
    return c


def tiny_traffic(name):
    spec = copy.deepcopy(cfgmod.traffic_file(name))
    if spec["runner"] == "serve":
        r = spec["requests"]
        r["cycle"] = 64
        r["tokens_per_utt"] = {"dist": "exponential", "min": 2,
                               "scale": 2.0, "max": 6}
        r["utts_per_dialogue"] = {"dist": "poisson", "min": 1, "mean": 3.0,
                                  "max": 6}
        r["audio_frames"] = {"dist": "exponential", "min": 2, "scale": 3.0,
                             "max": 12}
        r["faces"] = {"dist": "exponential", "min": 0, "scale": 2.0,
                      "max": 6}
        r["pool"] = {"tokens": 4096, "audio_rows": 256, "vision_rows": 64,
                     "faces": 64}
        spec["buckets"] = [[1, 6], [4, 12]]
        spec["check"]["sample"] = 6
        # the server computes in bf16 on the CPU too; at these widths its
        # gaps read up to about 0.07, an altered answer's about 0.9
        spec["check"]["limits"] = {"answer_gap": 0.3,
                                   "answer_gap_median": 0.3, "fer_gap": 0.3}
        if "rate_utt_per_s" in spec:
            spec["rate_utt_per_s"] = 20.0
        if "clients" in spec:
            spec["clients"] = 8
            spec["max_rate_utt_per_s"] = 100.0
        spec["trace"] = {"start_s": 0.3, "length_s": 0.5}
    elif spec["runner"] == "train_target":
        spec.update(utts=8, dialogues=2, pool_utts=64, pool_dialogues=16,
                    trace={"first_step": 1, "steps": 2})
        spec["requests"] = tiny_traffic("serve_tav_poisson")["requests"]
    elif spec["runner"] == "train_aux":
        spec.update(frames=60, frame_px=16, batch=6,
                    trace={"first_step": 1, "steps": 2})
    return spec


def patch(monkeypatch, workload, traffic=None):
    """Point the harness at the tiny files of `workload`."""
    tree = tiny_tree()
    spec = traffic or tiny_traffic(workload)
    real = cfgmod.config_file
    monkeypatch.setattr(cfgmod, "config_file",
                        lambda name, repo=cfgmod.REPO: dict(
                            real(name, repo), config=tree))
    monkeypatch.setattr(cfgmod, "traffic_file",
                        lambda name, root=cfgmod.ROOT: spec)
    return tree, spec
