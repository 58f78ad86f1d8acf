"""The benchmark's frozen MAC counts equal the program's on the default
configuration, and the per-request and training counts add up."""

import pytest

from perfbench.lib import config as cfgmod
from perfbench.lib import flops

TREE = cfgmod.config_file("facialmmt_tav_roberta_large")["config"]


@pytest.mark.parametrize("utts,dias,faces", [(1, 1, 12), (8, 8, 64),
                                             (32, 32, 256), (32, 8, 0)])
def test_eval_macs_equal_the_programs(utts, dias, faces):
    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.utils.flops import eval_step_macs

    assert flops.eval_step_macs(TREE, utts, dias, faces) == eval_step_macs(
        FacialMMTConfig(), utts, dias, faces)


def test_swin_macs_equal_the_programs():
    from facialmmt_tpu_torch.config import SwinConfig
    from facialmmt_tpu_torch.ops.swin import swin_flops

    assert flops.swin_macs(TREE["swin"]) == swin_flops(SwinConfig())


def test_a_full_request_counts_what_a_full_eval_row_counts():
    d = TREE["data"]
    full = {"tokens": d["max_seq_length"], "audio": d["audio_utt_max_len"],
            "faces": d["vision_utt_max_len"], "span": d["text_utt_max_len"]}
    assert flops.request_macs(TREE, full) == flops.eval_step_macs(
        TREE, 1, 1, d["vision_utt_max_len"])
    assert flops.aux_step_macs(TREE, 150) == 3 * 150 * flops.swin_macs(
        TREE["swin"])
