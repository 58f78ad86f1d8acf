"""The dialogue cell (`train_m3ed_dia`): its entries are found by name, its
traffic reproduces from the shape seed with M3ED's mean, its MAC count
holds to a hand count, its readers read nothing where the program has no
spans, and on the CPU at tiny widths a sound run is correct while the
control, a step that leaves its state unchanged and half the batch left
out are not."""

import subprocess
import sys
import time

import numpy as np
import pytest

from perfbench import control_dialogue, run
from perfbench.lib import config as cfgmod
from perfbench.lib import flops_dialogue, harness, readers_dialogue
from perfbench.runners import train_dialogue as td
from perfbench.tests import tiny_dialogue

CELL = tiny_dialogue.CELL
SEED = 2 ** 31 + 77
METRICS = ("encoders_device_ms", "text_device_ms", "fusion_device_ms",
           "backward_device_ms", "slot_fill_pct", "input_ms", "mfu_pct",
           "device_idle_pct")


def _run(monkeypatch, trace="0", seconds="4"):
    tiny_dialogue.patch(monkeypatch)
    code, res = run.main(["--workload", CELL, "--seed", str(SEED),
                          "--seconds", seconds, "--trace", trace],
                         device="cpu", t_start=time.perf_counter())
    assert code == 0
    return res


def test_the_cell_and_its_metrics_are_found_by_name():
    bench = cfgmod.benchmark()
    entry = cfgmod.workload_entry(CELL)
    assert entry["chips"] == 1
    conf = cfgmod.config_entry(entry["config"])
    assert conf["reduced"] == [] and conf["file"].endswith(
        entry["config"] + ".json")
    assert cfgmod.traffic_file(entry["traffic"])["runner"] == \
        "train_dialogue"
    e2e = {m["name"] for m in bench["end_to_end"]
           if CELL in m.get("workloads", [CELL])}
    assert e2e == {"train_utt_per_s", "setup_s"}
    layer = {m["name"]: m for m in bench["per_layer"]
             if CELL in m["workloads"]}
    assert set(layer) == {f"{m}.train_dia" for m in METRICS}
    for name, m in layer.items():
        assert m["moves"] == "train_utt_per_s" and m["workloads"] == [CELL]
        path = f"{cfgmod.ROOT}/metrics/{name}.py"
        assert callable(harness.load_file(path, "m_" + name.replace(
            ".", "_")).read)


def test_the_sizes_reproduce_from_the_shape_seed():
    spec = cfgmod.traffic_file(CELL)
    a, b = td.sizes(spec), td.sizes(spec)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    utts = a["utts"]
    assert len(utts) == spec["pool_dialogues"] == 64
    # M3ED: 24,449 utterances in 990 dialogues
    assert abs(utts.mean() - 24449 / 990) < 0.5
    assert utts.max() == 64 and 4 <= (utts == 64).sum() <= 8
    assert utts.min() >= 1 and 15 <= np.median(utts) <= 22
    assert a["tokens"].max() <= 38 and a["frames"].max() <= 157
    assert a["rows"].max() <= 32 and a["rows"].min() == 0


def test_the_run_seed_draws_the_values_not_the_sizes():
    import torch

    tree, spec = tiny_dialogue.tiny_tree(), tiny_dialogue.tiny_traffic()
    one, two = (td.dialogue_pool(torch, spec, tree, s, torch.device("cpu"))
                for s in (1, 2 ** 33 + 5))
    for k in ("dia_mask", "audio_mask", "vision_mask", "dia_input_mask",
              "dia_sep_mask"):
        assert np.array_equal(one[k], two[k]), k
    assert not np.array_equal(one["dia_input_ids"], two["dia_input_ids"])
    assert not np.array_equal(one["audio_inputs"], two["audio_inputs"])
    # zeros past each slot's frames and in the empty slots
    assert np.all(one["audio_inputs"][one["audio_mask"] == 0] == 0)
    assert np.all(one["vision_inputs"][one["vision_mask"] == 0] == 0)
    assert np.all(one["labels"][one["dia_mask"] == 0] == 0)


def test_a_long_dialogue_is_cut_longest_first():
    from facialmmt_tpu_torch.data.text_prep import truncate_seq_pair

    ids = np.arange(1000, 1100)
    row, mask, sep = td.dialogue_text(3, [30, 5, 20, 9], ids, 40)
    # 40 - 3 - 1 = 36 tokens, as M3edTextPreprocessor cuts
    assert td.truncate_longest_first([30, 5, 20], 36) == [15, 5, 16] == [
        len(t) for t in truncate_seq_pair([["a"] * 30, ["b"] * 5,
                                           ["c"] * 20], 36)]
    assert row[0] == td.CLS and mask.sum() == 40
    assert list(np.flatnonzero(sep)) == [16, 22, 39]
    assert all(row[i] == td.SEP for i in np.flatnonzero(sep))
    assert list(row[1:16]) == list(range(1000, 1015))


def test_the_mac_count_by_hand():
    tree = tiny_dialogue.tiny_tree()
    d, ff, t = 32, 64, tree["text"]
    # one dialogue: 10 tokens, two utterances of (3 frames, 2 rows) and
    # (5 frames, 0 rows)
    enc = lambda layers, s, dm, f: layers * (4 * s * dm * dm + 2 * s * s * dm
                                             + 2 * s * dm * f)
    text = enc(2, 10, 64, 128) + 10 * 64 * d
    audio = sum(f * 12 * d + enc(2, f, d, ff) + f * (d * d + d)
                for f in (3, 5))
    vision = sum(r * 8 * d + enc(1, r, d, ff) + r * (d * d + d)
                 for r in (2, 0))
    # one 2-layer stack over the 2 utterances; TA and TA_V each both ways
    cm = 2 * (2 * 2 * d * d + 2 * 2 * d * d + 2 * 2 * 2 * d + 8 * 2 * d * d)
    # multimodal_linear2 twice, the classifier
    want = text + audio + vision + 4 * cm + 2 * 2 * 2 * d * d + 2 * d * 7
    assert t["num_layers"] == 2 and t["hidden_size"] == 64
    assert flops_dialogue.forward_macs(tree, 10, [3, 5], [2, 0]) == want
    assert flops_dialogue.train_macs(want) == 3 * want
    pad = flops_dialogue.padded_forward_macs(tree, 2)
    assert pad == flops_dialogue.forward_macs(tree, 48, [6, 6], [4, 4])


def test_the_readers_read_nothing_without_the_programs_spans():
    class Empty:
        """A trace with the methods the readers call, and no launch."""
        window = (0, 1)
        window_s = 1.0

        def launched_in_window(self):
            return []

    r = {"trace": Empty(), "rows": [], "input_s": [0.01],
         "traced_steps": 2, "untraced_step_s": [0.5]}
    for name in ("encoders_device_ms", "text_device_ms", "fusion_device_ms",
                 "backward_device_ms", "slot_fill_pct"):
        assert getattr(readers_dialogue, name)(r) is None, name


def test_input_and_idle_read_what_an_untraced_step_pays():
    class Busy:
        """A traced stretch of 2 steps with 0.6 s of device work."""
        window_s = 1.8

        def busy_s(self):
            return 0.6

    r = {"trace": Busy(), "traced_steps": 2, "untraced_step_s": [0.35, 0.45],
         "input_s": [0.05, 0.03]}
    # the wait and the copy of the steps before the profiler records
    assert readers_dialogue.input_ms(r) == pytest.approx(40.0)
    # 0.3 s busy a step of an untraced 0.4 s, not 0.6 of the slowed 0.9
    assert readers_dialogue.device_idle_pct(r) == pytest.approx(25.0)
    for key in ("trace", "traced_steps", "untraced_step_s"):
        assert readers_dialogue.device_idle_pct(
            dict(r, **{key: None})) is None, key
    assert readers_dialogue.input_ms(dict(r, input_s=[])) is None


def test_an_epochs_repeated_rows_are_not_counted():
    from facialmmt_tpu_torch.data.loader import epoch_batches

    spec = cfgmod.traffic_file(CELL)
    plan = epoch_batches(spec["epoch_dialogues"], spec["dialogues"],
                         shuffle=True, seed=td.loader_seed(SEED), epoch=0)
    idx, n_valid = plan[-1]
    # 685 = 85 x 8 + 5: the last batch repeats its last index 3 times
    assert n_valid == 5 and list(idx[5:]) == [idx[4]] * 3
    assert all(n == spec["dialogues"] for _, n in plan[:-1])
    mask = np.zeros((8, 64), np.int32)
    mask[:, :10] = 1
    assert td.valid_utterances({"dia_mask": mask}, n_valid) == 50
    assert td.valid_utterances({"dia_mask": mask}, 8) == 80


def test_a_sound_run_is_correct(monkeypatch):
    res = _run(monkeypatch)
    assert res["correct"], res["checks"]
    # on the CPU both sides compute in float32 from the same draws
    assert all(c["value"] < 1e-4 for c in res["checks"].values())
    assert res["metrics"]["train_utt_per_s"]["value"] > 0


def test_a_traced_run_reads_every_metric(monkeypatch):
    res = _run(monkeypatch, trace="1")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {f"{m}.train_dia" for m in METRICS}
    fill = res["metrics"]["slot_fill_pct.train_dia"]["value"]
    assert 0 < fill < 100
    assert list(res)[-1] == "checks"


def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    from facialmmt_tpu_torch.train.optim import ClippedAdamW

    def unchanged(self, sync=True):
        self.adamw.zero_grad(set_to_none=True)
        for p in self.params:
            p.grad = None

    monkeypatch.setattr(ClippedAdamW, "step", unchanged)
    res = _run(monkeypatch)
    assert not res["correct"]
    assert res["checks"]["update1_gap"]["value"] > 0.99


def test_half_the_batch_left_out_fails(monkeypatch):
    from facialmmt_tpu_torch.train import steps

    make = steps.make_dialogue_train_step

    def half(model, **kw):
        step = make(model, **kw)

        def run_half(state, batch, generator=None):
            h = batch["labels"].shape[0] // 2
            return step(state, {k: v[:h] for k, v in batch.items()},
                        generator)
        return run_half

    monkeypatch.setattr(steps, "make_dialogue_train_step", half)
    assert not _run(monkeypatch)["correct"]


def test_the_control_is_not_correct_and_reads_more(monkeypatch):
    tiny_dialogue.patch(monkeypatch)
    low = control_dialogue.main(["--workload", CELL, "--seconds", "2", "7"],
                                device="cpu")[0]
    assert not low["correct"], low["checks"]
    same = control_dialogue.main(["--workload", CELL, "--seconds", "2",
                                  "--precision", "fp32", "7"],
                                 device="cpu")[0]
    assert same["correct"]
    low, same = ({k: v for k, v in r["readings"].items()
                  if isinstance(v, float)} for r in (low, same))
    assert all(v < 1e-4 for v in same.values()), same
    assert max(low.values()) > 100 * max(max(same.values()), 1e-9), low


def test_the_cells_modules_load_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import perfbench.runners.train_dialogue,"
            " perfbench.reference.dialogue, perfbench.lib.check_dialogue,"
            " perfbench.lib.readers_dialogue, perfbench.control_dialogue,"
            " facialmmt_tpu_torch.models.dialogue,"
            " facialmmt_tpu_torch.data.m3ed;"
            "from perfbench.lib.harness import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, cfgmod.REPO],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("key", ["trace", "check", "sizes"])
def test_the_traffic_file_holds_its_groups(key):
    spec = cfgmod.traffic_file(CELL)
    assert key in spec
    assert spec["dialogues"] == 8 and spec["slots"] == 64
