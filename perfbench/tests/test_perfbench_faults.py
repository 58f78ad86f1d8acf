"""The check fails what it must.  Each cell's run is driven whole on the
CPU at tiny widths (the look for a card skipped) with the timed path broken
underneath, and `correct` comes out false: an answer altered where the
program produces it, in every slot of a pack or in its first alone; a
training step that leaves its state unchanged; half of the batch left out,
the mean taken over the rest.  (One chip: no exchange between chips to
leave out.)  The control, the reference one precision below the
configuration's, reads more than the program does, and the training cells'
controls come out not correct at the limits their files hold (the serving
cells' limits are for full widths: their control is judged on the card,
test_perfbench_gpu.py)."""

import time

import pytest
import torch

from perfbench import control, run
from perfbench.tests import tiny

SEED = 2 ** 31 + 77


def _run(workload, seconds="1.5"):
    code, res = run.main(["--workload", workload, "--seed", str(SEED),
                          "--seconds", seconds, "--trace", "0"],
                         device="cpu", t_start=time.perf_counter())
    assert code == 0
    return res


@pytest.mark.parametrize("workload", ["serve_tav_poisson",
                                      "serve_tav_backlog"])
def test_a_sound_serving_run_is_correct(monkeypatch, workload):
    tiny.patch(monkeypatch, workload)
    res = _run(workload)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("slots", ["every", "first"])
@pytest.mark.parametrize("workload", ["serve_tav_poisson",
                                      "serve_tav_backlog"])
def test_an_altered_answer_fails_the_check(monkeypatch, workload, slots):
    from facialmmt_tpu_torch.serving import EmotionServer

    tiny.patch(monkeypatch, workload)
    predict = EmotionServer.predict_device

    def altered(self, batch, faces_raw):
        probs = predict(self, batch, faces_raw)
        if slots == "every":
            return torch.roll(probs, 1, dims=-1)
        probs = probs.clone()
        probs[0] = torch.roll(probs[0], 1, dims=-1)
        return probs

    monkeypatch.setattr(EmotionServer, "predict_device", altered)
    res = _run(workload)
    assert not res["correct"]
    # one altered answer shows in the widest gap, whatever the median reads
    assert res["checks"]["answer_gap"]["value"] > \
        res["checks"]["answer_gap"]["limit"]


TRAINING = ["train_fer_aux", "train_tav_target"]


@pytest.mark.parametrize("workload", TRAINING)
def test_a_sound_training_run_is_correct(monkeypatch, workload):
    tiny.patch(monkeypatch, workload)
    res = _run(workload)
    assert res["correct"], res["checks"]
    # on the CPU both sides compute in float32 from the same draws
    assert all(c["value"] < 1e-4 for c in res["checks"].values())


@pytest.mark.parametrize("workload", TRAINING)
def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch, workload):
    from facialmmt_tpu_torch.train.optim import ClippedAdamW

    tiny.patch(monkeypatch, workload)

    def unchanged(self, sync=True):
        self.adamw.zero_grad(set_to_none=True)
        for p in self.params:
            p.grad = None

    monkeypatch.setattr(ClippedAdamW, "step", unchanged)
    res = _run(workload)
    assert not res["correct"]
    assert max(c["value"] for k, c in res["checks"].items()
               if k.startswith("update")) > 0.99


def _half_aux(step):
    def run_half(state, images, labels, generator=None, keeps=None):
        h = labels.shape[0] // 2
        keeps = [tuple(None if k is None else k[:h] for k in pair)
                 for pair in keeps]
        return step(state, images[:h], labels[:h], generator, keeps)
    return run_half


def _half_target(step):
    def run_half(state, batch, generator=None):
        h = batch["labels"].shape[0] // 2
        half = {k: v[:h] for k, v in batch.items()
                if k not in ("faces", "face_utt_id", "face_pos")}
        half["faces"], half["face_pos"] = batch["faces"], batch["face_pos"]
        uid = batch["face_utt_id"]
        half["face_utt_id"] = torch.where(uid < h, uid, -1)
        return step(state, half, generator)
    return run_half


@pytest.mark.parametrize("workload,maker,half", [
    ("train_fer_aux", "make_aux_train_step", _half_aux),
    ("train_tav_target", "make_multimodal_train_step", _half_target)])
def test_half_the_batch_left_out_fails(monkeypatch, workload, maker, half):
    from facialmmt_tpu_torch.train import steps

    tiny.patch(monkeypatch, workload)
    make = getattr(steps, maker)
    monkeypatch.setattr(steps, maker, lambda model, **kw: half(
        make(model, **kw)))
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", ["serve_tav_poisson", "train_fer_aux",
                                      "train_tav_target"])
def test_the_control_reads_more_than_the_reference_itself(monkeypatch,
                                                           workload):
    tiny.patch(monkeypatch, workload)
    run7 = control.main(["--workload", workload, "--seconds", "2", "7"],
                        device="cpu")[0]
    if workload in TRAINING:
        # judged at the limits the cell's file holds
        assert not run7["correct"], run7["checks"]
    low = run7["readings"]
    same = control.main(["--workload", workload, "--seconds", "2",
                         "--precision", "fp32", "7"],
                        device="cpu")[0]["readings"]
    low, same = ({k: v for k, v in r.items() if isinstance(v, float)}
                 for r in (low, same))
    assert all(v < 1e-4 for v in same.values()), same
    assert max(low.values()) > 100 * max(max(same.values()), 1e-9), low



@pytest.mark.parametrize("workload", ["serve_tav_poisson", "train_fer_aux",
                                      "train_tav_target"])
def test_a_traced_run_ends_with_its_result(monkeypatch, workload):
    # the traced stretch, its reading and the check all run on the CPU
    # too; the card's own readings are test_perfbench_gpu.py's
    tiny.patch(monkeypatch, workload)
    code, res = run.main(["--workload", workload, "--seed", str(SEED),
                          "--seconds", "1.5", "--trace", "1"],
                         device="cpu", t_start=time.perf_counter())
    assert code == 0
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
