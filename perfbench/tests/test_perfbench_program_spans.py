"""The readings of the program's own spans (lib/program_spans.py) and the
run that takes them (program_spans_run.py).

On a synthetic trace: an idle gap inside a full collection (`fmmt.gc`)
nested in a benchmark span is named `fmmt.gc` and the program span it
stopped; a launch is charged to the module span open at its launch time,
on any thread, the modules' share of a pack's dispatch follows, and a
pack's rows are taken by its key.  Driven whole on the CPU at tiny widths, a
traced run of each cell with the recorder on reads every host-side
quantity the program's spans give there, and its result stays correct."""

import time

import pytest

from facialmmt_tpu_torch.utils.observability import Row
from perfbench import program_spans_run
from perfbench.lib import program_spans as ps
from perfbench.lib.trace import Trace
from perfbench.tests import tiny

SEED = 2 ** 31 + 91
MS = 1_000_000


def _trace(device, spans, window):
    t = Trace.__new__(Trace)
    t.device, t.spans, t.window = device, spans, window
    t.uncorrelated = 0
    return t


def _row(name, start, end, thread=1, parent=None, key=None):
    return Row(name, start * MS, end * MS, thread, parent, key, None)


def test_a_gap_in_a_full_collection_is_named_by_it():
    # device busy 0-10 and 60-100 ms; idle 10-60 inside perfbench.dispatch
    # (5-70) around a full collection (12-58) on the packer's thread
    t = _trace([(0, 10 * MS, "k", 0), (60 * MS, 100 * MS, "k", 59 * MS)],
               [(5 * MS, 70 * MS, "perfbench.dispatch", None)],
               (0, 100 * MS))
    rows = [_row("fmmt.serve.dispatch", 6, 69, thread=2),
            _row("fmmt.gc", 12, 58, thread=2, parent="fmmt.serve.dispatch")]
    assert ps.idle_gaps(t, rows)[0] == [
        "fmmt.gc in fmmt.serve.dispatch", 0.05]
    assert t.idle_gaps()[0] == ["perfbench.dispatch", 0.05]  # as before
    assert ps.idle_gaps(t, [])[0] == ["perfbench.dispatch", 0.05]


def test_a_launch_is_charged_to_the_module_open_at_its_launch():
    # one pack: dispatch 0-50 ms holding stage 0-5, swin 5-20, text 20-35,
    # head 35-45; launches at 1, 6, 21, 36 and 47 (the last in no module),
    # each running 2 ms later for 3 ms; a launch is placed by its time
    # alone, whatever thread made it
    launches = [1, 6, 21, 36, 47]
    device = [((a + 2) * MS, (a + 5) * MS, "k", a * MS) for a in launches]
    t = _trace(device, [], (0, 60 * MS))
    rows = [_row("fmmt.serve.dispatch", 0, 50, key=0),
            _row("fmmt.serve.stage", 0, 5, key=0),
            _row("fmmt.model.swin", 5, 20, key=0),
            _row("fmmt.model.text", 20, 35, key=0),
            _row("fmmt.model.head", 35, 45, key=0)]
    per = {name: ps.device_ms_per(t, rows, names, "fmmt.serve.dispatch")
           for name, names in (("stage", ps.STAGE), ("swin", ps.SWIN),
                               ("text", ps.TEXT), ("fusion", ps.FUSION),
                               ("dispatch", ("fmmt.serve.dispatch",)))}
    assert per == pytest.approx({"stage": 3.0, "swin": 3.0, "text": 3.0,
                                 "fusion": 3.0, "dispatch": 15.0})
    assert ps.share_pct(t, rows, ps.SERVE_MODULES,
                        ("fmmt.serve.dispatch",)) == pytest.approx(80.0)
    # a pack the stretch cuts (its dispatch from -10 ms) is left out with
    # its rows, though its Swin span and launch lie inside the stretch; a
    # pack's rows are taken by its key, and rows of other names are not
    cut = [_row("fmmt.serve.dispatch", -10, 55, thread=3, key=1),
           _row("fmmt.model.swin", 50, 54, thread=3, key=1),
           _row("fmmt.serve.readback", 48, 58, key=0),
           _row("fmmt.serve.queued", 40, 59, key=0)]
    t.device.append((53 * MS, 57 * MS, "k", 51 * MS))
    units, inside = ps.within_units(t, rows + cut, "fmmt.serve.dispatch",
                                    ps.SERVE_MODULES)
    assert [u.key for u in units] == [0]
    assert sorted(r.name for r in inside) == sorted(r.name for r in rows)
    assert ps.share_pct(t, inside, ps.SERVE_MODULES,
                        ("fmmt.serve.dispatch",)) == pytest.approx(80.0)
    assert ps.device_ms_per(t, [], ps.SWIN, "fmmt.serve.dispatch") is None
    assert ps.device_ms_per(None, rows, ps.SWIN, "x") is None


def test_host_readings_over_the_window():
    w = (0, 1000 * MS)
    rows = [_row("fmmt.serve.dispatch", 10, 14),
            _row("fmmt.serve.dispatch", 500, 502),
            _row("fmmt.serve.dispatch", 1500, 1600),     # after the window
            _row("fmmt.gc", 990, 1100),                  # cut at its end
            _row("fmmt.gc", 100, 150)]
    rows += [Row("fmmt.serve.queued", k * 10 * MS, (k * 10 + k) * MS, 1,
                 None, k, 0) for k in range(1, 21)]
    assert ps.host_ms(rows, "fmmt.serve.dispatch", (0, 400 * MS)
                      ) == pytest.approx(4.0)
    assert ps.host_ms(rows, "fmmt.serve.dispatch", w) == pytest.approx(3.0)
    assert ps.gc_ms_per_s(rows, w) == pytest.approx(60.0)
    assert ps.gc_ms_per_s([], w) is None
    assert ps.queue_wait_p95_ms(rows, w) == pytest.approx(19.0)


HOST = {"serve_tav_poisson": ["queue_wait_ms", "dispatch_ms", "gc_ms_per_s"],
        "serve_tav_backlog": ["dispatch_ms", "gc_ms_per_s"],
        "train_fer_aux": ["fetch_ms", "gc_ms_per_s"],
        "train_tav_target": ["fetch_ms", "gc_ms_per_s"]}
SUFFIX = {"serve_tav_poisson": "serve_p95", "serve_tav_backlog": "serve_tput",
          "train_fer_aux": "train_img", "train_tav_target": "train_utt"}


@pytest.mark.parametrize("workload", sorted(HOST))
def test_a_traced_run_reads_the_programs_host_spans(monkeypatch, workload):
    # the stretch late enough to leave host readings before the profiler
    spec = tiny.tiny_traffic(workload)
    if "start_s" in spec["trace"]:
        spec["trace"]["start_s"] = 1.2
    else:
        spec["trace"]["first_step"] = 3
    tiny.patch(monkeypatch, workload, spec)
    code, res = program_spans_run.main(
        ["--workload", workload, "--seed", str(SEED), "--seconds", "2.5",
         "--trace", "1"], device="cpu", t_start=time.perf_counter())
    assert code == 0
    assert res["correct"], res["checks"]
    got = res["program_spans"]
    for name in HOST[workload]:
        value = got[f"{name}.{SUFFIX[workload]}"]
        assert value >= 0 and value == value, (name, got)
    assert res["program_gaps"] is not None
    from facialmmt_tpu_torch.utils import observability as obs
    assert not obs.RECORDER.on and obs.rows() == []
