"""The traffic generator and the open loop: the same seed gives the same
requests, every seed the same set of sizes, and a stall of the server shows
in the due-time tail of the requests queued behind it."""

import threading
import time
from concurrent.futures import Future

import numpy as np

from perfbench.lib import config as cfgmod
from perfbench.lib import load
from perfbench.lib.traffic import Traffic

TREE = cfgmod.config_file("facialmmt_tav_roberta_large")["config"]
SPEC = dict(cfgmod.traffic_file("serve_tav_poisson")["requests"],
            pool={"tokens": 8192, "audio_rows": 512, "vision_rows": 128,
                  "faces": 64})


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_the_same_seed_gives_the_same_traffic():
    big = 2 ** 31 + 12345
    t1, t2 = (Traffic(SPEC, TREE, big, 200, 100.0) for _ in range(2))
    np.testing.assert_array_equal(t1.due, t2.due)
    for i in (0, 7, 199):
        _same(t1.request(i), t2.request(i))


def test_every_seed_gets_the_same_sizes_in_its_own_order():
    t1, t2 = Traffic(SPEC, TREE, 1, 500), Traffic(SPEC, TREE, 2, 500)
    for k in ("utts", "pos", "audio", "faces", "gaps"):
        np.testing.assert_array_equal(np.sort(t1.sizes[k]),
                                      np.sort(t2.sizes[k]))
    assert not np.array_equal(t1.sizes["faces"], t2.sizes["faces"])


def test_requests_are_meld_shaped():
    t = Traffic(SPEC, TREE, 3, 2000)
    work = [t.work(i) for i in range(2000)]
    faces = np.asarray([w["faces"] for w in work])
    tokens = np.asarray([w["tokens"] for w in work])
    audio = np.asarray([w["audio"] for w in work])
    per_utt = t.sizes["toks"][:, 0]
    # the published means and the reference's caps (the file's sources)
    assert 6.5 < faces.mean() < 9.0 and faces.max() == 32
    assert 7.5 < per_utt.mean() < 8.5 and per_utt.max() == 38
    assert 35 < audio.mean() < 45 and audio.min() >= 1 and audio.max() == 157
    assert 8.8 < t.sizes["utts"].mean() < 9.8
    assert tokens.min() >= 3 and tokens.max() <= 512
    r = t.request(0)
    assert r["sep_mask"].sum() >= 1 and len(r["input_ids"]) <= 512
    assert r["input_ids"][0] == 0 and r["input_ids"][-1] == 2 or \
        len(r["input_ids"]) == 512


class StallingServer:
    """Answers each request 2 ms after it arrives, except that it stalls
    for `stall` seconds at `at` seconds."""

    def __init__(self, t0, at, stall):
        self.t0, self.at, self.stall = t0, at, stall
        self.stalled = False
        self.lock = threading.Lock()

    def submit(self, req):
        fut = Future()

        def answer():
            with self.lock:
                now = time.perf_counter() - self.t0
                if not self.stalled and now >= self.at:
                    self.stalled = True
                    time.sleep(self.stall)
            time.sleep(0.002)
            fut.set_result(np.zeros(7))

        threading.Thread(target=answer).start()
        return fut


def test_a_stalled_server_shows_in_the_due_time_tail():
    due = np.arange(0, 1.0, 0.01)           # 100 requests over 1 s
    t0 = time.perf_counter()
    server = StallingServer(t0, 0.3, 0.4)
    record, futures = load.open_loop(server.submit,
                                     lambda i: {"rid": i}, due, 1.0, t0)
    assert load.settle(futures, 10.0) == 0
    s = load.latency_summary(record, 1.0)
    # the 40 requests due during the stall wait for it
    assert s["p95_ms"] > 200 and s["attempted"] == 100 and s["failed"] == 0


def test_a_failed_request_counts_as_a_miss():
    def submit(req):
        fut = Future()
        if req["rid"] % 10 == 0:
            fut.set_exception(RuntimeError("refused"))
        else:
            fut.set_result(np.zeros(7))
        return fut

    t0 = time.perf_counter()
    record, futures = load.open_loop(submit, lambda i: {"rid": i},
                                     np.arange(0, 0.2, 0.01), 0.2, t0)
    s = load.latency_summary(record, 0.2)
    assert s["failed"] == 2 and s["p95_ms"] == float("inf")


def test_the_open_loop_window_holds_one_set_of_sizes_and_gaps():
    t1, t2 = Traffic(SPEC, TREE, 5, 300, 2.0), Traffic(SPEC, TREE, 6, 300, 2.0)
    for t in (t1, t2):
        assert t.due[0] == 0.0 and t.due[-1] < 2.0
        assert np.all(np.diff(t.due) > 0)
    np.testing.assert_allclose(np.sort(np.diff(t1.due)).sum() + 0,
                               np.sort(np.diff(t2.due)).sum(), rtol=0.02)


def test_a_closed_loop_takes_its_set_in_cycles():
    t = Traffic(SPEC, TREE, 5, 100, cycle=40)
    for k in ("faces", "audio"):
        first, second = t.sizes[k][:40], t.sizes[k][40:80]
        np.testing.assert_array_equal(np.sort(first), np.sort(second))
        assert not np.array_equal(first, second)
