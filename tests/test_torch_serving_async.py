"""The port's serving front end (AsyncBatchServer, its bucket router and
benchmark_load) against the JAX package's, on the CPU.

Both packages' EmotionServers are built once per module at the same buckets
from the tiny config (deterministic gumbel, float32 compute and wire) and
the same weights, carried from the JAX variables by the weight bridge.  The
same queued requests must get the same answers (atol 1e-5 on
probabilities), pack sizes, bucket choices and failures; the packer's
failure paths are driven in both packages by the same blocking stub servers.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu import serving as jax_serving
from facialmmt_tpu.config import FacialMMTConfig, RuntimeConfig
from facialmmt_tpu_torch import serving as port_serving
from facialmmt_tpu_torch.checkpoint import from_jax
from tests.test_models import make_multimodal_batch
from tests.test_torch_ops import random_params
from tests.torch_bridge import port_config

CFG = FacialMMTConfig.tiny().replace(
    runtime=RuntimeConfig(deterministic_gumbel=True))
D = CFG.data
SMALL, BIG, CAP8 = (1, 4), (4, 16), (4, 8)
PACKAGES = {"jax": jax_serving, "port": port_serving}


@pytest.fixture(scope="module")
def servers():
    """{"jax": {bucket: server}, "port": {...}, "state": the port's weights}:
    one EmotionServer of each package per bucket, the same weights."""
    from facialmmt_tpu.models.pipeline import FacialMMTPipeline

    rng = np.random.default_rng(11)
    variables = random_params(FacialMMTPipeline(CFG), rng,
                              make_multimodal_batch(rng, CFG, b=2))
    state = from_jax.pipeline_state_dict(variables)
    out = {"jax": {}, "port": {}, "state": state}
    for mb, cap in (SMALL, BIG, CAP8):
        kw = dict(max_batch=mb, face_capacity=cap, transfer_dtype=np.float32)
        out["jax"][mb, cap] = jax_serving.EmotionServer(
            CFG, variables, dtype=jnp.float32, **kw)
        out["port"][mb, cap] = port_serving.EmotionServer(
            port_config(CFG), state, dtype=torch.float32, device="cpu", **kw)
    return out


def _serve(package, server, requests, **kw):
    """Submit every request at once to a new front; (answers, front)."""
    front = PACKAGES[package].AsyncBatchServer(server, **kw)
    try:
        futures = [front.submit(r) for r in requests]
        return [f.result(timeout=60) for f in futures], front
    finally:
        front.close()


def _full_requests(rng, n):
    return [{
        "audio": rng.normal(size=(5, D.audio_feat_dim)),
        "vision": rng.normal(size=(3, D.vision_feat_dim)),
        "faces": rng.integers(0, 255, (2, 160, 160, 3), dtype=np.uint8),
        "input_ids": rng.integers(2, CFG.text.vocab_size, size=(20,)),
        "sep_mask": np.eye(20)[7],
    } for _ in range(n)]


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == (CFG.num_labels,)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_packer_matches_jax(servers):
    """Six queued requests share packs and get JAX's answers."""
    rng = np.random.default_rng(0)
    reqs = [{"audio": rng.normal(size=(4, D.audio_feat_dim))}
            for _ in range(6)]
    got, front = _serve("port", servers["port"][BIG], reqs,
                        batch_deadline_ms=200.0)
    want, jax_front = _serve("jax", servers["jax"][BIG], reqs,
                             batch_deadline_ms=200.0)
    _close(got, want)
    for probs in got:
        np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-5)
    for f in (front, jax_front):
        assert sum(f.pack_sizes) == 6
        assert max(f.pack_sizes) > 1  # requests actually shared a pack


def test_face_capacity_splits_packs_as_jax(servers):
    """2 x 6 faces > capacity 8: two packs of one, no error, in both."""
    rng = np.random.default_rng(1)
    heavy = [{"faces": rng.integers(0, 255, (6, 160, 160, 3),
                                    dtype=np.uint8)} for _ in range(2)]
    got, front = _serve("port", servers["port"][CAP8], heavy,
                        batch_deadline_ms=200.0)
    want, jax_front = _serve("jax", servers["jax"][CAP8], heavy,
                             batch_deadline_ms=200.0)
    _close(got, want)
    assert front.pack_sizes == jax_front.pack_sizes == [1, 1]


def test_pack_identity_matches_solo(servers):
    """Each request's row in a shared pack (direct and through the packer)
    equals its solo prediction, and JAX's."""
    server = servers["port"][BIG]
    reqs = _full_requests(np.random.default_rng(2), 3)
    solo = [server.predict([r])[0] for r in reqs]
    assert not np.allclose(solo[0], solo[1])
    _close(solo, [servers["jax"][BIG].predict([r])[0] for r in reqs])
    _close(server.predict(reqs), solo)
    got, front = _serve("port", server, reqs, batch_deadline_ms=200.0)
    _close(got, solo)


def test_fp16_wire_matches_fp32(servers):
    """The default wire format ships features as fp16 and restores fp32 on
    the device: the answers stay within fp16 input rounding (atol 5e-3, as
    the JAX package's test)."""
    s16 = port_serving.EmotionServer(
        port_config(CFG), servers["state"], max_batch=BIG[0],
        face_capacity=BIG[1], dtype=torch.float32, device="cpu")
    s32 = servers["port"][BIG]
    assert s16._zero_batch()["audio_inputs"].dtype == np.float16
    assert s32._zero_batch()["audio_inputs"].dtype == np.float32
    reqs = _full_requests(np.random.default_rng(3), 3)
    for a, b in zip(s16.predict(reqs), s32.predict(reqs)):
        np.testing.assert_allclose(a, b, atol=5e-3, rtol=0)


def test_bucket_router_matches_jax(servers):
    """A router over two buckets: a lone light request runs the small one, a
    6-face request and a burst of 4 the big one, in both packages, with
    JAX's answers."""
    rng = np.random.default_rng(4)
    light = {"audio": rng.normal(size=(5, D.audio_feat_dim))}
    heavy = {"faces": rng.integers(0, 255, (6, 160, 160, 3),
                                   dtype=np.uint8)}
    results = {}
    for package in PACKAGES:
        s = servers[package]
        front = PACKAGES[package].AsyncBatchServer([s[BIG], s[SMALL]],
                                                   batch_deadline_ms=100.0)
        assert front.server is s[BIG]  # the largest bucket bounds the drain
        try:
            outs = [front.submit(light).result(timeout=60),
                    front.submit(heavy).result(timeout=60)]
            burst = [front.submit(dict(light)) for _ in range(4)]
            outs += [f.result(timeout=60) for f in burst]
        finally:
            front.close()
        assert front.bucket_choices[:2] == [SMALL, BIG]
        assert BIG in front.bucket_choices[2:]
        results[package] = outs
    _close(results["port"], results["jax"])
    port = servers["port"]
    _close(results["port"][:2], [port[SMALL].predict([light])[0],
                                 port[BIG].predict([heavy])[0]])
    _close(results["port"][2:], [results["port"][0]] * 4)


def test_oversized_request_fails_its_own_future(servers):
    """A request whose faces fit no bucket fails its own future with the
    port's FaceCapacityError; the packer survives it; submit after close
    fails with RuntimeError."""
    rng = np.random.default_rng(5)
    front = port_serving.AsyncBatchServer(servers["port"][SMALL],
                                          batch_deadline_ms=50.0)
    big = {"faces": rng.integers(0, 255, (6, 160, 160, 3), dtype=np.uint8)}
    with pytest.raises(port_serving.FaceCapacityError):
        front.submit(big).result(timeout=30)
    ok_request = {"audio": rng.normal(size=(4, D.audio_feat_dim))}
    ok = front.submit(ok_request).result(timeout=30)
    _close([ok], servers["jax"][SMALL].predict([ok_request]))
    front.close()
    assert not front._thread.is_alive()
    with pytest.raises(RuntimeError):
        front.submit(ok_request).result(timeout=30)


def _stub_server(mb, cap, release, rows):
    """The JAX package's test stub (tests/test_appendix.py): build_pack does
    nothing, and the dispatched rows block their readback on `release`."""
    class _Probs:
        def __array__(self, dtype=None, copy=None):
            release.wait(timeout=30)
            return np.ones((rows, 7), np.float32)

    class _Stub:
        max_batch, face_capacity = mb, cap

        def face_take(self, faces):
            return min(len(faces), 6)

        def build_pack(self, reqs):
            return {}, None

        def predict_device(self, batch, faces_raw):
            return _Probs()
    return _Stub()


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_router_backlog_justified_escalation(package):
    """A pack grows past a bucket boundary only when the waiting backlog can
    fill the larger bucket (the assertions of the JAX package's test)."""
    release = threading.Event()

    def run(n_queued):
        release.clear()
        front = PACKAGES[package].AsyncBatchServer(
            [_stub_server(2, 4, release, 8), _stub_server(8, 16, release, 8)],
            batch_deadline_ms=1.0, pipeline_depth=1)
        futs = [front.submit({})]
        while not front.pack_sizes:  # packer blocked on pack 1's readback
            time.sleep(0.005)
        futs += [front.submit({}) for _ in range(n_queued)]
        release.set()
        for f in futs:
            f.result(timeout=30)
        front.close()
        return front.bucket_choices

    # backlog 3 after the first drained pair cannot fill the 8-bucket
    assert all(mb == 2 for mb, _ in run(4)[1:])
    # a backlog that fills the big bucket escalates past the boundary
    assert any(mb == 8 for mb, _ in run(8)[1:])


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_close_fails_queued_requests(package):
    """close() resolves the pack in flight and fails the queued requests."""
    release = threading.Event()
    front = PACKAGES[package].AsyncBatchServer(
        _stub_server(1, 4, release, 1), batch_deadline_ms=1.0,
        pipeline_depth=1)
    f1 = front.submit({})
    while not front.pack_sizes:  # f1 dispatched, its readback blocked
        time.sleep(0.005)
    f2, f3 = front.submit({}), front.submit({})
    front._stop.set()  # stop THEN release, so the packer cannot start a
    release.set()      # new pack with f2
    front._thread.join(timeout=10)
    assert not front._thread.is_alive()
    assert f1.result(timeout=1).shape == (7,)
    for f in (f2, f3):
        with pytest.raises(RuntimeError):
            f.result(timeout=1)


@pytest.mark.parametrize("router", [False, True], ids=["single", "router"])
def test_benchmark_load_matches_jax_keys(servers, router):
    """Poisson load at 50 utt/s for 0.4 s: every request answered (the call
    waits on each future), and the same result keys as JAX's, with the
    packs per bucket behind a router."""
    stats = {}
    for package in PACKAGES:
        s = servers[package]
        server = [s[SMALL], s[BIG]] if router else s[BIG]
        stats[package] = PACKAGES[package].benchmark_load(
            server, rate_utt_per_s=50.0, duration_s=0.4,
            batch_deadline_ms=10.0)
    got, want = stats["port"], stats["jax"]
    assert sorted(got) == sorted(want)
    assert ("bucket_counts" in got) == router
    assert got["n_requests"] >= 1 and got["p50_ms"] > 0
    assert got["mean_batch_fill"] >= 1.0
    if router:  # 6 faces a request: only the big bucket fits one
        assert set(got["bucket_counts"]) == {"4,16"}


def test_packer_thread_and_readback_follow_the_servers_card(monkeypatch):
    """A server on cuda:1: the packer thread runs with device 1 as its
    current device, and the readback's event is recorded on device 1's
    stream, where the copy is queued (torch.cuda's device, current_stream
    and Event recorded by monkeypatch)."""
    entered, recorded = [], []
    card = torch.device("cuda", 1)

    class _Device:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append((self.dev, threading.current_thread()))

        def __exit__(self, *exc):
            return False

    class _Event:
        def record(self, stream=None):
            recorded.append(stream)

        def synchronize(self):
            pass

    class _Rows:
        is_cuda = True
        device = card

        def to(self, device, non_blocking=False):
            assert device == "cpu" and non_blocking
            return torch.full((2, 7), 1.0 / 7)

    class _Server:
        max_batch, face_capacity, device, mesh_plan = 2, 4, card, None

        def face_take(self, faces):
            return len(faces)

        def build_pack(self, reqs):
            return {}, None

        def predict_device(self, batch, faces_raw):
            return _Rows()

    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream of", device))
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    front = port_serving.AsyncBatchServer(_Server(), batch_deadline_ms=1.0)
    try:
        probs = front.submit({}).result(timeout=30)
    finally:
        front.close()
    assert probs.shape == (7,)
    assert entered == [(card, front._thread)]
    assert recorded == [("stream of", card)]


@pytest.mark.parametrize("layout", [(1, 1), "none"])
def test_one_rank_front_takes_the_one_process_path(layout):
    """No plan, or a plan of one rank: no group, no broadcast, the stub's
    rows as before."""
    from facialmmt_tpu_torch.parallel.mesh import MeshPlan

    release = threading.Event()
    release.set()
    stub = _stub_server(2, 4, release, 2)
    stub.mesh_plan = None if layout == "none" else MeshPlan.abstract(*layout)
    front = port_serving.AsyncBatchServer(stub, batch_deadline_ms=1.0)
    try:
        assert front.submit({}).result(timeout=30).shape == (7,)
    finally:
        front.close()
    assert front.plan is None and front._group is None
    assert front.broadcast_ms == [] and front.keepalives == 0


def test_rank_outside_the_mesh_takes_no_part():
    """A front over a plan whose rank is past dp x tp, over buckets on
    different plans, or over a plan of several ranks without its host group
    (not made by build_mesh), raises before it starts a thread."""
    from facialmmt_tpu_torch.parallel.mesh import MeshPlan

    release = threading.Event()
    outside, inside = (_stub_server(2, 4, release, 2) for _ in range(2))
    outside.mesh_plan = MeshPlan(None, 2, 1, rank=2)
    with pytest.raises(ValueError, match="outside the 2 x 1 mesh"):
        port_serving.AsyncBatchServer(outside)
    outside.mesh_plan = MeshPlan(None, 2, 1, rank=0)
    inside.mesh_plan = None
    with pytest.raises(ValueError, match="one mesh plan"):
        port_serving.AsyncBatchServer([outside, inside])
    inside.mesh_plan = outside.mesh_plan
    with pytest.raises(ValueError, match="host group"):
        port_serving.AsyncBatchServer([outside, inside])
