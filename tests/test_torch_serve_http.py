"""The port's HTTP front end (facialmmt_tpu_torch/serve_http.py) against the
JAX package's, on the CPU: request decode, routing through the packer,
health and stats, error surfaces, the best-file loader, and the two entry
points (`python -m facialmmt_tpu_torch.serve_http` and `.streaming_demo`)
in processes of their own that load no JAX.

Both fronts route over (1, 4) and (4, 16) buckets built from the tiny
config (deterministic gumbel, float32 compute and wire) and the same
weights, carried from the JAX variables by the weight bridge.
"""

import base64
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facialmmt_tpu.config import FacialMMTConfig, RuntimeConfig
from facialmmt_tpu_torch.checkpoint import from_jax
from tests.test_models import make_multimodal_batch
from tests.test_torch_ops import random_params
from tests.torch_bridge import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = FacialMMTConfig.tiny().replace(
    runtime=RuntimeConfig(deterministic_gumbel=True))
BUCKETS = ((1, 4), (4, 16))
BANNED = ("jax", "jaxlib", "flax", "optax", "facialmmt_tpu")


@pytest.fixture(scope="module")
def fronts():
    """{"port": (url, front, small server), "jax": (url, front, None)}: both
    packages' HTTP fronts on ports the OS picked."""
    from facialmmt_tpu import serve_http as jax_http
    from facialmmt_tpu import serving as jax_serving
    from facialmmt_tpu.models.pipeline import FacialMMTPipeline
    from facialmmt_tpu_torch import serve_http, serving

    rng = np.random.default_rng(7)
    variables = random_params(FacialMMTPipeline(CFG), rng,
                              make_multimodal_batch(rng, CFG, b=2))
    state = from_jax.pipeline_state_dict(variables)
    port_servers = [serving.EmotionServer(
        port_config(CFG), state, max_batch=mb, face_capacity=cap,
        dtype=torch.float32, transfer_dtype=np.float32, device="cpu")
        for mb, cap in BUCKETS]
    jax_servers = [jax_serving.EmotionServer(
        CFG, variables, max_batch=mb, face_capacity=cap, dtype=jnp.float32,
        transfer_dtype=np.float32) for mb, cap in BUCKETS]
    out, stop = {}, []
    for key, package, servers in (("port", serving, port_servers),
                                  ("jax", jax_serving, jax_servers)):
        front = package.AsyncBatchServer(servers, batch_deadline_ms=50.0)
        httpd, _ = (serve_http if key == "port" else jax_http).serve(
            front, port=0, block=False)
        out[key] = (f"http://127.0.0.1:{httpd.server_address[1]}", front,
                    servers[0])
        stop.append((httpd, front))
    yield out
    for httpd, front in stop:
        httpd.shutdown()
        front.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_healthz_lists_buckets(fronts):
    status, body = _get(fronts["port"][0] + "/healthz")
    assert status == 200
    assert body == {"ok": True, "buckets": [list(b) for b in BUCKETS]}


def test_predict_matches_direct_path_and_jax(fronts):
    """One body (base64 faces, nested-list audio and tokens) through the
    port's endpoint equals the port's direct predict and JAX's endpoint;
    nested-list faces give the same reply."""
    url, _, small = fronts["port"]
    rng = np.random.default_rng(8)
    audio = rng.normal(size=(5, CFG.data.audio_feat_dim))
    faces = rng.integers(0, 255, (2, 160, 160, 3), dtype=np.uint8)
    payload = {
        "audio": audio.tolist(),
        "faces": base64.b64encode(faces.tobytes()).decode(),
        "faces_shape": list(faces.shape),
        "input_ids": rng.integers(2, CFG.text.vocab_size, size=(12,)).tolist(),
    }
    status, body = _post(url + "/predict", payload)
    assert status == 200
    probs = np.asarray(body["probs"])
    assert probs.shape == (CFG.num_labels,)
    np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-5)
    assert body["label"] == int(np.argmax(probs))

    direct = small.predict([{
        "audio": audio.astype(np.float32), "faces": faces,
        "input_ids": np.asarray(payload["input_ids"], np.int32),
        "utt_in_dia_idx": 0}])[0]
    np.testing.assert_allclose(probs, direct, atol=1e-5, rtol=0)

    jax_status, jax_body = _post(fronts["jax"][0] + "/predict", payload)
    assert jax_status == 200
    np.testing.assert_allclose(probs, jax_body["probs"], atol=1e-5, rtol=0)
    assert body["label"] == jax_body["label"]

    status2, body2 = _post(url + "/predict", {
        "audio": audio.tolist(), "faces": faces.tolist(),
        "input_ids": payload["input_ids"]})
    assert status2 == 200
    np.testing.assert_allclose(body2["probs"], probs, atol=1e-5, rtol=0)


def test_stats_reports_packs_and_buckets(fronts):
    url, front, _ = fronts["port"]
    _post(url + "/predict", {"input_ids": [5, 6, 7]})
    status, body = _get(url + "/stats")
    assert status == 200
    assert body["n_packs"] == len(front.pack_sizes) >= 1
    assert sum(body["bucket_counts"].values()) == body["n_packs"]
    assert body["mean_fill"] >= 1.0


def test_error_surfaces(fronts):
    """404 on an unknown route, 400 with the error on a malformed body, and
    the endpoint still serves afterwards."""
    url = fronts["port"][0]
    for call in (lambda: _get(url + "/nope"),
                 lambda: _post(url + "/nope", {})):
        with pytest.raises(urllib.error.HTTPError) as e:
            call()
        assert e.value.code == 404
    for bad in ({"faces": "!!notbase64!!", "faces_shape": [1, 160, 160, 3]},
                {"faces": base64.b64encode(b"\0" * 10).decode(),
                 "faces_shape": [1, 160, 160, 3]}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/predict", bad)
        assert e.value.code == 400
        assert "error" in json.loads(e.value.read())
    req = urllib.request.Request(url + "/predict", data=b"{not json",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400
    status, body = _post(url + "/predict", {"input_ids": [3, 4, 5]})
    assert status == 200 and len(body["probs"]) == CFG.num_labels


def test_load_serving_state(tmp_path):
    """The newest best file of a CheckpointManager loads strictly into an
    EmotionServer, BatchNorm running statistics included; a directory with
    no best file raises FileNotFoundError."""
    from facialmmt_tpu_torch.checkpoint.io import CheckpointManager
    from facialmmt_tpu_torch.models.pipeline import build_pipeline
    from facialmmt_tpu_torch.serve_http import load_serving_state
    from facialmmt_tpu_torch.serving import EmotionServer

    cfg = port_config(CFG)
    model = build_pipeline(cfg, torch.device("cpu"))
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert stats
    gen = torch.Generator().manual_seed(0)
    for k, v in stats.items():
        v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    manager = CheckpointManager(str(tmp_path / "run"))
    manager.save_best({k: v * 0 for k, v in model.state_dict().items()}, 1)
    manager.save_best(model.state_dict(), 3)  # the newest best is served

    state = load_serving_state(str(tmp_path / "run"))
    server = EmotionServer(cfg, state, max_batch=1, face_capacity=4,
                           dtype=torch.float32, device="cpu")
    served = server.model.state_dict()
    assert sorted(served) == sorted(model.state_dict())
    for k, v in stats.items():
        torch.testing.assert_close(served[k], v, rtol=0, atol=0)
        assert not torch.equal(v, torch.zeros_like(v))

    (tmp_path / "empty").mkdir()
    for missing in ("empty", "absent"):
        with pytest.raises(FileNotFoundError):
            load_serving_state(str(tmp_path / missing))
    assert not (tmp_path / "absent").exists()


def _imported(stderr: str) -> set:
    """Module names from `python -X importtime`'s report."""
    return {line.rsplit("|", 1)[1].strip() for line in stderr.splitlines()
            if line.startswith("import time:") and "|" in line}


def _banned(modules) -> list:
    return sorted(m for m in modules if m.split(".")[0] in BANNED)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_http_module_serves_without_jax(tmp_path):
    port = _free_port()
    err_path = tmp_path / "stderr.txt"
    env = {**os.environ, "PYTHONPATH": REPO}
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m",
             "facialmmt_tpu_torch.serve_http", "--tiny", "--device", "cpu",
             "--port", str(port)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            deadline, body = time.monotonic() + 120, None
            while body is None and time.monotonic() < deadline:
                assert proc.poll() is None, err_path.read_text()[-2000:]
                try:
                    status, body = _get(f"http://127.0.0.1:{port}/healthz")
                except (urllib.error.URLError, ConnectionError):
                    time.sleep(0.2)
            assert body == {"ok": True, "buckets": [[1, 12], [8, 64]]}
        finally:
            proc.terminate()
            proc.wait(timeout=30)
    modules = _imported(err_path.read_text())
    assert "facialmmt_tpu_torch.serving" in modules
    assert not _banned(modules)


def test_streaming_demo_module_runs_without_jax():
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "facialmmt_tpu_torch.streaming_demo", "--tiny", "--device", "cpu",
         "--ticks", "3"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ticks = [line for line in proc.stdout.splitlines()
             if line.startswith("tick ")]
    assert len(ticks) == 3
    assert "latency p50" in proc.stdout
    modules = _imported(proc.stderr)
    assert "facialmmt_tpu_torch.serving" in modules
    assert not _banned(modules)
