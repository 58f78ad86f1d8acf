"""The port's serving slice end to end against the JAX EmotionServer (CPU).

Both servers are built from the same tiny config (deterministic gumbel,
float32 compute and wire format) and the same weights, carried from the JAX
variables by the weight bridge; they must pack requests identically and
answer with the same probabilities (atol 1e-5).
"""

import os
import subprocess
import sys
import textwrap

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


def _requests(rng, d, vocab):
    return [
        {"input_ids": rng.integers(2, vocab, size=(20,)),
         "sep_mask": np.eye(20, dtype=np.int32)[7]},                 # text only
        {"audio": rng.normal(size=(5, d.audio_feat_dim)),
         "faces": rng.integers(0, 255, (3, 160, 160, 3), dtype=np.uint8)},
        {"audio": rng.normal(size=(30, d.audio_feat_dim)),           # truncated
         "vision": rng.normal(size=(4, d.vision_feat_dim)),
         "faces": rng.integers(0, 255, (4, 160, 160, 3), dtype=np.uint8),
         "input_ids": rng.integers(2, vocab, size=(90,)),            # truncated
         "sep_mask": np.eye(90, dtype=np.int32)[[10, 30]].sum(0),
         "utt_in_dia_idx": 1},
    ]


def test_emotion_server_matches_jax(rng):
    from facialmmt_tpu.data.meld import FaceCapacityError as JaxCapacityError
    from facialmmt_tpu.models.pipeline import FacialMMTPipeline as J
    from facialmmt_tpu.serving import EmotionServer as JaxServer
    from facialmmt_tpu_torch.serving import EmotionServer, FaceCapacityError

    cfg = FacialMMTConfig.tiny().replace(
        runtime=RuntimeConfig(deterministic_gumbel=True))
    variables = random_params(J(cfg), rng, make_multimodal_batch(rng, cfg, b=2))
    kw = dict(max_batch=4, face_capacity=8, transfer_dtype=np.float32)
    ref = JaxServer(cfg, variables, dtype=jnp.float32, **kw)
    port = EmotionServer(port_config(cfg),
                         from_jax.pipeline_state_dict(variables),
                         dtype=torch.float32, device="cpu", **kw)

    reqs = _requests(rng, cfg.data, cfg.text.vocab_size)
    batch, faces = port.build_pack(reqs)
    want_batch, want_faces = ref.build_pack(reqs)
    assert sorted(batch) == sorted(want_batch)
    for k in batch:
        assert batch[k].dtype == want_batch[k].dtype, k
        np.testing.assert_array_equal(batch[k], want_batch[k], err_msg=k)
    np.testing.assert_array_equal(faces, want_faces)

    for got, want in zip(port.predict(reqs), ref.predict(reqs)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.sum(), 1.0, atol=1e-5)
    # the all-padding pack (what the warm-up sends): every row answered
    empty, no_faces = port.build_pack([])
    np.testing.assert_allclose(port.predict_raw(empty, no_faces),
                               ref.predict_raw(empty, no_faces), atol=1e-5,
                               rtol=0)
    assert port.predict([]) == []

    too_many = [{"faces": np.zeros((5, 160, 160, 3), np.uint8)}] * 2
    with pytest.raises(FaceCapacityError) as err:
        port.build_pack(too_many)
    assert err.value.required == 10 and err.value.capacity == 8
    with pytest.raises(JaxCapacityError):
        ref.build_pack(too_many)
    with pytest.raises(ValueError):
        port.build_pack(reqs * 2)                # more than max_batch


def test_port_imports_no_jax():
    """A process that imports the port and serves one pack never loads JAX."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from facialmmt_tpu_torch.config import FacialMMTConfig
        from facialmmt_tpu_torch.serving import EmotionServer
        cfg = FacialMMTConfig.tiny()
        server = EmotionServer(cfg, max_batch=2, face_capacity=4,
                               dtype=torch.float32, device="cpu")
        out = server.predict([{"input_ids": np.arange(2, 12),
                               "faces": np.zeros((2, 160, 160, 3), np.uint8)}])
        assert out[0].shape == (7,) and abs(out[0].sum() - 1) < 1e-5
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                               "facialmmt_tpu"))
        assert not loaded, loaded
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    """Every source of the port and chip_smoke.py: no import of jax, flax,
    optax or facialmmt_tpu (the port keeps its own copy of what it needs)."""
    import pathlib
    import re

    banned = re.compile(
        r"^\s*(?:from|import)\s+(jax|jaxlib|flax|optax|facialmmt_tpu)(?:[.\s]|$)",
        re.MULTILINE)
    root = pathlib.Path(REPO)
    sources = sorted((root / "facialmmt_tpu_torch").rglob("*.py"))
    sources.append(root / "chip_smoke.py")
    assert len(sources) > 20
    for path in sources:
        hits = banned.findall(path.read_text())
        assert not hits, (str(path.relative_to(root)), hits)
