"""The plain reference agrees with the program's CPU path at tiny widths,
in float32: a served pack's answers and FER distributions, and an auxiliary
FER step's loss and update."""

import numpy as np
import torch

from perfbench.lib import check, weights
from perfbench.lib.traffic import Traffic
from perfbench.reference import facialmmt as ref_model
from perfbench.runners.serve import gumbel_table
from perfbench.tests import tiny


def _served(tree, spec, seed):
    from facialmmt_tpu_torch.serving import EmotionServer
    from perfbench.lib import config as cfgmod

    ref = ref_model.FacialMMT(tree)
    weights.draw_(ref, seed)
    server = EmotionServer(cfgmod.program_config(tree),
                           state_dict=ref.state_dict(), max_batch=4,
                           face_capacity=16, dtype=torch.float32,
                           device="cpu")
    traffic = Traffic(spec["requests"], tree, seed, 64, 1.0)
    nf = tree["data"]["vision_utt_max_len"]
    noise = gumbel_table(torch, 64, nf, tree["num_labels"], seed, "cpu")
    rids = [i for i in range(64) if traffic.sizes["faces"][i] <= 4][:4]
    reqs = [traffic.request(i) for i in rids]
    batch, faces_raw = server.build_pack(reqs)
    idx = np.where(batch["face_utt_id"] >= 0,
                   np.asarray(rids)[np.maximum(batch["face_utt_id"], 0)] * nf
                   + batch["face_pos"], 0)
    captured = {}
    fer = server.model.fer_probs

    def keep(faces, **kw):
        captured["fer"] = fer(faces, **kw)
        return captured["fer"]

    server.model.fer_probs = keep
    forward = server.model.forward
    server.model.forward = lambda b, generator=None, **kw: forward(
        b, generator=generator, noise=noise[torch.from_numpy(idx)])
    probs = server.predict_raw(batch, faces_raw)
    return ref, traffic, noise, rids, batch, probs, captured["fer"]


def test_reference_serves_what_the_program_serves_in_fp32():
    tree = tiny.tiny_tree()
    spec = tiny.tiny_traffic("serve_tav_poisson")
    ref, traffic, noise, rids, batch, probs, fer = _served(tree, spec, 5)
    nf = tree["data"]["vision_utt_max_len"]
    at = 0
    with torch.no_grad():
        for j, rid in enumerate(rids):
            arrays = check.request_arrays(torch, tree, traffic.request(rid),
                                          "cpu")
            n = arrays["faces"].shape[0]
            logits, fer_ref, answers = ref_model.serve_one(
                ref, arrays, noise[rid * nf:rid * nf + n])
            np.testing.assert_allclose(probs[j], answers[0].numpy(),
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(fer[at:at + n].numpy(),
                                       fer_ref.numpy(), rtol=1e-4, atol=1e-6)
            at += n
